"""`TorchBackend`: the ceremony's bulk-math backend on PyTorch (counterpart of
`phase2_bn254_tpu/ops/backend.py`: the contribute, verify and
prepare_phase2 protocols; the Groth16 prover's query MSMs go through
`msm_async` / `msm_wait`).

Contribute: `ceremony.accumulator.transform` calls, per chunk and kind,
`decode`, then `pow_mul` (point i times coeff * tau^(start + i)), then
`encode`. Here `pow_mul` runs the tau powers, the scalar split, the
ladder kernel that the backend's `Ladders` name (by default K1 for G1, K2
for G2) and the device half of the batched normalization, and returns
without waiting for the device: the product total of the Montgomery trick
travels to pinned host memory behind an event, and `encode` inverts it on
the host and finishes. So `transform`'s pipeline
(decode and launch chunk i+1 before encoding chunk i) keeps the device busy.

Verify: `ceremony.accumulator.verify_transformation` decodes each compressed
chunk (kernel D1) and calls `power_pairs`, two MSMs (K3, K4, K5 in
`ops/msm.py`) with shared random coefficients; `decompress` re-encodes the
chunks uncompressed. The phase-2 checks of `phase2/mpc.py` call
`merge_pairs`, the same MSMs over pairs of query vectors.

prepare_phase2 (`ceremony/prepare.py`) reads its regions through `decode`
and writes the H bases tau^(i+m) - tau^i through `from_batch`,
`sub_batches` (plain torch: an add and the batched normalization) and
`encode_radix` (infinity permitted); its Lagrange vectors go through
`ceremony.streaming` (the group iNTT's kernels N1 and N2, `ops/ntt.py`), as
`group_intt` does for one vector. `slice` and `concat` serve the exact
in-memory path's protocol.

Every MSM (power_pairs, merge_pairs, the prover's msm_many_async) takes the
digits that the backend's `MsmMode` names: unsigned by default, signed under
PHASE2_TPU_MSM_SIGNED, as the JAX package's `pallas_msm._signed_mode` reads
it.

Batches are ragged: no padding to a power of two (the JAX backend pads with
generator points; the output bytes are the same).
"""

from __future__ import annotations

import os
import secrets
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from .. import convert
from ..curve import codecs
from ..curve import group as G
from ..field import fp
from ..field.fq2 import FQ, FQ2
from ..refimpl import curve as rc
from ..refimpl.field import Fq2, R_MOD
from . import batch_exp
from . import msm as M


@dataclass
class PointSet:
    """A chunk of points on the device. After `pow_mul` the affine points are
    pending until the host inverse of `total_host` is known."""

    group: str
    n: int
    affine: G.AffineBatch | None = None
    pending: G.PendingNormalize | None = None
    total_host: torch.Tensor | None = None
    ready: torch.cuda.Event | None = None


def _fr_mont(vals, device) -> torch.Tensor:
    return convert.ints_to_limbs([fp.FR_CTX.to_mont_int(v % R_MOD) for v in vals], device)


@dataclass(frozen=True)
class Ladders:
    """The ladder kernels of `pow_mul` and of the phase-2 QAP terms (JAX
    `ops/backend.py:133-172`, `ops/segsum.py:104-121`):

    * g1: "glv_signed" (K1, the default), "glv" (K7) or "windowed" (K8);
    * g2: "gls_signed" (K2, the default), "gls" (K10) or "windowed" (K9);
    * terms_g1, the G1 ladder of `ops.segsum.term_products`: "glv_signed"
      (K1) or "glv" (K7). Its G2 terms always take K9."""

    g1: str = "glv_signed"
    g2: str = "gls_signed"
    terms_g1: str = "glv_signed"

    @classmethod
    def from_env(cls, environ: Mapping[str, str]) -> "Ladders":
        """The JAX package's switches, with its precedence: PHASE2_TPU_NO_GLV
        takes G1 to K8 and PHASE2_TPU_NO_GLS G2 to K9, before
        PHASE2_TPU_NO_SIGNED5 takes them to K7 and K10; the QAP terms follow
        PHASE2_TPU_NO_SIGNED5 only. A variable counts when it is set and not
        empty. The port reads them nowhere else."""
        no_glv, no_gls, no_signed5 = (bool(environ.get(f"PHASE2_TPU_NO_{v}")) for v in ("GLV", "GLS", "SIGNED5"))
        return cls(g1="windowed" if no_glv else "glv" if no_signed5 else "glv_signed",
                   g2="windowed" if no_gls else "gls" if no_signed5 else "gls_signed",
                   terms_g1="glv" if no_signed5 else "glv_signed")


@dataclass(frozen=True)
class MsmMode:
    """The digits of every MSM the backend runs: signed (the JAX package's
    PHASE2_TPU_MSM_SIGNED, `ops.msm.msm_sets(..., signed=True)`) or
    unsigned (the default)."""

    signed: bool = False

    @classmethod
    def from_env(cls, environ: Mapping[str, str]) -> "MsmMode":
        """Signed where PHASE2_TPU_MSM_SIGNED is "1", "true" or "on" after
        strip().lower(), as `pallas_msm._signed_mode` reads it (not the
        PHASE2_TPU_NO_* rule of set and not empty). The port reads it nowhere
        else."""
        return cls(environ.get("PHASE2_TPU_MSM_SIGNED", "").strip().lower() in ("1", "true", "on"))


def check_device(device) -> torch.device:
    """The torch device named by `device`; a CUDA device raises when CUDA is
    not available (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: CUDA is not available")
    return dev


class TorchBackend:
    """The ceremony's backend on one torch device ("cuda",
    "cuda:1" or "cpu") with its ladder kernels and MSM digits: `ladders` and
    `msm_mode`, by default those that the environment selects
    (`Ladders.from_env`, `MsmMode.from_env`), as the JAX package reads its
    switches on every path. A CUDA device that is not there raises; nothing
    falls back."""

    name = "torch"

    def __init__(self, device, ladders: Ladders | None = None, msm_mode: MsmMode | None = None):
        self.device = check_device(device)
        self.ladders = Ladders.from_env(os.environ) if ladders is None else ladders
        self.msm_mode = MsmMode.from_env(os.environ) if msm_mode is None else msm_mode

    # -- the contribute protocol -------------------------------------------
    def decode(self, raw: bytes, group: str, count: int, compressed: bool, check: bool,
               allow_infinity: bool = False) -> PointSet:
        """Raises on a point at infinity unless allow_infinity (uncompressed
        only: the point then has its inf flag set)."""
        return PointSet(group, count, affine=codecs.decode_batch(raw, group, count, compressed, check, self.device,
                                                                 allow_infinity))

    def pow_mul(self, ps: PointSet, tau: int, start: int, coeff: int | None) -> PointSet:
        log2n = (ps.n - 1).bit_length()  # 2^log2n >= n
        scalars = batch_exp.tau_powers(
            _fr_mont([pow(tau, start, R_MOD)], self.device)[0],
            _fr_mont([pow(tau, 1 << j, R_MOD) for j in range(log2n)], self.device),
            _fr_mont([1 if coeff is None else coeff], self.device)[0],
            log2n,
        )[: ps.n]
        pts = self._affine(ps)
        if ps.group == "g1":
            f, jac = FQ, batch_exp.batch_exp_g1(self.ladders.g1, pts.x, pts.y, scalars)
        else:
            f, jac = FQ2, batch_exp.batch_exp_g2(self.ladders.g2, pts.x, pts.y, scalars)
        pend = G.jac_normalize_start(f, jac)
        out = PointSet(ps.group, ps.n, pending=pend)
        if self.device.type == "cuda":
            out.total_host = torch.empty(fp.NLIMBS, dtype=fp.DTYPE, pin_memory=True)
            out.total_host.copy_(pend.total, non_blocking=True)
            # the copy runs on the stream of the tensor's device, which need
            # not be the current device
            out.ready = torch.cuda.Event()
            out.ready.record(torch.cuda.current_stream(self.device))
        else:
            out.total_host = pend.total
        return out

    def encode(self, ps: PointSet, compressed: bool) -> bytes:
        """Raises on a point at infinity ("contribution produced infinity,
        re-run", batched_accumulator.rs:1176-1179)."""
        return codecs.encode_batch(self._affine(ps), ps.group, compressed)

    def _affine(self, ps: PointSet) -> G.AffineBatch:
        if ps.affine is None:
            if ps.ready is not None:
                ps.ready.synchronize()
            f = FQ if ps.group == "g1" else FQ2
            ps.affine = G.jac_normalize_finish(f, ps.pending, fp.limbs_to_int(ps.total_host))
            ps.pending = ps.total_host = ps.ready = None
        return ps.affine

    # -- the verify protocol -----------------------------------------------
    def msm(self, ps: PointSet, scalars: list[int]) -> rc.Point:
        """sum_i scalars[i] * point i, as a host Point."""
        return self.msm_wait(self.msm_async(ps, scalars))

    def msm_async(self, ps: PointSet, scalars: list[int] | torch.Tensor):
        """Launch an MSM without waiting for it; msm_wait takes the handle.
        scalars: ints, or canonical Fr limbs, int64 (ps.n, 16) on the
        backend's device."""
        return self.msm_many_async([(ps, scalars)])

    def msm_wait(self, handle) -> rc.Point:
        return self.msm_many_wait(handle)[0]

    def msm_many_async(self, items):
        """Launch the MSMs of items, (PointSet, scalars) pairs of one group
        (scalars as msm_async takes them), sharing one K4 and one K5 launch;
        msm_many_wait gives their results in order."""
        sets = []
        for ps, scalars in items:
            if len(scalars) != ps.n:
                raise ValueError(f"msm: {len(scalars)} scalars for {ps.n} points")
            if not isinstance(scalars, torch.Tensor):
                scalars = convert.ints_to_limbs([s % R_MOD for s in scalars], self.device)
            sets.append((self._affine(ps), scalars, (0,)))
        return self._to_host(M.msm_sets(sets, signed=self.msm_mode.signed), items[0][0].group)

    def msm_many_wait(self, handle) -> list[rc.Point]:
        return self._msm_points(handle)

    def power_pairs(self, ps: PointSet) -> tuple[rc.Point, rc.Point]:
        """(merge_pairs of v[:-1] vs v[1:]) with shared random coefficients,
        uniform in [0, r): the two MSMs share the scalars, so they run as one
        (`msm.msm_sets`, one set of shifts 0 and 1)."""
        coeffs = convert.to_device(random_scalars(ps.n - 1), self.device)
        s, sx = self._msm_points(self._to_host(M.msm_sets([(self._affine(ps), coeffs, (0, 1))],
                                                         signed=self.msm_mode.signed), ps.group))
        return s, sx

    def merge_pairs(self, pairs, group: str) -> list[tuple[rc.Point, rc.Point]]:
        """For each (v1, v2) pair of equal-length AffineBatches of `group` on
        the backend's device: (sum c_i v1_i, sum c_i v2_i) as host Points,
        with coefficients c_i uniform in [0, r) drawn for the pair and shared
        by its two sums (phase2 utils.rs merge_pairs). A pair is one
        `msm.msm_sets` set of shifts (0, n) over v1 || v2, and all pairs
        share one K4 and one K5 launch; an empty pair gives infinity twice."""
        sets = []
        for v1, v2 in pairs:
            n = v1.inf.shape[0]
            if v2.inf.shape[0] != n:
                raise ValueError(f"merge_pairs: {n} points against {v2.inf.shape[0]}")
            if n:
                both = G.AffineBatch(*(torch.cat([a, b]) for a, b in zip(v1, v2)))
                sets.append((both, convert.to_device(random_scalars(n), self.device), (0, n)))
        sums = iter(self._msm_points(self._to_host(M.msm_sets(sets, signed=self.msm_mode.signed), group))
                    if sets else ())
        zero = rc.point_zero(group)
        return [(next(sums), next(sums)) if v1.inf.shape[0] else (zero, zero) for v1, _ in pairs]

    def first_point(self, ps: PointSet) -> rc.Point:
        return convert.affine_to_points(G.AffineBatch(*(t[:1] for t in self._affine(ps))), ps.group)[0]

    def last_point(self, ps: PointSet) -> rc.Point:
        return convert.affine_to_points(G.AffineBatch(*(t[ps.n - 1 : ps.n] for t in self._affine(ps))), ps.group)[0]

    def from_points(self, points, group: str) -> PointSet:
        return PointSet(group, len(points), affine=convert.points_to_affine(points, group, self.device))

    # -- the prepare_phase2 protocol (ceremony/prepare.py) --------------------
    def from_batch(self, batch: G.AffineBatch, group: str) -> PointSet:
        """An AffineBatch (host-resident rows, say) on the backend's device."""
        return PointSet(group, batch.inf.shape[0], affine=G.AffineBatch(*(t.to(self.device) for t in batch)))

    def slice(self, ps: PointSet, start: int, stop: int) -> PointSet:
        if not 0 <= start <= stop <= ps.n:
            raise ValueError(f"slice [{start}, {stop}) of {ps.n} points")
        return PointSet(ps.group, stop - start, affine=G.AffineBatch(*(t[start:stop] for t in self._affine(ps))))

    def concat(self, parts: list[PointSet]) -> PointSet:
        batches = [self._affine(p) for p in parts]
        return PointSet(parts[0].group, sum(p.n for p in parts),
                        affine=G.AffineBatch(*(torch.cat(c) for c in zip(*batches))))

    def group_intt(self, ps: PointSet) -> PointSet:
        """Lagrange conversion (prepare_phase2.rs:102-131): the inverse group
        NTT on the device (`ceremony.streaming.intt_device`: N1 a stage, N2
        for 1/N, the batched normalization); n a power of two. May give
        points at infinity."""
        from ..ceremony import streaming

        exp = ps.n.bit_length() - 1
        if ps.n != 1 << exp:
            raise ValueError(f"group_intt: {ps.n} points is not a power of two")
        return PointSet(ps.group, ps.n, affine=streaming.intt_device(self._affine(ps), exp))

    def sub_batches(self, a: PointSet, b: PointSet) -> PointSet:
        """a[i] - b[i], normalized (the H-query bases tau^(i+m) - tau^i,
        prepare_phase2.rs:137-148): plain torch on the device."""
        if a.n != b.n or a.group != b.group:
            raise ValueError(f"sub_batches: {a.n} {a.group} points against {b.n} {b.group}")
        f = FQ if a.group == "g1" else FQ2
        ja, jb = G.affine_to_jac(f, self._affine(a)), G.affine_to_jac(f, self._affine(b))
        return PointSet(a.group, a.n, affine=G.jac_normalize(f, G.jac_add(f, ja, jb._replace(y=f.neg(jb.y)))))

    def encode_radix(self, ps: PointSet, compressed: bool = False) -> bytes:
        """Uncompressed encode permitting points at infinity (radix files)."""
        return codecs.encode_batch(self._affine(ps), ps.group, compressed, allow_infinity=True)

    def _to_host(self, jac: G.JacobianBatch, group: str):
        """Start the copy of (S,) Jacobian MSM results to host memory behind
        an event (pinned memory on a card): the handle _msm_points takes."""
        jac = torch.stack(list(jac), dim=1)  # (S, 3, ...)
        if self.device.type != "cuda":
            return jac, None, group
        host = torch.empty(jac.shape, dtype=jac.dtype, pin_memory=True)
        host.copy_(jac, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return host, ready, group

    @staticmethod
    def _msm_points(handle) -> list[rc.Point]:
        host, ready, group = handle
        if ready is not None:
            ready.synchronize()
        return [_jacobian_to_point(jac, group) for jac in host]


def random_scalars(m: int) -> torch.Tensor:
    """m scalars uniform in [0, r) from the system's randomness, as canonical
    int64 (m, 16) limbs: 254-bit draws from `secrets.token_bytes`, the ones
    >= r rejected (the distribution of `secrets.randbelow(r)`), in bulk."""
    r_words = np.array([(R_MOD >> (64 * k)) & (2**64 - 1) for k in range(4)], dtype=np.uint64)
    out, have = np.empty((m, 4), dtype=np.uint64), 0
    while have < m:
        k = (m - have) * 4 // 3 + 8  # r / 2^254 > 3 / 4 of the draws are kept
        words = np.frombuffer(secrets.token_bytes(32 * k), dtype="<u8").reshape(k, 4).copy()
        words[:, 3] &= np.uint64(2**62 - 1)  # 254 bits
        lt, eq = np.zeros(k, dtype=bool), np.ones(k, dtype=bool)
        for j in range(3, -1, -1):
            lt |= eq & (words[:, j] < r_words[j])
            eq &= words[:, j] == r_words[j]
        keep = words[lt][: m - have]
        out[have : have + len(keep)] = keep
        have += len(keep)
    return torch.from_numpy(out.view("<u2").astype(np.int64))


def _jacobian_to_point(jac: torch.Tensor, group: str) -> rc.Point:
    """Stacked (x, y, z) Montgomery limbs of one point -> host Point."""
    ctx = fp.FQ_CTX

    def fq(t):
        return ctx.from_mont_int(fp.limbs_to_int(t))

    if group == "g1":
        x, y, z = (fq(jac[i]) for i in range(3))
        if z == 0:
            return rc.point_zero("g1")
        zinv = pow(z, -1, ctx.p)
        return rc.Point(x * zinv**2 % ctx.p, y * zinv**3 % ctx.p, False, "g1")
    x, y, z = (Fq2(fq(jac[i, 0]), fq(jac[i, 1])) for i in range(3))
    if z == Fq2(0, 0):
        return rc.point_zero("g2")
    zinv = z.inverse()
    zinv2 = zinv * zinv
    return rc.Point(x * zinv2, y * zinv2 * zinv, False, "g2")
