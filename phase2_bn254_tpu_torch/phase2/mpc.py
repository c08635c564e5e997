"""Phase-2 circuit-specific Groth16 MPC on the device (counterpart of
`phase2_bn254_tpu/phase2/mpc.py`, phase2/src/parameters.rs and keypair.rs),
with the same file format:

    .params file = bellman Parameters || cs_hash(64) || u32-BE count
                   || contributions (each: delta_after,s,s_delta uncompressed
                   G1; r_delta uncompressed G2; transcript 64B)

`MPCParameters` keeps the verifying key and the contributions as host
objects (a few points) and the five queries h, l, a, b_g1, b_g2 as device
`AffineBatch`es with infinity flags (`DeviceParameters`), read and written
through the device codec, never as host Points:

* `new`: the QAP evaluated at tau from the phase-1 radix file, one G1 and
  one G2 segmented multiply-and-sum (`ops/segsum.py`: on G1 the backend's
  `ladders.terms_g1`, K1 or K7, K9 on G2, the segmented scan S1) on term
  arrays built with numpy;
* `contribute`: delta^-1 applied to every point of h and l (K1, the GLV
  split of the one scalar broadcast over the batch); keypair and
  `vk.delta_*` on the host;
* `verify` / `verify_contribution`: the transcript and pairing checks on the
  host (`refimpl.pairing.same_ratio`), the query comparisons on the device,
  and the h / l update check through `TorchBackend.merge_pairs` (K3, K4,
  K5).

`Phase2PublicKey` is the JAX package's code unchanged. Every function that
takes a `backend` (a `TorchBackend`) runs on its device; without one, on
"cuda", which raises where there is no GPU. File:line citations of `.rs`
files are to the upstream Rust repository.
"""

from __future__ import annotations

import hashlib
import io
import itertools
import struct
from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from .. import convert
from ..crypto.chacha import ChaChaRng
from ..curve import codecs
from ..curve import group as G
from ..field.fq2 import FQ, FQ2
from ..groth16.containers import VerifyingKey
from ..groth16.cs import KeypairAssembly, LinearCombination, PolynomialDegreeTooLarge, UnconstrainedVariable, Variable
from ..groth16.source import VECTORS, ParametersSource
from ..ops import batch_exp, glv, segsum
from ..ops.backend import TorchBackend
from ..refimpl import curve as rc
from ..refimpl.field import R_MOD
from ..refimpl.pairing import same_ratio
from ..refimpl.sampling import hash_to_g2, rand_fr, rand_g1


@dataclass
class Phase2PublicKey:
    """phase2/src/keypair.rs:30-47."""

    delta_after: rc.Point
    s: rc.Point
    s_delta: rc.Point
    r_delta: rc.Point
    transcript: bytes  # 64 bytes

    def write(self) -> bytes:
        return (
            rc.point_to_bytes(self.delta_after, False)
            + rc.point_to_bytes(self.s, False)
            + rc.point_to_bytes(self.s_delta, False)
            + rc.point_to_bytes(self.r_delta, False)
            + self.transcript
        )

    @classmethod
    def read(cls, buf) -> "Phase2PublicKey":
        def rd(group):
            size = 64 if group == "g1" else 128
            p = rc.point_from_bytes(buf.read(size), group, False, check=True)
            if p.is_zero():
                raise ValueError("point at infinity in phase2 public key")
            return p

        delta_after = rd("g1")
        s = rd("g1")
        s_delta = rd("g1")
        r_delta = rd("g2")
        transcript = buf.read(64)
        assert len(transcript) == 64
        return cls(delta_after, s, s_delta, r_delta, transcript)

    def __eq__(self, o):
        return (
            isinstance(o, Phase2PublicKey)
            and self.delta_after == o.delta_after
            and self.s == o.s
            and self.s_delta == o.s_delta
            and self.r_delta == o.r_delta
            and self.transcript == o.transcript
        )

    def digest(self) -> bytes:
        return hashlib.blake2b(self.write()).digest()


def _same_points(p: G.AffineBatch, q: G.AffineBatch) -> bool:
    """Equal point vectors: the same length, infinity at the same places and
    the same (canonical) coordinates elsewhere."""
    return (p.inf.shape == q.inf.shape and torch.equal(p.inf, q.inf)
            and all(torch.equal(a[~p.inf], b[~p.inf]) for a, b in zip(p[:2], q[:2])))


def _backend(backend: TorchBackend | None) -> TorchBackend:
    return TorchBackend("cuda") if backend is None else backend


@dataclass
class DeviceParameters:
    """bellman `Parameters` (groth16/mod.rs:252-291) with the verifying key on
    the host and the five query vectors as device AffineBatches (Montgomery,
    inf flags)."""

    vk: VerifyingKey
    h: G.AffineBatch
    l: G.AffineBatch
    a: G.AffineBatch
    b_g1: G.AffineBatch
    b_g2: G.AffineBatch

    def write(self) -> bytes:
        out = bytearray(self.vk.write())
        for name, group in VECTORS:
            batch = getattr(self, name)
            out += struct.pack(">I", batch.inf.shape[0])
            out += codecs.encode_batch(batch, group, False, allow_infinity=True)
        return bytes(out)

    @classmethod
    def read(cls, buf, device, disallow_points_at_infinity: bool = False,
             checked: bool = True) -> "DeviceParameters":
        """Read from a seekable file object, leaving it after the last
        vector. checked: the on-curve test of every point (the device
        codec's); disallow_points_at_infinity: raise on one."""
        src = ParametersSource(buf, checked=checked, disallow_points_at_infinity=disallow_points_at_infinity)
        vectors = {name: codecs.decode_vector(src, name, device) for name, _ in VECTORS}
        buf.seek(src.end_offset)
        return cls(vk=src.vk, **vectors)

    def __eq__(self, o):
        return (
            isinstance(o, DeviceParameters)
            and self.vk == o.vk
            and all(_same_points(getattr(self, name), getattr(o, name)) for name, _ in VECTORS)
        )


def _terms(per_var: list[list[tuple[int, int]]]):
    """A QAP matrix as host term arrays: basis index (= constraint) and
    segment (= variable, sorted), numpy int64, and the coefficients (ints)."""
    flat = list(itertools.chain.from_iterable(per_var))
    lags = np.fromiter((lag for _, lag in flat), dtype=np.int64, count=len(flat))
    segs = np.repeat(np.arange(len(per_var), dtype=np.int64), [len(t) for t in per_var])
    return lags, segs, [c for c, _ in flat]


def _qap_terms(at, bt, ct, m: int):
    """The term arrays of the whole QAP evaluation over V variables, as two
    segmented sums: G1 over the basis coeffs_g1 || alpha_coeffs_g1 ||
    beta_coeffs_g1 (3m points) with segments a (0..V-1), b_g1 (V..2V-1) and
    ext (2V..3V-1; A on beta, B on alpha, C on coeffs_g1, stably sorted by
    variable), and G2 over coeffs_g2 with segments b_g2 (0..V-1). Returns
    the coefficients of the A, B and C terms (ints, in that order) and, for
    each sum, (basis index, segment, index of the term's coefficient in that
    list) as numpy int64 arrays."""
    v = len(at)
    (al, as_, ac), (bl, bs, bc), (cl, cs_, cc) = _terms(at), _terms(bt), _terms(ct)
    na, nb = len(ac), len(bc)
    ext_segs = np.concatenate([as_, bs, cs_])
    order = np.argsort(ext_segs, kind="stable")
    g1 = (np.concatenate([al, bl, np.concatenate([al + 2 * m, bl + m, cl])[order]]),
          np.concatenate([as_, bs + v, ext_segs[order] + 2 * v]),
          np.concatenate([np.arange(na + nb), order]))
    return ac + bc + cc, g1, (bl, bs, np.arange(na, na + nb))


def _read_radix(path: str, m: int, device):
    """phase1radix2m{exp} (layout in ceremony/prepare.py:1-12): the header
    (alpha G1, beta G1, beta G2) as host Points and the five vectors on
    `device`, decoded without the on-curve test; a point at infinity
    raises."""
    with open(path, "rb") as f:
        raw = f.read()
    off = 0

    def take(size: int) -> bytes:
        nonlocal off
        if off + size > len(raw):
            raise ValueError(f"{path}: too short for a domain of {m}")
        off += size
        return raw[off - size : off]

    def header(group: str) -> rc.Point:
        p = rc.point_from_bytes(take(64 if group == "g1" else 128), group, False, check=False)
        if p.is_zero():
            raise ValueError("point at infinity in radix file")
        return p

    def vector(group: str, count: int) -> G.AffineBatch:
        data = take(count * (64 if group == "g1" else 128))
        return codecs.decode_batch(data, group, count, False, False, device)

    head = header("g1"), header("g1"), header("g2")
    vecs = [vector(g, k) for g, k in (("g1", m), ("g2", m), ("g1", m), ("g1", m), ("g1", m - 1))]
    return head, vecs


@dataclass
class MPCParameters:
    params: DeviceParameters
    cs_hash: bytes
    contributions: list[Phase2PublicKey] = dfield(default_factory=list)

    # ------------------------------------------------------------------
    @classmethod
    def new(cls, circuit, should_filter_points_at_infinity: bool, radix_path_for,
            backend: TorchBackend | None = None) -> "MPCParameters":
        """parameters.rs:99-391. `circuit` has .synthesize(cs);
        `radix_path_for(exp)` -> path of phase1radix2m{exp}. The QAP
        evaluation (parameters.rs:225-305) gives, for every variable, a =
        A.coeffs_g1, b_g1 = B.coeffs_g1, b_g2 = B.coeffs_g2 and ext (ic for
        the inputs, l for the aux) = A.beta_coeffs_g1 + B.alpha_coeffs_g1 +
        C.coeffs_g1. The JAX package runs six segmented sums per section;
        here the G1 ones of both sections are one segmented sum with the
        segments offset (one K1 or K7 launch, one scan), and b_g2 another (one K9
        launch, one scan): the same points."""
        backend = _backend(backend)
        dev = backend.device
        assembly = KeypairAssembly()
        assembly.alloc_input()  # the "one" variable
        circuit.synthesize(assembly)
        for i in range(assembly.num_inputs):
            assembly.enforce(
                None,
                LinearCombination([(Variable("input", i), 1)]),
                LinearCombination(),
                LinearCombination(),
            )

        m, exp = 1, 0
        while m < assembly.num_constraints:
            m *= 2
            exp += 1
            if exp > 28:
                raise PolynomialDegreeTooLarge()

        (alpha, beta_g1, beta_g2), vecs = _read_radix(radix_path_for(exp), m, dev)
        coeffs_g1, coeffs_g2, alpha_coeffs_g1, beta_coeffs_g1, h = vecs

        # one G1 and one G2 segmented sum (variables: the inputs, then the aux)
        nv, ninp = assembly.num_inputs + assembly.num_aux, assembly.num_inputs
        coeffs, g1_terms, g2_terms = _qap_terms(assembly.at_inputs + assembly.at_aux,
                                                assembly.bt_inputs + assembly.bt_aux,
                                                assembly.ct_inputs + assembly.ct_aux, m)
        coeffs = convert.ints_to_limbs(coeffs, dev)
        basis_g1 = G.AffineBatch(*(torch.cat(t) for t in zip(coeffs_g1, alpha_coeffs_g1, beta_coeffs_g1)))
        sums = []
        for basis, (idx, segs, pick), nseg in ((basis_g1, g1_terms, 3 * nv), (coeffs_g2, g2_terms, nv)):
            sums.append(segsum.segmented_msm(basis, convert.to_device(idx, dev), coeffs[convert.to_device(pick, dev)],
                                             convert.to_device(segs, dev), nseg, backend.ladders.terms_g1))
        g1, b_g2 = G.jac_normalize(FQ, sums[0]), G.jac_normalize(FQ2, sums[1])
        a_g1, b_g1, ic, l = (G.AffineBatch(*(t[lo:hi] for t in g1))
                             for lo, hi in ((0, nv), (nv, 2 * nv), (2 * nv, 2 * nv + ninp), (2 * nv + ninp, 3 * nv)))
        if bool(l.inf.any()):
            raise UnconstrainedVariable()

        vk = VerifyingKey(
            alpha_g1=alpha,
            beta_g1=beta_g1,
            beta_g2=beta_g2,
            gamma_g2=rc.G2_GEN,
            delta_g1=rc.G1_GEN,
            delta_g2=rc.G2_GEN,
            ic=convert.affine_to_points(ic, "g1"),
        )
        if should_filter_points_at_infinity:
            a_g1, b_g1, b_g2 = (G.AffineBatch(*(t[~v.inf] for t in v)) for v in (a_g1, b_g1, b_g2))
        params = DeviceParameters(vk=vk, h=h, l=l, a=a_g1, b_g1=b_g1, b_g2=b_g2)

        cs_hash = hashlib.blake2b(params.write()).digest()
        return cls(params=params, cs_hash=cs_hash, contributions=[])

    # ------------------------------------------------------------------
    def keypair(self, rng: ChaChaRng) -> tuple[Phase2PublicKey, int]:
        """parameters.rs:860-908; returns (public key, delta)."""
        delta = rand_fr(rng)
        s = rand_g1(rng)
        s_delta = s.mul(delta)

        h = hashlib.blake2b()
        h.update(self.cs_hash)
        for pk in self.contributions:
            h.update(pk.write())
        h.update(rc.point_to_bytes(s, False))
        h.update(rc.point_to_bytes(s_delta, False))
        transcript = h.digest()

        r = hash_to_g2(transcript)
        r_delta = r.mul(delta)
        pub = Phase2PublicKey(
            delta_after=self.params.vk.delta_g1.mul(delta),
            s=s,
            s_delta=s_delta,
            r_delta=r_delta,
            transcript=transcript,
        )
        return pub, delta

    def contribute(self, rng: ChaChaRng, backend: TorchBackend | None = None) -> bytes:
        """parameters.rs:414-521; applies delta^-1 to every point of H and L
        on the backend's device."""
        dev = _backend(backend).device
        pubkey, delta = self.keypair(rng)
        delta_inv = pow(delta, -1, R_MOD)

        self.params.l = _batch_exp(self.params.l, delta_inv, dev)
        self.params.h = _batch_exp(self.params.h, delta_inv, dev)
        self.params.vk.delta_g1 = self.params.vk.delta_g1.mul(delta)
        self.params.vk.delta_g2 = self.params.vk.delta_g2.mul(delta)
        self.contributions.append(pubkey)
        return pubkey.digest()

    # ------------------------------------------------------------------
    def verify(self, circuit, should_filter_points_at_infinity: bool, radix_path_for,
               backend: TorchBackend | None = None) -> list[bytes]:
        """Full re-derivation verify (parameters.rs:529-658)."""
        backend = _backend(backend)
        initial = MPCParameters.new(circuit, should_filter_points_at_infinity, radix_path_for, backend)
        _check_invariants(initial, self)

        sink = hashlib.blake2b()
        sink.update(initial.cs_hash)
        current_delta = rc.G1_GEN
        result = []
        for pubkey in self.contributions:
            our = sink.copy()
            our.update(rc.point_to_bytes(pubkey.s, False))
            our.update(rc.point_to_bytes(pubkey.s_delta, False))
            sink.update(pubkey.write())
            h = our.digest()
            if pubkey.transcript != h:
                raise ValueError("inconsistent transcript")
            r = hash_to_g2(h)
            if not same_ratio((pubkey.s, pubkey.s_delta), (r, pubkey.r_delta)):
                raise ValueError("invalid phase2 PoK")
            if not same_ratio((current_delta, pubkey.delta_after), (r, pubkey.r_delta)):
                raise ValueError("inconsistent delta change")
            current_delta = pubkey.delta_after
            result.append(pubkey.digest())

        if current_delta != self.params.vk.delta_g1:
            raise ValueError("inconsistent delta_g1")
        if not same_ratio((rc.G1_GEN, current_delta), (rc.G2_GEN, self.params.vk.delta_g2)):
            raise ValueError("inconsistent delta_g2")
        _check_hl_update(initial, self, self.params.vk.delta_g2, rc.G2_GEN, backend)
        return result

    # ------------------------------------------------------------------
    def write(self) -> bytes:
        out = bytearray(self.params.write())
        out += self.cs_hash
        out += struct.pack(">I", len(self.contributions))
        for pk in self.contributions:
            out += pk.write()
        return bytes(out)

    @classmethod
    def read(cls, data: bytes, disallow_points_at_infinity: bool = False, checked: bool = True,
             backend: TorchBackend | None = None) -> "MPCParameters":
        """The .params bytes, queries decoded on the backend's device."""
        buf = io.BytesIO(data)
        params = DeviceParameters.read(buf, _backend(backend).device, disallow_points_at_infinity, checked)
        cs_hash = buf.read(64)
        (n,) = struct.unpack(">I", buf.read(4))
        contributions = [Phase2PublicKey.read(buf) for _ in range(n)]
        return cls(params=params, cs_hash=cs_hash, contributions=contributions)

    def __eq__(self, o):
        return (
            isinstance(o, MPCParameters)
            and self.params == o.params
            and self.cs_hash == o.cs_hash
            and self.contributions == o.contributions
        )


# ---------------------------------------------------------------------------

def _batch_exp(points: G.AffineBatch, coeff: int, device) -> G.AffineBatch:
    """Every point times the same scalar (parameters.rs:424-470): K1 with
    the GLV digits of the one scalar broadcast over the batch; infinity
    stays infinity."""
    n = points.inf.shape[0]
    if n == 0:
        return points
    x, y, inf = (t.to(device).contiguous() for t in points)
    d1, d2 = (d.expand(-1, n).contiguous() for d in glv.decompose_signed(convert.ints_to_limbs([coeff % R_MOD], device)))
    jac = batch_exp.batch_exp_glv_signed(x, y, d1, d2)
    jac = jac._replace(z=FQ.select(inf, torch.zeros_like(jac.z), jac.z))
    return G.jac_normalize(FQ, jac)


def _check_invariants(before: "MPCParameters", after: "MPCParameters"):
    """Shared invariant checks (parameters.rs:536-579 / 741-781); the
    queries are compared on the device."""
    p, q = before.params, after.params
    if p.h.inf.shape != q.h.inf.shape or p.l.inf.shape != q.l.inf.shape:
        raise ValueError("H/L length mismatch")
    if not (_same_points(p.a, q.a) and _same_points(p.b_g1, q.b_g1) and _same_points(p.b_g2, q.b_g2)):
        raise ValueError("A/B queries changed")
    if (
        p.vk.alpha_g1 != q.vk.alpha_g1
        or p.vk.beta_g1 != q.vk.beta_g1
        or p.vk.beta_g2 != q.vk.beta_g2
        or p.vk.gamma_g2 != q.vk.gamma_g2
    ):
        raise ValueError("alpha/beta/gamma changed")
    if p.vk.ic != q.vk.ic:
        raise ValueError("IC changed")
    if before.cs_hash != after.cs_hash:
        raise ValueError("cs_hash changed")


def _check_hl_update(before, after, delta_g2_num, delta_g2_den, backend: TorchBackend):
    """H and L must be updated by delta^-1: same_ratio(merge_pairs(h_before,
    h_after), (delta_after_g2, delta_before_g2)) - 'reversed for inverse'.
    Both merge_pairs run as one set of MSMs (TorchBackend.merge_pairs)."""
    p, q = before.params, after.params
    merged = backend.merge_pairs([(p.h, q.h), (p.l, q.l)], "g1")
    for name, (s, sx) in zip(("h", "l"), merged):
        if not same_ratio((s, sx), (delta_g2_num, delta_g2_den)):
            raise ValueError(f"{name} query not updated by delta^-1")


def verify_contribution(before: "MPCParameters", after: "MPCParameters",
                        backend: TorchBackend | None = None) -> bytes:
    """Single-step pairwise check (parameters.rs:726-854)."""
    backend = _backend(backend)
    if len(after.contributions) != len(before.contributions) + 1:
        raise ValueError("exactly one new contribution expected")
    if before.contributions != after.contributions[: len(before.contributions)]:
        raise ValueError("previous contributions changed")
    _check_invariants(before, after)

    sink = hashlib.blake2b()
    sink.update(before.cs_hash)
    for pk in before.contributions:
        sink.update(pk.write())
    pubkey = after.contributions[-1]
    sink.update(rc.point_to_bytes(pubkey.s, False))
    sink.update(rc.point_to_bytes(pubkey.s_delta, False))
    h = sink.digest()
    if pubkey.transcript != h:
        raise ValueError("inconsistent transcript")
    r = hash_to_g2(h)
    if not same_ratio((pubkey.s, pubkey.s_delta), (r, pubkey.r_delta)):
        raise ValueError("invalid phase2 PoK")
    if not same_ratio((before.params.vk.delta_g1, pubkey.delta_after), (r, pubkey.r_delta)):
        raise ValueError("inconsistent delta change")
    if pubkey.delta_after != after.params.vk.delta_g1:
        raise ValueError("inconsistent delta_g1")
    if not same_ratio((rc.G1_GEN, pubkey.delta_after), (rc.G2_GEN, after.params.vk.delta_g2)):
        raise ValueError("inconsistent delta_g2")
    _check_hl_update(before, after, after.params.vk.delta_g2, before.params.vk.delta_g2, backend)
    return pubkey.digest()


def contains_contribution(contributions: list[bytes], my_contribution: bytes) -> bool:
    return any(c == my_contribution for c in contributions)
