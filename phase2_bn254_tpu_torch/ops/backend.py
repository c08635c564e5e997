"""`TorchBackend`: the ceremony's bulk-math backend on PyTorch (counterpart of
`phase2_bn254_tpu/ops/backend.py`, the contribute slice).

`phase2_bn254_tpu.ceremony.accumulator.transform` calls, per chunk and kind,
`decode`, then `pow_mul` (point i times coeff * tau^(start + i)), then
`encode`. Here `pow_mul` runs the tau powers, the GLV / GLS split, the
ladder kernel (K1 for G1, K2 for G2) and the device half of the batched
normalization, and returns without waiting for the device: the product
total of the Montgomery trick travels to pinned host memory behind an event,
and `encode` inverts it on the host and finishes. So `transform`'s pipeline
(decode and launch chunk i+1 before encoding chunk i) keeps the device busy.

Batches are ragged: no padding to a power of two (the JAX backend pads with
generator points; the output bytes are the same).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from phase2_bn254_tpu.refimpl.field import R_MOD

from .. import convert
from ..curve import codecs
from ..curve import group as G
from ..field import fp
from ..field.fq2 import FQ, FQ2
from . import batch_exp, gls, glv


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


def check_device(device) -> torch.device:
    """The torch device named by `device`; a CUDA device raises when CUDA is
    not available (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: CUDA is not available")
    return dev


class TorchBackend:
    """Contribute-slice backend on one torch device ("cuda", "cuda:1" or
    "cpu"). A CUDA device that is not there raises; nothing falls back."""

    name = "torch"

    def __init__(self, device):
        self.device = check_device(device)

    # -- the contribute protocol -------------------------------------------
    def decode(self, raw: bytes, group: str, count: int, compressed: bool, check: bool) -> PointSet:
        return PointSet(group, count, affine=codecs.decode_batch(raw, group, count, compressed, check, self.device))

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
            f = FQ
            d1, d2 = glv.decompose_signed(scalars)
            jac = batch_exp.batch_exp_glv_signed(pts.x, pts.y, d1, d2)
        else:
            f = FQ2
            jac = batch_exp.batch_exp_gls_signed(pts.x, pts.y, gls.decompose_signed(scalars))
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


def _not_ported(name: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"TorchBackend.{name} is not ported yet: ROADMAP.md queue 1 item {item}")

    method.__name__ = name
    return method


# the rest of the backend protocol belongs to later slices
_VERIFY, _PREPARE = "7 (MSM and the verify slice)", "9 (prepare_phase2)"
for _name, _item in {
    "msm": _VERIFY, "msm_async": _VERIFY, "msm_wait": _VERIFY, "power_pairs": _VERIFY,
    "first_point": _VERIFY, "last_point": _VERIFY, "from_points": _VERIFY,
    "from_batch": _PREPARE, "slice": _PREPARE, "concat": _PREPARE, "group_intt": _PREPARE,
    "sub_batches": _PREPARE, "encode_radix": _PREPARE,
}.items():
    setattr(TorchBackend, _name, _not_ported(_name, _item))
