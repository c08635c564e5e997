"""Point codecs between file bytes and device tensors (counterpart of
`phase2_bn254_tpu/curve/codecs.py:215-309`, the parts contribute uses).

The byte swizzle and the flag and range checks run on the host in the JAX
package's native C++ codec (`phase2_bn254_tpu.native`); the Montgomery
conversions, the on-curve test and the "greatest y" flag run on the device.

* G1 uncompressed 64B: x||y, bit6(byte0) = infinity
* G1 compressed  32B: x, bit7 = y lexicographically largest
* G2 uncompressed 128B: x.c1||x.c0||y.c1||y.c0; compressed 64B: x.c1||x.c0

Decompression (square roots) belongs to the verify slice and is not here.
"""

from __future__ import annotations

import numpy as np
import torch

from phase2_bn254_tpu import native
from phase2_bn254_tpu.refimpl.field import B_G2, Q

from ..convert import to_device
from ..field import fp
from ..field.fq2 import FQ, FQ2
from . import group as G

_Q_BE = Q.to_bytes(32, "big")
CTX = fp.FQ_CTX


def _ops(group: str):
    return FQ if group == "g1" else FQ2


def _b_coeff(group: str, device) -> torch.Tensor:
    if group == "g1":
        return CTX.const(3, device)
    return torch.stack([CTX.const(B_G2.c0, device), CTX.const(B_G2.c1, device)])


def decode_batch(raw: bytes, group: str, count: int, compressed: bool, check: bool, device) -> G.AffineBatch:
    """Uncompressed element bytes -> AffineBatch (Montgomery) on `device`.
    The host codec rejects, as the reference does, a point at infinity, a
    compression flag on an uncompressed point and a coordinate >= q;
    check=True also runs the on-curve test (one device sync)."""
    if compressed:
        raise NotImplementedError("compressed decode (decompression) is ROADMAP queue 1 item 7, the verify slice")
    res = native.decode_digits(raw, count, 2 if group == "g1" else 4, 16, _Q_BE, reject_greatest=True)
    if res is None:
        raise RuntimeError("the native host codec is unavailable (it needs g++)")
    digits = res[0]  # uint32 (count, ncoords, 16), file coordinate order
    d = to_device(digits.astype(np.int64), device)
    if group == "g2":
        # file order is c1 || c0 per coordinate; tensors hold [c0, c1]
        d = d[:, [1, 0, 3, 2]].reshape(count, 2, 2, fp.NLIMBS)
    mont = fp.to_mont(CTX, d)
    x, y = mont[:, 0].contiguous(), mont[:, 1].contiguous()
    if check:
        f = _ops(group)
        rhs = f.add(f.mul(f.sqr(x), x), _b_coeff(group, device))
        if not bool(f.eq(f.sqr(y), rhs).all()):
            raise ValueError(f"invalid {group} point in stream (off-curve)")
    return G.AffineBatch(x, y, torch.zeros(count, dtype=torch.bool, device=device))


def fq2_gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq2 canonical order: c1 first, then c0 (fq2.rs:21-30)."""
    c1_gt = fp.gt(a[..., 1, :], b[..., 1, :])
    c1_eq = fp.eq(a[..., 1, :], b[..., 1, :])
    return c1_gt | (c1_eq & fp.gt(a[..., 0, :], b[..., 0, :]))


def encode_batch(batch: G.AffineBatch, group: str, compressed: bool) -> bytes:
    """AffineBatch -> element bytes, compressed or uncompressed. Raises on a
    point at infinity (the reference's "contribution produced infinity,
    re-run" guard, codecs.py:282-285).

    The device computes one int32 row per point, pulled in one copy:
    G1 [x | y | greatest | inf], G2 [x.c0 | x.c1 | y.c0 | y.c1 | greatest | inf]."""
    f = _ops(group)
    can = fp.from_mont(CTX, torch.stack([batch.x, batch.y, f.neg(batch.y)]))
    x, y, ny = can[0], can[1], can[2]
    greatest = fp.gt(y, ny) if group == "g1" else fq2_gt(y, ny)
    n = batch.inf.shape[0]
    cols = [x.reshape(n, -1), y.reshape(n, -1), greatest[:, None].to(fp.DTYPE), batch.inf[:, None].to(fp.DTYPE)]
    packed = torch.cat(cols, dim=1).to(torch.int32).cpu().numpy()
    if packed[:, -1].any():
        raise ValueError("point at infinity cannot be serialized into the accumulator")
    if group == "g1":
        coord_cols = [0] if compressed else [0, 16]
    else:
        # file order = x.c1 || x.c0 (|| y.c1 || y.c0)
        coord_cols = [16, 0] if compressed else [16, 0, 48, 32]
    out = native.encode_digits(packed.view(np.uint32), coord_cols, 16, greatest_col=packed.shape[1] - 2 if compressed else -1)
    if out is None:
        raise RuntimeError("the native host codec is unavailable (it needs g++)")
    return out.tobytes()
