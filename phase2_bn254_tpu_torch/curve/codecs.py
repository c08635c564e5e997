"""Point codecs between file bytes and device tensors (counterpart of
`phase2_bn254_tpu/curve/codecs.py:215-309`).

The byte swizzle and the flag and range checks run on the host in the
native C++ codec (`native`); the Montgomery conversions, the on-curve test,
decompression (kernel D1, `ops/decompress.py`) and the "greatest y" flag
run on the device.

* G1 uncompressed 64B: x||y, bit6(byte0) = infinity
* G1 compressed  32B: x, bit7 = y lexicographically largest
* G2 uncompressed 128B: x.c1||x.c0||y.c1||y.c0; compressed 64B: x.c1||x.c0
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..convert import to_device
from ..ops import decompress as D1
from ..field import fp
from ..field.fq2 import FQ, FQ2
from ..refimpl.field import Q
from . import group as G

_Q_BE = Q.to_bytes(32, "big")
CTX = fp.FQ_CTX
VECTOR_CHUNK = 1 << 18  # points per read in decode_vector


def _ops(group: str):
    return FQ if group == "g1" else FQ2


def decode_batch(raw: bytes, group: str, count: int, compressed: bool, check: bool, device,
                 allow_infinity: bool = False) -> G.AffineBatch:
    """Element bytes -> AffineBatch (Montgomery) on `device`. The host codec
    rejects, as the reference does, a point at infinity (unless
    allow_infinity, for uncompressed points: it then comes back with its inf
    flag set), a compression flag on an uncompressed point and a coordinate
    >= q. Compressed points go through D1 and raise if an x has no square
    root (one device sync); check=True runs the on-curve test on the finite
    uncompressed points (one sync)."""
    if allow_infinity and compressed:
        raise ValueError("allow_infinity is for uncompressed points")
    ncoords = (1 if group == "g1" else 2) * (1 if compressed else 2)
    res = native.decode_digits(raw, count, ncoords, 16, _Q_BE, reject_inf=not allow_infinity,
                               reject_greatest=not compressed)
    if res is None:
        raise RuntimeError("the native host codec is unavailable (it needs g++)")
    digits, greatest, inf = res  # digits uint32 (count, ncoords, 16), file coordinate order
    d = to_device(digits.astype(np.int64), device)
    if group == "g2":
        # file order is c1 || c0 per coordinate; tensors hold [c0, c1]
        d = d[:, [1, 0, 3, 2][:ncoords]].reshape(count, ncoords // 2, 2, fp.NLIMBS)
    if compressed:
        batch, valid = D1.decompress(d[:, 0].contiguous(), to_device(greatest, device), group)
        if not bool(valid.all()):
            raise ValueError(f"invalid {group} point in stream (off-curve or non-QR)")
        return batch
    mont = fp.to_mont(CTX, d)
    x, y = mont[:, 0].contiguous(), mont[:, 1].contiguous()
    inf = torch.zeros(count, dtype=torch.bool, device=device) if inf is None else to_device(inf, device)
    if check:
        f = _ops(group)
        rhs = f.add(f.mul(f.sqr(x), x), G.curve_b(f, device))
        if not bool((f.eq(f.sqr(y), rhs) | inf).all()):
            raise ValueError(f"invalid {group} point in stream (off-curve)")
    return G.AffineBatch(x, y, inf)


def encode_batch(batch: G.AffineBatch, group: str, compressed: bool, allow_infinity: bool = False) -> bytes:
    """AffineBatch -> element bytes, compressed or uncompressed. Raises on a
    point at infinity (the reference's "contribution produced infinity,
    re-run" guard, codecs.py:282-285) unless allow_infinity (uncompressed
    only): such a point is then written as bellman writes it, 0x40 and zeros.

    The device computes one int32 row per point, pulled in one copy:
    G1 [x | y | greatest | inf], G2 [x.c0 | x.c1 | y.c0 | y.c1 | greatest | inf]."""
    if allow_infinity and compressed:
        raise ValueError("allow_infinity is for uncompressed points")
    n = batch.inf.shape[0]
    if n == 0:
        return b""
    f = _ops(group)
    can = fp.from_mont(CTX, torch.stack([batch.x, batch.y, f.neg(batch.y)]))
    x, y, ny = can[0], can[1], can[2]
    greatest = f.gt(y, ny)
    cols = [x.reshape(n, -1), y.reshape(n, -1), greatest[:, None].to(fp.DTYPE), batch.inf[:, None].to(fp.DTYPE)]
    packed = torch.cat(cols, dim=1).to(torch.int32).cpu().numpy()
    inf = packed[:, -1] != 0
    if inf.any() and not allow_infinity:
        raise ValueError("point at infinity cannot be serialized into the accumulator")
    if group == "g1":
        coord_cols = [0] if compressed else [0, 16]
    else:
        # file order = x.c1 || x.c0 (|| y.c1 || y.c0)
        coord_cols = [16, 0] if compressed else [16, 0, 48, 32]
    out = native.encode_digits(packed.view(np.uint32), coord_cols, 16, greatest_col=packed.shape[1] - 2 if compressed else -1,
                               inf_mask=inf if inf.any() else None)
    if out is None:
        raise RuntimeError("the native host codec is unavailable (it needs g++)")
    return out.tobytes()


def decode_vector(src, name: str, device) -> G.AffineBatch:
    """A query vector of a `groth16.source.ParametersSource` decoded whole
    on `device` (VECTOR_CHUNK points per read), with the source's read modes: its
    `checked` runs the on-curve test; a point at infinity comes back with its
    inf flag set, or raises if the source disallows them."""
    group, n = src.group(name), src.count(name)
    dim = (n, 16) if group == "g1" else (n, 2, 16)
    if n == 0:
        z = torch.zeros(dim, dtype=fp.DTYPE, device=device)
        return G.AffineBatch(z, z.clone(), torch.zeros(0, dtype=torch.bool, device=device))
    parts = []
    for off in range(0, n, VECTOR_CHUNK):
        k = min(VECTOR_CHUNK, n - off)
        try:
            parts.append(decode_batch(src.read_chunk(name, off, k), group, k, False, src.checked, device,
                                      allow_infinity=src.allow_inf))
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from e
    return G.AffineBatch(*(torch.cat(t) for t in zip(*parts)))
