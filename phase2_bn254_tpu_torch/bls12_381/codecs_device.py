"""BLS12-381 device codecs: zcash-format bytes <-> AffineBatch, with
decompression on the device in plain torch (counterpart of
`phase2_bn254_tpu/bls12_381/codecs_device.py`).

Byte semantics follow the reference's zcash conventions
(pairing/src/bls12_381/ec.rs): 48-byte big-endian Fq, flag bits in the three
most significant bits of byte 0 (bit 7 compressed, bit 6 infinity, bit 5 y
lexicographically largest), G2 x serialized c1 first. `decode_batch`
accepts and rejects what the JAX package's does (its `decode_batch`,
codecs_device.py:167-237), each with its message:

* a compressed batch without the compression flag on every point, or an
  uncompressed one with it on any point;
* an infinity flag on any point (the accumulator holds none);
* a sort flag on an uncompressed point;
* a coordinate >= q (after the flag bits are cleared);
* a compressed x whose x^3 + b has no square root, and (check=True) an
  uncompressed point off the curve.

Like the JAX package's, it makes no subgroup check. The byte swizzle and
the flag and range checks run on the host (the native codec, numpy where
it is missing); the Montgomery conversions, the on-curve test and the
square roots run on the batch's device, by exponentiation as the JAX
package's `_g1_decompress` / `_g2_decompress` take them: y = (x^3 + b)^((q +
1) / 4) in Fq, and the q = 3 mod 4 Fq2 square root (Algorithm 9 of eprint
2012/685, the reference's fq2.rs sqrt). In the JAX package decompression is
XLA glue, not a Pallas kernel; in the port it is the kernel D1-BLS
(`decompress`, csrc/decompress.cu's BLS12-381 instantiation) on a CUDA
device, one launch a batch (`LAUNCHES`), and its plain version
(`decompress_plain`: `_g1_decompress` / `_g2_decompress`, chains of torch
ops) on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..convert import to_device
from ..curve import group as G
from ..field import fp
from ..ops import _build
from .device import CTX_BLS_FQ as CTX
from .device import FQ2_OPS as FQ2
from .device import FQ_OPS as FQ
from .field import B_G1, B_G2, Q

FQ_BYTES = 48
NL = 24  # 16-bit digits of an Fq element
# kernel launches of D1-BLS (`decompress`); only a launch of the kernel counts
LAUNCHES = {"decompress_bls": 0}
_Q_BYTES = np.frombuffer(int(Q).to_bytes(FQ_BYTES, "big"), dtype=np.uint8)


def be_bytes_to_digits(b: np.ndarray) -> np.ndarray:
    """uint8 (n, 48) big-endian bytes -> uint32 (n, 24) little-endian 16-bit
    digits."""
    out = native.be_bytes_to_digits(b, NL)
    if out is not None:
        return out
    n = b.shape[0]
    pairs = b.reshape(n, NL, 2).astype(np.uint32)
    be = (pairs[..., 0] << 8) | pairs[..., 1]
    return be[:, ::-1].copy()


def digits_to_be_bytes(d: np.ndarray) -> np.ndarray:
    """uint32 (n, 24) little-endian 16-bit digits -> uint8 (n, 48) big-endian
    bytes."""
    out = native.digits_to_be_bytes(d, NL)
    if out is not None:
        return out
    n = d.shape[0]
    be = d[:, ::-1]
    out = np.empty((n, NL, 2), dtype=np.uint8)
    out[..., 0] = (be >> 8) & 0xFF
    out[..., 1] = be & 0xFF
    return out.reshape(n, FQ_BYTES)


def _check_lt_q(arr: np.ndarray, what: str) -> None:
    """Raise unless every row of big-endian bytes is below q."""
    d = arr.astype(np.int16) - _Q_BYTES[None, :]
    nz = d != 0
    first = np.argmax(nz, axis=1)
    val = d[np.arange(arr.shape[0]), first]
    if not (nz.any(axis=1) & (val < 0)).all():
        raise ValueError(f"{what}: coordinate not below field modulus")


def _rhs(f, x: torch.Tensor, b) -> torch.Tensor:
    """x^3 + b in f's field (Montgomery)."""
    return f.add(f.mul(f.sqr(x), x), G.curve_b(f, x.device, b))


def _choose_root(f, y: torch.Tensor, greatest: torch.Tensor) -> torch.Tensor:
    """y or -y: the one that is lexicographically largest where `greatest`,
    the other elsewhere (compared in canonical form, Fq2 c1 first)."""
    neg_y = f.neg(y)
    can = fp.from_mont(CTX, torch.stack([y, neg_y]))
    return f.select(f.gt(can[0], can[1]) == greatest, y, neg_y)


def _g1_decompress(x_dig: torch.Tensor, greatest: torch.Tensor):
    """Canonical x digits (N, 24) -> (AffineBatch, valid): y = (x^3 +
    4)^((q + 1) / 4), valid where y^2 = x^3 + 4."""
    x = fp.to_mont(CTX, x_dig)
    rhs = _rhs(FQ, x, B_G1)
    y = FQ.pow_fixed(rhs, (Q + 1) // 4)
    valid = FQ.eq(FQ.sqr(y), rhs)
    inf = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    return G.AffineBatch(x, _choose_root(FQ, y, greatest), inf), valid


def _g2_decompress(x_dig: torch.Tensor, greatest: torch.Tensor):
    """Canonical x digits (N, 2, 24) -> (AffineBatch, valid): the Fq2 square
    root of v = x^3 + 4 (1 + u) for q = 3 mod 4, valid where v is a residue
    and y^2 = v."""
    x = fp.to_mont(CTX, x_dig)
    v = _rhs(FQ2, x, B_G2)
    a1 = FQ2.pow_fixed(v, (Q - 3) // 4)
    alpha = FQ2.mul(FQ2.sqr(a1), v)
    a0 = FQ2.mul(FQ2.conjugate(alpha), alpha)
    batch, dev = x.shape[:-2], x.device
    neg1 = FQ2.pack(CTX.const(Q - 1, dev).expand(*batch, NL), CTX.zeros(batch, dev))
    u = FQ2.pack(CTX.zeros(batch, dev), CTX.ones_mont(batch, dev))
    is_nonresidue = FQ2.eq(a0, neg1)
    a1v = FQ2.mul(a1, v)
    root = FQ2.pow_fixed(FQ2.add(alpha, FQ2.ones(batch, dev)), (Q - 1) // 2)
    y = FQ2.select(FQ2.eq(alpha, neg1), FQ2.mul(a1v, u), FQ2.mul(a1v, root))
    valid = FQ2.eq(FQ2.sqr(y), v) & ~is_nonresidue
    inf = torch.zeros(batch, dtype=torch.bool, device=dev)
    return G.AffineBatch(x, _choose_root(FQ2, y, greatest), inf), valid


def decompress_plain(x_dig: torch.Tensor, greatest: torch.Tensor, group: str):
    """Plain PyTorch D1-BLS: `_g1_decompress` / `_g2_decompress`."""
    return (_g1_decompress if group == "g1" else _g2_decompress)(x_dig, greatest)


def decompress(x_dig: torch.Tensor, greatest: torch.Tensor, group: str):
    """D1-BLS: canonical x digits ((N, 24) G1, (N, 2, 24) G2) and the
    greatest flags (bool (N,)) -> (AffineBatch, valid). CPU tensors take
    the plain version; CUDA tensors launch csrc/decompress.cu's BLS12-381
    instantiation (the same limbs and flags)."""
    if not _build.on_card("decompress_bls", x_dig):
        return decompress_plain(x_dig, greatest, group)
    n = greatest.shape[0]
    _build.check("decompress_bls", "x", x_dig, (n, NL) if group == "g1" else (n, 2, NL), x_dig.device)
    _build.check("decompress_bls", "greatest", greatest, (n,), x_dig.device, torch.bool)
    ox, oy, valid = torch.empty_like(x_dig), torch.empty_like(x_dig), torch.empty_like(greatest)
    _build.launch(f"p2_decompress_bls_{group}", x_dig.device, x_dig, greatest, ox, oy, valid, n)
    LAUNCHES["decompress_bls"] += 1
    return G.AffineBatch(ox, oy, torch.zeros_like(greatest)), valid


def _from_canonical(f, b, x_dig: torch.Tensor, y_dig: torch.Tensor, check: bool):
    """Canonical x, y digits -> (AffineBatch, on_curve); on_curve all true
    without check."""
    x, y = fp.to_mont(CTX, x_dig), fp.to_mont(CTX, y_dig)
    batch = x.shape[: x.dim() - f.components]
    on_curve = f.eq(f.sqr(y), _rhs(f, x, b)) if check else torch.ones(batch, dtype=torch.bool, device=x.device)
    return G.AffineBatch(x, y, torch.zeros(batch, dtype=torch.bool, device=x.device)), on_curve


def decode_batch(raw: bytes, group: str, count: int, compressed: bool, check: bool = True,
                 device="cuda") -> G.AffineBatch:
    """zcash bytes -> AffineBatch (Montgomery) on `device` (the card unless
    "cpu"). Rejects (ValueError) infinities, coordinates >= q, bad flags,
    non-residue x (compressed) and, with check, off-curve points
    (uncompressed); one host sync for the validity test."""
    esize = (FQ_BYTES if compressed else 2 * FQ_BYTES) * (1 if group == "g1" else 2)
    if len(raw) != esize * count:
        raise ValueError(f"decode_batch: {len(raw)} bytes for {count} {group} points of {esize}")
    b = np.frombuffer(raw, dtype=np.uint8).reshape(count, esize).copy()

    comp_bit = (b[:, 0] & 0x80) != 0
    inf_bit = (b[:, 0] & 0x40) != 0
    sort_bit = (b[:, 0] & 0x20) != 0
    if compressed and not comp_bit.all():
        raise ValueError("compressed bit not set")
    if not compressed and comp_bit.any():
        raise ValueError("compressed bit set on uncompressed encoding")
    if inf_bit.any():
        raise ValueError("point at infinity in accumulator data")
    if not compressed and sort_bit.any():
        raise ValueError("sort bit set on uncompressed encoding")
    b[:, 0] &= 0x1F

    def fq_cols(mat):
        _check_lt_q(mat, "bls coordinate")
        return to_device(be_bytes_to_digits(np.ascontiguousarray(mat)).astype(np.int64), device)

    def fq2_cols(off):  # x = c1 || c0 (zcash order) -> [c0, c1]
        return torch.stack([fq_cols(b[:, off + FQ_BYTES : off + 2 * FQ_BYTES]), fq_cols(b[:, off : off + FQ_BYTES])],
                           dim=1)

    if compressed:
        x_dig = fq_cols(b) if group == "g1" else fq2_cols(0)
        batch, valid = decompress(x_dig.contiguous(), to_device(sort_bit, device), group)
    elif group == "g1":
        batch, valid = _from_canonical(FQ, B_G1, fq_cols(b[:, :FQ_BYTES]), fq_cols(b[:, FQ_BYTES:]), check)
    else:
        batch, valid = _from_canonical(FQ2, B_G2, fq2_cols(0), fq2_cols(2 * FQ_BYTES), check)
    if (compressed or check) and not bool(valid.all()):
        raise ValueError("invalid point encoding (off curve or non-residue)")
    return batch


def encode_batch(batch: G.AffineBatch, group: str, compressed: bool) -> bytes:
    """AffineBatch -> zcash bytes (no infinities: ValueError). The device
    computes the canonical coordinates and the greatest-y flag; one copy to
    the host."""
    if bool(batch.inf.any()):
        raise ValueError("point at infinity cannot be serialized")
    n = batch.inf.shape[0]
    f = FQ if group == "g1" else FQ2
    can = fp.from_mont(CTX, torch.stack([batch.x, batch.y, f.neg(batch.y)]))
    greatest = f.gt(can[1], can[2])
    packed = torch.cat([can[0].reshape(n, -1), can[1].reshape(n, -1), greatest[:, None].to(fp.DTYPE)], dim=1)
    packed = packed.cpu().numpy().astype(np.uint32)
    coords = [packed[:, k * NL : (k + 1) * NL] for k in range(packed.shape[1] // NL)]
    if group == "g1":
        xb, yb = digits_to_be_bytes(coords[0]), digits_to_be_bytes(coords[1])
    else:  # [x.c0, x.c1, y.c0, y.c1] -> c1 || c0
        xb = np.concatenate([digits_to_be_bytes(coords[1]), digits_to_be_bytes(coords[0])], axis=1)
        yb = np.concatenate([digits_to_be_bytes(coords[3]), digits_to_be_bytes(coords[2])], axis=1)
    if compressed:
        out = xb
        out[:, 0] |= np.where(packed[:, -1] != 0, 0x20, 0).astype(np.uint8)
        out[:, 0] |= 0x80
    else:
        out = np.concatenate([xb, yb], axis=1)
    return out.tobytes()
