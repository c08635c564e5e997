"""Point decompression D1 (counterpart of `phase2_bn254_tpu/curve/codecs.py`
`_g1_decompress` :101-114 and `_g2_decompress` :158-189, XLA glue in the JAX
package; kernel in csrc/decompress.cu).

`decompress(x, greatest, group)`: compressed x coordinates, canonical int64
digits ((N, 16) for G1, (N, 2, 16) = [c0, c1] for G2), and the "greatest"
flags (bool (N,)) -> (AffineBatch in Montgomery form, valid bool (N,)). A
point is valid iff x^3 + b has a square root in its field; y is the root
whose canonical value is the greater (Fq2 order: c1 first) when the flag is
set, its negation when not.

The wrapper takes the plain version for tensors on the CPU; on a CUDA tensor
it launches the kernel or raises, and counts the launch in
`LAUNCHES["decompress"]`.
"""

from __future__ import annotations

import torch

from ..curve import group as G
from ..field import fp
from ..field.fq2 import FQ, FQ2
from ..refimpl.field import Q
from . import _build

CTX = fp.FQ_CTX

# kernel launches; only a launch of the kernel counts
LAUNCHES = {"decompress": 0}


def _pick_y(f, y, greatest):
    """y or -y by the canonical order of the two and the flag."""
    ny = f.neg(y)
    can = fp.from_mont(CTX, torch.stack([y, ny]))
    return f.select(f.gt(can[0], can[1]) == greatest, y, ny)


def decompress_plain(x: torch.Tensor, greatest: torch.Tensor, group: str):
    """Plain PyTorch D1: the JAX package's formulation, op for op."""
    xm = fp.to_mont(CTX, x)
    if group == "g1":
        rhs = FQ.add(FQ.mul(FQ.sqr(xm), xm), G.curve_b(FQ, x.device))
        y = FQ.pow_fixed(rhs, (Q + 1) // 4)
        valid = FQ.eq(FQ.sqr(y), rhs)
        return G.AffineBatch(xm, _pick_y(FQ, y, greatest), torch.zeros_like(greatest)), valid
    v = FQ2.add(FQ2.mul(FQ2.sqr(xm), xm), G.curve_b(FQ2, x.device))
    a1 = FQ2.pow_fixed(v, (Q - 3) // 4)
    alpha = FQ2.mul(FQ2.sqr(a1), v)
    a0 = FQ2.mul(FQ2.conjugate(alpha), alpha)
    shape = greatest.shape
    neg1 = FQ2.pack(CTX.const(Q - 1, x.device).expand(*shape, fp.NLIMBS), CTX.zeros(shape, x.device))
    u = FQ2.pack(CTX.zeros(shape, x.device), CTX.ones_mont(shape, x.device))
    is_nonresidue = FQ2.eq(a0, neg1)
    a1v = FQ2.mul(a1, v)
    b = FQ2.pow_fixed(FQ2.add(alpha, FQ2.ones(shape, x.device)), (Q - 1) // 2)
    y = FQ2.select(FQ2.eq(alpha, neg1), FQ2.mul(a1v, u), FQ2.mul(a1v, b))
    valid = FQ2.eq(FQ2.sqr(y), v) & ~is_nonresidue
    return G.AffineBatch(xm, _pick_y(FQ2, y, greatest), torch.zeros_like(greatest)), valid


def decompress(x: torch.Tensor, greatest: torch.Tensor, group: str):
    """D1. CPU tensors take the plain version; CUDA tensors launch
    csrc/decompress.cu."""
    if not _build.on_card("decompress", x):
        return decompress_plain(x, greatest, group)
    n = greatest.shape[0]
    _build.check("decompress", "x", x, (n, 16) if group == "g1" else (n, 2, 16), x.device)
    _build.check("decompress", "greatest", greatest, (n,), x.device, torch.bool)
    ox, oy, valid = torch.empty_like(x), torch.empty_like(x), torch.empty_like(greatest)
    _build.launch(f"p2_decompress_{group}", x.device, x, greatest, ox, oy, valid, n)
    LAUNCHES["decompress"] += 1
    return G.AffineBatch(ox, oy, torch.zeros_like(greatest)), valid
