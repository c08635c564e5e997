"""Fq and Fq2 = Fq[u]/(u^2 + 1) op sets on torch tensors (counterpart of
`phase2_bn254_tpu/field/fq2.py`).

The curve layer is generic over one of these objects, as in the JAX package.
Layout: Fq = int64[..., n]; Fq2 = int64[..., 2, n] with c0 at index 0, n the
context's limb count (16 for BN254, 24 for BLS12-381: `BLS_FQ`, `BLS_FQ2`).
"""

from __future__ import annotations

import torch

from . import fp
from .fp import FpContext


class FqOps:
    """Fq ops (a veneer over field.fp)."""

    components = 1

    def __init__(self, ctx: FpContext):
        self.ctx = ctx

    def add(self, a, b):
        return fp.add(self.ctx, a, b)

    def sub(self, a, b):
        return fp.sub(self.ctx, a, b)

    def mul(self, a, b):
        return fp.mont_mul(self.ctx, a, b)

    def sqr(self, a):
        return fp.mont_mul(self.ctx, a, a)

    def neg(self, a):
        return fp.neg(self.ctx, a)

    def double(self, a):
        return fp.add(self.ctx, a, a)

    def is_zero(self, a):
        return fp.is_zero(a)

    def eq(self, a, b):
        return fp.eq(a, b)

    def gt(self, a, b):
        """a > b on canonical (not Montgomery) elements."""
        return fp.gt(a, b)

    def zeros(self, batch_shape, device):
        return self.ctx.zeros(batch_shape, device)

    def ones(self, batch_shape, device):
        return self.ctx.ones_mont(batch_shape, device)

    def select(self, mask, a, b):
        return torch.where(mask[..., None], a, b)

    def pow_fixed(self, a, e: int):
        return fp.pow_fixed(self.ctx, a, e)

    def norm(self, a):
        """The Fq element whose inverse yields a's inverse (a itself)."""
        return a

    def inv_from_norm(self, a, ninv):
        return ninv


class Fq2Ops:
    """Fq2 ops (Karatsuba mul, as fq2.rs:112-204)."""

    components = 2

    def __init__(self, ctx: FpContext):
        self.ctx = ctx

    @staticmethod
    def pack(c0, c1):
        return torch.stack([c0, c1], dim=-2)

    def add(self, a, b):
        return fp.add(self.ctx, a, b)  # componentwise over the 2-axis

    def sub(self, a, b):
        return fp.sub(self.ctx, a, b)

    def neg(self, a):
        return fp.neg(self.ctx, a)

    def double(self, a):
        return fp.add(self.ctx, a, a)

    def mul(self, a, b):
        c = self.ctx
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        v = fp.mont_mul(c, torch.stack([a0, a1, fp.add(c, a0, a1)]), torch.stack([b0, b1, fp.add(c, b0, b1)]))
        v0, v1, t = v[0], v[1], v[2]
        return self.pack(fp.sub(c, v0, v1), fp.sub(c, fp.sub(c, t, v0), v1))

    def sqr(self, a):
        c = self.ctx
        a0, a1 = a[..., 0, :], a[..., 1, :]
        # (a0 + a1)(a0 - a1) + 2 a0 a1 u
        v = fp.mont_mul(c, torch.stack([fp.add(c, a0, a1), a0]), torch.stack([fp.sub(c, a0, a1), a1]))
        return self.pack(v[0], fp.add(c, v[1], v[1]))

    def conjugate(self, a):
        return self.pack(a[..., 0, :], fp.neg(self.ctx, a[..., 1, :]))

    def is_zero(self, a):
        return (a == 0).all(-1).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1).all(-1)

    def gt(self, a, b):
        """a > b on canonical (not Montgomery) elements: c1 first, then c0
        (fq2.rs:21-30)."""
        c1_gt = fp.gt(a[..., 1, :], b[..., 1, :])
        c1_eq = fp.eq(a[..., 1, :], b[..., 1, :])
        return c1_gt | (c1_eq & fp.gt(a[..., 0, :], b[..., 0, :]))

    def zeros(self, batch_shape, device):
        return torch.zeros((*batch_shape, 2, self.ctx.nlimbs), dtype=fp.DTYPE, device=device)

    def ones(self, batch_shape, device):
        return self.pack(self.ctx.ones_mont(batch_shape, device), self.ctx.zeros(batch_shape, device))

    def select(self, mask, a, b):
        return torch.where(mask[..., None, None], a, b)

    def pow_fixed(self, a, e: int):
        """a^e for a public exponent e >= 0, square-and-multiply (JAX
        `Fq2Ops.pow_fixed`)."""
        return fp.square_multiply(self.mul, self.sqr, self.ones(a.shape[:-2], a.device), a, e)

    def norm(self, a):
        """a0^2 + a1^2 in Fq (fq2.rs norm)."""
        sq = fp.mont_mul(self.ctx, a, a)
        return fp.add(self.ctx, sq[..., 0, :], sq[..., 1, :])

    def inv_from_norm(self, a, ninv):
        """a^-1 = conj(a) / norm(a)."""
        return self.conjugate(fp.mont_mul(self.ctx, a, ninv[..., None, :]))

    def batch_inv(self, a):
        return self.inv_from_norm(a, fp.batch_inv(self.ctx, self.norm(a)))


FQ = FqOps(fp.FQ_CTX)
FQ2 = Fq2Ops(fp.FQ_CTX)
BLS_FQ = FqOps(fp.BLS_FQ_CTX)
BLS_FQ2 = Fq2Ops(fp.BLS_FQ_CTX)
