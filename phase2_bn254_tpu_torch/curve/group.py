"""Branchless Jacobian group law on torch tensors (counterpart of
`phase2_bn254_tpu/curve/group.py:43-136`).

The same dbl-2009-l / add-2007-bl formulas and the same masked handling of
the exceptional cases (infinity, P == Q, P == -Q), so the coordinates agree
with the JAX package limb for limb. Generic over `field.fq2.FqOps` / `Fq2Ops`.

Jacobian: (x, y, z), infinity <=> z == 0. Affine: (x, y, inf mask).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..field import fp


class JacobianBatch(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class AffineBatch(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool mask over the batch dims


def jac_zero(f, batch_shape, device) -> JacobianBatch:
    return JacobianBatch(f.zeros(batch_shape, device), f.ones(batch_shape, device), f.zeros(batch_shape, device))


def affine_to_jac(f, p: AffineBatch) -> JacobianBatch:
    shape, dev = p.inf.shape, p.inf.device
    one, zero = f.ones(shape, dev), f.zeros(shape, dev)
    return JacobianBatch(
        f.select(p.inf, zero, p.x), f.select(p.inf, one, p.y), f.select(p.inf, zero, one)
    )


def _muls(f, *pairs):
    """Independent products in one field multiply over a stacked batch
    (fewer, larger tensor ops; the values are those of separate calls)."""
    a = torch.stack([x for x, _ in pairs])
    b = torch.stack([y for _, y in pairs])
    return f.mul(a, b).unbind(0)


def jac_double(f, p: JacobianBatch) -> JacobianBatch:
    """dbl-2009-l; infinity maps to infinity (z3 = 2yz = 0)."""
    a, b, zy = _muls(f, (p.x, p.x), (p.y, p.y), (p.z, p.y))
    xb = f.add(p.x, b)
    c, xb2 = _muls(f, (b, b), (xb, xb))
    d = f.double(f.sub(f.sub(xb2, a), c))
    e = f.add(f.double(a), a)
    (ee,) = _muls(f, (e, e))
    x3 = f.sub(ee, f.double(d))
    c8 = f.double(f.double(f.double(c)))
    (t,) = _muls(f, (f.sub(d, x3), e))
    return JacobianBatch(x3, f.sub(t, c8), f.double(zy))


def jac_add(f, p: JacobianBatch, q: JacobianBatch) -> JacobianBatch:
    """add-2007-bl with masks for P+O, O+Q, doubling and P+(-P)."""
    p_inf = f.is_zero(p.z)
    q_inf = f.is_zero(q.z)
    z1z1, z2z2, pyqz, qypz = _muls(f, (p.z, p.z), (q.z, q.z), (p.y, q.z), (q.y, p.z))
    u1, u2, s1, s2 = _muls(f, (p.x, z2z2), (q.x, z1z1), (pyqz, z2z2), (qypz, z1z1))
    eq_x = f.eq(u1, u2)
    eq_y = f.eq(s1, s2)

    h = f.sub(u2, u1)
    h2 = f.double(h)
    r = f.double(f.sub(s2, s1))
    zz = f.add(p.z, q.z)
    i, rr, zz2 = _muls(f, (h2, h2), (r, r), (zz, zz))
    j, v, z3 = _muls(f, (h, i), (u1, i), (f.sub(f.sub(zz2, z1z1), z2z2), h))
    x3 = f.sub(f.sub(rr, j), f.double(v))
    vr, s1j = _muls(f, (f.sub(v, x3), r), (s1, j))
    y3 = f.sub(vr, f.double(s1j))

    dbl = jac_double(f, p)
    live = ~p_inf & ~q_inf
    is_dbl = eq_x & eq_y & live
    is_cancel = eq_x & ~eq_y & live
    x = f.select(is_dbl, dbl.x, x3)
    y = f.select(is_dbl, dbl.y, y3)
    z = f.select(is_dbl, dbl.z, z3)
    z = f.select(is_cancel, torch.zeros_like(z), z)
    x = f.select(p_inf, q.x, f.select(q_inf, p.x, x))
    y = f.select(p_inf, q.y, f.select(q_inf, p.y, y))
    z = f.select(p_inf, q.z, f.select(q_inf, p.z, z))
    return JacobianBatch(x, y, z)


class PendingNormalize(NamedTuple):
    """Device half of `jac_normalize`, waiting for the host inverse of
    `total` (Montgomery Fq limbs)."""

    jac: JacobianBatch
    partial: torch.Tensor
    total: torch.Tensor
    zero: torch.Tensor


def jac_normalize_start(f, p: JacobianBatch) -> PendingNormalize:
    partial, total, zero = fp.batch_inv_start(f.ctx, f.norm(p.z))
    return PendingNormalize(p, partial, total, zero)


def jac_normalize_finish(f, pend: PendingNormalize, total_mont: int) -> AffineBatch:
    ninv = fp.batch_inv_finish(f.ctx, pend.partial, fp.invert_total(f.ctx, total_mont), pend.zero)
    p = pend.jac
    zinv = f.inv_from_norm(p.z, ninv)  # zeros map to zero
    zinv2 = f.sqr(zinv)
    return AffineBatch(f.mul(p.x, zinv2), f.mul(p.y, f.mul(zinv2, zinv)), f.is_zero(p.z))


def jac_normalize(f, p: JacobianBatch) -> AffineBatch:
    """Jacobian -> affine with one batched inverse (JAX `jac_normalize`)."""
    pend = jac_normalize_start(f, p)
    return jac_normalize_finish(f, pend, fp.limbs_to_int(pend.total))
