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
from ..refimpl.field import B_G1, B_G2


class JacobianBatch(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class AffineBatch(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool mask over the batch dims


def curve_b(f, device, b=None) -> torch.Tensor:
    """b of y^2 = x^3 + b, Montgomery, in f's field: the curve's b (an int
    on G1, f Fq; an Fq2 value with c0, c1 on G2, f Fq2), by default BN254's:
    3 on G1, 3 / (9 + u) on G2 (BLS12-381: 4 and 4 (1 + u))."""
    if f.components == 1:
        return f.ctx.const(B_G1 if b is None else b, device)
    b = B_G2 if b is None else b
    return torch.stack([f.ctx.const(b.c0, device), f.ctx.const(b.c1, device)])


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


def _add_2007_bl(f, p: JacobianBatch, q: JacobianBatch):
    """add-2007-bl for finite P, Q: (sum, eq_x, eq_y); the sum is only right
    where not eq_x (P == Q needs the doubling, P == -Q has z3 = 0)."""
    z1z1, z2z2, pyqz, qypz = _muls(f, (p.z, p.z), (q.z, q.z), (p.y, q.z), (q.y, p.z))
    u1, u2, s1, s2 = _muls(f, (p.x, z2z2), (q.x, z1z1), (pyqz, z2z2), (qypz, z1z1))
    h = f.sub(u2, u1)
    h2 = f.double(h)
    r = f.double(f.sub(s2, s1))
    zz = f.add(p.z, q.z)
    i, rr, zz2 = _muls(f, (h2, h2), (r, r), (zz, zz))
    j, v, z3 = _muls(f, (h, i), (u1, i), (f.sub(f.sub(zz2, z1z1), z2z2), h))
    x3 = f.sub(f.sub(rr, j), f.double(v))
    vr, s1j = _muls(f, (f.sub(v, x3), r), (s1, j))
    y3 = f.sub(vr, f.double(s1j))
    return JacobianBatch(x3, y3, z3), f.eq(u1, u2), f.eq(s1, s2)


def jac_add(f, p: JacobianBatch, q: JacobianBatch) -> JacobianBatch:
    """add-2007-bl with masks for P+O, O+Q, doubling and P+(-P)."""
    p_inf = f.is_zero(p.z)
    q_inf = f.is_zero(q.z)
    s, eq_x, eq_y = _add_2007_bl(f, p, q)
    dbl = jac_double(f, p)
    live = ~p_inf & ~q_inf
    is_dbl = eq_x & eq_y & live
    is_cancel = eq_x & ~eq_y & live
    x = f.select(is_dbl, dbl.x, s.x)
    y = f.select(is_dbl, dbl.y, s.y)
    z = f.select(is_dbl, dbl.z, s.z)
    z = f.select(is_cancel, torch.zeros_like(z), z)
    x = f.select(p_inf, q.x, f.select(q_inf, p.x, x))
    y = f.select(p_inf, q.y, f.select(q_inf, p.y, y))
    z = f.select(p_inf, q.z, f.select(q_inf, p.z, z))
    return JacobianBatch(x, y, z)


def batch_scalar_mul(f, points: AffineBatch, scalars: torch.Tensor) -> JacobianBatch:
    """points[i] * scalars[i] over the masked group law (JAX
    `group.batch_scalar_mul`, curve/group.py:160): T[d] = d P for d < 16 by
    adds (P at infinity gives infinity throughout), then per 4-bit window of
    the canonical scalars (N, D) 16-bit digits, most significant first, 4
    doublings and one add of T[digit]. The windows before the first that any
    lane needs are skipped (the accumulator is infinity there, and stays so
    limb for limb)."""
    n, dev = points.inf.shape[0], points.inf.device
    base = affine_to_jac(f, points)
    entries = [jac_zero(f, (n,), dev), base]
    for _ in range(2, 16):
        entries.append(jac_add(f, entries[-1], base))
    table = JacobianBatch(*(torch.stack(c) for c in zip(*entries)))
    w = torch.arange(4 * scalars.shape[-1] - 1, -1, -1, device=dev)
    digits = ((scalars[:, w // 4] >> (4 * (w % 4))) & 0xF).T  # (windows, N), most significant first
    live = (digits != 0).any(1)
    lanes = torch.arange(n, device=dev)
    acc = jac_zero(f, (n,), dev)
    for d in digits[int(live.int().argmax()) if bool(live.any()) else digits.shape[0]:]:
        for _ in range(4):
            acc = jac_double(f, acc)
        acc = jac_add(f, acc, JacobianBatch(*(c[d, lanes] for c in table)))
    return acc


# ---------------------------------------------------------------------------
# lane-compacted forms for the MSM's plain versions (1-D batches): the same
# values as the masked forms, with the arithmetic only on the lanes that need
# it (each compaction is one host sync)
# ---------------------------------------------------------------------------

def take(p: JacobianBatch, idx: torch.Tensor) -> JacobianBatch:
    return JacobianBatch(p.x[idx], p.y[idx], p.z[idx])


def put(p: JacobianBatch, idx: torch.Tensor, q: JacobianBatch) -> JacobianBatch:
    """p with lanes idx replaced by q (a new batch; p is not changed)."""
    out = JacobianBatch(p.x.clone(), p.y.clone(), p.z.clone())
    for a, b in zip(out, q):
        a[idx] = b
    return out


def _lanes(mask: torch.Tensor) -> torch.Tensor:
    return mask.nonzero().squeeze(1)


def _with_doubling(f, p: JacobianBatch, s: JacobianBatch, is_dbl: torch.Tensor) -> JacobianBatch:
    idx = _lanes(is_dbl)
    return put(s, idx, jac_double(f, take(p, idx))) if idx.numel() else s


def jac_add_sparse(f, p: JacobianBatch, q: JacobianBatch) -> JacobianBatch:
    """jac_add, computed only on the lanes where both points are finite (the
    others take the finite one, or q, as jac_add does) and doubling only
    where P == Q: equal to jac_add limb for limb."""
    p_inf, q_inf = f.is_zero(p.z), f.is_zero(q.z)
    out = JacobianBatch(*(f.select(p_inf, b, a) for a, b in zip(p, q)))
    idx = _lanes(~p_inf & ~q_inf)
    if not idx.numel():
        return out
    pl, ql = take(p, idx), take(q, idx)
    s, eq_x, eq_y = _add_2007_bl(f, pl, ql)
    s = s._replace(z=f.select(eq_x & ~eq_y, torch.zeros_like(s.z), s.z))
    return put(out, idx, _with_doubling(f, pl, s, eq_x & eq_y))


def jac_madd(f, p: JacobianBatch, qx: torch.Tensor, qy: torch.Tensor) -> JacobianBatch:
    """P + Q for an affine Q (madd-2007-bl) with the exceptional cases of the
    JAX package's `pallas_msm.jac_madd`: P at infinity takes Q with z = 1,
    P == Q doubles, P == -Q gives z = 0 (x3, y3 as computed)."""
    p_inf = f.is_zero(p.z)
    z1z1, qypz = _muls(f, (p.z, p.z), (qy, p.z))
    u2, s2 = _muls(f, (qx, z1z1), (qypz, z1z1))
    eq_x, eq_y = f.eq(p.x, u2), f.eq(p.y, s2)
    h = f.sub(u2, p.x)
    r = f.double(f.sub(s2, p.y))
    zh = f.add(p.z, h)
    hh, rr, zh2 = _muls(f, (h, h), (r, r), (zh, zh))
    i = f.double(f.double(hh))
    j, v = _muls(f, (h, i), (p.x, i))
    x3 = f.sub(f.sub(rr, j), f.double(v))
    vr, yj = _muls(f, (f.sub(v, x3), r), (p.y, j))
    y3 = f.sub(vr, f.double(yj))
    z3 = f.sub(f.sub(zh2, z1z1), hh)
    z3 = f.select(eq_x & ~eq_y & ~p_inf, torch.zeros_like(z3), z3)
    s = _with_doubling(f, p, JacobianBatch(x3, y3, z3), eq_x & eq_y & ~p_inf)
    one = f.ones(p_inf.shape, p_inf.device)
    return JacobianBatch(f.select(p_inf, qx, s.x), f.select(p_inf, qy, s.y), f.select(p_inf, one, s.z))


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
