"""GLV scalar split for G1 on torch tensors (counterpart of
`phase2_bn254_tpu/ops/glv_device.py:311-460`), for BN254 (`BN_PLAN`, the
default) and for BLS12-381 (`bls12_381.device.GLV_PLAN`, the plan of
`bls12_381/glv.py`'s basis, which the JAX package's
`bls12_381/device.py:180-248` hands to the same functions).

k = k1 + k2 * LAMBDA (mod r) by Barrett-rounded lattice reduction:

    c1 ~ round(k * b2 / det), c2 ~ round(-k * b1 / det)
    k1 = k - c1 a1 - c2 a2,   k2 = -c1 b1 - c2 b2

in 16-bit digit arithmetic, mod 2^192 (two's complement; |ki| < 2^131).
The Barrett reciprocals make the same rounding as the JAX package, so the
digits agree exactly. Scalars are canonical on 16 digits for either curve
(both r < 2^255); the JAX package carries BLS12-381's on 17, whose top one
is zero, which changes no product below. Two outputs, each most significant
first:

* `decompose_signed` (K1): signed base-32 digits in [-16, 16], the sign of
  each k_i folded in (JAX `decompose_signed_device_t`);
* `decompose` (K7): 4-bit windows of |k1|, |k2| and one sign flag per k_i
  and lane (JAX `decompose_device_t`, glv_device.py:357-399).

Digits sit on the last axis here, (N, D); the outputs are (W, N) as in JAX.
"""

from __future__ import annotations

import torch

from ..field.fp import DTYPE, LIMB_BITS, MASK, _carry, int_to_limbs
from ..refimpl import glv as rglv
from ..refimpl.field import R_MOD

KDIG = 12  # two's-complement width of k1, k2 in digits (192 bits >> 2^131)
TDIG = 25  # Barrett shift in digits (400 bits)
# 4-bit windows of |k_i| (K7), the JAX `decompose_plan_t`'s count: 132 bits,
# a window above the 128 that |k_i| < GlvPlan's bound takes, so the digit
# rows equal JAX's row for row
WINDOWS4 = 33


def _ndigits(v: int) -> int:
    return max(1, (abs(v).bit_length() + LIMB_BITS - 1) // LIMB_BITS)


def barrett(mag: int, modulus: int) -> int:
    """round(mag * 2^(16 TDIG) / modulus)."""
    q, rem = divmod(mag << (LIMB_BITS * TDIG), modulus)
    return q + (1 if 2 * rem >= modulus else 0)


def mul_const(k: torch.Tensor, c: int, out_digits: int, round_bit: int | None = None) -> torch.Tensor:
    """(k * c [+ 2^round_bit]) mod 2^(16 out_digits) for k (N, nk) digits
    and a non-negative constant c."""
    cd = int_to_limbs(c, _ndigits(c))
    nk = k.shape[-1]
    t = torch.zeros((k.shape[0], max(nk + len(cd) + 1, out_digits)), dtype=DTYPE, device=k.device)
    for j, cj in enumerate(cd):
        if cj:
            t[:, j : j + nk] += k * cj
    if round_bit is not None:
        d, b = divmod(round_bit, LIMB_BITS)
        t[:, d] += 1 << b
    return _carry(t)[:, :out_digits]


def negate(t: torch.Tensor) -> torch.Tensor:
    """-t mod 2^(16 D) for canonical digits t, as non-negative digits that
    are not yet carried: (2^16 - 1 - t_j) per digit, plus 1."""
    out = MASK - t
    out[:, 0] += 1
    return out


def signed_sum(acc: torch.Tensor, terms) -> torch.Tensor:
    """acc - sum(sign * term) mod 2^(16 D), canonical digits."""
    for sign, term in terms:
        acc = acc + (negate(term) if sign > 0 else term)
    return _carry(acc)


def twos_complement_abs(v: torch.Tensor):
    """Two's-complement digits (N, D) -> (|v| digits, negative mask)."""
    neg = (v[:, -1] >> (LIMB_BITS - 1)) != 0
    return torch.where(neg[:, None], _carry(negate(v)), v), neg


def windows4(mag: torch.Tensor, nwin: int) -> torch.Tensor:
    """|v| digits (N, D) -> int64 (nwin, N) unsigned 4-bit windows, most
    significant first."""
    w = torch.arange(nwin - 1, -1, -1, device=mag.device)
    return ((mag[:, w // 4] >> (4 * (w % 4))).T & 0xF).contiguous()


def signed_windows5(mag: torch.Tensor, neg: torch.Tensor, nwin: int) -> torch.Tensor:
    """|v| digits (N, D) + sign -> int64 (nwin, N) signed base-32 digits in
    [-16, 15] MSB first, the sign folded in (so -16 may become +16)."""
    nd = mag.shape[-1]
    carry = torch.zeros_like(mag[:, 0])
    rows = []
    for w in range(nwin):
        d, s = divmod(5 * w, LIMB_BITS)
        v = mag[:, d] >> s
        if s > LIMB_BITS - 5 and d + 1 < nd:
            v = v | (mag[:, d + 1] << (LIMB_BITS - s))
        t = (v & 0x1F) + carry
        carry = (t >= 16).to(DTYPE)
        rows.append(t - (carry << 5))
    # the window count guarantees the final carry is zero (see GlvPlan)
    out = torch.stack(rows[::-1])
    return torch.where(neg[None], -out, out)


class GlvPlan:
    """Barrett decomposition constants of one curve, built from (r, short
    basis) as `glv_device.GlvPlan`."""

    def __init__(self, r_mod: int, a1: int, b1: int, a2: int, b2: int):
        det = a1 * b2 - a2 * b1
        assert abs(det) == r_mod
        sd = 1 if det > 0 else -1
        # W signed digits in [-16, 15] reach 15 (32^W - 1) / 31; |k_i| is at
        # most (|a1| + |a2|) / 2 plus one basis unit of Barrett slack
        bound = 3 * max(abs(a1) + abs(a2), abs(b1) + abs(b2)) // 2 + 2
        w = 1
        while 15 * ((1 << (5 * w)) - 1) // 31 < bound:
            w += 1
        self.windows5 = w
        self.m1 = barrett(abs(b2), r_mod)
        self.m2 = barrett(abs(b1), r_mod)
        s1 = (1 if b2 > 0 else -1) * sd
        s2 = -(1 if b1 > 0 else -1) * sd
        # k1 = k - e11 c1 |a1| - e12 c2 |a2|;  k2 = -e21 c1 |b1| - e22 c2 |b2|
        self.k1_terms = ((s1 * (1 if a1 > 0 else -1), abs(a1)), (s2 * (1 if a2 > 0 else -1), abs(a2)))
        self.k2_terms = ((s1 * (1 if b1 > 0 else -1), abs(b1)), (s2 * (1 if b2 > 0 else -1), abs(b2)))


BN_PLAN = GlvPlan(R_MOD, rglv._A1, rglv._B1, rglv._A2, rglv._B2)


def components(scalars: torch.Tensor, plan: GlvPlan = BN_PLAN):
    """Canonical Fr scalars int64 (N, 16) -> [(|k1| digits, k1 < 0), (|k2|
    digits, k2 < 0)], each magnitude (N, KDIG) (JAX glv_device.py:361-377)."""
    k = scalars
    round_bit = LIMB_BITS * TDIG - 1
    c1 = mul_const(k, plan.m1, KDIG + TDIG, round_bit)[:, TDIG:]
    c2 = mul_const(k, plan.m2, KDIG + TDIG, round_bit)[:, TDIG:]
    return [twos_complement_abs(signed_sum(acc, [(sign, mul_const(c, mag, KDIG))
                                                 for c, (sign, mag) in zip((c1, c2), terms)]))
            for acc, terms in ((k[:, :KDIG], plan.k1_terms), (torch.zeros_like(k[:, :KDIG]), plan.k2_terms))]


def decompose_signed(scalars: torch.Tensor, plan: GlvPlan = BN_PLAN):
    """Canonical Fr scalars int64 (N, 16) -> (d1, d2), each int64
    (plan.windows5, N) signed base-32 digits, MSB first (JAX
    `decompose_signed_device_t`, which takes the transposed (16, N))."""
    (m1, n1), (m2, n2) = components(scalars, plan)
    return signed_windows5(m1, n1, plan.windows5), signed_windows5(m2, n2, plan.windows5)


def decompose(scalars: torch.Tensor, plan: GlvPlan = BN_PLAN):
    """Canonical Fr scalars int64 (N, 16) -> (d1, d2, negs): d1, d2 int64
    (WINDOWS4, N) 4-bit windows of |k1|, |k2|, MSB first; negs int64
    (2, N), 1 where k_i < 0 (JAX `decompose_plan_t` / `decompose_device_t`)."""
    (m1, n1), (m2, n2) = components(scalars, plan)
    return windows4(m1, WINDOWS4), windows4(m2, WINDOWS4), torch.stack([n1, n2]).to(m1.dtype)
