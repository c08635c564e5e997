"""Montgomery prime-field arithmetic on torch tensors (counterpart of
`phase2_bn254_tpu/field/fp.py`).

A field element is n little-endian 16-bit limbs in an int64 tensor of shape
(..., n), in Montgomery form with R = 2^(16 n): n = 16 (R = 2^256) for BN254's
Fq and Fr, n = 24 (R = 2^384) for BLS12-381's Fq, each context's own count
(`FpContext.nlimbs`), as in the JAX package. The limb values are those of the
JAX package's uint32 arrays, so the two compare element for element. int64
holds every 16x16-bit product and every column sum of a product (< 2^56)
exactly;
torch has no uint32 add, shift or compare on the CPU. Each op is a fixed,
short sequence of whole-tensor ops (no per-digit loops): on the card every
tensor op is a kernel launch and a pass over memory.

Every op is a plain function of its tensors and runs on their device. The
single inversion of `batch_inv` (the Montgomery trick's product total) runs
on the host with Python integers; the prefix and suffix products stay on the
device.
"""

from __future__ import annotations

import functools

import torch

from ..bls12_381.field import Q as BLS_Q
from ..refimpl.field import Q, R_MOD

NLIMBS = 16  # the default limb count (BN254)
LIMB_BITS = 16
MASK = 0xFFFF
DTYPE = torch.int64


def int_to_limbs(v: int, nlimbs: int = NLIMBS) -> list[int]:
    """Python int -> little-endian 16-bit limbs."""
    return [(v >> (LIMB_BITS * i)) & MASK for i in range(nlimbs)]


def limbs_to_int(limbs) -> int:
    """One element's limbs (tensor or sequence) -> Python int."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.reshape(-1).tolist()
    return sum(int(d) << (LIMB_BITS * i) for i, d in enumerate(limbs))


class FpContext:
    """Constants of one prime field on `nlimbs` 16-bit limbs (R = 2^(16
    nlimbs), two spare bits above p, as the JAX package's FpContext); caches
    their limb tensors per device."""

    def __init__(self, p: int, name: str, nlimbs: int = NLIMBS):
        assert p % 2 == 1 and p.bit_length() <= LIMB_BITS * nlimbs - 2
        self.p = p
        self.name = name
        self.nlimbs = nlimbs
        self.mont_bits = LIMB_BITS * nlimbs
        self.r = (1 << self.mont_bits) % p
        self.r2 = pow(1 << self.mont_bits, 2, p)
        self.rinv = pow(1 << self.mont_bits, -1, p)
        self.pprime_full = (-pow(p, -1, 1 << self.mont_bits)) % (1 << self.mont_bits)  # -p^-1 mod R
        self._cache: dict[tuple[int, torch.device], torch.Tensor] = {}

    def to_mont_int(self, v: int) -> int:
        return (v * self.r) % self.p

    def from_mont_int(self, v: int) -> int:
        return (v * self.rinv) % self.p

    def limbs(self, v: int, device) -> torch.Tensor:
        """int64[nlimbs] limbs of the integer v (no Montgomery conversion), cached."""
        device = torch.device(device)
        key = (v, device)
        t = self._cache.get(key)
        if t is None:
            t = torch.tensor(int_to_limbs(v, self.nlimbs), dtype=DTYPE, device=device)
            self._cache[key] = t
        return t

    def const(self, v: int, device) -> torch.Tensor:
        """int64[nlimbs] Montgomery limbs of the field element v."""
        return self.limbs(self.to_mont_int(v % self.p), device)

    def zeros(self, batch_shape, device) -> torch.Tensor:
        return torch.zeros((*batch_shape, self.nlimbs), dtype=DTYPE, device=device)

    def ones_mont(self, batch_shape, device) -> torch.Tensor:
        return self.limbs(self.r, device).expand(*batch_shape, self.nlimbs).clone()


FQ_CTX = FpContext(Q, "fq")
FR_CTX = FpContext(R_MOD, "fr")
# BLS12-381's base field: 24 limbs, R = 2^384 (JAX bls12_381/device.py CTX_BLS_FQ)
BLS_FQ_CTX = FpContext(BLS_Q, "bls_fq", nlimbs=24)


# ---------------------------------------------------------------------------
# digit helpers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pow2(n: int, device: torch.device) -> torch.Tensor:
    return torch.ones(n, dtype=DTYPE, device=device) << torch.arange(n, device=device)


def _carry(t: torch.Tensor, passes: int = 4) -> torch.Tensor:
    """Non-negative digits (< 2^62, at most 62 of them) -> canonical 16-bit
    digits of the value mod 2^(16*n), in a fixed number of tensor ops.

    Four partial passes leave every digit <= 2^16 (one pass does for digits
    < 2^31: then a digit >= 2^16 has at most 2^15 in its low bits). The
    remaining carries are 0 or 1: digit 2^16 + k generates one, digit
    2^16 - 1 propagates one. With the generate and propagate bits packed
    into integers G and P, the carry into each digit is bit j of
    ((G | P) + G) ^ (G | P) ^ G (a binary adder whose operands have those
    generate and propagate bits)."""
    t = t.clone()
    for _ in range(passes):
        c = t >> LIMB_BITS
        t &= MASK
        t[..., 1:] += c[..., :-1]
    pow2 = _pow2(t.shape[-1], t.device)
    g = ((t >> LIMB_BITS) * pow2).sum(-1)
    p = ((t == MASK) * pow2).sum(-1)
    a = g | p
    carries = ((a + g) ^ a ^ g)[..., None] & pow2
    return (t + (carries != 0)) & MASK


def _mul_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column sums of the digit product: out[..., k] = sum_{i+j=k} a_i b_j,
    2n columns. Row i of the outer product is shifted right by i by reading
    the zero-padded rows (length 2n) with a row length of 2n - 1."""
    n = a.shape[-1]
    prod = torch.nn.functional.pad(a[..., :, None] * b[..., None, :], (0, n))
    lead = prod.shape[:-2]
    skew = prod.reshape(*lead, 2 * n * n)[..., : n * (2 * n - 1)].reshape(*lead, n, 2 * n - 1)
    return torch.nn.functional.pad(skew.sum(-2), (0, 1))


def _ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b on canonical digits: the sign of the most significant nonzero
    digit difference decides, read off as the sign of sum_j sign(d_j) 2^j."""
    return (torch.sign(a - b) * _pow2(a.shape[-1], a.device)).sum(-1) >= 0


def _pick_carried(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Carries digits u and v (< 2^31 each, as non-negative n-digit
    numbers) in one pass over both; returns v mod 2^(16 n) where v >= 2^(16
    n), else u mod 2^(16 n)."""
    n = u.shape[-1]
    both = _carry(torch.nn.functional.pad(torch.stack([u, v]), (0, 1)), passes=1)
    return torch.where(both[1, ..., n:] != 0, both[1, ..., :n], both[0, ..., :n])


def _sub_p_if_ge(ctx: FpContext, a: torch.Tensor) -> torch.Tensor:
    """a - p if a >= p, for canonical digits a < R: a + R - p reaches R
    exactly when a >= p."""
    return _pick_carried(a, a + ctx.limbs((1 << ctx.mont_bits) - ctx.p, a.device))


# ---------------------------------------------------------------------------
# field ops
# ---------------------------------------------------------------------------

def mont_mul(ctx: FpContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p for reduced Montgomery inputs (REDC on the whole
    product: m = (T mod R) (-p^-1) mod R, result (T + m p) / R < 2p)."""
    n = ctx.nlimbs
    a, b = torch.broadcast_tensors(a, b)
    t = _mul_columns(a, b)  # columns < 2^37 (24 limbs)
    # T mod R is the value of the low columns mod R, carried or not
    m = _carry(_mul_columns(t[..., :n], ctx.limbs(ctx.pprime_full, a.device).expand_as(a))[..., :n])
    u = _carry(t + _mul_columns(m, ctx.limbs(ctx.p, a.device).expand_as(a)))
    return _sub_p_if_ge(ctx, u[..., n:])


def add(ctx: FpContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b - p if a + b >= p (a + b + R - p reaches R), else a + b."""
    s = a + b
    return _pick_carried(s, s + ctx.limbs((1 << ctx.mont_bits) - ctx.p, a.device))


def sub(ctx: FpContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b if a >= b, else a - b + p: d = a + (R - b) reaches R exactly
    when a >= b, and then d mod R = a - b; else d + p does."""
    d = a + (MASK - b) + ctx.limbs(1, a.device)
    return _pick_carried(d + ctx.limbs(ctx.p, a.device), d)


def neg(ctx: FpContext, a: torch.Tensor) -> torch.Tensor:
    return sub(ctx, torch.zeros_like(a), a)


def int_minus(v: int, a: torch.Tensor) -> torch.Tensor:
    """v - a for canonical digits a <= v < 2^(16 n), n = a's digit count:
    v + (2^(16 n) - a) carried mod 2^(16 n)."""
    n = a.shape[-1]
    vl = torch.tensor(int_to_limbs(v, n), dtype=DTYPE, device=a.device)
    return _carry(vl + (MASK - a) + torch.tensor(int_to_limbs(1, n), dtype=DTYPE, device=a.device))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


def gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a > b on canonical digits."""
    return ~_ge(b, a)


def to_mont(ctx: FpContext, a: torch.Tensor) -> torch.Tensor:
    """Canonical digits -> Montgomery form (multiply by R^2)."""
    return mont_mul(ctx, a, ctx.limbs(ctx.r2, a.device))


def from_mont(ctx: FpContext, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical digits (multiply by integer 1)."""
    return mont_mul(ctx, a, ctx.limbs(1, a.device))


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], a, b)


def pow_fixed(ctx: FpContext, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a public exponent e >= 0 (square-and-multiply, least
    significant bit first); Montgomery in and out (JAX `fp.pow_fixed`)."""
    def mul(u, v):
        return mont_mul(ctx, u, v)

    return square_multiply(mul, lambda u: mul(u, u), ctx.ones_mont(a.shape[:-1], a.device), a, e)


def square_multiply(mul, sqr, one: torch.Tensor, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e by square-and-multiply over the bits of e, least significant
    first, in the field of `mul` / `sqr`; `one` is returned for e == 0."""
    res, base = None, a
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            res = base if res is None else mul(res, base)
        if i + 1 < e.bit_length():
            base = sqr(base)
    return one if res is None else res


def _inclusive_scan(ctx: FpContext, x: torch.Tensor) -> torch.Tensor:
    """Running Montgomery product along axis 0 in log2(n) steps."""
    x = x.clone()
    step = 1
    while step < x.shape[0]:
        x[step:] = mont_mul(ctx, x[step:], x[:-step])
        step <<= 1
    return x


def batch_inv_start(ctx: FpContext, a: torch.Tensor):
    """Device half of the Montgomery trick over axis 0: returns (partial,
    total, zero) with partial[i] the product of every nonzero element but
    a[i], total the product of all nonzero elements, zero the zero mask."""
    zero = is_zero(a)
    one = ctx.ones_mont(a.shape[1:-1], a.device)
    safe = select(zero, one.expand_as(a), a)
    prefix = _inclusive_scan(ctx, safe)
    suffix = _inclusive_scan(ctx, safe.flip(0)).flip(0)
    pre = torch.cat([one[None], prefix[:-1]], dim=0)
    suf = torch.cat([suffix[1:], one[None]], dim=0)
    return mont_mul(ctx, pre, suf), prefix[-1], zero


def invert_total(ctx: FpContext, total_mont: int) -> int:
    """Host inverse of one Montgomery element: (T R)^-1 R^2 = T^-1 R."""
    return pow(total_mont, ctx.p - 2, ctx.p) * ctx.r2 % ctx.p


def batch_inv_finish(ctx: FpContext, partial, tinv_mont: int, zero) -> torch.Tensor:
    from ..convert import to_device  # convert imports this module

    # a one-off operand: not cached, and uploaded without waiting for the stream
    tinv = to_device(torch.tensor(int_to_limbs(tinv_mont, ctx.nlimbs), dtype=DTYPE), partial.device)
    out = mont_mul(ctx, partial, tinv)
    return select(zero, torch.zeros_like(out), out)


def batch_inv(ctx: FpContext, a: torch.Tensor) -> torch.Tensor:
    """Batched inverse over axis 0; zeros map to zero (as fp.py:350-373)."""
    partial, total, zero = batch_inv_start(ctx, a)
    tinv = invert_total(ctx, limbs_to_int(total))
    return batch_inv_finish(ctx, partial, tinv, zero)
