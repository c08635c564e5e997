"""A check of the kernels' field code (csrc/fieldops.cu), not a port of a
TPU kernel: a b, a^2, a + b and a - b of Fq, Fr or Fq2 pairs (BN254, and
BLS12-381's Fq and Fq2: "bls_fq", "bls_fq2"), and the edge operands it is
held on.

The kernels' field arithmetic has two codes: inline PTX on the card
(field_ptx.cuh, which `ops._ptx` generates at build time) and C++ where a
host compiler builds csrc/ (the CPU tests). `field_ops` launches
fieldops.cu on a CUDA tensor; its plain version is `field/fp.py` (Fq2:
`field/fq2.py`), so holding the kernel against it on the card compares the
PTX, and the host tests compare the C++ path the same way. An Fq2 value is
a pair (c0, c1) of Montgomery integers, its limbs (N, 2, n); n = 16 (BN254)
or 24 (BLS12-381).
"""

from __future__ import annotations

import torch

from .. import convert
from ..field import fp
from ..field.fq2 import BLS_FQ2, FQ2
from . import _build

LAUNCHES = {"field_ops": 0}
FIELDS = {"fq": 0, "fr": 1, "fq2": 2, "bls_fq": 3, "bls_fq2": 4}
# the context of each field (an Fq2's: that of its components)
CTXS = {"fq": fp.FQ_CTX, "fr": fp.FR_CTX, "fq2": fp.FQ_CTX, "bls_fq": fp.BLS_FQ_CTX, "bls_fq2": fp.BLS_FQ_CTX}
FQ2_OPS = {"fq2": FQ2, "bls_fq2": BLS_FQ2}


def is_fq2(field: str) -> bool:
    return field in FQ2_OPS


def to_limbs(values: list, field: str, device) -> torch.Tensor:
    """Montgomery values (ints; Fq2: (c0, c1) pairs) -> int64 (N, n) or
    (N, 2, n) limbs."""
    n = CTXS[field].nlimbs
    if not is_fq2(field):
        return convert.ints_to_limbs(values, device, n)
    return convert.ints_to_limbs([c for v in values for c in v], device, n).reshape(len(values), 2, n)


def random_element(field: str, rng):
    """A uniform Montgomery value of the field (Fq2: a pair)."""
    p = CTXS[field].p
    return (rng.randrange(p), rng.randrange(p)) if is_fq2(field) else rng.randrange(p)


def field_ops_plain(a: torch.Tensor, b: torch.Tensor, field: str) -> tuple:
    """(a b, a^2, a + b, a - b), Montgomery, int64 (N, n) each ((N, 2, n)
    for Fq2)."""
    if is_fq2(field):
        f = FQ2_OPS[field]
        return f.mul(a, b), f.sqr(a), f.add(a, b), f.sub(a, b)
    ctx = CTXS[field]
    return fp.mont_mul(ctx, a, b), fp.mont_mul(ctx, a, a), fp.add(ctx, a, b), fp.sub(ctx, a, b)


def field_ops(a: torch.Tensor, b: torch.Tensor, field: str) -> tuple:
    """The same through csrc/fieldops.cu on a CUDA tensor (one launch); the
    plain version on a CPU one."""
    if not _build.on_card("field_ops", a):
        return field_ops_plain(a, b, field)
    shape = (a.shape[0], *((2,) if is_fq2(field) else ()), CTXS[field].nlimbs)
    for name, t in (("a", a), ("b", b)):
        _build.check("field_ops", name, t, shape, a.device)
    out = [torch.empty_like(a) for _ in range(4)]
    _build.launch("p2_field_ops", a.device, a, b, *out, shape[0], FIELDS[field])
    LAUNCHES["field_ops"] += 1
    return tuple(out)


def edge_pairs(field: str, rng) -> list[tuple]:
    """Operand pairs (Montgomery values in [0, p)) at the edges of the
    carry chains and of the final subtraction, `rng` a random.Random (Fq2:
    `edge_pairs_fq2`): every
    pair of 0, 1, 2, p - 1, p - 2, R mod p, R^2 mod p, (p - 1) / 2,
    (p + 1) / 2, p - 2^32 and the all-ones limbs below p's top bit and
    below its top 32-bit limb (BN254: 2^253 - 1, 2^224 - 1; BLS12-381:
    2^380 - 1, 2^352 - 1); pairs whose product is 0, 1, 2, p - 1, p - 2
    (the CIOS sum before its subtraction just above p, or just below p or
    2p); sums p - 1, p, p + 1; differences 0 and -1."""
    ctx = CTXS[field]
    p, r, top = ctx.p, ctx.r, 32 * (-(-ctx.p.bit_length() // 32) - 1)
    single = [0, 1, 2, p - 1, p - 2, r, r * r % p, (p - 1) // 2, (p + 1) // 2, p - (1 << 32),
              (1 << (p.bit_length() - 1)) - 1, (1 << top) - 1]
    pairs = [(x, y) for x in single for y in single]
    rinv = ctx.rinv
    for c in (0, 1, 2, p - 1, p - 2):
        for _ in range(8):
            x = rng.randrange(1, p)
            # x y R^-1 == c
            pairs.append((x, c * pow(x * rinv, -1, p) % p))
    for _ in range(8):
        x = rng.randrange(2, p - 2)
        pairs += [(x, p - x), (x, p - x - 1), (x, p - x + 1), (x, x), (x, x + 1)]
    return pairs


def edge_pairs_fq2(rng, field: str = "fq2") -> list[tuple]:
    """Fq2 operand pairs ((a0, a1), (b0, b1)) at the edges of the fused
    product and square (ops/_ptx.py): every pair of the elements with
    components 0, 1, p - 1 and R mod p; a0 + a1 >= p (p, p + 1, 2p - 2);
    a0 b0 < a1 b1 as integers (c0 needs its p^2); products whose c0, c1 or
    both land on 0, 1 or p - 1 (Montgomery values); squares with c0 = 0 (a1
    = +-a0) or c1 = 0; then random pairs. `field` "fq2" (BN254) or
    "bls_fq2"."""
    if field == "fq2":
        from ..refimpl.field import Fq2
    else:
        from ..bls12_381.field import Fq2

    ctx = CTXS[field]
    p, r = ctx.p, ctx.r
    comps = [0, 1, p - 1, r]
    elems = [(x, y) for x in comps for y in comps]
    pairs = [(x, y) for x in elems for y in elems]
    for _ in range(6):
        x = rng.randrange(2, p - 1)
        big = rng.randrange(p // 2, p)
        pairs += [((x, p - x), (x, p - x + 1)), ((p - 1, p - 1), (x, p + 1 - x)),
                  ((rng.randrange(1 << 64), big), (rng.randrange(1 << 64), rng.randrange(p // 2, p))),
                  ((x, x), (x, p - x)), ((x, 0), (0, x)), ((big, p - big), (big, big))]
    rinv = ctx.rinv

    def real(v):
        return Fq2(v[0] * rinv % p, v[1] * rinv % p)

    for target in ((0, 0), (0, 1), (1, 0), (p - 1, 0), (0, p - 1), (p - 1, p - 1), (1, p - 1)):
        for _ in range(4):
            a = (rng.randrange(1, p), rng.randrange(p))
            b = real(target) * real(a).inverse()  # a b R^-1 == target, componentwise Montgomery
            pairs.append((a, (b.c0 * r % p, b.c1 * r % p)))
    return pairs
