"""A check of the kernels' field code (csrc/fieldops.cu), not a port of a
TPU kernel: a b, a^2, a + b and a - b of Fq or Fr pairs, and the edge
operands it is held on.

The kernels' field arithmetic has two codes: inline PTX on the card
(field_ptx.cuh, which `ops._ptx` generates at build time) and C++ CIOS
where a host compiler builds csrc/ (the CPU tests). `field_ops` launches fieldops.cu on
a CUDA tensor; its plain version is `field/fp.py`, so holding the kernel
against it on the card compares the PTX, and the host tests compare the C++
path the same way.
"""

from __future__ import annotations

import torch

from ..field import fp
from . import _build

LAUNCHES = {"field_ops": 0}
FIELDS = {"fq": 0, "fr": 1}
CTXS = {"fq": fp.FQ_CTX, "fr": fp.FR_CTX}


def field_ops_plain(a: torch.Tensor, b: torch.Tensor, field: str) -> tuple:
    """(a b, a^2, a + b, a - b), Montgomery, int64 (N, 16) each."""
    ctx = CTXS[field]
    return fp.mont_mul(ctx, a, b), fp.mont_mul(ctx, a, a), fp.add(ctx, a, b), fp.sub(ctx, a, b)


def field_ops(a: torch.Tensor, b: torch.Tensor, field: str) -> tuple:
    """The same through csrc/fieldops.cu on a CUDA tensor (one launch); the
    plain version on a CPU one."""
    if not _build.on_card("field_ops", a):
        return field_ops_plain(a, b, field)
    n = a.shape[0]
    for name, t in (("a", a), ("b", b)):
        _build.check("field_ops", name, t, (n, 16), a.device)
    out = [torch.empty_like(a) for _ in range(4)]
    _build.launch("p2_field_ops", a.device, a, b, *out, n, FIELDS[field])
    LAUNCHES["field_ops"] += 1
    return tuple(out)


def edge_pairs(field: str, rng) -> list[tuple[int, int]]:
    """Operand pairs (Montgomery values in [0, p)) at the edges of the
    carry chains and of the final subtraction, `rng` a random.Random: every
    pair of 0, 1, 2, p - 1, p - 2, R mod p, R^2 mod p, (p - 1) / 2,
    (p + 1) / 2, p - 2^32 and the all-ones limbs 2^253 - 1, 2^224 - 1;
    pairs whose product is 0, 1, 2, p - 1, p - 2 (the CIOS sum before its
    subtraction just above p, or just below p or 2p); sums p - 1, p,
    p + 1; differences 0 and -1."""
    p = CTXS[field].p
    r = (1 << 256) % p
    single = [0, 1, 2, p - 1, p - 2, r, r * r % p, (p - 1) // 2, (p + 1) // 2, p - (1 << 32), (1 << 253) - 1,
              (1 << 224) - 1]
    pairs = [(x, y) for x in single for y in single]
    rinv = pow(1 << 256, -1, p)
    for c in (0, 1, 2, p - 1, p - 2):
        for _ in range(8):
            x = rng.randrange(1, p)
            # x y R^-1 == c
            pairs.append((x, c * pow(x * rinv, -1, p) % p))
    for _ in range(8):
        x = rng.randrange(2, p - 2)
        pairs += [(x, p - x), (x, p - x - 1), (x, p - x + 1), (x, x), (x, x + 1)]
    return pairs
