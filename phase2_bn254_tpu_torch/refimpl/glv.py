"""GLV endomorphism scalar decomposition for BN254 G1.

The curve has CM by sqrt(-3): phi(x, y) = (BETA*x, y) acts on the (prime-
order) group as multiplication by LAMBDA, a primitive cube root of unity
mod r. Scalars split as k = k1 + k2*LAMBDA with |k1|, |k2| ~ sqrt(r),
halving the doubling count of windowed ladders.

The reference has no GLV (plain wNAF, pairing/src/wnaf.rs); this is a pure
performance transform - multiplication results are identical points.

The port's own copy of `phase2_bn254_tpu/refimpl/glv.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

import math

from .field import Q, R_MOD

# verified eigenvalue pair: (BETA*x, y) == LAMBDA * (x, y) on the generator
LAMBDA = 4407920970296243842393367215006156084916469457145843978461
BETA = 2203960485148121921418603742825762020974279258880205651966

assert (LAMBDA * LAMBDA + LAMBDA + 1) % R_MOD == 0
assert (BETA * BETA + BETA + 1) % Q == 0


def derive_basis(r_mod: int, lam: int):
    """Short lattice basis for {(x, y): x + y*lam = 0 mod r_mod} via the
    half-extended Euclid (GLV01, Algorithm 3.74 in Guide to ECC). Shared
    with the BLS12-381 engine (bls12_381/glv.py)."""
    r0, r1 = r_mod, lam
    t0, t1 = 0, 1
    lim = math.isqrt(r_mod)
    seq = [(r0, t0), (r1, t1)]
    while r1 != 0:
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        t0, t1 = t1, t0 - q * t1
        seq.append((r1, t1))
    # first index with r < sqrt(r_mod)
    for i in range(len(seq)):
        if seq[i][0] < lim:
            (rl, tl) = seq[i]
            cands = [seq[i - 1], seq[i + 1] if i + 1 < len(seq) else seq[i - 1]]
            (ra, ta) = min(cands, key=lambda v: v[0] * v[0] + v[1] * v[1])
            # invariant: r_i = t_i * LAMBDA (mod r) => (r_i, -t_i) in lattice
            return (rl, -tl), (ra, -ta)
    raise AssertionError("no short vector found")


(_A1, _B1), (_A2, _B2) = derive_basis(R_MOD, LAMBDA)
_DET = _A1 * _B2 - _A2 * _B1
assert abs(_DET) == R_MOD, _DET

# decomposition bound: |ki| <= max(|a|,|b|) components + rounding slack
MAX_COMPONENT_BITS = max(abs(v).bit_length() for v in (_A1, _B1, _A2, _B2)) + 2


def decompose(k: int) -> tuple[int, int]:
    """k in [0, r) -> (k1, k2) with k1 + k2*LAMBDA = k (mod r), both short
    and possibly negative."""
    k %= R_MOD
    c1 = _round_div(k * _B2, _DET)
    c2 = _round_div(-k * _B1, _DET)
    k1 = k - c1 * _A1 - c2 * _A2
    k2 = -c1 * _B1 - c2 * _B2
    assert (k1 + k2 * LAMBDA - k) % R_MOD == 0
    assert abs(k1).bit_length() <= MAX_COMPONENT_BITS
    assert abs(k2).bit_length() <= MAX_COMPONENT_BITS
    return k1, k2


def _round_div(a: int, b: int) -> int:
    """Nearest-integer division (ties toward +inf, sign-safe)."""
    if b < 0:
        a, b = -a, -b
    q, rem = divmod(a, b)
    if 2 * rem >= b:
        q += 1
    return q
