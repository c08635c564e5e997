"""Deterministic field/point sampling replaying ff_ce `Rand` semantics.

These routines must consume the ChaCha word stream in EXACTLY the reference's
order, because rejection sampling makes stream position part of the output:

* `Fr::rand` / `Fq::rand`: ff_ce derive - 4x next_u64 (limb 0 first), shave 2
  top bits, accept if < modulus; accepted 256-bit value is the MONTGOMERY form.
* `G1::rand` (pairing/src/bn256/ec.rs:711-726):
  loop { x = Fq::rand; greatest = bool::rand; get_point_from_x }.
* `G2::rand` (ec.rs:1091-1105): loop { x = Fq2::rand (c0 then c1);
  greatest = bool::rand; get_point_from_x } then multiply by the cofactor
  2q - r (ec.rs:1347-1357).
* `hash_to_g2` (powersoftau/src/utils.rs:31-45): ChaCha seeded
  with 8 BE u32s of a >=32-byte digest, then G2::rand.

The port's own copy of `phase2_bn254_tpu/refimpl/sampling.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

from ..crypto.chacha import ChaChaRng
from .field import Fq2, MONT_R, Q, R_MOD
from .curve import G2_COFACTOR, Point, get_point_from_x


def rand_fr(rng: ChaChaRng) -> int:
    """Canonical value of Fr::rand (Montgomery repr / R mod r)."""
    mont = rng.gen_fp_mont(R_MOD)
    return (mont * pow(MONT_R, -1, R_MOD)) % R_MOD


def rand_fq(rng: ChaChaRng) -> int:
    mont = rng.gen_fp_mont(Q)
    return (mont * pow(MONT_R, -1, Q)) % Q


def rand_g1(rng: ChaChaRng) -> Point:
    """G1::rand - returns a curve point (NOT cofactor-cleared; h = 1)."""
    while True:
        x = rand_fq(rng)
        greatest = rng.gen_bool()
        p = get_point_from_x(x, greatest, "g1")
        if p is not None and not p.is_zero():
            return p


def rand_g2(rng: ChaChaRng) -> Point:
    """G2::rand - random twist point scaled by cofactor 2q - r."""
    while True:
        c0 = rand_fq(rng)
        c1 = rand_fq(rng)
        greatest = rng.gen_bool()
        p = get_point_from_x(Fq2(c0, c1), greatest, "g2")
        if p is not None and not p.is_zero():
            return p.mul(G2_COFACTOR)


def hash_to_g2(digest: bytes) -> Point:
    """utils.rs:31-45: seed ChaCha from first 32 digest bytes (BE words)."""
    assert len(digest) >= 32
    return rand_g2(ChaChaRng.from_digest_be(digest))
