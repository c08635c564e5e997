"""Exact host-side BN254 field arithmetic over Python integers.

This module is the executable *specification* for the TPU kernels: every
device kernel in ``phase2_bn254_tpu.field`` must agree with these functions
bit-for-bit at the serialization boundary.

Semantics follow the reference's `ff_ce`-derived fields
(pairing/src/bn256/fq.rs:4-7, fr.rs:3-6):

* Canonical representation ("repr") is the integer value in [0, p).
* Montgomery form with R = 2^256 is what `Fq(FqRepr([...]))` constants store;
  `from_repr` multiplies by R, `into_repr` divides by R.
* `Fq::rand` / `Fr::rand` (used by hash_to_g2 and keypair RNG consumption,
  powersoftau/src/utils.rs:31-45) interprets a masked random
  256-bit repr directly as the *Montgomery* limbs, i.e. the sampled field
  element has canonical value repr * R^{-1} mod p.

The port's own copy of `phase2_bn254_tpu/refimpl/field.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

# BN254 ("alt_bn128") base field modulus
# pairing/src/bn256/fq.rs:5
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# BN254 scalar field modulus
# pairing/src/bn256/fr.rs:4
R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Montgomery radix shared by Fq and Fr (4 x u64 limbs in the reference)
MONT_BITS = 256
MONT_R = 1 << MONT_BITS

# Multiplicative generators (PrimeFieldGenerator attributes)
FQ_GENERATOR = 2
FR_GENERATOR = 7

# Fr two-adicity: r - 1 = 2^28 * t  (fr.rs:32-34 asserts S == 28)
FR_S = 28
FR_T = (R_MOD - 1) >> FR_S
assert FR_T % 2 == 1

# 2^S-th primitive root of unity for Fr NTT domains: generator^t
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, FR_T, R_MOD)

# Number of bits in the modulus; both are 254 => REPR_SHAVE_BITS = 2
FQ_NUM_BITS = Q.bit_length()
FR_NUM_BITS = R_MOD.bit_length()
assert FQ_NUM_BITS == 254 and FR_NUM_BITS == 254
REPR_SHAVE_BITS = 2


def to_mont(x: int, p: int) -> int:
    """Canonical -> Montgomery form (ff_ce `from_repr`)."""
    return (x * MONT_R) % p


def from_mont(x: int, p: int) -> int:
    """Montgomery -> canonical (ff_ce `into_repr`)."""
    return (x * pow(MONT_R, -1, p)) % p


def inv(x: int, p: int) -> int:
    if x % p == 0:
        raise ZeroDivisionError("field inverse of zero")
    return pow(x, -1, p)


def legendre(x: int, p: int) -> int:
    """1 if QR, -1 if non-residue, 0 if zero."""
    if x % p == 0:
        return 0
    return 1 if pow(x, (p - 1) // 2, p) == 1 else -1


def sqrt_fq(x: int) -> int | None:
    """Square root in Fq (q = 3 mod 4 => x^((q+1)/4)), or None.

    The caller (point decompression, pairing/src/bn256/ec.rs:106-133)
    normalizes the root with the `greatest` flag, so only existence and the
    +-pair matter, not which root is returned.
    """
    assert Q % 4 == 3
    r = pow(x % Q, (Q + 1) // 4, Q)
    if (r * r) % Q != x % Q:
        return None
    return r


def sqrt_fr(x: int) -> int | None:
    """Tonelli-Shanks square root in Fr (S = 28)."""
    x %= R_MOD
    if x == 0:
        return 0
    if legendre(x, R_MOD) != 1:
        return None
    # Tonelli-Shanks
    z = pow(FR_GENERATOR, FR_T, R_MOD)  # generator of the 2-Sylow subgroup
    m, c, t, r = FR_S, z, pow(x, FR_T, R_MOD), pow(x, (FR_T + 1) // 2, R_MOD)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = (t2 * t2) % R_MOD
            i += 1
        b = pow(c, 1 << (m - i - 1), R_MOD)
        m, c = i, (b * b) % R_MOD
        t = (t * c) % R_MOD
        r = (r * b) % R_MOD
    return r


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1); nonresidue for the sextic twist is xi = 9 + u
# (pairing/src/bn256/fq2.rs:43-63)
# ---------------------------------------------------------------------------

class Fq2:
    """Immutable Fq2 element (c0 + c1*u) over Python ints (canonical form)."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        object.__setattr__(self, "c0", c0 % Q)
        object.__setattr__(self, "c1", c1 % Q)

    def __setattr__(self, *a):  # pragma: no cover
        raise AttributeError("immutable")

    # -- basic ring ops ----------------------------------------------------
    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        # (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fq2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    __rmul__ = __mul__

    def square(self) -> "Fq2":
        a0, a1 = self.c0, self.c1
        return Fq2(a0 * a0 - a1 * a1, 2 * a0 * a1)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"

    # -- field ops ---------------------------------------------------------
    def norm(self) -> int:
        """c0^2 + c1^2 (u^2 = -1), pairing/src/bn256/fq2.rs:87."""
        return (self.c0 * self.c0 + self.c1 * self.c1) % Q

    def inverse(self) -> "Fq2":
        n = inv(self.norm(), Q)
        return Fq2(self.c0 * n, -self.c1 * n)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def frobenius(self, power: int) -> "Fq2":
        """x -> x^(q^power); for Fq2 this is conjugation when power is odd."""
        return self.conjugate() if power % 2 == 1 else self

    def mul_by_nonresidue(self) -> "Fq2":
        """Multiply by xi = 9 + u (fq2.rs:43-63)."""
        a0, a1 = self.c0, self.c1
        return Fq2(9 * a0 - a1, a0 + 9 * a1)

    def pow(self, e: int) -> "Fq2":
        result = FQ2_ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    # -- ordering used by codecs ("lexicographically largest y") -----------
    def gt(self, o: "Fq2") -> bool:
        """Fq2 Ord: compare c1 first, then c0 (fq2.rs:21-30)."""
        if self.c1 != o.c1:
            return self.c1 > o.c1
        return self.c0 > o.c0

    def lt(self, o: "Fq2") -> bool:
        if self.c1 != o.c1:
            return self.c1 < o.c1
        return self.c0 < o.c0

    def sqrt(self) -> "Fq2 | None":
        """Square root per Algorithm 9 of eprint 2012/685 exactly as the
        reference implements it (fq2.rs:211-258). The specific returned root
        matters only through +- normalization done by callers."""
        if self.is_zero():
            return FQ2_ZERO
        # a1 = self^((q-3)/4)
        a1 = self.pow((Q - 3) // 4)
        alpha = a1.square() * self
        a0 = alpha.frobenius(1) * alpha
        neg1 = Fq2(Q - 1, 0)
        if a0 == neg1:
            return None
        if alpha == neg1:
            return a1 * self * Fq2(0, 1)
        b = (alpha + FQ2_ONE).pow((Q - 1) // 2)
        return a1 * self * b


FQ2_ZERO = Fq2(0, 0)
FQ2_ONE = Fq2(1, 0)

# Curve coefficients
# G1: y^2 = x^3 + 3 (fq.rs:11-16)
B_G1 = 3
# G2 (twist): y^2 = x^3 + 3/(9+u) (fq.rs:18-31)
B_G2 = Fq2(9, 1).inverse() * 3
