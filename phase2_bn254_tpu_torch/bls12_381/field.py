"""Exact host-side BLS12-381 field arithmetic over Python integers.

Second engine of the framework (the reference ships BLS12-381 alongside BN256
even though the ceremony only uses BN256 - pairing/src/bls12_381/). This
module is the executable specification: parameters, tower structure and
canonical values follow the reference's `ff_ce`-derived fields
(pairing/src/bls12_381/fq.rs:447-448, fr.rs:4-5) and tower files (fq2.rs).
Device kernels added for this engine must agree with these functions
bit-for-bit at the serialization boundary.

Fq2 = Fq[u] / (u^2 + 1); its nonresidue xi = 1 + u (fq2.rs:40-41
`mul_by_nonresidue`).

The port's own copy of `phase2_bn254_tpu/bls12_381/field.py` up to the
curve coefficients, with Fq6, Fq12 and the Frobenius coefficients left out
until the pairing is ported (code otherwise unchanged); file:line citations
of `.rs` files are to the upstream Rust repository.
"""

from __future__ import annotations

# BLS12-381 base field modulus (381 bits)
# pairing/src/bls12_381/fq.rs:447
Q = 4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787
# BLS12-381 scalar field modulus (255 bits)
# pairing/src/bls12_381/fr.rs:4
R_MOD = 52435875175126190479447740508185965837690552500527637822603658699938581184513

# Montgomery radices: Fq uses 6 x u64 limbs (R = 2^384), Fr uses 4 x u64 (R = 2^256)
FQ_MONT_BITS = 384
FR_MONT_BITS = 256

# Multiplicative generators (PrimeFieldGenerator attributes)
FQ_GENERATOR = 2  # fq.rs:448
FR_GENERATOR = 7  # fr.rs:5

# Fr two-adicity: r - 1 = 2^32 * t => NTT domains up to 2^32
FR_S = 32
FR_T = (R_MOD - 1) >> FR_S
assert FR_T % 2 == 1
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, FR_T, R_MOD)

FQ_NUM_BITS = Q.bit_length()
FR_NUM_BITS = R_MOD.bit_length()
assert FQ_NUM_BITS == 381 and FR_NUM_BITS == 255
# 6*64 - 381 = 3 spare bits in the top byte => room for the three codec flags
FQ_REPR_SHAVE_BITS = 3
FR_REPR_SHAVE_BITS = 1

# BLS loop parameter x (negative): the curve family parameter
# pairing/src/bls12_381/mod.rs:26-27
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True
_X_SIGNED = -BLS_X
assert Q == ((_X_SIGNED - 1) ** 2 * (_X_SIGNED**4 - _X_SIGNED**2 + 1)) // 3 + _X_SIGNED
assert R_MOD == _X_SIGNED**4 - _X_SIGNED**2 + 1

# Cofactors (ec.rs:922-925 G1; ec.rs:1614-1630 G2)
G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB
G2_COFACTOR = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5
assert G1_COFACTOR == (_X_SIGNED - 1) ** 2 // 3


def to_mont_fq(x: int) -> int:
    return (x << FQ_MONT_BITS) % Q


def from_mont_fq(x: int) -> int:
    return (x * pow(1 << FQ_MONT_BITS, -1, Q)) % Q


def to_mont_fr(x: int) -> int:
    return (x << FR_MONT_BITS) % R_MOD


def from_mont_fr(x: int) -> int:
    return (x * pow(1 << FR_MONT_BITS, -1, R_MOD)) % R_MOD


def inv(x: int, p: int) -> int:
    if x % p == 0:
        raise ZeroDivisionError("field inverse of zero")
    return pow(x, -1, p)


def sqrt_fq(x: int) -> int | None:
    """Square root in Fq (q = 3 mod 4 => x^((q+1)/4)), or None."""
    assert Q % 4 == 3
    r = pow(x % Q, (Q + 1) // 4, Q)
    if (r * r) % Q != x % Q:
        return None
    return r


class Fq2:
    """Immutable Fq2 element (c0 + c1*u) over Python ints (canonical form).

    Identical structure to the BN254 Fq2 in refimpl/field.py, with the
    BLS12-381 modulus and nonresidue xi = 1 + u
    (pairing/src/bls12_381/fq2.rs:39-57).
    """

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        object.__setattr__(self, "c0", c0 % Q)
        object.__setattr__(self, "c1", c1 % Q)

    def __setattr__(self, *a):  # pragma: no cover
        raise AttributeError("immutable")

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
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
        return hash(("bls", self.c0, self.c1))

    def __repr__(self):
        return f"Fq2b({self.c0}, {self.c1})"

    def norm(self) -> int:
        return (self.c0 * self.c0 + self.c1 * self.c1) % Q

    def inverse(self) -> "Fq2":
        n = inv(self.norm(), Q)
        return Fq2(self.c0 * n, -self.c1 * n)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def frobenius(self, power: int) -> "Fq2":
        return self.conjugate() if power % 2 == 1 else self

    def mul_by_nonresidue(self) -> "Fq2":
        """Multiply by xi = 1 + u (fq2.rs:40-57)."""
        a0, a1 = self.c0, self.c1
        return Fq2(a0 - a1, a0 + a1)

    def pow(self, e: int) -> "Fq2":
        result = FQ2_ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    # ordering used by codecs ("lexicographically largest y"): c1 then c0
    # (fq2.rs:21-37, same convention as BN254)
    def gt(self, o: "Fq2") -> bool:
        if self.c1 != o.c1:
            return self.c1 > o.c1
        return self.c0 > o.c0

    def lt(self, o: "Fq2") -> bool:
        if self.c1 != o.c1:
            return self.c1 < o.c1
        return self.c0 < o.c0

    def sqrt(self) -> "Fq2 | None":
        """Square root (Algorithm 9, eprint 2012/685; q = 3 mod 4).

        Callers normalize the returned root with the `greatest` flag, so only
        existence and the +- pair are specified behavior.
        """
        if self.is_zero():
            return FQ2_ZERO
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
XI = Fq2(1, 1)

# Curve coefficients: G1 y^2 = x^3 + 4 (fq.rs:4-13); twist (M-type)
# y^2 = x^3 + 4(1+u) (ec.rs:1607-1612: Fq2 { c0: B_COEFF, c1: B_COEFF })
B_G1 = 4
B_G2 = Fq2(4, 4)

