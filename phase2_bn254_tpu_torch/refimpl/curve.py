"""Exact host-side BN254 G1/G2 group law + point codecs over Python ints.

Specification mirror of pairing/src/bn256/ec.rs: affine and
Jacobian-projective points, EFD dbl-2009-l / add-2007-bl formulas (ec.rs:301-454),
and the big-endian flag-bit codecs (ec.rs:763-946 for G1, ec.rs:1135-1330 for G2).

Group-law results are coordinate-unique in affine form, so the TPU kernels may
use different internal formulas; this module pins down *byte* behavior
(flag bits, orderings, infinity handling) and provides the slow golden path.

The port's own copy of `phase2_bn254_tpu/refimpl/curve.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from .field import (
    B_G1,
    B_G2,
    FQ2_ONE,
    FQ2_ZERO,
    Fq2,
    Q,
    R_MOD,
    inv,
    sqrt_fq,
)

Fel = Union[int, Fq2]

# G2 cofactor c = 2q - r (ec.rs:1347-1357)
G2_COFACTOR = 2 * Q - R_MOD


class _Ops:
    """Small adapter so one group-law implementation covers Fq and Fq2."""

    def __init__(self, is_fq2: bool):
        self.is_fq2 = is_fq2

    def add(self, a, b):
        return (a + b) % Q if not self.is_fq2 else a + b

    def sub(self, a, b):
        return (a - b) % Q if not self.is_fq2 else a - b

    def mul(self, a, b):
        return (a * b) % Q if not self.is_fq2 else a * b

    def sqr(self, a):
        return (a * a) % Q if not self.is_fq2 else a.square()

    def neg(self, a):
        return (-a) % Q if not self.is_fq2 else -a

    def is_zero(self, a):
        return a == 0 if not self.is_fq2 else a.is_zero()

    def zero(self):
        return 0 if not self.is_fq2 else FQ2_ZERO

    def one(self):
        return 1 if not self.is_fq2 else FQ2_ONE

    def inverse(self, a):
        return inv(a, Q) if not self.is_fq2 else a.inverse()

    def gt(self, a, b):
        """Lexicographic order on canonical repr (ff Ord; Fq2: c1 then c0)."""
        return a > b if not self.is_fq2 else a.gt(b)


_FQ_OPS = _Ops(False)
_FQ2_OPS = _Ops(True)


@dataclass(frozen=True)
class Point:
    """Affine point; infinity encoded as the `inf` flag (ec.rs:14-18)."""

    x: Fel
    y: Fel
    inf: bool
    group: str  # "g1" | "g2"

    # -- helpers -----------------------------------------------------------
    @property
    def ops(self) -> _Ops:
        return _FQ2_OPS if self.group == "g2" else _FQ_OPS

    @property
    def b(self) -> Fel:
        return B_G2 if self.group == "g2" else B_G1

    def is_zero(self) -> bool:
        return self.inf

    def __eq__(self, o) -> bool:
        if not isinstance(o, Point):
            return NotImplemented
        if self.inf or o.inf:
            return self.inf == o.inf
        return self.group == o.group and self.x == o.x and self.y == o.y

    def __hash__(self):
        return hash((self.group, self.inf, None if self.inf else (self.x, self.y)))

    def neg(self) -> "Point":
        if self.inf:
            return self
        return Point(self.x, self.ops.neg(self.y), False, self.group)

    def is_on_curve(self) -> bool:
        """ec.rs:133-148."""
        if self.inf:
            return True
        f = self.ops
        y2 = f.sqr(self.y)
        x3b = f.add(f.mul(f.sqr(self.x), self.x), self.b)
        return y2 == x3b

    # -- group law (via Jacobian round-trip; results are unique affine) ----
    def add(self, o: "Point") -> "Point":
        return jacobian_to_affine(jacobian_add(affine_to_jacobian(self), affine_to_jacobian(o)))

    def double(self) -> "Point":
        return jacobian_to_affine(jacobian_double(affine_to_jacobian(self)))

    def mul(self, k: int) -> "Point":
        """Double-and-add over all bits, MSB first (ec.rs:544-563 semantics)."""
        acc = jacobian_zero(self.group)
        me = affine_to_jacobian(self)
        if k > 0:
            for bit in bin(k)[2:]:
                acc = jacobian_double(acc)
                if bit == "1":
                    acc = jacobian_add(acc, me)
        return jacobian_to_affine(acc)


@dataclass(frozen=True)
class Jacobian:
    x: Fel
    y: Fel
    z: Fel
    group: str

    @property
    def ops(self) -> _Ops:
        return _FQ2_OPS if self.group == "g2" else _FQ_OPS

    def is_zero(self) -> bool:
        return self.ops.is_zero(self.z)


def point_zero(group: str) -> Point:
    f = _FQ2_OPS if group == "g2" else _FQ_OPS
    return Point(f.zero(), f.one(), True, group)


def jacobian_zero(group: str) -> Jacobian:
    f = _FQ2_OPS if group == "g2" else _FQ_OPS
    return Jacobian(f.zero(), f.one(), f.zero(), group)


def affine_to_jacobian(p: Point) -> Jacobian:
    if p.inf:
        return jacobian_zero(p.group)
    return Jacobian(p.x, p.y, p.ops.one(), p.group)


def jacobian_to_affine(p: Jacobian) -> Point:
    f = p.ops
    if p.is_zero():
        return point_zero(p.group)
    zi = f.inverse(p.z)
    zi2 = f.sqr(zi)
    x = f.mul(p.x, zi2)
    y = f.mul(p.y, f.mul(zi2, zi))
    return Point(x, y, False, p.group)


def jacobian_double(p: Jacobian) -> Jacobian:
    """dbl-2009-l (ec.rs:301-358)."""
    if p.is_zero():
        return p
    f = p.ops
    a = f.sqr(p.x)
    b = f.sqr(p.y)
    c = f.sqr(b)
    d = f.sub(f.sqr(f.add(p.x, b)), f.add(a, c))
    d = f.add(d, d)
    e = f.add(f.add(a, a), a)
    fv = f.sqr(e)
    z3 = f.mul(p.z, p.y)
    z3 = f.add(z3, z3)
    x3 = f.sub(fv, f.add(d, d))
    c8 = f.add(c, c)
    c8 = f.add(c8, c8)
    c8 = f.add(c8, c8)
    y3 = f.sub(f.mul(f.sub(d, x3), e), c8)
    return Jacobian(x3, y3, z3, p.group)


def jacobian_add(p: Jacobian, q: Jacobian) -> Jacobian:
    """add-2007-bl with the reference's branch structure (ec.rs:360-454)."""
    if p.is_zero():
        return q
    if q.is_zero():
        return p
    f = p.ops
    z1z1 = f.sqr(p.z)
    z2z2 = f.sqr(q.z)
    u1 = f.mul(p.x, z2z2)
    u2 = f.mul(q.x, z1z1)
    s1 = f.mul(f.mul(p.y, q.z), z2z2)
    s2 = f.mul(f.mul(q.y, p.z), z1z1)
    if u1 == u2:
        if s1 == s2:
            return jacobian_double(p)
        return jacobian_zero(p.group)
    h = f.sub(u2, u1)
    i = f.sqr(f.add(h, h))
    j = f.mul(h, i)
    r = f.sub(s2, s1)
    r = f.add(r, r)
    v = f.mul(u1, i)
    x3 = f.sub(f.sub(f.sqr(r), j), f.add(v, v))
    s1j = f.mul(s1, j)
    y3 = f.sub(f.mul(f.sub(v, x3), r), f.add(s1j, s1j))
    z3 = f.mul(f.sub(f.sub(f.sqr(f.add(p.z, q.z)), z1z1), z2z2), h)
    return Jacobian(x3, y3, z3, p.group)


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

G1_GEN = Point(1, 2, False, "g1")  # fq.rs:39-50
G2_GEN = Point(
    Fq2(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    Fq2(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
    False,
    "g2",
)  # fq.rs:60-83


def get_point_from_x(x: Fel, greatest: bool, group: str) -> Optional[Point]:
    """ec.rs:106-131: y = sqrt(x^3 + b), normalized so that the
    lexicographically-largest root is chosen iff `greatest`."""
    f = _FQ2_OPS if group == "g2" else _FQ_OPS
    b = B_G2 if group == "g2" else B_G1
    x3b = f.add(f.mul(f.sqr(x), x), b)
    if group == "g2":
        y = x3b.sqrt()
        if y is None:
            return None
    else:
        y = sqrt_fq(x3b)
        if y is None:
            return None
    negy = f.neg(y)
    # reference: y if (y < negy) ^ greatest else negy  (ec.rs:121-126)
    y_lt_negy = f.gt(negy, y)
    chosen = y if (y_lt_negy ^ greatest) else negy
    return Point(x, chosen, False, group)


# ---------------------------------------------------------------------------
# Codecs (exact byte behavior)
# ---------------------------------------------------------------------------

def _fq_to_be(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


def _fq_from_be(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    if v >= Q:
        raise ValueError("coordinate not in field")
    return v


def g1_to_uncompressed(p: Point) -> bytes:
    """64B BE x||y; infinity => bit6 of byte 0 set, rest zero (ec.rs:827-843)."""
    if p.inf:
        return bytes([0x40]) + bytes(63)
    return _fq_to_be(p.x) + _fq_to_be(p.y)


def g1_from_uncompressed(b: bytes, check: bool = True) -> Point:
    assert len(b) == 64
    if b[0] & 0x40:
        rest = bytes([b[0] & 0x3F]) + b[1:]
        if any(rest):
            raise ValueError("unexpected information in infinity encoding")
        return point_zero("g1")
    if b[0] & 0x80:
        raise ValueError("compression flag set on uncompressed point")
    x = _fq_from_be(b[:32])
    y = _fq_from_be(b[32:])
    p = Point(x, y, False, "g1")
    if check and not p.is_on_curve():
        raise ValueError("not on curve")
    return p


def g1_to_compressed(p: Point) -> bytes:
    """32B BE x; bit7 = y is lexicographically largest; bit6 = infinity
    (ec.rs:922-945)."""
    if p.inf:
        return bytes([0x40]) + bytes(31)
    out = bytearray(_fq_to_be(p.x))
    negy = (Q - p.y) % Q
    if p.y > negy:
        out[0] |= 0x80
    return bytes(out)


def g1_from_compressed(b: bytes) -> Point:
    assert len(b) == 32
    if b[0] & 0x40:
        rest = bytes([b[0] & 0x3F]) + b[1:]
        if any(rest):
            raise ValueError("unexpected information in infinity encoding")
        return point_zero("g1")
    greatest = bool(b[0] & 0x80)
    x = _fq_from_be(bytes([b[0] & 0x3F]) + b[1:])
    p = get_point_from_x(x, greatest, "g1")
    if p is None:
        raise ValueError("not on curve")
    return p


def g2_to_uncompressed(p: Point) -> bytes:
    """128B BE x.c1||x.c0||y.c1||y.c0 (ec.rs:1213-1228)."""
    if p.inf:
        return bytes([0x40]) + bytes(127)
    return (
        _fq_to_be(p.x.c1) + _fq_to_be(p.x.c0) + _fq_to_be(p.y.c1) + _fq_to_be(p.y.c0)
    )


def g2_from_uncompressed(b: bytes, check: bool = True) -> Point:
    assert len(b) == 128
    if b[0] & 0x80:
        raise ValueError("compression flag set on uncompressed point")
    if b[0] & 0x40:
        rest = bytes([b[0] & 0x3F]) + b[1:]
        if any(rest):
            raise ValueError("unexpected information in infinity encoding")
        return point_zero("g2")
    xc1 = _fq_from_be(bytes([b[0] & 0x3F]) + b[1:32])
    xc0 = _fq_from_be(b[32:64])
    yc1 = _fq_from_be(b[64:96])
    yc0 = _fq_from_be(b[96:128])
    p = Point(Fq2(xc0, xc1), Fq2(yc0, yc1), False, "g2")
    if check and not p.is_on_curve():
        raise ValueError("not on curve")
    return p


def g2_to_compressed(p: Point) -> bytes:
    """64B BE x.c1||x.c0 with flag bits (ec.rs:1315-1330)."""
    if p.inf:
        return bytes([0x40]) + bytes(63)
    out = bytearray(_fq_to_be(p.x.c1) + _fq_to_be(p.x.c0))
    negy = -p.y
    if p.y.gt(negy):
        out[0] |= 0x80
    return bytes(out)


def g2_from_compressed(b: bytes) -> Point:
    assert len(b) == 64
    if b[0] & 0x40:
        rest = bytes([b[0] & 0x3F]) + b[1:]
        if any(rest):
            raise ValueError("unexpected information in infinity encoding")
        return point_zero("g2")
    greatest = bool(b[0] & 0x80)
    xc1 = _fq_from_be(bytes([b[0] & 0x3F]) + b[1:32])
    xc0 = _fq_from_be(b[32:64])
    p = get_point_from_x(Fq2(xc0, xc1), greatest, "g2")
    if p is None:
        raise ValueError("not on curve")
    return p


def point_to_bytes(p: Point, compressed: bool) -> bytes:
    if p.group == "g1":
        return g1_to_compressed(p) if compressed else g1_to_uncompressed(p)
    return g2_to_compressed(p) if compressed else g2_to_uncompressed(p)


def point_from_bytes(b: bytes, group: str, compressed: bool, check: bool = True) -> Point:
    if group == "g1":
        return g1_from_compressed(b) if compressed else g1_from_uncompressed(b, check)
    return g2_from_compressed(b) if compressed else g2_from_uncompressed(b, check)
