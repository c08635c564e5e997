"""Exact host-side BLS12-381 G1/G2 group law + point codecs.

Specification mirror of pairing/src/bls12_381/ec.rs: same
curve_impl! group law as BN254 (dbl-2009-l / add-2007-bl) but with the
zcash serialization conventions, which differ from BN254's:

* sizes: G1 = 96B uncompressed / 48B compressed; G2 = 192B / 96B
* three flag bits in the top byte (q is 381 bits, 3 spare bits):
  bit7 = compressed-form distinguisher (set iff compressed),
  bit6 = point at infinity,
  bit5 = y is lexicographically largest (compressed only)
  (ec.rs:684-930 G1, ec.rs:1380-1600 G2)
* decoding performs subgroup membership checks (there are no cofactor-1
  groups on this curve; cf. ec.rs:836-843 `into_affine`)
* G2 coordinates serialize c1 before c0 (ec.rs:1413-1424,1458-1461)

The group-law helpers mirror refimpl/curve.py (BN254); results are unique
affine coordinates so the two engines share test scaffolding.

The port's own copy of `phase2_bn254_tpu/bls12_381/curve.py` (code
unchanged); file:line citations of `.rs` files are to the upstream Rust
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
    G1_COFACTOR,
    G2_COFACTOR,
    Q,
    R_MOD,
    inv,
    sqrt_fq,
)

Fel = Union[int, Fq2]


class _Ops:
    """Field-op adapter so one group law covers Fq and Fq2 (BLS modulus)."""

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
        return a > b if not self.is_fq2 else a.gt(b)


_FQ_OPS = _Ops(False)
_FQ2_OPS = _Ops(True)


@dataclass(frozen=True)
class Point:
    """Affine point; infinity encoded as the `inf` flag."""

    x: Fel
    y: Fel
    inf: bool
    group: str  # "g1" | "g2"

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
        return hash(("bls", self.group, self.inf, None if self.inf else (self.x, self.y)))

    def neg(self) -> "Point":
        if self.inf:
            return self
        return Point(self.x, self.ops.neg(self.y), False, self.group)

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        f = self.ops
        y2 = f.sqr(self.y)
        x3b = f.add(f.mul(f.sqr(self.x), self.x), self.b)
        return y2 == x3b

    def in_subgroup(self) -> bool:
        """is_in_correct_subgroup_assuming_on_curve: r*P == 0 (ec.rs:170-178)."""
        return self.mul(R_MOD).is_zero()

    def scale_by_cofactor(self) -> "Point":
        """ec.rs:922-925 (G1), ec.rs:1614-1630 (G2)."""
        return self.mul(G2_COFACTOR if self.group == "g2" else G1_COFACTOR)

    def add(self, o: "Point") -> "Point":
        return jacobian_to_affine(
            jacobian_add(affine_to_jacobian(self), affine_to_jacobian(o))
        )

    def double(self) -> "Point":
        return jacobian_to_affine(jacobian_double(affine_to_jacobian(self)))

    def mul(self, k: int) -> "Point":
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
    """dbl-2009-l, identical formula set to the BN254 engine."""
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
    """add-2007-bl with the reference's branch structure."""
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
# Generators (fq.rs:21-72; decimal values from the in-tree comments)
# ---------------------------------------------------------------------------

G1_GEN = Point(
    3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
    1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
    False,
    "g1",
)
G2_GEN = Point(
    Fq2(
        352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
        3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758,
    ),
    Fq2(
        1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
        927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582,
    ),
    False,
    "g2",
)


def get_point_from_x(x: Fel, greatest: bool, group: str) -> Optional[Point]:
    """ec.rs:101-122: y = sqrt(x^3 + b); largest root iff `greatest`."""
    f = _FQ2_OPS if group == "g2" else _FQ_OPS
    b = B_G2 if group == "g2" else B_G1
    x3b = f.add(f.mul(f.sqr(x), x), b)
    if group == "g2":
        y = x3b.sqrt()
    else:
        y = sqrt_fq(x3b)
    if y is None:
        return None
    negy = f.neg(y)
    y_lt_negy = f.gt(negy, y)
    chosen = y if (y_lt_negy ^ greatest) else negy
    return Point(x, chosen, False, group)


# ---------------------------------------------------------------------------
# Codecs — zcash flag-bit conventions
# ---------------------------------------------------------------------------

FQ_BYTES = 48


def _fq_to_be(v: int) -> bytes:
    return int(v).to_bytes(FQ_BYTES, "big")


def _fq_from_be(b: bytes, what: str) -> int:
    v = int.from_bytes(b, "big")
    if v >= Q:
        raise ValueError(f"{what} coordinate not in field")
    return v


def _check_decoded(p: Point, check: bool, subgroup: bool) -> Point:
    if check and not p.inf:
        if not p.is_on_curve():
            raise ValueError("point not on curve")
        if subgroup and not p.in_subgroup():
            raise ValueError("point not in the r-order subgroup")
    return p


def g1_to_uncompressed(p: Point) -> bytes:
    """96B BE x||y; infinity => bit6 set, rest zero (ec.rs:735-751)."""
    if p.inf:
        return bytes([0x40]) + bytes(95)
    return _fq_to_be(p.x) + _fq_to_be(p.y)


def g1_from_uncompressed(b: bytes, check: bool = True, subgroup: bool = True) -> Point:
    """ec.rs:684-734 into_affine_unchecked + into_affine checks."""
    assert len(b) == 96
    if b[0] & 0x80:
        raise ValueError("compressed bit set on uncompressed encoding")
    if b[0] & 0x40:
        if (b[0] & 0x3F) or any(b[1:]):
            raise ValueError("malformed infinity encoding")
        return point_zero("g1")
    if b[0] & 0x20:
        raise ValueError("sort bit set on uncompressed encoding")
    x = _fq_from_be(bytes([b[0] & 0x1F]) + b[1:48], "x")
    y = _fq_from_be(b[48:96], "y")
    return _check_decoded(Point(x, y, False, "g1"), check, subgroup)


def g1_to_compressed(p: Point) -> bytes:
    """48B BE x with bit7 set; bit5 = y lexicographically largest (ec.rs:888-917)."""
    if p.inf:
        return bytes([0x80 | 0x40]) + bytes(47)
    out = bytearray(_fq_to_be(p.x))
    if p.y > (Q - p.y) % Q:
        out[0] |= 0x20
    out[0] |= 0x80
    return bytes(out)


def g1_from_compressed(b: bytes, check: bool = True) -> Point:
    """ec.rs:846-887; decompression guarantees on-curve, then subgroup check."""
    assert len(b) == 48
    if not (b[0] & 0x80):
        raise ValueError("compressed bit not set")
    if b[0] & 0x40:
        if (b[0] & 0x3F) or any(b[1:]):
            raise ValueError("malformed infinity encoding")
        return point_zero("g1")
    greatest = bool(b[0] & 0x20)
    x = _fq_from_be(bytes([b[0] & 0x1F]) + b[1:48], "x")
    p = get_point_from_x(x, greatest, "g1")
    if p is None:
        raise ValueError("x not on curve")
    if check and not p.in_subgroup():
        raise ValueError("point not in the r-order subgroup")
    return p


def g2_to_uncompressed(p: Point) -> bytes:
    """192B BE x.c1||x.c0||y.c1||y.c0 (ec.rs:1447-1462)."""
    if p.inf:
        return bytes([0x40]) + bytes(191)
    return (
        _fq_to_be(p.x.c1)
        + _fq_to_be(p.x.c0)
        + _fq_to_be(p.y.c1)
        + _fq_to_be(p.y.c0)
    )


def g2_from_uncompressed(b: bytes, check: bool = True, subgroup: bool = True) -> Point:
    assert len(b) == 192
    if b[0] & 0x80:
        raise ValueError("compressed bit set on uncompressed encoding")
    if b[0] & 0x40:
        if (b[0] & 0x3F) or any(b[1:]):
            raise ValueError("malformed infinity encoding")
        return point_zero("g2")
    if b[0] & 0x20:
        raise ValueError("sort bit set on uncompressed encoding")
    x_c1 = _fq_from_be(bytes([b[0] & 0x1F]) + b[1:48], "x c1")
    x_c0 = _fq_from_be(b[48:96], "x c0")
    y_c1 = _fq_from_be(b[96:144], "y c1")
    y_c0 = _fq_from_be(b[144:192], "y c0")
    p = Point(Fq2(x_c0, x_c1), Fq2(y_c0, y_c1), False, "g2")
    return _check_decoded(p, check, subgroup)


def g2_to_compressed(p: Point) -> bytes:
    """96B BE x.c1||x.c0 with flags; bit5 = y lex-largest via Fq2 Ord (c1,c0)."""
    if p.inf:
        return bytes([0x80 | 0x40]) + bytes(95)
    out = bytearray(_fq_to_be(p.x.c1) + _fq_to_be(p.x.c0))
    if p.y.gt(-p.y):
        out[0] |= 0x20
    out[0] |= 0x80
    return bytes(out)


def g2_from_compressed(b: bytes, check: bool = True) -> Point:
    assert len(b) == 96
    if not (b[0] & 0x80):
        raise ValueError("compressed bit not set")
    if b[0] & 0x40:
        if (b[0] & 0x3F) or any(b[1:]):
            raise ValueError("malformed infinity encoding")
        return point_zero("g2")
    greatest = bool(b[0] & 0x20)
    x_c1 = _fq_from_be(bytes([b[0] & 0x1F]) + b[1:48], "x c1")
    x_c0 = _fq_from_be(b[48:96], "x c0")
    p = get_point_from_x(Fq2(x_c0, x_c1), greatest, "g2")
    if p is None:
        raise ValueError("x not on curve")
    if check and not p.in_subgroup():
        raise ValueError("point not in the r-order subgroup")
    return p
