"""Host-side BN254 pairing for ceremony ratio checks.

The ceremony uses pairings ONLY inside boolean `same_ratio` checks
(powersoftau/src/utils.rs:151-159); pairing values are never
serialized, so bit-parity with the reference's optimal-ate implementation
(pairing/src/bn256/mod.rs:57-226) is not required - any
non-degenerate bilinear pairing gives identical accept/reject behavior.

We implement the reduced Tate pairing e(P, Q) = f_{r,P}(psi(Q))^((q^12-1)/r)
with denominator elimination, over the tower

    Fq2  = Fq[u]/(u^2+1)
    Fq12 = Fq2[w]/(w^6 - xi),  xi = 9 + u

and the sextic untwist psi(x', y') = (x' w^2, y' w^3) mapping the twist
E'/Fq2: y^2 = x^3 + 3/xi (where G2 lives) into E/Fq12.

Verticals evaluate into the subfield Fq2[w^2] = Fq6, which the final
exponentiation kills ((q^6-1) | (q^12-1)/r), so they are omitted.

The port's own copy of `phase2_bn254_tpu/refimpl/pairing.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

from .field import FQ2_ONE, FQ2_ZERO, Fq2, Q, R_MOD
from .curve import Point

# ---------------------------------------------------------------------------
# Fq12 = Fq2[w]/(w^6 - xi): elements are tuples of 6 Fq2 coefficients
# ---------------------------------------------------------------------------

XI = Fq2(9, 1)

Fq12 = tuple  # tuple[Fq2 x 6]

FQ12_ONE: Fq12 = (FQ2_ONE,) + (FQ2_ZERO,) * 5
FQ12_ZERO: Fq12 = (FQ2_ZERO,) * 6


# Internally Fq12 = Fq6[w]/(w^2 - v) with Fq6 = Fq2[v]/(v^3 - xi); the
# w-basis tuple maps to the tower as c0 = (a0, a2, a4), c1 = (a1, a3, a5)
# (the reference's fq6.rs/fq12.rs layout). Karatsuba: a full Fq12 mul costs
# 18 Fq2 muls (3 Fq6 muls of 6) instead of 36 schoolbook.

def _fq6_mul(a0, a1, a2, b0, b1, b2):
    v0, v1, v2 = a0 * b0, a1 * b1, a2 * b2
    c0 = v0 + ((a1 + a2) * (b1 + b2) - v1 - v2) * XI
    c1 = (a0 + a1) * (b0 + b1) - v0 - v1 + v2 * XI
    c2 = (a0 + a2) * (b0 + b2) - v0 + v1 - v2
    return c0, c1, c2


def _fq6_mul_by_v(a0, a1, a2):
    return a2 * XI, a0, a1


def fq12_mul(a: Fq12, b: Fq12) -> Fq12:
    aa = _fq6_mul(a[0], a[2], a[4], b[0], b[2], b[4])
    bb = _fq6_mul(a[1], a[3], a[5], b[1], b[3], b[5])
    cc = _fq6_mul(
        a[0] + a[1], a[2] + a[3], a[4] + a[5],
        b[0] + b[1], b[2] + b[3], b[4] + b[5],
    )
    vb = _fq6_mul_by_v(*bb)
    c0 = tuple(x + y for x, y in zip(aa, vb))
    c1 = tuple(c - x - y for c, x, y in zip(cc, aa, bb))
    return c0[0], c1[0], c0[1], c1[1], c0[2], c1[2]


def fq12_sqr(a: Fq12) -> Fq12:
    """Complex squaring over the w^2 = v tower: 2 Fq6 muls."""
    a0 = (a[0], a[2], a[4])
    a1 = (a[1], a[3], a[5])
    v0 = _fq6_mul(*a0, *a1)
    t = _fq6_mul_by_v(*a1)
    s0 = tuple(x + y for x, y in zip(a0, a1))
    s1 = tuple(x + y for x, y in zip(a0, t))
    c0 = _fq6_mul(*s0, *s1)
    vv0 = _fq6_mul_by_v(*v0)
    c0 = tuple(c - x - y for c, x, y in zip(c0, v0, vv0))
    c1 = tuple(2 * x for x in v0)
    return c0[0], c1[0], c0[1], c1[1], c0[2], c1[2]


def fq12_mul_line(f: Fq12, c0: int, c1: Fq2, c3: Fq2) -> Fq12:
    """f * (c0 + c1 w + c3 w^3) with c0 in Fq - the D-twist ate line shape.

    This is the tower-coordinate sparse mul (`mul_by_034`/`mul_by_014`
    analog, pairing/src/bn256/fq12.rs): 13 Fq2 muls."""
    out = [fi * c0 for fi in f]
    for i in range(6):
        j = i + 1
        t = f[i] * c1
        if j >= 6:
            j -= 6
            t = t * XI
        out[j] = out[j] + t
    for i in range(6):
        j = i + 3
        t = f[i] * c3
        if j >= 6:
            j -= 6
            t = t * XI
        out[j] = out[j] + t
    return tuple(out)


def fq12_conj_w(a: Fq12) -> Fq12:
    """w -> -w conjugation (the q^6 Frobenius): negate odd coefficients."""
    return tuple(ci if i % 2 == 0 else -ci for i, ci in enumerate(a))


def _fq6_inv(b0: Fq2, b1: Fq2, b2: Fq2) -> tuple[Fq2, Fq2, Fq2]:
    """Inverse in Fq2[v]/(v^3 - xi) by the standard norm formula."""
    c0 = b0.square() - b1 * b2 * XI
    c1 = b2.square() * XI - b0 * b1
    c2 = b1.square() - b0 * b2
    t = (b0 * c0 + (b2 * c1 + b1 * c2) * XI).inverse()
    return c0 * t, c1 * t, c2 * t


def fq12_inv(a: Fq12) -> Fq12:
    """a^-1 = conj(a) / (a * conj(a)); the product lies in Fq2[w^2] = Fq6."""
    ac = fq12_conj_w(a)
    n = fq12_mul(a, ac)
    assert n[1].is_zero() and n[3].is_zero() and n[5].is_zero()
    i0, i1, i2 = _fq6_inv(n[0], n[2], n[4])
    ninv = (i0, FQ2_ZERO, i1, FQ2_ZERO, i2, FQ2_ZERO)
    return fq12_mul(ac, ninv)


# Frobenius coefficients: (Sum a_i w^i)^q = Sum frob(a_i) * G_i * w^i,
# G_i = xi^(i*(q-1)/6)
_FROB_GAMMA = [XI.pow(i * (Q - 1) // 6) for i in range(6)]


def fq12_frobenius(a: Fq12, power: int = 1) -> Fq12:
    out = a
    for _ in range(power):
        out = tuple(out[i].conjugate() * _FROB_GAMMA[i] for i in range(6))
    return out


def fq12_pow(a: Fq12, e: int) -> Fq12:
    result = FQ12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# Tate pairing
# ---------------------------------------------------------------------------

def _psi(q: Point) -> tuple[Fq12, Fq12]:
    """Untwist a G2 point into E(Fq12): (x w^2, y w^3)."""
    xw2 = (FQ2_ZERO, FQ2_ZERO, q.x, FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
    yw3 = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO, q.y, FQ2_ZERO, FQ2_ZERO)
    return xw2, yw3


def _fq12_scale_fq(a: Fq12, s: int) -> Fq12:
    return tuple(ci * s for ci in a)


def _line(fx: int, fy: int, lam: int, xq: Fq12, yq: Fq12) -> Fq12:
    """Evaluate the line through (fx, fy) with Fq slope lam at (xq, yq):
    (yq - fy) - lam * (xq - fx). All Fq-coefficient terms sit in w^0."""
    const = (lam * fx - fy) % Q  # -fy + lam*fx
    out = list(yq)
    # subtract lam * xq
    lx = _fq12_scale_fq(xq, lam)
    out = [o - l for o, l in zip(out, lx)]
    out[0] = out[0] + Fq2(const, 0)
    return tuple(out)


_FINAL_EXP = (Q**12 - 1) // R_MOD
_HARD_EXP = (Q**4 - Q**2 + 1) // R_MOD


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((q^12-1)/r): easy part (q^6-1)(q^2+1), then the BN hard part via
    the Frobenius/exp-by-u addition chain
    (pairing/src/bn256/mod.rs:132-227; Devegili-Scott-Dahab).
    Inverses in the cyclotomic subgroup are w-conjugations."""
    # easy part
    r = fq12_mul(fq12_conj_w(f), fq12_inv(f))
    r = fq12_mul(fq12_frobenius(r, 2), r)

    # hard part (q^4 - q^2 + 1)/r
    fp = fq12_frobenius(r, 1)
    fp2 = fq12_frobenius(r, 2)
    fp3 = fq12_frobenius(fp2, 1)
    fu = fq12_pow(r, BN_U)
    fu2 = fq12_pow(fu, BN_U)
    fu3 = fq12_pow(fu2, BN_U)
    y0 = fq12_mul(fq12_mul(fp, fp2), fp3)
    y1 = fq12_conj_w(r)
    y2 = fq12_frobenius(fu2, 2)
    y3 = fq12_conj_w(fq12_frobenius(fu, 1))
    y4 = fq12_conj_w(fq12_mul(fu, fq12_frobenius(fu2, 1)))
    y5 = fq12_conj_w(fu2)
    y6 = fq12_conj_w(fq12_mul(fu3, fq12_frobenius(fu3, 1)))
    t = fq12_mul(fq12_mul(fq12_sqr(y6), y4), y5)
    t1 = fq12_mul(fq12_mul(y3, y5), t)
    t = fq12_mul(t, y2)
    t1 = fq12_sqr(fq12_mul(fq12_sqr(t1), t))
    t0 = fq12_mul(t1, y1)
    t1 = fq12_mul(t1, y0)
    return fq12_mul(fq12_sqr(t0), t1)


def pairing(p: Point, q: Point) -> Fq12:
    """Reduced optimal-ate pairing (the default pairing for all ratio
    checks and serialized Fq12 values); accepts infinity (returns 1)."""
    if p.is_zero() or q.is_zero():
        return FQ12_ONE
    return final_exponentiation(miller_loop_ate(p, q))


def tate_pairing(p: Point, q: Point) -> Fq12:
    """Reduced Tate pairing - kept as an independent second implementation
    for oracle cross-checks (differs from the ate value by a fixed power
    coprime to r, so boolean same-ratio behavior matches)."""
    if p.is_zero() or q.is_zero():
        return FQ12_ONE
    return final_exponentiation(_miller_safe(p, q))


def _miller_safe(p: Point, q: Point) -> Fq12:
    """Miller loop with the T == +-P corner cases handled explicitly."""
    xq, yq = _psi(q)
    f = FQ12_ONE
    tx, ty, tinf = p.x, p.y, False
    bits = bin(R_MOD)[3:]
    for b in bits:
        if not tinf:
            if ty == 0:
                # vertical tangent; doubling gives O, line is vertical: elide
                tinf = True
                f = fq12_sqr(f)
            else:
                lam = (3 * tx * tx * pow(2 * ty, -1, Q)) % Q
                f = fq12_mul(fq12_sqr(f), _line(tx, ty, lam, xq, yq))
                nx = (lam * lam - 2 * tx) % Q
                ny = (lam * (tx - nx) - ty) % Q
                tx, ty = nx, ny
        else:
            f = fq12_sqr(f)
        if b == "1":
            if tinf:
                tx, ty, tinf = p.x, p.y, False
            elif tx == p.x:
                if ty == p.y:
                    # doubling disguised as add (cannot happen for prime r)
                    lam = (3 * tx * tx * pow(2 * ty, -1, Q)) % Q
                    f = fq12_mul(f, _line(tx, ty, lam, xq, yq))
                    nx = (lam * lam - 2 * tx) % Q
                    ny = (lam * (tx - nx) - ty) % Q
                    tx, ty = nx, ny
                else:
                    # T == -P: vertical line, elided; T becomes O
                    tinf = True
            else:
                lam = ((ty - p.y) * pow(tx - p.x, -1, Q)) % Q
                f = fq12_mul(f, _line(tx, ty, lam, xq, yq))
                nx = (lam * lam - tx - p.x) % Q
                ny = (lam * (tx - nx) - ty) % Q
                tx, ty = nx, ny
    return f


# ---------------------------------------------------------------------------
# Optimal ate pairing (the reference's pairing, bn256/mod.rs:29-226)
#
# The reduced optimal-ate VALUE is canonical for BN curves, so a from-scratch
# textbook implementation reproduces the reference's Fq12 output exactly
# (needed by the snarkjs `vk_alfabeta_12` JSON export,
# phase2/src/circom_circuit.rs:303-317). The Tate pairing
# above differs by a fixed power coprime to r - fine for same_ratio booleans,
# not for serialized values.
# ---------------------------------------------------------------------------

BN_U = 4965661367192848881  # mod.rs:29
ATE_LOOP = 6 * BN_U + 2


# twist Frobenius endomorphism psi(x, y) = (conj(x) g2, conj(y) g3) maps
# E'(Fq2) to itself and commutes with the untwist into E(Fq12)
_TW_G2 = XI.pow((Q - 1) // 3)
_TW_G3 = XI.pow((Q - 1) // 2)
_TW_G2_SQ = XI.pow((Q * Q - 1) // 3)
_TW_G3_SQ = XI.pow((Q * Q - 1) // 2)


def _ate_double(tx: Fq2, ty: Fq2, px: int, py: int):
    """Double T on the twist; return (T2, line coeffs (c0, c1, c3)).

    Line through T with Fq2 slope lam, untwisted and evaluated at P:
    l = py - lam*px*w + (lam*tx - ty)*w^3."""
    lam = tx.square() * 3 * (ty * 2).inverse()
    x3 = lam.square() - tx * 2
    y3 = lam * (tx - x3) - ty
    return x3, y3, (py, lam * (-px), lam * tx - ty)


def _ate_add(tx: Fq2, ty: Fq2, qx: Fq2, qy: Fq2, px: int, py: int):
    """Add Q into T on the twist (distinct x, guaranteed for r-torsion
    inputs along the 6u+2 ate schedule); returns (T+Q, line coeffs)."""
    d = qx - tx
    assert not d.is_zero(), "ate addition degenerate: input not in r-torsion"
    lam = (qy - ty) * d.inverse()
    x3 = lam.square() - tx - qx
    y3 = lam * (tx - x3) - ty
    return x3, y3, (py, lam * (-px), lam * tx - ty)


def miller_loop_ate(p: Point, q: Point) -> Fq12:
    """f_{6u+2,Q}(P) * l_{T,piQ}(P) * l_{T+piQ,-pi2Q}(P), verticals elided.

    Runs entirely in twist-affine Fq2 coordinates with sparse line
    multiplications (pairing/src/bn256/mod.rs:57-130 uses
    the same loop with prepared projective coefficients)."""
    px, py = p.x, p.y
    qx, qy = q.x, q.y
    tx, ty = qx, qy
    f = FQ12_ONE
    for bit in bin(ATE_LOOP)[3:]:
        tx, ty, line = _ate_double(tx, ty, px, py)
        f = fq12_mul_line(fq12_sqr(f), *line)
        if bit == "1":
            tx, ty, line = _ate_add(tx, ty, qx, qy, px, py)
            f = fq12_mul_line(f, *line)
    # Frobenius correction lines: +psi(Q), then -psi^2(Q)
    q1x, q1y = qx.conjugate() * _TW_G2, qy.conjugate() * _TW_G3
    q2x, q2y = qx * _TW_G2_SQ, qy * _TW_G3_SQ
    tx, ty, line = _ate_add(tx, ty, q1x, q1y, px, py)
    f = fq12_mul_line(f, *line)
    _, _, line = _ate_add(tx, ty, q2x, -q2y, px, py)
    return fq12_mul_line(f, *line)


def ate_pairing(p: Point, q: Point) -> Fq12:
    """Reduced optimal ate pairing - the reference's `Bn256::pairing`."""
    if p.is_zero() or q.is_zero():
        return FQ12_ONE
    return final_exponentiation(miller_loop_ate(p, q))


def fq12_to_tower_coeffs(a: Fq12) -> list[int]:
    """Map w-basis coefficients to the reference's Fq6/Fq2 tower layout
    (c0.c0.c0, c0.c0.c1, c0.c1.c0, ..., c1.c2.c1) as canonical ints - the
    order used by `pairing_to_vec` (phase2/src/utils.rs:153-185):
    c0 = a0 + a2 v + a4 v^2, c1 = a1 + a3 v + a5 v^2 (v = w^2, w^3 = v w)."""
    order = [0, 2, 4, 1, 3, 5]
    out = []
    for i in order:
        out.append(a[i].c0)
        out.append(a[i].c1)
    return out


def same_ratio(g1_pair: tuple[Point, Point], g2_pair: tuple[Point, Point]) -> bool:
    """e(a, d) == e(b, c) check with the reference's zero-rejection
    (powersoftau/src/utils.rs:151-159)."""
    a, b = g1_pair
    c, d = g2_pair
    if a.is_zero() or b.is_zero() or c.is_zero() or d.is_zero():
        return False
    return pairing(a, d) == pairing(b, c)
