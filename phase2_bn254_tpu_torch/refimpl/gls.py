"""GLS 4-dimensional scalar decomposition for BN254 G2 (host exact layer).

The twist endomorphism psi = untwist . frobenius . twist acts on G2 as
multiplication by q mod r (G2 is the q-eigenspace of Frobenius on E[r]),
and Phi_12(q) = q^4 - q^2 + 1 = 0 mod r, so every scalar splits as

    k = k0 + k1*L + k2*L^2 + k3*L^3  (mod r),   L = q mod r,  |ki| ~ r^(1/4)

via Babai round-off against an LLL-reduced basis of the lattice
{(a,b,c,d) : a + b*L + c*L^2 + d*L^3 = 0 mod r}. This quarters the doubling
count of the G2 ladder (Galbraith-Lopez-Scott; the reference has no G2
endomorphism path - its per-point wNAF ladder is the comparison point,
pairing/src/wnaf.rs:49-71).

On the twist coordinates (x, y in Fq2):

    psi(x, y) = (conj(x) * G2C1, conj(y) * G2C2),
    G2C1 = xi^((q-1)/3), G2C2 = xi^((q-1)/2),  xi = 9+u

(the same Frobenius gammas as the pairing's coefficient tables,
pairing/src/bn256/fq.rs:87-119).

The port's own copy of `phase2_bn254_tpu/refimpl/gls.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

from fractions import Fraction

from . import curve as rc
from .field import Fq2, Q, R_MOD

LAMBDA = Q % R_MOD

G2C1 = Fq2(9, 1).pow((Q - 1) // 3)
G2C2 = Fq2(9, 1).pow((Q - 1) // 2)


def psi(p: rc.Point) -> rc.Point:
    """The twist endomorphism on G2 affine points; psi(P) == [q mod r] P."""
    if p.is_zero():
        return p
    return rc.Point(p.x.conjugate() * G2C1, p.y.conjugate() * G2C2, False, "g2")


# ---------------------------------------------------------------------------
# lattice basis (computed once by LLL over the defining 4x4 basis)
# ---------------------------------------------------------------------------

def _lll(basis: list[list[int]], delta: Fraction = Fraction(3, 4)) -> list[list[int]]:
    """Integer LLL reduction with exact rational Gram-Schmidt (4x4 inputs)."""
    b = [row[:] for row in basis]
    n = len(b)

    def gso():
        bstar: list[list[Fraction]] = []
        mu = [[Fraction(0)] * n for _ in range(n)]
        for i in range(n):
            bi = [Fraction(x) for x in b[i]]
            for j in range(i):
                denom = sum(bstar[j][t] * bstar[j][t] for t in range(n))
                mu[i][j] = sum(Fraction(b[i][t]) * bstar[j][t] for t in range(n)) / denom
                bi = [bi[t] - mu[i][j] * bstar[j][t] for t in range(n)]
            bstar.append(bi)
        return bstar, mu

    k = 1
    while k < n:
        bstar, mu = gso()
        for j in range(k - 1, -1, -1):
            q = round(mu[k][j])
            if q:
                b[k] = [b[k][t] - q * b[j][t] for t in range(n)]
        bstar, mu = gso()
        nk = sum(x * x for x in bstar[k])
        nk1 = sum(x * x for x in bstar[k - 1])
        if nk >= (delta - mu[k][k - 1] ** 2) * nk1:
            k += 1
        else:
            b[k], b[k - 1] = b[k - 1], b[k]
            k = max(k - 1, 1)
    return b


_BASIS = _lll(
    [
        [R_MOD, 0, 0, 0],
        [-LAMBDA, 1, 0, 0],
        [-pow(LAMBDA, 2, R_MOD), 0, 1, 0],
        [-pow(LAMBDA, 3, R_MOD), 0, 0, 1],
    ]
)


def _det4(m):
    if len(m) == 1:
        return m[0][0]
    out = 0
    for j in range(len(m)):
        minor = [row[:j] + row[j + 1 :] for row in m[1:]]
        out += (-1) ** j * m[0][j] * _det4(minor)
    return out


_DET = _det4(_BASIS)
# Babai round-off needs only the FIRST column of B^-1 (the target vector is
# (k, 0, 0, 0)): (B^-1)[j][0] = cof(B)[0][j] / det = adj column.
_ADJ_COL0 = [
    (-1) ** j
    * _det4([[_BASIS[r][c] for c in range(1, 4)] for r in range(4) if r != j])
    for j in range(4)
]


def decompose(k: int) -> tuple[int, int, int, int]:
    """k (mod r) -> (k0, k1, k2, k3) with k = sum k_i L^i (mod r),
    |k_i| < ~2^66."""
    k %= R_MOD
    cs = [round(Fraction(k * _ADJ_COL0[j], _DET)) for j in range(4)]
    k_vec = [k, 0, 0, 0]
    for j in range(4):
        for t in range(4):
            k_vec[t] -= cs[j] * _BASIS[j][t]
    k0, k1, k2, k3 = k_vec
    assert (
        k0 + k1 * LAMBDA + k2 * pow(LAMBDA, 2, R_MOD) + k3 * pow(LAMBDA, 3, R_MOD) - k
    ) % R_MOD == 0
    return k0, k1, k2, k3


def mul_gls(p: rc.Point, k: int) -> rc.Point:
    """Reference GLS multiplication (host): sum_i [k_i] psi^i(P)."""
    acc = rc.point_zero("g2")
    q = p
    for ki in decompose(k):
        if ki:
            acc = acc.add(q.mul(ki % R_MOD))
        q = psi(q)
    return acc
