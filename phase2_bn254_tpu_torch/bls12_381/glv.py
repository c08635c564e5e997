"""GLV endomorphism scalar decomposition for BLS12-381 G1 (the port's copy
of `phase2_bn254_tpu/bls12_381/glv.py`, which imports no JAX; its code is
the original's, `tests/test_torch_host.py` holds the two equal).

BLS12-381 has the same CM-by-sqrt(-3) structure as BN254: phi(x, y) =
(BETA*x, y) multiplies prime-order points by LAMBDA = z^2 - 1 (z the BLS
parameter), a primitive cube root of unity mod r. Scalars split as
k = k1 + k2*LAMBDA with |ki| ~ sqrt(r) ~ 2^128, halving ladder doublings.

The reference's BLS engine has no endomorphism path either
(pairing/src/bls12_381/ec.rs uses plain double-and-add); this is a pure
performance transform - results are identical points. The short basis is
(1, 0xac45a4010001a4020000000100000000),
(0xac45a4010001a40200000000ffffffff, -1); the device split is
`ops.glv.GlvPlan` over it (`device.GLV_PLAN`).
"""

from __future__ import annotations

from ..refimpl.glv import derive_basis
from .field import Q, R_MOD

Z = -0xD201000000010000  # BLS parameter (ec.rs BLS_X, negative)

LAMBDA = (Z * Z - 1) % R_MOD
# the cube root of unity in Fq matching the LAMBDA eigenvalue on G1
# (derived by checking (BETA*x, y) == LAMBDA*(x, y) on the generator)
BETA = 0x1A0111EA397FE699EC02408663D4DE85AA0D857D89759AD4897D29650FB85F9B409427EB4F49FFFD8BFD00000000AAAC

assert (LAMBDA * LAMBDA + LAMBDA + 1) % R_MOD == 0
assert (BETA * BETA + BETA + 1) % Q == 0

(_A1, _B1), (_A2, _B2) = derive_basis(R_MOD, LAMBDA)
_DET = _A1 * _B2 - _A2 * _B1
assert abs(_DET) == R_MOD, _DET

MAX_COMPONENT_BITS = max(abs(v).bit_length() for v in (_A1, _B1, _A2, _B2)) + 2


def phi(p):
    """The endomorphism (x, y) -> (BETA*x, y) on G1."""
    import dataclasses

    if p.is_zero():
        return p
    assert p.group == "g1"
    return dataclasses.replace(p, x=p.x * BETA % Q)


def decompose(k: int) -> tuple[int, int]:
    """k in [0, r) -> (k1, k2) with k1 + k2*LAMBDA = k (mod r), both short."""
    from ..refimpl.glv import _round_div

    k %= R_MOD
    c1 = _round_div(k * _B2, _DET)
    c2 = _round_div(-k * _B1, _DET)
    k1 = k - c1 * _A1 - c2 * _A2
    k2 = -c1 * _B1 - c2 * _B2
    assert (k1 + k2 * LAMBDA - k) % R_MOD == 0
    assert abs(k1).bit_length() <= MAX_COMPONENT_BITS
    assert abs(k2).bit_length() <= MAX_COMPONENT_BITS
    return k1, k2


def mul_glv(p, k: int):
    """Host oracle: GLV split multiplication; equals p.mul(k)."""
    k1, k2 = decompose(k)
    acc1 = p.mul(abs(k1))
    if k1 < 0:
        acc1 = acc1.neg()
    acc2 = phi(p).mul(abs(k2))
    if k2 < 0:
        acc2 = acc2.neg()
    return acc1.add(acc2)
