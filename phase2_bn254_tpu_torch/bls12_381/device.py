"""BLS12-381 device path of the port (counterpart of
`phase2_bn254_tpu/bls12_381/device.py`).

The limb-generic machinery of the BN254 path serves the second engine:
`field.fp`'s Montgomery arithmetic, `field.fq2`'s tower ops and
`curve.group`'s masked Jacobian group law are parameterized over an
`FpContext`, and the kernels' per-point ladders (K8 / K9, K7, K1) over the
field type. This module supplies the contexts, the host <-> tensor
converters and the batch multiplications:

* Fq: 24 x 16-bit limbs, Montgomery R = 2^384 (`fp.BLS_FQ_CTX`), the radix of
  the reference's 6 x u64 `ff_ce` representation
  (pairing/src/bls12_381/fq.rs:447), so Montgomery-form values match at the
  serialization boundary.
* Scalars: reduced mod r and carried canonical, 16 x 16-bit digits (r <
  2^255: 64 4-bit windows). The JAX package carries them on 17 limbs (its
  Fr context needs two spare bits for its CIOS) and cuts 68 windows, whose
  top 4 are always zero; the port does no Fr arithmetic here.
* `batch_mul`: the plain path over the generic group law
  (`group.batch_scalar_mul`), as the JAX package's `batch_mul`.
* `windowed_batch_mul` (the JAX package's `pallas_batch_mul`) and its tensor
  form `ladder` / `mul_batch`: K8-BLS (G1) or K9-BLS (G2) on a CUDA device
  (`ops.batch_exp.batch_exp_bls_g1_windowed` / `_g2_windowed`), their plain
  versions on the CPU, then one batched normalization.
* The G1 GLV path (`glv.py`'s split k = k1 + k2 LAMBDA, phi(x, y) = (BETA
  x, y)): `GLV_PLAN`, the device splits `decompose_glv_t` /
  `decompose_glv_signed_t` (`ops.glv` over the BLS plan), and the ladders
  `glv_batch_mul` / tensor form `glv_ladder` (K7-BLS, the JAX package's
  `pallas_batch_mul_glv`) and `glv_signed_batch_mul` / `glv_signed_ladder`
  (K1-BLS, its `pallas_batch_mul_glv_signed`).

A point at infinity gives infinity, as `batch_mul`, host `Point.mul` and the
JAX docstrings promise. The JAX package's `pallas_batch_mul`,
`pallas_batch_mul_glv` and `pallas_batch_mul_glv_signed` never read the
batch's inf flags, so their infinity input, written as (0, 1), enters the
ladder as a finite point off the curve; the port masks those lanes to the
Jacobian infinity (0, 1, 0) after each ladder instead.
"""

from __future__ import annotations

import torch

from .. import convert
from ..curve import group as G
from ..field import fp
from ..field.fq2 import BLS_FQ, BLS_FQ2
from ..ops import batch_exp
from ..ops import glv as glv_ops
from . import curve as host
from . import glv
from .field import R_MOD

CTX_BLS_FQ = fp.BLS_FQ_CTX
FQ_OPS = BLS_FQ
FQ2_OPS = BLS_FQ2
SCALAR_LIMBS = 16  # canonical scalars: 16 x 16-bit digits, r < 2^255


def field_ops(grp: str):
    """The Fq ops of G1 ("g1"), the Fq2 ops of G2 ("g2")."""
    return FQ_OPS if grp == "g1" else FQ2_OPS


def points_to_batch(points: list[host.Point], grp: str, device) -> G.AffineBatch:
    """Host affine points -> AffineBatch (Montgomery limbs) on `device`; a
    point at infinity as (0, 1) with its inf flag (JAX `points_to_batch`)."""
    return convert.points_to_affine(points, grp, device, curve="bls12_381")


def batch_to_points(batch: G.AffineBatch, grp: str) -> list[host.Point]:
    """AffineBatch -> host affine points."""
    return convert.affine_to_points(batch, grp, curve="bls12_381")


def scalars_to_canon(scalars: list[int], device) -> torch.Tensor:
    """Python ints -> canonical int64 (N, 16) digits mod r on `device`."""
    return convert.ints_to_limbs([s % R_MOD for s in scalars], device, SCALAR_LIMBS)


def batch_mul(points: list[host.Point], scalars: list[int], grp: str, device="cuda") -> list[host.Point]:
    """Plain batch scalar multiplication over the generic group law (4-bit
    windows, masked adds) in torch on `device` (the card unless "cpu"),
    exact against host `Point.mul`."""
    f = field_ops(grp)
    jac = G.batch_scalar_mul(f, points_to_batch(points, grp, device), scalars_to_canon(scalars, device))
    return batch_to_points(G.jac_normalize(f, jac), grp)


def _infinity_where_input_is(f, batch: G.AffineBatch, jac: G.JacobianBatch) -> G.JacobianBatch:
    """jac with the lanes whose input point is at infinity set to (0, 1, 0)."""
    zero = G.jac_zero(f, batch.inf.shape, batch.inf.device)
    return G.JacobianBatch(*(f.select(batch.inf, z, c) for z, c in zip(zero, jac)))


def ladder(batch: G.AffineBatch, scalars: torch.Tensor, grp: str) -> G.JacobianBatch:
    """k_i P_i, Jacobian Montgomery limbs, by K8-BLS (G1) or K9-BLS (G2) on
    the batch's device (CUDA: the kernel; CPU: its plain version). scalars:
    canonical int64 (N, 16). Lanes whose input is at infinity give (0, 1,
    0)."""
    kernel = batch_exp.batch_exp_bls_g1_windowed if grp == "g1" else batch_exp.batch_exp_bls_g2_windowed
    jac = kernel(batch.x.contiguous(), batch.y.contiguous(), scalars.contiguous())
    return _infinity_where_input_is(field_ops(grp), batch, jac)


def mul_batch(batch: G.AffineBatch, scalars: torch.Tensor, grp: str) -> G.AffineBatch:
    """`ladder`, then one batched normalization to affine (inf flags set
    where k_i P_i is infinity)."""
    return G.jac_normalize(field_ops(grp), ladder(batch, scalars, grp))


def windowed_batch_mul(points: list[host.Point], scalars: list[int], grp: str, device="cuda") -> list[host.Point]:
    """The windowed ladder K8-BLS / K9-BLS on host points and scalars
    (counterpart of JAX `pallas_batch_mul`), on the card unless `device` is
    "cpu"; exact against `batch_mul` and host `Point.mul`, infinity inputs
    included."""
    batch = points_to_batch(points, grp, device)
    return batch_to_points(mul_batch(batch, scalars_to_canon(scalars, device), grp), grp)


# ---------------------------------------------------------------------------
# GLV path: the cube-root endomorphism halves the ladder length (glv.py)
# ---------------------------------------------------------------------------

# the Barrett split of bls12_381/glv.py's basis (JAX `_glv_plan`: the same
# constants, 33 4-bit windows, 26 signed base-32 ones)
GLV_PLAN = glv_ops.GlvPlan(R_MOD, glv._A1, glv._B1, glv._A2, glv._B2)


def decompose_glv_t(scalars: torch.Tensor):
    """Canonical scalars int64 (N, 16) mod r -> (d1, d2 int64 (33, N) 4-bit
    windows of |k1|, |k2|, MSB first; negs int64 (2, N), 1 where k_i < 0),
    on the scalars' device: the JAX package's `decompose_glv_t`, which takes
    them transposed, (17, N), row for row."""
    return glv_ops.decompose(scalars, GLV_PLAN)


def decompose_glv_signed_t(scalars: torch.Tensor):
    """Canonical scalars int64 (N, 16) mod r -> (d1, d2 int64 (26, N) signed
    base-32 digits in [-16, 16], the sign of k_i folded in, MSB first): the
    JAX package's `decompose_glv_signed_t`, row for row."""
    return glv_ops.decompose_signed(scalars, GLV_PLAN)


def glv_ladder(batch: G.AffineBatch, scalars: torch.Tensor) -> G.JacobianBatch:
    """k_i P_i on G1, Jacobian Montgomery limbs, by the unsigned GLV ladder
    K7-BLS on the batch's device (CUDA: the kernel; CPU: its plain version),
    the scalars split on that device first (`decompose_glv_t`). scalars:
    canonical int64 (N, 16). Lanes whose input is at infinity give (0, 1,
    0)."""
    jac = batch_exp.batch_exp_bls_glv(batch.x.contiguous(), batch.y.contiguous(),
                                      *decompose_glv_t(scalars.contiguous()))
    return _infinity_where_input_is(FQ_OPS, batch, jac)


def glv_signed_ladder(batch: G.AffineBatch, scalars: torch.Tensor) -> G.JacobianBatch:
    """k_i P_i on G1 by the signed GLV ladder K1-BLS (`decompose_glv_signed_t`
    first), as `glv_ladder`."""
    jac = batch_exp.batch_exp_bls_glv_signed(batch.x.contiguous(), batch.y.contiguous(),
                                             *decompose_glv_signed_t(scalars.contiguous()))
    return _infinity_where_input_is(FQ_OPS, batch, jac)


def glv_batch_mul(points: list[host.Point], scalars: list[int], device="cuda") -> list[host.Point]:
    """K7-BLS on host G1 points and scalars (counterpart of JAX
    `pallas_batch_mul_glv`: 33 windows where the windowed ladder takes 64),
    on the card unless `device` is "cpu"; exact against host `Point.mul`,
    infinity inputs included."""
    batch = points_to_batch(points, "g1", device)
    jac = glv_ladder(batch, scalars_to_canon(scalars, device))
    return batch_to_points(G.jac_normalize(FQ_OPS, jac), "g1")


def glv_signed_batch_mul(points: list[host.Point], scalars: list[int], device="cuda") -> list[host.Point]:
    """K1-BLS on host G1 points and scalars (counterpart of JAX
    `pallas_batch_mul_glv_signed`: 26 signed 5-bit windows), as
    `glv_batch_mul`."""
    batch = points_to_batch(points, "g1", device)
    jac = glv_signed_ladder(batch, scalars_to_canon(scalars, device))
    return batch_to_points(G.jac_normalize(FQ_OPS, jac), "g1")
