"""BLS12-381 device path of the port (counterpart of
`phase2_bn254_tpu/bls12_381/device.py`).

The limb-generic machinery of the BN254 path serves the second engine:
`field.fp`'s Montgomery arithmetic, `field.fq2`'s tower ops and
`curve.group`'s masked Jacobian group law are parameterized over an
`FpContext`, and the windowed ladders K8 / K9 (`csrc/ladders.cuh`) over the
field type. This module supplies the contexts, the host <-> tensor
converters and the two batch multiplications:

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

A point at infinity gives infinity, as `batch_mul`, host `Point.mul` and the
JAX docstring promise. The JAX package's `pallas_batch_mul` never reads the
batch's inf flags, so its infinity input, written as (0, 1), enters the
ladder as a finite point off the curve; the port masks those lanes to the
Jacobian infinity (0, 1, 0) after the ladder instead.
"""

from __future__ import annotations

import torch

from .. import convert
from ..curve import group as G
from ..field import fp
from ..field.fq2 import BLS_FQ, BLS_FQ2
from ..ops import batch_exp
from . import curve as host
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


def ladder(batch: G.AffineBatch, scalars: torch.Tensor, grp: str) -> G.JacobianBatch:
    """k_i P_i, Jacobian Montgomery limbs, by K8-BLS (G1) or K9-BLS (G2) on
    the batch's device (CUDA: the kernel; CPU: its plain version). scalars:
    canonical int64 (N, 16). Lanes whose input is at infinity give (0, 1,
    0)."""
    f = field_ops(grp)
    kernel = batch_exp.batch_exp_bls_g1_windowed if grp == "g1" else batch_exp.batch_exp_bls_g2_windowed
    jac = kernel(batch.x.contiguous(), batch.y.contiguous(), scalars.contiguous())
    zero = G.jac_zero(f, batch.inf.shape, batch.inf.device)
    return G.JacobianBatch(*(f.select(batch.inf, z, c) for z, c in zip(zero, jac)))


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
