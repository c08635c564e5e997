"""The port's group law and codecs against the JAX package's.

`phase2_bn254_tpu_torch.curve.group` (jac_add, jac_double, jac_normalize)
against `phase2_bn254_tpu.curve.group` (G1) and the port's refimpl (G1, G2),
and `curve.codecs` decode/encode against `phase2_bn254_tpu.curve.codecs`, on
the same points from a seeded generator. Tolerance: exact integer equality
of every limb, and of every encoded byte.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase2_bn254_tpu.curve import codecs as jcodecs
from phase2_bn254_tpu.curve import group as JG
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.curve import codecs
from phase2_bn254_tpu_torch.curve import group as G
from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
from phase2_bn254_tpu_torch.refimpl import curve as rc
from phase2_bn254_tpu_torch.refimpl.field import R_MOD

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

OPS = {"g1": (FQ, jcodecs.FQ), "g2": (FQ2, jcodecs.FQ2)}
# the JAX reference, compiled once per op (eager dispatch is far slower)
J_ADD, J_DOUBLE, J_NORMALIZE = (jax.jit(fn, static_argnums=0) for fn in (JG.jac_add, JG.jac_double, JG.jac_normalize))


def _points(group: str, n: int, seed: int):
    rng = random.Random(seed)
    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    return [gen.mul(rng.randrange(1, R_MOD)) for _ in range(n)]


def _jac_pair(f, aff: G.AffineBatch):
    """Jacobian versions of the points with z = y + 1 (z = 0 at infinity),
    as torch and JAX batches holding the same limbs."""
    jac = G.affine_to_jac(f, aff)
    shape = aff.inf.shape
    z = f.select(aff.inf, f.zeros(shape, "cpu"), f.add(jac.y, f.ones(shape, "cpu")))
    z2 = f.sqr(z)
    t = G.JacobianBatch(f.mul(jac.x, z2), f.mul(jac.y, f.mul(z2, z)), z)
    j = JG.JacobianBatch(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in t))
    return t, j


def _same(t, j) -> bool:
    return all(np.array_equal(a.numpy(), np.asarray(b).astype(np.int64)) for a, b in zip(t, j))


def _group_law_cases(group: str):
    f = OPS[group][0]
    pts = _points(group, 6, 1)
    others = _points(group, 6, 2)
    # lanes: generic, P + P, P + (-P), O + Q, P + O, O + O
    lhs = [pts[0], pts[1], pts[2], rc.point_zero(group), pts[4], rc.point_zero(group)]
    rhs = [others[0], pts[1], pts[2].neg(), others[3], rc.point_zero(group), rc.point_zero(group)]
    p, jp = _jac_pair(f, convert.points_to_affine(lhs, group, "cpu"))
    q, jq = _jac_pair(f, convert.points_to_affine(rhs, group, "cpu"))
    s = G.jac_add(f, p, q)
    aff = G.jac_normalize(f, s)
    assert convert.affine_to_points(aff, group) == [a.add(b) for a, b in zip(lhs, rhs)]
    assert aff.inf.tolist() == [False, False, True, False, False, True]
    dbl = G.jac_normalize(f, G.jac_double(f, p))
    assert convert.affine_to_points(dbl, group) == [a.double() for a in lhs]
    return (p, q, s, aff), (jp, jq)


def test_group_law_g1_matches_jax():
    """G1: limb for limb against the JAX group law, and against refimpl."""
    (p, q, s, aff), (jp, jq) = _group_law_cases("g1")
    jf = OPS["g1"][1]
    js = J_ADD(jf, jp, jq)
    assert _same(s, js)
    assert _same(G.jac_double(FQ, p), J_DOUBLE(jf, jp))
    assert _same(aff, J_NORMALIZE(jf, js))


def test_group_law_g2_matches_refimpl():
    """G2: against refimpl (the JAX Fq2 group law compiles for ~30 s on
    XLA:CPU; its formulas are the G1 ones over FQ2)."""
    _group_law_cases("g2")


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("check", [False, True])
def test_decode_matches_jax(group, check):
    pts = _points(group, 5, 5)
    raw = b"".join(rc.point_to_bytes(p, False) for p in pts)
    got = codecs.decode_batch(raw, group, len(pts), False, check, "cpu")
    want = jcodecs.decode_batch(raw, group, len(pts), False, check)
    assert _same(got, want)
    assert convert.affine_to_points(got, group) == pts


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("compressed", [False, True])
def test_encode_matches_jax_bytes(group, compressed):
    pts = _points(group, 7, 6)
    batch = convert.points_to_affine(pts, group, "cpu")
    x, y, inf = convert.affine_to_numpy(batch)
    jbatch = JG.AffineBatch(jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf))
    got = codecs.encode_batch(batch, group, compressed)
    assert got == jcodecs.encode_batch(jbatch, group, compressed)
    assert got == b"".join(rc.point_to_bytes(p, compressed) for p in pts)


def test_encode_rejects_infinity():
    pts = _points("g1", 2, 7) + [rc.point_zero("g1")]
    with pytest.raises(ValueError, match="infinity"):
        codecs.encode_batch(convert.points_to_affine(pts, "g1", "cpu"), "g1", True)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_decode_rejections(group):
    """The uncompressed rejections of tests/test_codecs.py: compression flag,
    infinity flag, a coordinate >= q, and off-curve with check=True; the
    same point compressed decodes (tests/test_torch_decompress.py holds the
    compressed rejections)."""
    p = _points(group, 1, 8)[0]
    good = rc.point_to_bytes(p, False)

    def bad(mutate):
        b = bytearray(good)
        mutate(b)
        return bytes(b)

    for raw in (
        bad(lambda b: b.__setitem__(0, b[0] | 0x80)),  # compression bit
        bad(lambda b: b.__setitem__(0, b[0] | 0x40)),  # infinity bit
        bad(lambda b: b.__setitem__(slice(0, 32), rc.Q.to_bytes(32, "big"))),  # x = q
    ):
        with pytest.raises(ValueError):
            codecs.decode_batch(raw, group, 1, False, False, "cpu")
        with pytest.raises(ValueError):
            jcodecs.decode_batch(raw, group, 1, False, False)
    off = bad(lambda b: b.__setitem__(len(b) - 1, b[-1] ^ 1))  # y no longer on the curve
    with pytest.raises(ValueError, match="off-curve"):
        codecs.decode_batch(off, group, 1, False, True, "cpu")
    assert codecs.decode_batch(off, group, 1, False, False, "cpu").x.shape[0] == 1
    assert convert.affine_to_points(codecs.decode_batch(rc.point_to_bytes(p, True), group, 1, True, False, "cpu"),
                                    group) == [p]
