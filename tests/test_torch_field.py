"""The port's field layer against the JAX package's, limb for limb.

`phase2_bn254_tpu_torch.field.fp` / `fq2` on the CPU against
`phase2_bn254_tpu.field.fp` / `fq2` (XLA:CPU), on the same inputs made from
a seeded numpy generator. Tolerance: exact integer equality of every limb
(the Montgomery values are the same integers in both packages).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase2_bn254_tpu.field import fp as jfp
from phase2_bn254_tpu.field.fq2 import Fq2Ops as JFq2Ops
from phase2_bn254_tpu.refimpl.field import Q, R_MOD, Fq2
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.field import fp
from phase2_bn254_tpu_torch.field.fq2 import FQ2

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

N = 24
CTXS = {"fq": (fp.FQ_CTX, jfp.FpContext(Q, "fq")), "fr": (fp.FR_CTX, jfp.FpContext(R_MOD, "fr"))}


def _elements(seed: int, p: int, n: int = N) -> list[int]:
    """Reduced Montgomery-form values: random, plus 0, 1, p - 1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n - 3, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]
    return vals + [0, 1, p - 1]


def _pair(vals):
    """The same values as a torch tensor and a JAX array."""
    t = convert.ints_to_limbs(vals, "cpu")
    return t, jnp.asarray(t.numpy().astype(np.uint32))


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("field", ["fq", "fr"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_ops_match_jax(field, op):
    ctx, jctx = CTXS[field]
    a, ja = _pair(_elements(1, ctx.p))
    b, jb = _pair(_elements(2, ctx.p)[::-1])
    assert _same(getattr(fp, op)(ctx, a, b), getattr(jfp, op)(jctx, ja, jb))


@pytest.mark.parametrize("field", ["fq", "fr"])
def test_unary_ops_match_jax(field):
    ctx, jctx = CTXS[field]
    a, ja = _pair(_elements(3, ctx.p))
    b, jb = _pair(_elements(4, ctx.p))
    assert _same(fp.neg(ctx, a), jfp.neg(jctx, ja))
    assert _same(fp.to_mont(ctx, a), jfp.to_mont(jctx, ja))
    assert _same(fp.from_mont(ctx, a), jfp.from_mont(jctx, ja))
    assert np.array_equal(fp.gt(a, b).numpy(), np.asarray(jfp.gt(ja, jb)))
    assert np.array_equal(fp.eq(a, a.flip(0)).numpy(), np.asarray(jfp.eq(ja, ja[::-1])))
    assert np.array_equal(fp.is_zero(a).numpy(), np.asarray(jfp.is_zero(ja)))


def test_batch_inv_with_zeros_matches_jax():
    ctx, jctx = CTXS["fq"]
    vals = _elements(5, Q, 16)
    vals[3] = vals[9] = 0
    a, ja = _pair(vals)
    got = fp.batch_inv(ctx, a)
    assert _same(got, jax.jit(jfp.batch_inv, static_argnums=0)(jctx, ja))
    for v, inv in zip(vals, convert.limbs_to_ints(got)):
        assert inv == 0 if v == 0 else v * inv * ctx.rinv % Q == ctx.r  # Montgomery product is one


def test_fq2_ops_match_jax():
    jf = JFq2Ops(CTXS["fq"][1])
    a = torch.stack([convert.ints_to_limbs(_elements(6, Q), "cpu"), convert.ints_to_limbs(_elements(7, Q), "cpu")], 1)
    b = torch.stack([convert.ints_to_limbs(_elements(8, Q), "cpu"), convert.ints_to_limbs(_elements(9, Q), "cpu")], 1)
    ja, jb = jnp.asarray(a.numpy().astype(np.uint32)), jnp.asarray(b.numpy().astype(np.uint32))
    assert _same(FQ2.mul(a, b), jf.mul(ja, jb))
    assert _same(FQ2.sqr(a), jf.sqr(ja))
    assert _same(FQ2.add(a, b), jf.add(ja, jb))
    assert _same(FQ2.sub(a, b), jf.sub(ja, jb))
    assert _same(FQ2.neg(a), jf.neg(ja))
    assert _same(FQ2.conjugate(a), jf.conjugate(ja))
    ctx = fp.FQ_CTX
    inv = FQ2.batch_inv(a[:8])
    for i in range(8):
        x = Fq2(*(ctx.from_mont_int(v) for v in convert.limbs_to_ints(a[i])))
        y = Fq2(*(ctx.from_mont_int(v) for v in convert.limbs_to_ints(inv[i])))
        assert x * y == Fq2(1, 0)


def test_convert_round_trips():
    vals = _elements(10, Q)
    assert convert.limbs_to_ints(convert.ints_to_limbs(vals, "cpu")) == vals
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 16, size=(5, 2, 16), dtype=np.uint32)
    y = rng.integers(0, 1 << 16, size=(5, 2, 16), dtype=np.uint32)
    inf = np.array([False, True, False, False, True])
    batch = convert.affine_from_numpy(x, y, inf, "cpu")
    assert batch.x.dtype == torch.int64 and batch.x.shape == (5, 2, 16)
    bx, by, binf = convert.affine_to_numpy(batch)
    assert bx.dtype == np.uint32 and np.array_equal(bx, x) and np.array_equal(by, y)
    assert np.array_equal(binf, inf)
