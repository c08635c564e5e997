"""The contribute path's scalar glue and ladders (K1, K2) against the JAX
package and refimpl.

* `tau_powers` against `pallas_exp.tau_powers_t` (plain XLA);
* the GLV / GLS signed digits against `glv_device` / `gls_device`
  `decompose_signed_device_t` and the host recodes
  `pallas_exp.glv_signed_digit_arrays` / `gls_device.gls_signed_digit_arrays`;
* the plain K1 / K2 against refimpl `Point.mul` after normalizing, at the
  edge scalars of tests/test_glv_signed.py and tests/test_gls.py;
* the CUDA sources' per-point arithmetic, compiled for the host with g++,
  against the plain K1 / K2 (the kernels themselves run only on a GPU: the
  `gpu` test below);
* csrc/constants.cuh against the refimpl integers.

The Pallas kernels are not run here (interpret mode takes minutes to tens of
minutes); the plain references above are what the JAX tests use in their
default tier. Tolerance: exact integer equality of every limb and digit.
"""

import ctypes
import os
import random
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase2_bn254_tpu.field import fp as jfp
from phase2_bn254_tpu.ops import gls_device, glv_device, pallas_exp
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.curve import group as G
from phase2_bn254_tpu_torch.field import fp
from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
from phase2_bn254_tpu_torch.ops import _build, batch_exp, gls, glv
from phase2_bn254_tpu_torch.refimpl import curve as rc
from phase2_bn254_tpu_torch.refimpl import gls as rgls
from phase2_bn254_tpu_torch.refimpl.field import R_MOD
from phase2_bn254_tpu_torch.refimpl.glv import LAMBDA

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

EDGE = [1, 2, R_MOD - 1, R_MOD // 2, (R_MOD - 1) // 2, LAMBDA, R_MOD - LAMBDA, (1 << 128) - 1, 1 << 253, 0]


def _scalars(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % R_MOD for row in words]


def _jax_t(vals):
    """Canonical ints -> the JAX transposed uint32 (16, N) layout."""
    return jnp.asarray(np.stack([jfp.int_to_limbs(v) for v in vals]).T)


def test_tau_powers_match_jax():
    ctx = fp.FR_CTX
    tau, start, coeff, log2n = _scalars(1, 1)[0], 5, _scalars(2, 1)[0], 3
    mont = [ctx.to_mont_int(pow(tau, start, R_MOD)), ctx.to_mont_int(coeff)]
    pows = [ctx.to_mont_int(pow(tau, 1 << j, R_MOD)) for j in range(log2n)]
    got = batch_exp.tau_powers(
        convert.ints_to_limbs(mont[:1], "cpu")[0], convert.ints_to_limbs(pows, "cpu"),
        convert.ints_to_limbs(mont[1:], "cpu")[0], log2n,
    )
    want = jax.jit(pallas_exp.tau_powers_t, static_argnums=3)(
        _jax_t(mont[:1])[:, 0], _jax_t(pows).T, _jax_t(mont[1:])[:, 0], log2n
    )
    assert np.array_equal(got.numpy(), np.asarray(want).T.astype(np.int64))
    assert convert.limbs_to_ints(got) == [coeff * pow(tau, start + i, R_MOD) % R_MOD for i in range(1 << log2n)]


def _value(col) -> int:
    """MSB-first signed base-32 digits -> integer."""
    v = 0
    for d in col:
        v = (v << 5) + int(d)
    return v


# r // 2 rounds half way in the Babai step: the Barrett quotient and the
# host's exact rounding pick different (equally valid) splits there
_TIE = R_MOD // 2


def test_glv_digits_match_jax_and_host_recode():
    vals = EDGE + _scalars(3, 22)
    d1, d2 = glv.decompose_signed(convert.ints_to_limbs(vals, "cpu"))
    assert d1.shape == (batch_exp.G1_WINDOWS, len(vals)) == (26, len(vals))
    j1, j2 = glv_device.decompose_signed_device_t(_jax_t(vals))
    h1, h2 = pallas_exp.glv_signed_digit_arrays(vals)
    off_tie = np.array([v != _TIE for v in vals])
    for got, dev, host in ((d1, j1, h1), (d2, j2, h2)):
        assert np.array_equal(got.numpy(), np.asarray(dev))
        assert np.array_equal(got.numpy()[:, off_tie], host[:, off_tie])
    assert int(d1.abs().max()) <= 16 and int(d2.abs().max()) <= 16
    for i, k in enumerate(vals):
        assert (_value(d1[:, i]) + _value(d2[:, i]) * LAMBDA - k) % R_MOD == 0


def test_gls_digits_match_jax_and_host_recode():
    vals = EDGE + _scalars(4, 22)
    d = gls.decompose_signed(convert.ints_to_limbs(vals, "cpu"))
    assert d.shape == (4, batch_exp.G2_WINDOWS, len(vals)) == (4, 14, len(vals))
    assert np.array_equal(d.numpy(), np.asarray(gls_device.decompose_signed_device_t(_jax_t(vals))))
    off_tie = np.array([v != _TIE for v in vals])
    assert np.array_equal(d.numpy()[..., off_tie], gls_device.gls_signed_digit_arrays(vals)[..., off_tie])
    lam = rgls.LAMBDA
    for i, k in enumerate(vals):
        assert (sum(_value(d[c, :, i]) * pow(lam, c, R_MOD) for c in range(4)) - k) % R_MOD == 0


@pytest.fixture(scope="module")
def ladders():
    """Inputs and plain K1 / K2 outputs at the edge scalars plus two random."""
    rng = random.Random(5)
    vals = EDGE + _scalars(6, 2)
    k = convert.ints_to_limbs(vals, "cpu")
    out = {}
    for group, gen in (("g1", rc.G1_GEN), ("g2", rc.G2_GEN)):
        pts = [gen.mul(rng.randrange(1, R_MOD)) for _ in vals]
        aff = convert.points_to_affine(pts, group, "cpu")
        if group == "g1":
            digits = glv.decompose_signed(k)
            jac = batch_exp.batch_exp_glv_signed(aff.x, aff.y, *digits)
        else:
            digits = (gls.decompose_signed(k),)
            jac = batch_exp.batch_exp_gls_signed(aff.x, aff.y, *digits)
        out[group] = (pts, vals, aff, digits, jac)
    return out


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_ladder_matches_refimpl(ladders, group):
    pts, vals, _, _, jac = ladders[group]
    aff = G.jac_normalize(FQ if group == "g1" else FQ2, jac)
    assert convert.affine_to_points(aff, group) == [p.mul(s) for p, s in zip(pts, vals)]


_HOST_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "batch_exp_g1.cu"
#include "batch_exp_g2.cu"
extern "C" void host_g1(const int64_t* x, const int64_t* y, const int64_t* d1, const int64_t* d2,
                        int64_t* ox, int64_t* oy, int64_t* oz, int n, int nw) {
  for (int i = 0; i < n; ++i) batch_exp_glv_signed_point(x, y, d1, d2, ox, oy, oz, i, n, nw);
}
extern "C" void host_g2(const int64_t* x, const int64_t* y, const int64_t* d,
                        int64_t* ox, int64_t* oy, int64_t* oz, int n, int nw) {
  for (int i = 0; i < n; ++i) batch_exp_gls_signed_point(x, y, d, ox, oy, oz, i, n, nw);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("ladder_shim")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
         str(d / "shim.cpp"), "-o", str(d / "shim.so")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(d / "shim.so"))
    lib.host_g1.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int]
    lib.host_g2.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int]
    return lib


def _host_ladder(fn, aff, digits):
    out = [torch.empty_like(aff.x) for _ in range(3)]
    fn(aff.x.data_ptr(), aff.y.data_ptr(), *(d.data_ptr() for d in digits), *(o.data_ptr() for o in out),
       aff.x.shape[0], digits[0].shape[-2])
    return out


def test_cuda_sources_arithmetic_on_host_matches_plain(ladders, host_lib):
    """csrc/ per-point functions compiled by g++ (CUDA qualifiers defined
    away): the kernels' field, group law and ladder code, run on the CPU."""
    for group, fn in (("g1", host_lib.host_g1), ("g2", host_lib.host_g2)):
        _, _, aff, digits, want = ladders[group]
        assert all(torch.equal(a, b) for a, b in zip(_host_ladder(fn, aff, digits), want)), group


def test_k1_table_and_first_window_on_host(host_lib):
    """K1's table by one doubling and mixed adds equals the table by general
    adds limb for limb, and its per-lane start (each lane from its own first
    nonzero window, where the plain version starts the batch at the first
    window any lane needs) gives the plain version's limbs, on the edge
    scalars (_TIE among them) and small ones whose first nonzero window
    comes late and differs from lane to lane."""
    vals = EDGE + [_TIE, 31, 32, 1023, (1 << 40) + 1, 1 << 100, 7 * LAMBDA % R_MOD] + _scalars(8, 4)
    rng = random.Random(12)
    aff = convert.points_to_affine([rc.G1_GEN.mul(rng.randrange(1, R_MOD)) for _ in vals], "g1", "cpu")
    ones = FQ.ones((len(vals),), "cpu")
    mixed = [G.jac_zero(FQ, (len(vals),), "cpu"), G.JacobianBatch(aff.x, aff.y, ones)]
    mixed.append(G.jac_double(FQ, mixed[1]))
    for _ in range(3, 17):
        mixed.append(G.jac_madd(FQ, mixed[-1], aff.x, aff.y))
    general = batch_exp._table(FQ, aff.x, aff.y)
    assert all(torch.equal(torch.stack(a), b) for a, b in zip(zip(*mixed), general))
    d1, d2 = glv.decompose_signed(convert.ints_to_limbs(vals, "cpu"))
    first = ((d1 != 0) | (d2 != 0)).int().argmax(0)
    assert len(set(first.tolist())) > 3
    want = batch_exp.batch_exp_glv_signed_plain(aff.x, aff.y, d1, d2)
    assert all(torch.equal(a, b) for a, b in zip(_host_ladder(host_lib.host_g1, aff, (d1, d2)), want))
    got = convert.affine_to_points(G.jac_normalize(FQ, want), "g1")
    pts = convert.affine_to_points(aff, "g1")
    assert got == [p.mul(k) for p, k in zip(pts, vals)]


def test_k2_table_and_first_window_on_host(host_lib):
    """K2's table by one doubling and mixed adds equals the table by general
    adds limb for limb, and its per-lane start (each lane from its own first
    window with a nonzero digit in any of the four rows, a lane with none
    from the last window; the plain version starts every lane at window 0)
    gives the plain version's limbs, on the edge scalars (0 and _TIE among
    them) and small ones whose leading windows are zero in all four rows,
    up to a late first window that differs from lane to lane."""
    vals = [0, _TIE, 1, R_MOD - 1, 31, 1023, (1 << 40) + 1, 1 << 70, 1 << 100, 5 * rgls.LAMBDA % R_MOD] + _scalars(9, 2)
    rng = random.Random(13)
    aff = convert.points_to_affine([rc.G2_GEN.mul(rng.randrange(1, R_MOD)) for _ in vals], "g2", "cpu")
    ones = FQ2.ones((len(vals),), "cpu")
    mixed = [G.jac_zero(FQ2, (len(vals),), "cpu"), G.JacobianBatch(aff.x, aff.y, ones)]
    mixed.append(G.jac_double(FQ2, mixed[1]))
    for _ in range(3, 17):
        mixed.append(G.jac_madd(FQ2, mixed[-1], aff.x, aff.y))
    general = batch_exp._table(FQ2, aff.x, aff.y)
    assert all(torch.equal(torch.stack(a), b) for a, b in zip(zip(*mixed), general))
    digits = gls.decompose_signed(convert.ints_to_limbs(vals, "cpu"))
    live = (digits != 0).any(0)
    first = torch.where(live.any(0), live.int().argmax(0), digits.shape[1] - 1)
    assert len(set(first.tolist())) > 3 and int(first.max()) == digits.shape[1] - 1
    want = batch_exp.batch_exp_gls_signed_plain(aff.x, aff.y, digits)
    assert all(torch.equal(a, b) for a, b in zip(_host_ladder(host_lib.host_g2, aff, (digits,)), want))
    got = convert.affine_to_points(G.jac_normalize(FQ2, want), "g2")
    pts = convert.affine_to_points(aff, "g2")
    assert got == [p.mul(k) for p, k in zip(pts, vals)]


def test_constants_header_matches_refimpl():
    with open(f"{_build.CSRC}/constants.cuh") as f:
        assert f.read() == _build.constants_header()


def test_wrappers_take_no_other_device():
    x = torch.zeros((2, 16), dtype=torch.int64, device="meta")
    d = torch.zeros((26, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        batch_exp.batch_exp_glv_signed(x, x, d, d)


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_kernel_matches_plain_on_gpu(ladders, group):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, aff, digits, want = ladders[group]
    kernel = batch_exp.batch_exp_glv_signed if group == "g1" else batch_exp.batch_exp_gls_signed
    before = batch_exp.LAUNCHES[kernel.__name__]
    got = kernel(aff.x.cuda(), aff.y.cuda(), *(d.cuda() for d in digits))
    assert batch_exp.LAUNCHES[kernel.__name__] == before + 1
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
