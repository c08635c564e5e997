"""The port's Fr NTT (ops/ntt.py, kernel K6 in csrc/ntt.cu) on the CPU.

* `ntt` (its two K6 passes in their plain versions) against the JAX
  package's `ops.ntt._ntt_xla` at exp 1, 5 and 6, forward and inverse, and
  against `ntt_pallas` in interpret mode at exp 3 (odd exp: pass lengths 4
  and 2, the inverse's 1/m folded into the first pass);
* `coset_ntt`, `icoset_ntt`, `distribute_powers` and `divide_by_z_on_coset`
  against the JAX functions at exp 3;
* `ntt` against a direct DFT on host integers at exp 0-8, both directions;
* `Domain`'s constants against the JAX package's;
* the Fr constants of csrc/constants.cuh against the refimpl integers;
* the kernel's per-element code (csrc/ntt.cu), compiled for the host with
  g++, against the plain pass, both passes of exp 5 and 6 (the kernel itself
  runs only on a GPU: the `gpu` test).

Inputs are canonical Fr values in Montgomery form, made from seeds.
Tolerance: exact (limbs, integers).
"""

import ctypes
import os
import random
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase2_bn254_tpu.ops import ntt as jntt
from phase2_bn254_tpu.ops.pallas_ntt import ntt_pallas
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.field import fp
from phase2_bn254_tpu_torch.ops import _build
from phase2_bn254_tpu_torch.ops import ntt
from phase2_bn254_tpu_torch.refimpl.field import R_MOD

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CTX = fp.FR_CTX


def _values(exp: int, seed: int) -> list[int]:
    rng = random.Random(seed)
    return [rng.randrange(R_MOD) for _ in range(1 << exp)]


def _mont(vals) -> torch.Tensor:
    return convert.ints_to_limbs([CTX.to_mont_int(v) for v in vals], "cpu")


def _jax(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _same(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("exp,inverse", [(1, False), (1, True), (5, False), (5, True), (6, False), (6, True)])
def test_ntt_matches_jax_xla(exp, inverse):
    x = _mont(_values(exp, 10 * exp + inverse))
    assert _same(ntt.ntt(exp, x, inverse), jntt._ntt_xla(exp, _jax(x), inverse))


def test_ntt_matches_pallas_interpret():
    x = _mont(_values(3, 7))
    assert _same(ntt.ntt(3, x, True), ntt_pallas(3, _jax(x), True))


def test_coset_helpers_match_jax():
    exp = 3
    x = _mont(_values(exp, 3))
    jx = _jax(x)
    assert _same(ntt.distribute_powers(exp, x, 11), jntt.distribute_powers(exp, jx, 11))
    assert _same(ntt.coset_ntt(exp, x), jntt.coset_ntt(exp, jx))
    assert _same(ntt.icoset_ntt(exp, x), jntt.icoset_ntt(exp, jx))
    assert _same(ntt.divide_by_z_on_coset(exp, x), jntt.divide_by_z_on_coset(exp, jx))


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_host_dft(inverse):
    for exp in range(9):
        vals = _values(exp, 100 + exp)
        d = ntt.Domain(exp)
        w = d.omegainv if inverse else d.omega
        m = d.m
        pw = [pow(w, i, R_MOD) for i in range(m)]
        want = [sum(v * pw[j * k % m] for j, v in enumerate(vals)) % R_MOD for k in range(m)]
        if inverse:
            want = [v * d.minv % R_MOD for v in want]
        got = convert.limbs_to_ints(fp.from_mont(CTX, ntt.ntt(exp, _mont(vals), inverse)))
        assert got == want, exp


def test_domain_matches_jax():
    for exp in (0, 1, 5, 18, 24, 28):
        d, j = ntt.Domain(exp), jntt.Domain(exp)
        for name in ("exp", "m", "omega", "omegainv", "minv", "gen", "geninv"):
            assert getattr(d, name) == getattr(j, name), (exp, name)
    with pytest.raises(ValueError):
        ntt.Domain(29)


def test_ntt_takes_exp_up_to_24():
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        ntt.ntt(25, torch.zeros((1, 16), dtype=torch.int64), False)
    assert torch.equal(ntt.ntt(0, _mont([5]), True), _mont([5]))


def test_fr_constants_match_refimpl():
    """FR_P, FR_PINV and FR_ONE of csrc/constants.cuh, parsed from the file,
    against the refimpl integers (and FQ_PINV, their Fq twin)."""
    from phase2_bn254_tpu_torch.refimpl.field import Q

    with open(os.path.join(_build.CSRC, "constants.cuh")) as f:
        text = f.read()
    arrays = {name: sum(int(v, 16) << (32 * i) for i, v in enumerate(re.findall(r"0x([0-9a-f]{8})u", body)))
              for name, body in re.findall(r"uint32_t (\w+)\[8\] = \{([^}]*)\}", text)}
    scalars = {name: int(v, 16) for name, v in re.findall(r"uint32_t (\w+) = 0x([0-9a-f]{8})u", text)}
    assert arrays["FR_P"] == R_MOD
    assert arrays["FR_ONE"] == (1 << 256) % R_MOD
    assert scalars["FR_PINV"] * R_MOD % (1 << 32) == (1 << 32) - 1
    assert arrays["FQ_P"] == Q and scalars["FQ_PINV"] * Q % (1 << 32) == (1 << 32) - 1


_HOST_SHIM = r"""
#include <cstdint>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "ntt.cu"
// One pass, the blocks' rows one after another and each loop of the kernel
// run in order (what the barriers between them guarantee on the card).
extern "C" void host_lane_dft(const int64_t* in, int64_t* out, const int64_t* stage_tw, const int64_t* tw_lo,
                              const int64_t* tw_hi, int rows, int log2c, int lo_bits, int irs, int ics, int ors,
                              int ocs) {
  const int c = 1 << log2c;
  std::vector<Fr> s(c);
  for (int64_t row = 0; row < rows; ++row) {
    for (int j = 0; j < c; ++j) dft_load(s.data(), in, row, j, log2c, irs, ics);
    for (int st = 1; st <= log2c; ++st)
      for (int b = 0; b < c / 2; ++b) dft_butterfly(s.data(), stage_tw, log2c, st, b);
    for (int k = 0; k < c; ++k) dft_store(s.data(), out, row, k, ors, ocs, tw_lo, tw_hi, lo_bits);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("ntt_shim")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(d / "shim.so")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(d / "shim.so"))


def _passes(exp: int, inverse: bool):
    """The two passes of `ntt` at exp: (rows, log2c, strides, tables)."""
    log2r = exp // 2
    log2c = exp - log2r
    r, c = 1 << log2r, 1 << log2c
    stage1, lo, hi, stage2 = ntt._tables(exp, inverse, torch.device("cpu"))
    return [(r, log2c, (1, r, 1, r), stage1, lo, hi, log2c), (c, log2r, (r, 1, 1, c), stage2, None, None, 0)]


@pytest.mark.parametrize("exp,inverse", [(5, True), (6, False)])
def test_cuda_source_on_host_matches_plain(exp, inverse, host_lib):
    """csrc/ntt.cu's per-element functions compiled by g++ (CUDA qualifiers
    defined away), run on the CPU, pass by pass, against the plain pass."""
    x = _mont(_values(exp, 55 + exp))
    for rows, log2c, strides, stage, lo, hi, lo_bits in _passes(exp, inverse):
        want = ntt.lane_dft_plain(x, rows, log2c, *strides, stage, lo, hi, lo_bits)
        got = torch.empty_like(x)
        ptr = [ctypes.c_void_p(t.data_ptr() if t is not None else None) for t in (x, got, stage, lo, hi)]
        host_lib.host_lane_dft(*ptr, rows, log2c, lo_bits, *strides)
        assert torch.equal(got, want)
        x = want
    assert torch.equal(x, ntt.ntt(exp, _mont(_values(exp, 55 + exp)), inverse))


def test_wrapper_takes_no_other_device():
    x = torch.zeros((8, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ntt.lane_dft(x, 2, 2, 1, 2, 1, 2, x[:2])


@pytest.mark.gpu
@pytest.mark.parametrize("exp", [1, 2, 3, 10])
def test_kernel_matches_plain_on_gpu(exp):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _mont(_values(exp, 77 + exp))
    for inverse in (False, True):
        want = ntt.ntt(exp, x, inverse)
        before = ntt.LAUNCHES["lane_dft"]
        got = ntt.ntt(exp, x.cuda(), inverse)
        assert ntt.LAUNCHES["lane_dft"] == before + (1 if exp == 1 else 2)
        assert torch.equal(got.cpu(), want)
