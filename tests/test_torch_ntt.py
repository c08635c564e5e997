"""The port's Fr NTT (ops/ntt.py, kernel K6 in csrc/ntt.cu) on the CPU.

* `ntt` (its K6 passes in their plain versions) against the JAX
  package's `ops.ntt._ntt_xla` at exp 1, 5 and 6, forward and inverse, and
  against `ntt_pallas` in interpret mode at exp 3 (odd exp: pass lengths 4
  and 2, the inverse's 1/m folded into the first pass);
* the pass plan at every exp 0-28, and the k-pass driver `four_step` with a
  forced three-pass plan at exp 6, 7 and 9, both directions, against
  `_ntt_xla`; at exp 25 and 28 `ntt` reaches its kernel (meta tensors: the
  wrapper's "no kernel" error, not a cap);
* `coset_ntt`, `icoset_ntt` (and its divide_by_z form, the prover's),
  `distribute_powers` and `divide_by_z_on_coset` against the JAX functions
  at exp 3; the folded coset passes at exp 5 and at exp 6 with three passes
  against `_ntt_xla` with the coset factors applied on host integers;
* `ntt` against a direct DFT on host integers at exp 0-8, both directions;
* `Domain`'s constants against the JAX package's;
* the Fr constants of csrc/constants.cuh against the refimpl integers;
* the kernel's per-group code (csrc/ntt.cu), compiled for the host with
  g++ and run block by block, phase by phase, against the plain pass: every
  pass of two- and three-pass plans, with the coset factors, int64 and
  packed elements (the kernel itself runs only on a GPU: the `gpu` test).

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


def _ints(t) -> list[int]:
    """Montgomery limbs (torch or JAX) -> canonical ints."""
    return [CTX.from_mont_int(v) for v in convert.limbs_to_ints(torch.as_tensor(np.asarray(t).astype(np.int64)))]


def test_coset_helpers_match_jax():
    """At exp 3 against the JAX helpers themselves; the folded passes at exp
    5 (two passes) and 6 (forced three) against `_ntt_xla` with g^i applied
    to the input and geninv^k / (g^m - 1) to the inverse's output on host
    integers, which is what the JAX helpers compute around it."""
    exp = 3
    x = _mont(_values(exp, 3))
    jx = _jax(x)
    assert _same(ntt.distribute_powers(exp, x, 11), jntt.distribute_powers(exp, jx, 11))
    assert _same(ntt.coset_ntt(exp, x), jntt.coset_ntt(exp, jx))
    assert _same(ntt.icoset_ntt(exp, x), jntt.icoset_ntt(exp, jx))
    assert _same(ntt.divide_by_z_on_coset(exp, x), jntt.divide_by_z_on_coset(exp, jx))
    assert _same(ntt.icoset_ntt(exp, x, divide_by_z=True), jntt.icoset_ntt(exp, jntt.divide_by_z_on_coset(exp, jx)))

    for exp, plan in ((5, None), (6, (2, 2, 2))):
        vals = _values(exp, 30 + exp)
        d = ntt.Domain(exp)
        zinv = pow(pow(ntt.MULT_GEN, d.m, R_MOD) - 1, -1, R_MOD)
        shifted = _mont([v * pow(ntt.MULT_GEN, i, R_MOD) % R_MOD for i, v in enumerate(vals)])
        got = ntt.four_step(exp, _mont(vals), False, plan, pre=ntt.MULT_GEN)
        assert _same(got, jntt._ntt_xla(exp, _jax(shifted), False)), exp
        got = ntt.four_step(exp, _mont(vals), True, plan, post=(d.geninv, zinv))
        inverse = _ints(jntt._ntt_xla(exp, _jax(_mont(vals)), True))
        want = [v * pow(d.geninv, k, R_MOD) * zinv % R_MOD for k, v in enumerate(inverse)]
        assert _ints(got) == want, exp
    assert torch.equal(ntt.coset_ntt(5, _mont(_values(5, 35))), ntt.four_step(5, _mont(_values(5, 35)), False, pre=7))


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


def test_pass_plan_covers_every_exp():
    for exp in range(29):
        plan = ntt.pass_plan(exp)
        assert sum(plan) == exp and all(1 <= lc <= 12 for lc in plan), exp
        assert len(plan) == (0 if exp == 0 else 1 if exp == 1 else 2 if exp <= 24 else 3), exp
        assert list(plan) == sorted(plan, reverse=True) and max(plan, default=0) - min(plan, default=0) <= 1
    assert ntt.pass_plan(28) == (10, 9, 9) and ntt.pass_plan(24) == (12, 12)
    assert ntt.device_bytes(28) == 160 << 28 and ntt.device_bytes(1) == 128 * 2
    with pytest.raises(ValueError):
        ntt.pass_plan(29)


@pytest.mark.parametrize("exp,plan", [(6, (2, 2, 2)), (7, (3, 2, 2)), (9, (3, 3, 3))])
@pytest.mark.parametrize("inverse", [False, True])
def test_three_passes_match_jax_xla(exp, plan, inverse):
    x = _mont(_values(exp, 90 + exp))
    assert _same(ntt.four_step(exp, x, inverse, plan), jntt._ntt_xla(exp, _jax(x), inverse))


def test_ntt_takes_every_exp_to_28():
    """No cap: above 24 `ntt` plans three passes and goes to the kernel (on
    meta tensors the wrapper raises for the device, where it raised
    NotImplementedError before); bad plans and shapes are refused."""
    for exp in (25, 28):
        x = torch.zeros((1 << exp, 16), dtype=torch.int64, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            ntt.ntt(exp, x, False)
    x = _mont(_values(4, 1))
    for plan in ((2, 1), (1, 1, 1, 1), (13, 0)):
        with pytest.raises(ValueError, match="plan"):
            ntt.four_step(4, x, False, plan)
    with pytest.raises(ValueError, match="limbs"):
        ntt.ntt(4, x[:8], False)
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
#include <cstddef>
#include <cstdint>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "ntt.cu"
// One pass: the blocks one after another, each block's phases in order and
// a phase's groups one after another (what the barriers between phases
// guarantee on the card), on the launch's own geometry.
extern "C" void host_lane_dft(const void* in, void* out, const void* stage, const void* tw_lo, const void* tw_hi,
                              const void* fin_lo, const void* fin_hi, const void* fout_lo, const void* fout_hi,
                              int rows, int log2c, int rlo_bits, int tw_bits, int fin_bits, int fout_bits, int in_hi,
                              int in_lo, int in_col, int out_hi, int out_lo, int out_col, int in_packed,
                              int out_packed) {
  NttPass a{in, out, (const uint32_t*)stage, (const uint32_t*)tw_lo, (const uint32_t*)tw_hi,
            (const uint32_t*)fin_lo, (const uint32_t*)fin_hi, (const uint32_t*)fout_lo, (const uint32_t*)fout_hi,
            rows, log2c, rlo_bits, tw_bits, fin_bits, fout_bits, in_hi, in_lo, in_col, out_hi, out_lo, out_col,
            in_packed, out_packed};
  const int block_log = ntt_block_log(log2c, rows);
  std::vector<uint32_t> s((std::size_t)8 << block_log);
  for (int row0 = 0; row0 < rows; row0 += 1 << (block_log - log2c))
    for (int ph = 0; ph < (log2c + 1) / 2; ++ph)
      for (int g = 0; g < ntt_phase_groups(log2c, block_log, ph); ++g) ntt_group(a, s.data(), block_log, row0, ph, g);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("ntt_shim")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(d / "shim.so")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(d / "shim.so"))


def _host_lane(host_lib):
    """A `lane` for ntt.four_step: csrc/ntt.cu's per-group code through the
    g++ shim, in the wrapper's place (in place where four_step asks)."""
    def lane(x, spec, packed_out=False, out=None):
        if out is None:
            out = torch.empty((x.shape[0], 8) if packed_out else (x.shape[0], 16),
                              dtype=torch.int32 if packed_out else torch.int64)
        tables = []
        for f in (spec.twiddle, spec.load, spec.store):
            tables += [None, None, 0] if f is None else [f.lo, f.hi, f.bits]
        ptr = [ctypes.c_void_p(t.data_ptr() if t is not None else None)
               for t in (x, out, spec.stage, tables[0], tables[1], tables[3], tables[4], tables[6], tables[7])]
        host_lib.host_lane_dft(*ptr, spec.rows, spec.log2c, spec.rlo_bits, tables[2], tables[5], tables[8], *spec.ins,
                               *spec.outs, int(x.dtype == torch.int32), int(packed_out))
        return out
    return lane


@pytest.mark.parametrize("exp,inverse", [(5, True), (6, False)])
def test_cuda_source_on_host_matches_plain(exp, inverse, host_lib):
    """csrc/ntt.cu's per-group functions compiled by g++ (CUDA qualifiers
    defined away), run on the CPU, pass by pass, against the plain pass:
    `ntt`'s own plan, the forced three-pass plans (2, 2, exp - 4) and
    (exp - 4, 2, 2), with the coset factors on the input and on the output;
    each pass's output (packed between passes) limb for limb."""
    x = _mont(_values(exp, 55 + exp))
    lane = _host_lane(host_lib)
    d = ntt.Domain(exp)
    for plan in (None, (2, 2, exp - 4), (exp - 4, 2, 2)):
        for pre, post in ((None, None), (ntt.MULT_GEN, None), (None, (d.geninv, 3))):
            passes = ntt._plan_passes(exp, inverse, ntt.pass_plan(exp) if plan is None else plan, pre, post,
                                      torch.device("cpu"))
            y = x
            for p, spec in enumerate(passes):
                want = ntt.lane_dft_plain(y, spec, p < len(passes) - 1)
                got = lane(y, spec, p < len(passes) - 1)
                assert torch.equal(got, want), (plan, pre, post, p)
                y = want
            assert torch.equal(y, ntt.four_step(exp, x, inverse, plan, pre, post))


def test_cuda_source_on_host_big_rows(host_lib):
    """Rows of 2^11 and 2^12 elements (one block a row, 512 groups a phase)
    and 2^3 (128 rows a block), int64 in and out."""
    for exp, plan in ((13, (12, 1)), (14, (11, 3)), (9, (3, 3, 3))):
        x = _mont(_values(exp, exp))
        assert torch.equal(ntt.four_step(exp, x, False, plan, lane=_host_lane(host_lib)),
                           ntt.four_step(exp, x, False, plan)), exp


def test_pack_round_trip():
    x = _mont(_values(6, 4) + [R_MOD - 1, 0, (1 << 31) + 5])
    p = ntt.pack(x)
    assert p.dtype == torch.int32 and p.shape == (x.shape[0], 8)
    assert torch.equal(ntt.unpack(p), x)
    assert [int(v) & 0xFFFFFFFF for v in p[-1]] == [(CTX.to_mont_int((1 << 31) + 5) >> (32 * i)) & 0xFFFFFFFF
                                                    for i in range(8)]


def test_wrapper_takes_no_other_device():
    x = torch.zeros((8, 16), dtype=torch.int64, device="meta")
    spec = ntt.Pass(rows=2, log2c=2, rlo_bits=1, ins=(0, 1, 2), outs=(0, 1, 2), stage=x[:2])
    with pytest.raises(ValueError, match="no kernel"):
        ntt.lane_dft(x, spec)
    with pytest.raises(ValueError, match="leave"):
        ntt.lane_dft(x, spec._replace(ins=(0, 1, 4)))
    with pytest.raises(ValueError, match="in place"):
        ntt.lane_dft(x, spec._replace(outs=(0, 2, 1)), out=x)


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
        assert ntt.LAUNCHES["lane_dft"] == before + len(ntt.pass_plan(exp))
        assert torch.equal(got.cpu(), want)
    if exp >= 3:  # three passes, the coset factors folded in
        plan = (1, 1, exp - 2)
        for inverse, pre, post in ((False, ntt.MULT_GEN, None), (True, None, (ntt.Domain(exp).geninv, 3))):
            want = ntt.four_step(exp, x, inverse, plan, pre, post)
            assert torch.equal(ntt.four_step(exp, x.cuda(), inverse, plan, pre, post).cpu(), want)
