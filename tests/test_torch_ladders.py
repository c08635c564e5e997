"""The ceremony's other ladder configurations in the port, on the CPU: the
unsigned GLV ladder K7, the plain G1 ladder K8 and the unsigned GLS ladder
K10, and the PHASE2_TPU_NO_GLV / NO_GLS / NO_SIGNED5 switches that select
them, against the JAX package and refimpl.

* `glv.decompose` / `gls.decompose` (the unsigned splits) against
  `glv_device.decompose_device_t` / `gls_device.decompose_device_t` (plain
  XLA, jitted on the CPU) digit for digit, and against the host recodes
  `pallas_exp.glv_digit_arrays` / `gls_device.gls_digit_arrays` everywhere
  but the Babai tie r // 2, where the Barrett quotient and the host's exact
  rounding pick different, equally valid splits;
* the plain K7, K8 and K10 against refimpl `Point.mul` after normalizing, at
  the edge scalars of tests/test_torch_batch_exp.py and random ones;
* the CUDA sources' per-point code (csrc/batch_exp_glv.cu,
  batch_exp_g1_windowed.cu, batch_exp_gls.cu) compiled with g++ against the
  plain versions, limb for limb; K7's and K10's per-lane start, their
  tables (mixed adds, only where a digit above 1 occurs) and their skipped
  adds of zero digits on lanes that take each path (k = 0 under any sign
  flags, 1, r - 1, late first windows), also against refimpl; ladders.cuh's
  windowed ladder (K8 and K9) on the edge scalars of its recoding and its
  per-thread start, also against refimpl;
* `Ladders.from_env` over the eight combinations of the three variables,
  against the table of the JAX package's `ops/backend.py:133-172` and
  `ops/segsum.py:104-115`;
* `compute_constrained` at size 4, batch 16, under PHASE2_TPU_NO_SIGNED5
  (K7 + K10) and under PHASE2_TPU_NO_GLV + NO_GLS (K8 + K9): the golden
  response tests/fixtures/golden_response_s4_b16.bin, which the default
  ladders also write;
* the phase-2 `new` under PHASE2_TPU_NO_SIGNED5 (the QAP terms on K7) on
  tests/test_torch_phase2.py's two circuits: the JAX package's bytes, and
  `new` + `contribute` give tests/fixtures/golden_params_s3.bin;
* the card-only half (K7, K8 and K10 against their plain versions, the
  size-10 parity, scripts/fixtures' `new`) is in
  tests/test_torch_ladders_gpu.py, which imports no JAX.

The Pallas kernels are not run in interpret mode (the JAX package gates its
own K10 interpreter test behind PHASE2_TPU_XSLOW_TESTS). Tolerance: exact
equality of every digit, limb and byte.
"""

import ctypes
import json
import os
import random
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase2_bn254_tpu.ceremony.prepare import prepare_phase2
from phase2_bn254_tpu.cli.phase1 import contribute as p1_contribute
from phase2_bn254_tpu.cli.phase1 import new_challenge, participant_rng
from phase2_bn254_tpu.field import fp as jfp
from phase2_bn254_tpu.ops import gls_device, glv_device, pallas_exp
from phase2_bn254_tpu.phase2 import mpc as jmpc
from phase2_bn254_tpu.phase2.circom import CircomCircuit as JCircomCircuit
from phase2_bn254_tpu.refimpl.backend import ExactBackend
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.cli import phase1, phase2
from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
from phase2_bn254_tpu_torch.curve import group as G
from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
from phase2_bn254_tpu_torch.ops import _build, batch_exp, gls, glv
from phase2_bn254_tpu_torch.ops.backend import Ladders, TorchBackend
from phase2_bn254_tpu_torch.phase2 import mpc
from phase2_bn254_tpu_torch.phase2.circom import CircomCircuit
from phase2_bn254_tpu_torch.refimpl import gls as rgls
from phase2_bn254_tpu_torch.refimpl.field import R_MOD
from phase2_bn254_tpu_torch.refimpl.glv import LAMBDA
from test_torch_ladders_gpu import (
    CONFIGS, EDGE, LADDERS, REPO, SEED, TIE, USES, VARIABLES, WRAPPERS, _scalars, ladder_inputs, set_config,
)

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden_response_s4_b16.bin")
GOLDEN_PARAMS = os.path.join(REPO, "tests", "fixtures", "golden_params_s3.bin")


def _jax_t(vals):
    """Canonical ints -> the JAX transposed uint32 (16, N) layout."""
    return jnp.asarray(np.stack([jfp.int_to_limbs(v) for v in vals]).T)


def _value(col) -> int:
    """MSB-first 4-bit windows -> integer."""
    v = 0
    for d in col:
        v = (v << 4) + int(d)
    return v


def _signed(col, neg) -> int:
    return -_value(col) if neg else _value(col)


# ---------------------------------------------------------------------------
# the unsigned splits
# ---------------------------------------------------------------------------

def test_glv_decompose_matches_jax_and_host_recode():
    vals = EDGE + _scalars(3, 32)
    d1, d2, negs = glv.decompose(convert.ints_to_limbs(vals, "cpu"))
    assert d1.shape == d2.shape == (glv.WINDOWS4, len(vals)) == (33, len(vals))
    assert negs.shape == (2, len(vals))
    off_tie = np.array([v != TIE for v in vals])
    for got, dev, host in zip((d1, d2, negs), glv_device.decompose_device_t(_jax_t(vals)),
                              pallas_exp.glv_digit_arrays(vals)):
        assert np.array_equal(got.numpy(), np.asarray(dev))
        assert np.array_equal(got.numpy()[:, off_tie], host[:, off_tie])
    assert not off_tie.all()  # the tie is among the inputs
    for i, k in enumerate(vals):
        assert (_signed(d1[:, i], negs[0, i]) + _signed(d2[:, i], negs[1, i]) * LAMBDA - k) % R_MOD == 0


def test_gls_decompose_matches_jax_and_host_recode():
    vals = EDGE + _scalars(4, 32)
    digits, negs = gls.decompose(convert.ints_to_limbs(vals, "cpu"))
    assert digits.shape == (4, gls.GLS_WINDOWS, len(vals)) == (4, 17, len(vals))
    assert negs.shape == (4, len(vals))
    jd, jn = gls_device.decompose_device_t(_jax_t(vals))
    assert np.array_equal(digits.numpy(), np.asarray(jd)) and np.array_equal(negs.numpy(), np.asarray(jn))
    hd, hn = gls_device.gls_digit_arrays(vals)
    off_tie = np.array([v != TIE for v in vals])
    assert np.array_equal(digits.numpy()[..., off_tie], hd[..., off_tie])
    assert np.array_equal(negs.numpy()[:, off_tie], hn[:, off_tie])
    for i, k in enumerate(vals):
        total = sum(_signed(digits[c, :, i], negs[c, i]) * pow(rgls.LAMBDA, c, R_MOD) for c in range(4))
        assert (total - k) % R_MOD == 0


# ---------------------------------------------------------------------------
# the plain ladders and the CUDA sources' per-point code
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ladder_cases():
    """Per ladder: points, scalars (edge and two random), the inputs and the
    plain version's output."""
    out = {}
    for name, (_, wrapper, _) in LADDERS.items():
        pts, vals, aff, inputs = ladder_inputs(name, "cpu")
        out[name] = (pts, vals, aff, inputs, wrapper(aff.x, aff.y, *inputs))
    return out


@pytest.mark.parametrize("name", sorted(LADDERS))
def test_plain_ladder_matches_refimpl(ladder_cases, name):
    pts, vals, _, _, jac = ladder_cases[name]
    group = LADDERS[name][0]
    aff = G.jac_normalize(FQ if group == "g1" else FQ2, jac)
    assert convert.affine_to_points(aff, group) == [p.mul(s) for p, s in zip(pts, vals)]


_HOST_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "batch_exp_g1_windowed.cu"
#include "batch_exp_g2_windowed.cu"
#include "batch_exp_glv.cu"
#include "batch_exp_gls.cu"
extern "C" void host_k8(const int64_t* x, const int64_t* y, const int64_t* k, int64_t* ox, int64_t* oy,
                        int64_t* oz, int n) {
  for (int i = 0; i < n; ++i) batch_exp_g1_windowed_point(x, y, k, ox, oy, oz, i);
}
extern "C" void host_k9(const int64_t* x, const int64_t* y, const int64_t* k, int64_t* ox, int64_t* oy,
                        int64_t* oz, int n) {
  for (int i = 0; i < n; ++i) batch_exp_g2_windowed_point(x, y, k, ox, oy, oz, i);
}
extern "C" void host_k7(const int64_t* x, const int64_t* y, const int64_t* d1, const int64_t* d2,
                        const int64_t* negs, int64_t* ox, int64_t* oy, int64_t* oz, int n, int nw) {
  for (int i = 0; i < n; ++i)
    batch_exp_glv_point<Fp>(x, y, d1, d2, negs, fp_from_const(GLV_BETA), ox, oy, oz, i, n, nw);
}
extern "C" void host_k10(const int64_t* x, const int64_t* y, const int64_t* d, const int64_t* negs,
                         int64_t* ox, int64_t* oy, int64_t* oz, int n, int nw) {
  for (int i = 0; i < n; ++i) batch_exp_gls_point(x, y, d, negs, ox, oy, oz, i, n, nw);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("ladders_shim")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(d / "shim.so")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(d / "shim.so"))


@pytest.mark.parametrize("name", sorted(LADDERS))
def test_cuda_sources_arithmetic_on_host_matches_plain(ladder_cases, host_lib, name):
    """The .cu per-point function compiled by g++ (CUDA qualifiers defined
    away), limb for limb with the plain version."""
    _, vals, aff, inputs, want = ladder_cases[name]
    out = [torch.empty_like(aff.x) for _ in range(3)]
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (aff.x, aff.y, *inputs, *out)]
    windows = [] if name == "k8" else [ctypes.c_int(inputs[0].shape[-2])]
    getattr(host_lib, f"host_{name}")(*ptrs, ctypes.c_int(len(vals)), *windows)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


def _host_ladder(fn, aff, inputs) -> list:
    """The per-point function `fn` of the g++ shim over every lane."""
    out = [torch.empty_like(aff.x) for _ in range(3)]
    fn(*[ctypes.c_void_p(t.data_ptr()) for t in (aff.x, aff.y, *inputs, *out)], ctypes.c_int(aff.x.shape[0]),
       ctypes.c_int(inputs[0].shape[-2]))
    return out


def _random_points(group: str, n: int, seed: str):
    from phase2_bn254_tpu_torch.refimpl import curve as rc

    rng = random.Random(seed)
    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    pts = [gen.mul(rng.randrange(1, R_MOD)) for _ in range(n)]
    return pts, convert.points_to_affine(pts, group, "cpu")


def _mixed_table(f, aff, size: int = 16) -> list:
    """T[0..size-1] by one doubling and mixed adds of the affine P, as the
    kernels build it."""
    n = aff.x.shape[0]
    table = [G.jac_zero(f, (n,), "cpu"), G.JacobianBatch(aff.x, aff.y, f.ones((n,), "cpu"))]
    table.append(G.jac_double(f, table[1]))
    for _ in range(3, size):
        table.append(G.jac_madd(f, table[-1], aff.x, aff.y))
    return table


# the redesigned K7 and K10 on lanes that take each of their paths: k = 0 (no
# nonzero digit: the last window alone), 1 and r - 1 (new's terms: no table,
# one add), a lane whose nonzero digits are all in d2 (K7) or in row 3 (K10),
# small scalars whose first nonzero window comes late and differs from lane
# to lane, the Babai tie, two random scalars
def _redesign_lanes(only_last_part: int) -> list[int]:
    return ([0, 1, R_MOD - 1, only_last_part, 3 * only_last_part % R_MOD, 31, 1023, (1 << 40) + 1, 1 << 70,
             1 << 100, TIE] + _scalars(15, 2))


def test_k7_table_and_first_window_on_host(host_lib):
    """K7's table by one doubling and mixed adds equals the table by general
    adds limb for limb; its per-lane start (a lane without a nonzero digit
    from the last window), its table and beta x only where the digits reach
    them and its skipped adds of T[0] give the plain version's limbs (the
    plain version starts the batch at its first live window), the negs lanes
    included, also on a batch whose every scalar is 0 (under each pair of
    sign flags); k P equals refimpl's."""
    vals = _redesign_lanes(LAMBDA)
    pts, aff = _random_points("g1", len(vals), "k7 redesign")
    general = batch_exp._table(FQ, aff.x, aff.y, 16)
    assert all(torch.equal(torch.stack(a), b) for a, b in zip(zip(*_mixed_table(FQ, aff)), general))
    d1, d2, negs = glv.decompose(convert.ints_to_limbs(vals, "cpu"))
    assert bool((d1[:, 3] == 0).all()) and bool((d2[:, 3] != 0).any())  # only d2 on LAMBDA's lane
    live = (d1 != 0) | (d2 != 0)
    first = torch.where(live.any(0), live.int().argmax(0), d1.shape[0] - 1)
    assert len(set(first.tolist())) > 3 and bool(negs.any())
    want = batch_exp.batch_exp_glv_plain(aff.x, aff.y, d1, d2, negs)
    assert all(torch.equal(a, b) for a, b in zip(_host_ladder(host_lib.host_k7, aff, (d1, d2, negs)), want))
    got = convert.affine_to_points(G.jac_normalize(FQ, G.JacobianBatch(*want)), "g1")
    assert got == [p.mul(k) for p, k in zip(pts, vals)]
    # k = 0 under each pair of sign flags (the split gives none; the kernel takes any)
    zero = G.AffineBatch(aff.x[:4], aff.y[:4], aff.inf[:4])
    inputs = (*glv.decompose(convert.ints_to_limbs([0] * 4, "cpu"))[:2], torch.tensor([[0, 1, 0, 1], [0, 0, 1, 1]]))
    want = batch_exp.batch_exp_glv_plain(zero.x, zero.y, *inputs)
    assert all(torch.equal(a, b) for a, b in zip(_host_ladder(host_lib.host_k7, zero, inputs), want))
    assert bool(G.jac_normalize(FQ, want).inf.all())


def test_k10_table_and_first_window_on_host(host_lib):
    """K10's table by one doubling and mixed adds over Fq2 equals the table
    by general adds limb for limb; its per-lane start (a lane without a
    nonzero digit in any row from the last window), its table only where a
    digit above 1 occurs and its skipped psi and adds of T[0] give the plain
    version's limbs, the negs lanes included, also on a batch whose every
    scalar is 0 (under sign flags in every row); k Q equals refimpl's."""
    vals = _redesign_lanes(pow(rgls.LAMBDA, 3, R_MOD))
    pts, aff = _random_points("g2", len(vals), "k10 redesign")
    general = batch_exp._table(FQ2, aff.x, aff.y, 16)
    assert all(torch.equal(torch.stack(a), b) for a, b in zip(zip(*_mixed_table(FQ2, aff)), general))
    digits, negs = gls.decompose(convert.ints_to_limbs(vals, "cpu"))
    assert bool((digits[:3, :, 3] == 0).all()) and bool((digits[3, :, 3] != 0).any())  # only row 3
    live = (digits != 0).any(0)
    first = torch.where(live.any(0), live.int().argmax(0), digits.shape[1] - 1)
    assert len(set(first.tolist())) > 3 and bool(negs.any())
    want = batch_exp.batch_exp_gls_plain(aff.x, aff.y, digits, negs)
    assert all(torch.equal(a, b) for a, b in zip(_host_ladder(host_lib.host_k10, aff, (digits, negs)), want))
    got = convert.affine_to_points(G.jac_normalize(FQ2, G.JacobianBatch(*want)), "g2")
    assert got == [p.mul(k) for p, k in zip(pts, vals)]
    # k = 0 under sign flags in every row (the split gives none; the kernel takes any)
    zero = G.AffineBatch(aff.x[:4], aff.y[:4], aff.inf[:4])
    inputs = (gls.decompose(convert.ints_to_limbs([0] * 4, "cpu"))[0],
              torch.tensor([[0, 1, 0, 1], [1, 0, 0, 1], [0, 1, 1, 0], [0, 0, 1, 1]]))
    want = batch_exp.batch_exp_gls_plain(zero.x, zero.y, *inputs)
    assert all(torch.equal(a, b) for a, b in zip(_host_ladder(host_lib.host_k10, zero, inputs), want))
    assert bool(G.jac_normalize(FQ2, want).inf.all())


# ladders.cuh's windowed ladder at the edges of its recoding and its start:
# k <= (r - 1)/2 runs as it is, k above as (r - k)(-P); one window, small
# digits (a table built up to 1, 2, 15 or 16 = 1 0), a single high bit
WINDOWED_EDGE = [0, 1, 2, 15, 16, 1 << 5, 1 << 64, 1 << 128, 1 << 253, (R_MOD - 1) // 2, (R_MOD + 1) // 2,
                 R_MOD - 2, R_MOD - 1, R_MOD - 16, R_MOD - (1 << 100)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_windowed_ladder_edge_scalars_on_host(host_lib, group):
    """K8 (G1) and K9 (G2), csrc/ladders.cuh windowed_ladder_point compiled
    by g++, on WINDOWED_EDGE: limb for limb with the plain version (which
    takes the same recoding), and k P against refimpl after normalizing."""
    import random

    from phase2_bn254_tpu_torch.refimpl import curve as rc

    rng = random.Random(f"windowed {group}")
    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    pts = [gen.mul(rng.randrange(1, R_MOD)) for _ in WINDOWED_EDGE]
    aff = convert.points_to_affine(pts, group, "cpu")
    k = convert.ints_to_limbs(WINDOWED_EDGE, "cpu")
    plain = batch_exp.batch_exp_g1_windowed if group == "g1" else batch_exp.batch_exp_g2_windowed
    want = plain(aff.x, aff.y, k)
    out = [torch.empty_like(aff.x) for _ in range(3)]
    getattr(host_lib, "host_k8" if group == "g1" else "host_k9")(
        *[ctypes.c_void_p(t.data_ptr()) for t in (aff.x, aff.y, k, *out)], ctypes.c_int(len(WINDOWED_EDGE)))
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    got = convert.affine_to_points(G.jac_normalize(FQ if group == "g1" else FQ2, G.JacobianBatch(*out)), group)
    assert got == [p.mul(v) for p, v in zip(pts, WINDOWED_EDGE)]
    recoded, neg = batch_exp.half_recode(k)
    assert neg.tolist() == [v > (R_MOD - 1) // 2 for v in WINDOWED_EDGE]
    assert convert.limbs_to_ints(recoded) == [min(v, R_MOD - v) if v else 0 for v in WINDOWED_EDGE]


def test_wrappers_take_no_other_device():
    x1 = torch.zeros((2, 16), dtype=torch.int64, device="meta")
    x2 = torch.zeros((2, 2, 16), dtype=torch.int64, device="meta")
    d = torch.zeros((33, 2), dtype=torch.int64, device="meta")
    n2 = torch.zeros((2, 2), dtype=torch.int64, device="meta")
    for call in (lambda: batch_exp.batch_exp_glv(x1, x1, d, d, n2),
                 lambda: batch_exp.batch_exp_g1_windowed(x1, x1, x1),
                 lambda: batch_exp.batch_exp_gls(x2, x2, torch.zeros((4, 17, 2), dtype=torch.int64, device="meta"),
                                                 torch.zeros((4, 2), dtype=torch.int64, device="meta"))):
        with pytest.raises(ValueError, match="no kernel"):
            call()
    k = convert.ints_to_limbs([1], "cpu")
    for pick in (batch_exp.batch_exp_g1, batch_exp.batch_exp_g2):
        with pytest.raises(ValueError, match="no G"):
            pick("glv_signed5", k, k, k)


# ---------------------------------------------------------------------------
# the switches
# ---------------------------------------------------------------------------

# (NO_GLV, NO_GLS, NO_SIGNED5) -> (G1 pow_mul, G2 pow_mul, phase-2 G1 terms),
# written from the JAX package's ops/backend.py:133-172 (G1: NO_GLV before
# NO_SIGNED5; G2: NO_GLS before NO_SIGNED5) and ops/segsum.py:104-115 (the
# terms follow NO_SIGNED5 alone; G2 terms always take the windowed ladder)
JAX_TABLE = {
    (False, False, False): ("glv_signed", "gls_signed", "glv_signed"),
    (False, False, True): ("glv", "gls", "glv"),
    (False, True, False): ("glv_signed", "windowed", "glv_signed"),
    (False, True, True): ("glv", "windowed", "glv"),
    (True, False, False): ("windowed", "gls_signed", "glv_signed"),
    (True, False, True): ("windowed", "gls", "glv"),
    (True, True, False): ("windowed", "windowed", "glv_signed"),
    (True, True, True): ("windowed", "windowed", "glv"),
}


@pytest.mark.parametrize("flags", sorted(JAX_TABLE), ids=lambda f: "".join("01"[b] for b in f))
def test_ladders_from_env_follow_the_jax_package(flags):
    environ = {"PATH": "/bin", **{v: "1" for v, on in zip(VARIABLES, flags) if on}}
    got = Ladders.from_env(environ)
    assert (got.g1, got.g2, got.terms_g1) == JAX_TABLE[flags]
    # a variable set to the empty string counts as unset, as os.environ.get's truthiness has it
    assert Ladders.from_env({v: "" for v in VARIABLES}) == Ladders() == Ladders.from_env({})


def _spy(monkeypatch, *names) -> dict:
    """Count the calls of the named batch_exp wrappers (on the CPU the
    kernels' LAUNCHES do not move)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(batch_exp, name)

        def counted(*a, _name=name, _fn=fn, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(batch_exp, name, counted)
    return calls


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_golden_response_under_each_configuration(tmp_path, monkeypatch, config):
    """The contribute tool under the configuration's variables writes the
    golden response (the default ladders' bytes), through its ladders only."""
    set_config(monkeypatch, config)
    calls = _spy(monkeypatch, *WRAPPERS)
    challenge, response = str(tmp_path / "challenge"), str(tmp_path / "response")
    phase1.new_constrained(challenge, 4, 16)
    phase1.compute_constrained(challenge, response, 4, 16, ChaChaRng.from_digest_be(SEED), "cpu")
    with open(response, "rb") as got, open(GOLDEN, "rb") as want:
        assert got.read() == want.read()
    assert {name for name, n in calls.items() if n} == USES[config]


# ---------------------------------------------------------------------------
# phase 2: the QAP terms on K7
# ---------------------------------------------------------------------------

# tests/test_torch_phase2.py's circuits: aux2 * aux3 == out, and a 3-bit
# Num2Bits as circom compiles it (r - 1 on ONE in B, 2^i in C)
_M1 = str(R_MOD - 1)
CIRCUITS = {
    "mul": {"constraints": [[{"2": "1"}, {"3": "1"}, {"1": "1"}]], "nPubInputs": 0, "nOutputs": 1, "nVars": 4},
    "num2bits": {"constraints": [[{str(2 + i): "1"}, {str(2 + i): "1", "0": _M1}, {}] for i in range(3)]
                 + [[{}, {}, {"2": "1", "3": "2", "4": "4", "1": _M1}]],
                 "nPubInputs": 1, "nOutputs": 0, "nVars": 5},
}


@pytest.fixture(scope="module")
def radix_dir(tmp_path_factory):
    """Radix files of a size-3 phase-1 ceremony on the JAX package's exact
    backend (tests/test_golden_phase2.py's), and the circuits' JSON."""
    d = tmp_path_factory.mktemp("radix")
    new_challenge(str(d / "c1"), 3, 4)
    p1_contribute(str(d / "c1"), str(d / "r1"), 3, 4, participant_rng("golden phase2", system_entropy=bytes(1024)),
                  backend=ExactBackend())
    prepare_phase2(str(d / "r1"), 3, 4, ExactBackend(), out_dir=str(d))
    for name, circuit in CIRCUITS.items():
        (d / f"{name}.json").write_text(json.dumps(circuit))
    return d


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_new_under_no_signed5_matches_jax(radix_dir, tmp_path, monkeypatch, name):
    """The `new` tool under PHASE2_TPU_NO_SIGNED5 runs the G1 terms on K7 (and
    K9 for G2, as always) and writes the JAX package's bytes."""
    set_config(monkeypatch, "no_signed5")
    calls = _spy(monkeypatch, *WRAPPERS)
    phase2.new(str(radix_dir / f"{name}.json"), str(tmp_path / "out.params"), str(radix_dir), "cpu")
    assert {w for w, n in calls.items() if n} == {"batch_exp_glv", "batch_exp_g2_windowed"}
    want = jmpc.MPCParameters.new(JCircomCircuit.from_json(CIRCUITS[name]), False,
                                  lambda exp: str(radix_dir / f"phase1radix2m{exp}"))
    with open(tmp_path / "out.params", "rb") as f:
        assert f.read() == want.write()


def test_golden_params_under_no_signed5(radix_dir, monkeypatch):
    """new (filtered) + contribute with the fixed seed on a backend built
    from the environment give tests/fixtures/golden_params_s3.bin."""
    set_config(monkeypatch, "no_signed5")
    be = TorchBackend("cpu")
    assert be.ladders.terms_g1 == "glv"
    mp = mpc.MPCParameters.new(CircomCircuit.from_json(CIRCUITS["mul"]), True,
                               lambda exp: str(radix_dir / f"phase1radix2m{exp}"), be)
    mp.contribute(ChaChaRng.from_digest_be(bytes(range(64))), be)
    with open(GOLDEN_PARAMS, "rb") as f:
        assert mp.write() == f.read()


def test_tool_backend_reads_the_environment(monkeypatch):
    """The tools' backend, TorchBackend(device), takes the ladders that the
    environment selects; ladders given to it win."""
    set_config(monkeypatch, "no_glv_no_gls")
    assert TorchBackend("cpu").ladders == Ladders("windowed", "windowed", "glv_signed")
    assert TorchBackend("cpu", Ladders()).ladders == Ladders()
