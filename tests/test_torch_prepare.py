"""The port's phase-1 -> phase-2 bridge on the CPU (plain versions), held
against the JAX package's host path (`refimpl.backend.ExactBackend`, no XLA
compile):

* `ceremony.streaming.group_intt_streamed` (the in-core path: N1 a stage,
  N2 for 1/N, the batched normalization) and `TorchBackend.group_intt`
  against `ExactBackend.group_intt` at exp 0-3 on G1 and G2, for a random
  vector, a vector of equal points (the generator: it must come out as (G,
  inf, ..., inf)) and one with a point at infinity, stacked as the three G1
  vectors of a degree are;
* the four-step with a forced one-row block against the in-core path at exp
  3 and 4 (G1);
* `prepare_phase2` on a size-2 response of the JAX package's
  `cli.phase1.contribute(..., backend=ExactBackend())`: every
  `phase1radix2m{m}` byte-equal to the JAX `prepare_phase2(...,
  ExactBackend())` (size 2, not 3: through the plain ladders on one CPU
  thread a size-3 prepare takes some 40 s, a size-2 one 20 s);
* `reduce_powers`: the JAX function's bytes and hash;
* `cli.transcript.verify_transcript` over a two-round size-3 transcript
  (on the port's `ExactBackend`, as the JAX function runs on its own):
  the JAX function's hashes, and a tampered round rejected with the same
  round number;
* `phase2.portable.contribute`: the JAX function's bytes and hash for the
  same .params and entropy;
* `prepare_phase2`, `reduce_powers` and `verify_transcript` through `python
  -m phase2_bn254_tpu_torch ... --device cpu` in a process where neither
  `jax` nor `phase2_bn254_tpu` can be imported (as in
  tests/test_torch_contribute.py), at size 1: the JAX package's radix and
  reduced bytes, and the transcript accepted;
* N1 and N2's per-pair and per-point code (csrc/group_ntt.cu) compiled by
  g++ against the plain versions, limb for limb, on the inputs of
  tests/test_torch_group_ntt_gpu.py (edge scalars, equal points,
  infinities).

Inputs come from numpy seeds. Tolerance: exact equality of bytes, integers
and limbs.
"""

import ctypes
import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from phase2_bn254_tpu.ceremony.params import CeremonyParams
from phase2_bn254_tpu.ceremony.prepare import prepare_phase2 as jprepare_phase2
from phase2_bn254_tpu.ceremony.prepare import reduce_powers as jreduce_powers
from phase2_bn254_tpu.cli.phase1 import contribute as jcontribute
from phase2_bn254_tpu.cli.phase1 import new_challenge, participant_rng
from phase2_bn254_tpu.cli.phase1 import verify_transform as jverify_transform
from phase2_bn254_tpu.cli.transcript import verify_transcript as jverify_transcript
from phase2_bn254_tpu.phase2 import mpc as jmpc
from phase2_bn254_tpu.phase2 import portable as jportable
from phase2_bn254_tpu.phase2.circom import CircomCircuit as JCircomCircuit
from phase2_bn254_tpu.refimpl import curve as jrc
from phase2_bn254_tpu.refimpl.backend import ExactBackend as JExactBackend
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.ceremony import prepare, streaming
from phase2_bn254_tpu_torch.cli import transcript
from phase2_bn254_tpu_torch.ops import _build, ntt
from phase2_bn254_tpu_torch.ops.backend import TorchBackend
from phase2_bn254_tpu_torch.phase2 import portable
from phase2_bn254_tpu_torch.refimpl import curve as rc
from phase2_bn254_tpu_torch.refimpl.backend import ExactBackend
from test_torch_group_ntt_gpu import scalar_case, stage_case

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = TorchBackend("cpu")
MUL_JSON = {"constraints": [[{"2": "1"}, {"3": "1"}, {"1": "1"}]], "nPubInputs": 0, "nOutputs": 1, "nVars": 4}


def _gen(group: str) -> rc.Point:
    return rc.G1_GEN if group == "g1" else rc.G2_GEN


def _vectors(group: str, exp: int, seed: int) -> list[list[rc.Point]]:
    """A random vector, the generator 2^exp times, and a random vector with
    its point 1 (mod 2^exp) at infinity."""
    rng = np.random.default_rng(seed)
    m, gen = 1 << exp, _gen(group)
    rand = [gen.mul(int(k)) for k in rng.integers(1, 1 << 62, size=2 * m)]
    with_inf = rand[m:]
    with_inf[1 % m] = rc.point_zero(group)
    return [rand[:m], [gen] * m, with_inf]


def _host(points: list[rc.Point], group: str) -> streaming.HostPoints:
    return streaming.HostPoints(*convert.points_to_affine(points, group, "cpu"), group)


def _exact_radix(points: list[rc.Point], group: str) -> bytes:
    """JAX ExactBackend's group_intt of the points, as radix-file bytes."""
    size = 64 if group == "g1" else 128
    jpts = [jrc.point_from_bytes(rc.point_to_bytes(p, False), group, False, check=False) for p in points]
    out = JExactBackend().encode_radix(JExactBackend().group_intt(jpts))
    assert len(out) == size * len(points)
    return out


@pytest.fixture(autouse=True)
def _inference():
    """The plain versions outside autograd (a fifth faster on the CPU)."""
    with torch.inference_mode():
        yield


# ---------------------------------------------------------------------------
# the group iNTT
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _in_core(group: str, exp: int):
    """The three `_vectors` and their in-core iNTT, stacked as one call."""
    vecs = _vectors(group, exp, seed=10 + exp)
    with torch.inference_mode():
        return vecs, streaming.group_intt_streamed([_host(v, group) for v in vecs], exp, "cpu")


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_group_intt_matches_exact(group):
    for exp in range(4):
        vecs, got = _in_core(group, exp)
        for name, v, res in zip(("random", "equal", "infinity"), vecs, got):
            assert res == _exact_radix(v, group), (exp, name)
        if exp:  # (G, inf, ..., inf), infinity written as 0x40 and zeros
            size = streaming.POINT_BYTES[group]
            assert got[1] == rc.point_to_bytes(_gen(group), False) + (b"\x40" + bytes(size - 1)) * ((1 << exp) - 1)


def test_backend_group_intt_matches_exact():
    vec = _vectors("g1", 1, seed=20)[2]
    got = CPU.group_intt(CPU.from_points(vec, "g1"))
    assert CPU.encode_radix(got) == _exact_radix(vec, "g1")


@pytest.mark.parametrize("exp", [3, 4])
def test_four_step_one_row_blocks_match_in_core(exp):
    vecs, (in_core, *_) = _in_core("g1", exp)
    (streamed,) = streaming.group_intt_streamed([_host(vecs[0], "g1")], exp, "cpu", rows_per_block=1)
    assert streamed == in_core


# ---------------------------------------------------------------------------
# prepare_phase2, reduce_powers, verify_transcript, portable.contribute
# ---------------------------------------------------------------------------

def _ceremony(d, size: int, batch: int, rounds: int) -> list[str]:
    """A phase-1 transcript on the JAX package's ExactBackend: the initial
    challenge c1, then per round a response r{i}, verified into the next
    round's challenge c{i+1}. Returns the response paths."""
    new_challenge(str(d / "c1"), size, batch)
    responses = []
    for i in range(1, rounds + 1):
        c, r = str(d / f"c{i}"), str(d / f"r{i}")
        if responses:
            jverify_transform(str(d / f"c{i - 1}"), responses[-1], c, size, batch, backend=JExactBackend())
        jcontribute(c, r, size, batch, participant_rng(f"round {i}", system_entropy=bytes(1024)),
                    backend=JExactBackend())
        responses.append(r)
    return responses


@pytest.fixture(scope="module")
def size2(tmp_path_factory):
    """A size-2 response and the JAX package's radix files of it."""
    d = tmp_path_factory.mktemp("size2")
    (response,) = _ceremony(d, 2, 4, 1)
    (d / "jax").mkdir()
    jprepare_phase2(response, 2, 4, JExactBackend(), out_dir=str(d / "jax"))
    return d


def _same_files(a, b, names) -> None:
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_prepare_phase2_matches_jax(size2):
    out = size2 / "port"
    out.mkdir()
    paths = prepare.prepare_phase2(str(size2 / "r1"), 2, 4, CPU, out_dir=str(out))
    assert paths == [str(out / f"phase1radix2m{m}") for m in range(3)]
    _same_files(out, size2 / "jax", [f"phase1radix2m{m}" for m in range(3)])


def test_reduce_powers_matches_jax(tmp_path):
    new_challenge(str(tmp_path / "c"), 3, 4)
    want = jreduce_powers(str(tmp_path / "c"), str(tmp_path / "jax"), 3, 1, 4)
    assert prepare.reduce_powers(str(tmp_path / "c"), str(tmp_path / "port"), 3, 1, 4) == want
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()


def test_verify_transcript_matches_jax(tmp_path):
    responses = _ceremony(tmp_path, 3, 4, 2)
    c1 = str(tmp_path / "c1")
    want = jverify_transcript(c1, responses, 3, 4, backend=JExactBackend())
    assert transcript.verify_transcript(c1, responses, 3, 4, ExactBackend()) == want
    assert len(want) == 2
    # round 1's tau_g1[1] replaced by another valid point
    bad = str(tmp_path / "bad")
    shutil.copyfile(responses[0], bad)
    with open(bad, "r+b") as f:
        f.seek(CeremonyParams(3, 4).position("tau_g1", 1, True))
        f.write(jrc.point_to_bytes(jrc.G1_GEN.mul(5), True))
    for fn, backend in ((jverify_transcript, JExactBackend()), (transcript.verify_transcript, ExactBackend())):
        with pytest.raises(ValueError, match="round 1: invalid transformation"):
            fn(c1, [bad, responses[1]], 3, 4, backend)


def test_portable_contribute_matches_jax(size2):
    params = jmpc.MPCParameters.new(JCircomCircuit.from_json(MUL_JSON), False,
                                    lambda exp: str(size2 / "jax" / f"phase1radix2m{exp}")).write()
    want = jportable.contribute(params, b"portable entropy")
    assert portable.contribute(params, b"portable entropy") == want


# ---------------------------------------------------------------------------
# the CLI, where neither jax nor the JAX package can be imported
# ---------------------------------------------------------------------------

_TOOLS = r"""
import json, runpy, sys
sys.modules["jax"] = None  # any import of either now raises ImportError
sys.modules["phase2_bn254_tpu"] = None
import torch
for argv in json.loads(sys.argv[1]):
    sys.argv = ["phase2_bn254_tpu_torch", *argv]
    try:
        with torch.inference_mode():  # as the tests in this file run the plain versions
            runpy.run_module("phase2_bn254_tpu_torch", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code:
            raise
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "phase2_bn254_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
"""


def test_tools_run_without_jax(tmp_path):
    (response,) = _ceremony(tmp_path, 1, 4, 1)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jprepare_phase2(response, 1, 4, JExactBackend(), out_dir=str(tmp_path / "jax"))
    new_challenge(str(tmp_path / "big"), 2, 4)
    jreduce_powers(str(tmp_path / "big"), str(tmp_path / "reduced_jax"), 2, 1, 4)
    runs = [["prepare_phase2", response, "1", "4", "--out-dir", str(tmp_path / "port"), "--device", "cpu"],
            ["reduce_powers", str(tmp_path / "big"), str(tmp_path / "reduced"), "2", "1", "4", "--device", "cpu"],
            ["verify_transcript", str(tmp_path / "c1"), response, "--size", "1", "--batch", "4", "--device", "cpu"]]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("PHASE2_TPU_NO_CACHE", None)  # set by tests/conftest.py; the port must not need it
    res = subprocess.run([sys.executable, "-c", _TOOLS, json.dumps(runs)], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Transcript OK" in res.stdout
    _same_files(tmp_path / "port", tmp_path / "jax", ["phase1radix2m0", "phase1radix2m1"])
    assert (tmp_path / "reduced").read_bytes() == (tmp_path / "reduced_jax").read_bytes()


def test_tools_default_to_the_card(tmp_path):
    """--device defaults to cuda; without a GPU each tool raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from phase2_bn254_tpu_torch.cli import phase1

    for main, argv in ((phase1.main_prepare_phase2, ["r", "1", "4"]),
                       (phase1.main_reduce_powers, ["c", "r", "2", "1", "4"]),
                       (transcript.main_verify_transcript, ["c", "r", "--size", "1", "--batch", "4"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([str(tmp_path / a) if a in ("r", "c") else a for a in argv])


# ---------------------------------------------------------------------------
# N1 and N2's code on the host
# ---------------------------------------------------------------------------

_HOST_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "group_ntt.cu"
extern "C" void host_stage_g1(int64_t* x, int64_t* y, int64_t* z, const int64_t* tw, int log2c, int s, int pairs) {
  for (int p = 0; p < pairs; ++p) group_ntt_pair<Fp>(x, y, z, tw, log2c, s, p);
}
extern "C" void host_stage_g2(int64_t* x, int64_t* y, int64_t* z, const int64_t* tw, int log2c, int s, int pairs) {
  for (int p = 0; p < pairs; ++p) group_ntt_pair<Fp2>(x, y, z, tw, log2c, s, p);
}
extern "C" void host_mul_g1(int64_t* x, int64_t* y, int64_t* z, const int64_t* k, int per_lane, int n) {
  for (int i = 0; i < n; ++i) jac_scalar_mul_point<Fp>(x, y, z, k, per_lane, i);
}
extern "C" void host_mul_g2(int64_t* x, int64_t* y, int64_t* z, const int64_t* k, int per_lane, int n) {
  for (int i = 0; i < n; ++i) jac_scalar_mul_point<Fp2>(x, y, z, k, per_lane, i);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("group_ntt_shim")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(d / "shim.so")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(d / "shim.so"))


def _ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def _clone(jac):
    return type(jac)(*(c.clone() for c in jac))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_kernels_code_on_host_matches_plain(host_lib, group):
    """Stages 1 and 3 of rows of 8 (the twiddles 0, 1, r - 1, (r -/+ 1)/2
    and random ones, over equal points and infinities), and N2 per lane and
    broadcast: g++-built csrc/group_ntt.cu against the plain versions."""
    pts, tw = stage_case(group, 3, 3, seed=40)
    for s in (1, 3):
        got = _clone(pts)
        getattr(host_lib, f"host_stage_{group}")(*_ptrs(*got, tw), 3, s, pts.x.shape[0] // 2)
        want = ntt.group_ntt_stage_plain(_clone(pts), tw, 3, s)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), s
    pts, k = scalar_case(group, 12, seed=41)
    for scalars in (k, k[2:3]):
        got = _clone(pts)
        getattr(host_lib, f"host_mul_{group}")(*_ptrs(*got, scalars), int(scalars.shape[0] > 1), pts.x.shape[0])
        want = ntt.jac_scalar_mul_plain(_clone(pts), scalars)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
