"""The port's phase-2 MPC path on the CPU (plain versions of K1, K9, S1 and
K3-K5) against the JAX package's and refimpl.

* `scalar_windows_msb` against `pallas_exp.scalar_windows_t_msb`;
* the plain K9 against refimpl `Point.mul` at the edge scalars (0, 1, r-1,
  2^k, ...), as the JAX package's own tests hold its plain windowed ladder
  (`test_pallas_batch_exp_matches_host`): the Pallas K9 in interpret mode
  took over 90 s at n = 4 on a CPU, too slow for the default tier;
* the per-point code of csrc/batch_exp_g2_windowed.cu (K9), compiled with
  g++, against the plain version limb for limb, and the per-thread code of
  csrc/segsum.cu (S1), with host loops for the block's threads and the
  launches, against the plain version per segment in canonical affine and
  against refimpl sums, on S1's edge cases (segments that end on a tile's
  last lane, fill a tile, span many tiles; single-term and empty segments;
  P + P and P + (-P); infinity terms; fewer terms than a tile);
* the plain segmented multiply-and-sum against refimpl sums, G1 and G2, with
  empty segments, one skewed segment and coefficients 0, 1 and r-1;
* `MPCParameters.new` on `TorchBackend("cpu")` against the JAX package's
  host path (no backend): the same bytes and cs_hash, filtered and
  unfiltered, on tests/test_phase2_mpc.py's circuit and on a 3-bit
  Num2Bits-shaped circuit whose ONE variable holds a skewed B segment;
* `new` + `contribute` with a fixed ChaCha seed give
  tests/fixtures/golden_params_s3.bin byte for byte;
* `verify_contribution` accepts the port's and the JAX package's
  contributions (as the JAX package's does), and rejects a changed
  transcript, a changed l point and a changed delta_g2;
* the CLI chain new -> contribute -> verify_contribution -> prove in a
  subprocess where neither jax nor the JAX package can be imported, and
  `beacon`: new, contribute and beacon give the JAX package's bytes;
* `export_keys`, `generate_verifier`, `copy_json` and `snarkjs_verify`
  against the JAX tools on the same .params;
* the default device (cuda) raises without a GPU.

The radix files come from a size-3 phase-1 ceremony on the JAX package's
exact backend, as tests/test_golden_phase2.py builds them. Tolerance: exact
(bytes, limbs, points as integers).
"""

import ctypes
import json
import os
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase2_bn254_tpu.ceremony.prepare import prepare_phase2
from phase2_bn254_tpu.cli import phase2 as jcli2
from phase2_bn254_tpu.cli.phase1 import contribute as p1_contribute
from phase2_bn254_tpu.cli.phase1 import beacon_rng as jbeacon_rng
from phase2_bn254_tpu.cli.phase1 import new_challenge, participant_rng
from phase2_bn254_tpu.crypto.chacha import ChaChaRng as JChaChaRng
from phase2_bn254_tpu.field import fp as jfp
from phase2_bn254_tpu.ops import pallas_exp
from phase2_bn254_tpu.phase2 import mpc as jmpc
from phase2_bn254_tpu.phase2.circom import CircomCircuit as JCircomCircuit
from phase2_bn254_tpu.refimpl.backend import ExactBackend
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.cli import phase2 as cli2
from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
from phase2_bn254_tpu_torch.curve import group as G
from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
from phase2_bn254_tpu_torch.ops import _build, batch_exp, segsum
from phase2_bn254_tpu_torch.ops.backend import TorchBackend
from phase2_bn254_tpu_torch.phase2 import mpc
from phase2_bn254_tpu_torch.phase2.circom import CircomCircuit
from phase2_bn254_tpu_torch.refimpl import curve as rc
from phase2_bn254_tpu_torch.refimpl.field import Q, R_MOD

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = TorchBackend("cpu")
EDGE = [0, 1, 2, R_MOD - 1, R_MOD - 2, 1 << 4, 1 << 200, (1 << 253) + 1]
GOLDEN_SEED = bytes(range(64))

# tests/test_phase2_mpc.py's circuit: aux2 * aux3 == public output (var 1)
MUL_JSON = {"constraints": [[{"2": "1"}, {"3": "1"}, {"1": "1"}]], "nPubInputs": 0, "nOutputs": 1, "nVars": 4}
MUL_WITNESS = ["1", "6", "2", "3"]
# a 3-bit Num2Bits as circom compiles it: var 1 the public input, 2..4 the
# bits; b * (b - 1) = 0 puts r - 1 on ONE in B (a skewed segment: every bit
# constraint), and the sum constraint puts 2^i on the bits in C
_M1 = str(R_MOD - 1)
NUM2BITS_JSON = {"constraints": [[{str(2 + i): "1"}, {str(2 + i): "1", "0": _M1}, {}] for i in range(3)]
                 + [[{}, {}, {"2": "1", "3": "2", "4": "4", "1": _M1}]],
                 "nPubInputs": 1, "nOutputs": 0, "nVars": 5}
NUM2BITS_WITNESS = ["1", "5", "1", "0", "1"]
CIRCUITS = {"mul": MUL_JSON, "num2bits": NUM2BITS_JSON}


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

def _scalars(seed: int, n: int) -> list[int]:
    rng = random.Random(seed)
    return [rng.randrange(R_MOD) for _ in range(n)]


def _g2_points(seed: int, n: int) -> list:
    rng = random.Random(seed)
    return [rc.G2_GEN.mul(rng.randrange(1, R_MOD)) for _ in range(n)]


def test_scalar_windows_msb_matches_jax():
    vals = EDGE + _scalars(1, 8)
    got = batch_exp.scalar_windows_msb(convert.ints_to_limbs(vals, "cpu"))
    want = pallas_exp.scalar_windows_t_msb(jnp.asarray(np.stack([jfp.int_to_limbs(v) for v in vals]).T))
    assert got.shape == (64, len(vals))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.fixture(scope="module")
def k9_case():
    """Edge scalars on random G2 points and the plain K9 output."""
    pts = _g2_points(2, len(EDGE))
    aff = convert.points_to_affine(pts, "g2", "cpu")
    k = convert.ints_to_limbs(EDGE, "cpu")
    return pts, aff, k, batch_exp.batch_exp_g2_windowed(aff.x, aff.y, k)


def test_k9_plain_matches_refimpl(k9_case):
    pts, _, _, jac = k9_case
    got = convert.affine_to_points(G.jac_normalize(FQ2, jac), "g2")
    assert got == [p.mul(s) for p, s in zip(pts, EDGE)]
    assert got[0].is_zero()


# ---------------------------------------------------------------------------
# S1 and the segmented sum
# ---------------------------------------------------------------------------

def _segment_case(group: str, seed: int):
    """Terms over 12 segments: segments 0, 5 and 11 empty, segment 3 holds a
    third of the terms; coefficients 0, 1, r-1 and random; bases 6 random
    multiples of the generator."""
    rng = random.Random(seed)
    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    basis = [gen.mul(rng.randrange(1, R_MOD)) for _ in range(6)]
    segs = sorted([3] * 10 + [rng.choice([1, 2, 4, 6, 7, 8, 9, 10]) for _ in range(20)])
    coeffs = [rng.choice([0, 1, R_MOD - 1, rng.randrange(R_MOD)]) for _ in segs]
    idx = [rng.randrange(6) for _ in segs]
    return basis, idx, coeffs, segs


@pytest.fixture(scope="module")
def segment_cases():
    """Per group: the case and its plain term products (K1 / K9)."""
    out = {}
    for group, seed in (("g1", 7), ("g2", 8)):
        basis, idx, coeffs, segs = _segment_case(group, seed)
        aff = convert.points_to_affine(basis, group, "cpu")
        out[group] = (basis, idx, coeffs, segs,
                      segsum.term_products(aff, torch.tensor(idx), convert.ints_to_limbs(coeffs, "cpu")))
    return out


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_segmented_msm_plain_matches_refimpl(segment_cases, group):
    basis, idx, coeffs, segs, products = segment_cases[group]
    got = segsum.segment_sums(products, torch.tensor(segs), 12)
    want = [rc.point_zero(group)] * 12
    for i, c, s in zip(idx, coeffs, segs):
        want[s] = want[s].add(basis[i].mul(c))
    out = convert.affine_to_points(G.jac_normalize(FQ if group == "g1" else FQ2, got), group)
    assert out == want
    assert all(out[s].is_zero() for s in (0, 5, 11))
    # segmented_msm is term_products then segment_sums
    small = segsum.segmented_msm(convert.points_to_affine(basis, group, "cpu"), torch.tensor(idx[:3]),
                                 convert.ints_to_limbs([1, 2, 0], "cpu"), torch.tensor([0, 0, 2]), 3)
    aff = G.jac_normalize(FQ if group == "g1" else FQ2, small)
    assert convert.affine_to_points(aff, group) == [basis[idx[0]].add(basis[idx[1]].mul(2)),
                                                    rc.point_zero(group), rc.point_zero(group)]


_HOST_SHIM = r"""
#include <cstdint>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "batch_exp_g2_windowed.cu"
#include "segsum.cu"
extern "C" void host_k9(const int64_t* x, const int64_t* y, const int64_t* k, int64_t* ox, int64_t* oy,
                        int64_t* oz, int n) {
  for (int i = 0; i < n; ++i) batch_exp_g2_windowed_point(x, y, k, ox, oy, oz, i);
}
// one launch of S1: a loop over the tiles stands in for the blocks, and
// loops over the threads for a block's threads between its barriers
template <class F>
void sums_level(const int64_t* x, const int64_t* y, const int64_t* z, const int64_t* seg, int64_t* ox, int64_t* oy,
                int64_t* oz, int64_t* cx, int64_t* cy, int64_t* cz, int64_t* cseg, int n, int threads, int terms) {
  const int64_t size = (int64_t)threads * terms;
  for (int64_t tile = 0; tile * size < n; ++tile) {
    const int64_t lo = tile * size, hi = lo + size < n ? lo + size : n;
    std::vector<SegRun<F>> runs(threads);
    std::vector<Jac<F>> v(threads), nv(threads);
    std::vector<uint8_t> f(threads), nf(threads), changed(threads);
    for (int t = 0; t < threads; ++t) {
      runs[t] = seg_run<F>(x, y, z, seg, n, lo + (int64_t)t * terms, terms, ox, oy, oz);
      v[t] = runs[t].tail;
      f[t] = seg_flag(runs[t], seg, lo);
    }
    for (int d = 1; d < threads; d *= 2) {
      for (int t = 0; t < threads; ++t) changed[t] = seg_scan_step(v.data(), f.data(), t, d, nv[t], nf[t]);
      for (int t = 0; t < threads; ++t)
        if (changed[t]) v[t] = nv[t], f[t] = nf[t];
    }
    for (int t = 0; t < threads; ++t) seg_finish(runs[t], v.data(), seg, n, tile, lo, hi, t, ox, oy, oz, cx, cy, cz, cseg);
  }
}
extern "C" void host_sums_g1(const int64_t* x, const int64_t* y, const int64_t* z, const int64_t* seg, int64_t* ox,
                             int64_t* oy, int64_t* oz, int64_t* cx, int64_t* cy, int64_t* cz, int64_t* cseg, int n,
                             int threads, int terms) {
  sums_level<Fp>(x, y, z, seg, ox, oy, oz, cx, cy, cz, cseg, n, threads, terms);
}
extern "C" void host_sums_g2(const int64_t* x, const int64_t* y, const int64_t* z, const int64_t* seg, int64_t* ox,
                             int64_t* oy, int64_t* oz, int64_t* cx, int64_t* cy, int64_t* cz, int64_t* cseg, int n,
                             int threads, int terms) {
  sums_level<Fp2>(x, y, z, seg, ox, oy, oz, cx, cy, cz, cseg, n, threads, terms);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("phase2_shim")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(d / "shim.so")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(d / "shim.so"))


def _ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def _host_sums(host_lib, jac, seg_ids, n_segments, threads, terms, launches=None):
    """S1 through segsum.reduce_levels with csrc/segsum.cu's per-thread code
    compiled by g++ in each launch's place, tiles of threads x terms."""
    fn = host_lib.host_sums_g1 if jac.x.dim() == 2 else host_lib.host_sums_g2

    def level(src, seg, out, carry, carry_seg, n):
        fn(*_ptrs(*src, seg, *out, *carry, carry_seg), ctypes.c_int(n), ctypes.c_int(threads), ctypes.c_int(terms))
        if launches is not None:
            launches.append(n)

    return segsum.reduce_levels(jac, seg_ids, n_segments, level, threads, terms)


def _affine_points(group, jac):
    return convert.affine_to_points(G.jac_normalize(FQ if group == "g1" else FQ2, jac), group)


def test_cuda_sources_arithmetic_on_host_matches_plain(k9_case, segment_cases, host_lib):
    """csrc/batch_exp_g2_windowed.cu's per-point and csrc/segsum.cu's
    per-thread code compiled by g++ (CUDA qualifiers defined away): K9 limb
    for limb with its plain version, and S1 (host loops for the block's
    threads and the launches) per segment in canonical affine, G1 and G2."""
    _, aff, k, want = k9_case
    out = [torch.empty_like(aff.x) for _ in range(3)]
    host_lib.host_k9(*_ptrs(aff.x, aff.y, k, *out), ctypes.c_int(k.shape[0]))
    assert all(torch.equal(a, b) for a, b in zip(out, want))

    for group in ("g1", "g2"):
        _, _, _, segs, jac = segment_cases[group]
        seg_ids = torch.tensor(segs)
        want = _affine_points(group, segsum.segment_sums_plain(jac, seg_ids, 12))
        for threads, terms in ((4, 2), (3, 3), (segsum.THREADS, segsum.TERMS)):
            got = _host_sums(host_lib, jac, seg_ids, 12, threads, terms)
            assert _affine_points(group, got) == want, (group, threads, terms)


def _jacobian(group: str, points: list, rng: random.Random) -> G.JacobianBatch:
    """Points as Jacobian limbs with a random z each (x z^2, y z^3, z);
    infinity as z = 0."""
    f = FQ if group == "g1" else FQ2
    jac = G.affine_to_jac(f, convert.points_to_affine(points, group, "cpu"))
    zs = convert.ints_to_limbs([rng.randrange(1, Q) for _ in range(len(points) * (1 if group == "g1" else 2))], "cpu")
    z = zs if group == "g1" else zs.reshape(len(points), 2, 16)
    z2 = f.sqr(z)
    return G.JacobianBatch(f.mul(jac.x, z2), f.mul(jac.y, f.mul(z2, z)), f.mul(jac.z, z))


# S1's edge cases in tiles of 4 threads x 2 terms (8 terms a tile): per case
# the terms as (segment, point) in order, point "Pk" the basis point k, "Nk"
# its negation, "O" infinity; and the number of segments
_P, _N, _O = "P", "N", "O"
SEGMENT_EDGES = {
    # segment 1 ends on tile 0's last lane (7), after crossing two threads
    "tile_end": ([(0, "P0"), (0, "P1"), (0, "P2")] + [(1, f"P{k}") for k in range(5)]
                 + [(2, "P3"), (2, "P4"), (3, "P5")], 4),
    # tile 1 (terms 8..15) lies inside segment 1, which crosses into it and out
    "one_tile": ([(0, "P0")] * 3 + [(1, f"P{k % 6}") for k in range(16)] + [(2, "P1"), (2, "P2")], 3),
    # segment 1 spans 13 tiles: three launches
    "many_tiles": ([(0, "P5")] + [(1, f"P{k % 5}") for k in range(100)] + [(2, "P0"), (3, "P1"), (3, "P1")], 4),
    # single-term segments and empty ones (1, 4, 6, 9, 10, 12)
    "single_and_empty": ([(0, "P0"), (2, "P1"), (3, "P2"), (3, "P3"), (5, "P4"), (7, "P5"), (8, "P0"), (8, "P1"),
                          (8, "P2"), (11, "P3")], 13),
    # P + P and P + (-P): inside a run (0, 1), across threads (3), across
    # tiles (4 at 7 | 8, 7 at 15 | 16), in the scan of a segment across
    # runs (9: P0 + P1 twice), and a sum that cancels to infinity (5)
    "double_and_cancel": ([(0, "P0"), (0, "P0"), (1, "P1"), (1, "N1"), (2, "P2"), (3, "P3"), (3, "P3"), (4, "P4"),
                           (4, "N4"), (5, "P5"), (5, "P5"), (5, "N5"), (5, "N5"), (6, "P1"), (6, "P2"), (7, "P3"),
                           (7, "P3"), (8, "O"), (8, "P1"), (8, "P2"), (8, "P3"), (8, "P4"), (8, "P0"), (8, "P3"),
                           (9, "P0"), (9, "P1"), (9, "P0"), (9, "P1"), (9, "P0"), (9, "P1"), (9, "P0"), (9, "P1"),
                           (10, "P2")], 11),
    # infinity terms: a segment of them only (1), first and last in a
    # segment, across a tile boundary (3 at 6..9)
    "infinity": ([(0, "P0"), (1, "O"), (1, "O"), (1, "O"), (2, "O"), (2, "P1"), (3, "O"), (3, "O"), (3, "O"),
                  (3, "P2"), (3, "O"), (4, "P3"), (4, "O")], 5),
    # fewer terms than one tile
    "below_tile": ([(0, "P0"), (0, "P1"), (2, "P2"), (2, "N2"), (3, "P3")], 5),
}


@pytest.fixture(scope="module")
def edge_bases():
    rng = random.Random(15)
    return {g: [gen.mul(rng.randrange(1, R_MOD)) for _ in range(6)]
            for g, gen in (("g1", rc.G1_GEN), ("g2", rc.G2_GEN))}


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("case", sorted(SEGMENT_EDGES))
def test_segment_sums_on_host_edges(host_lib, edge_bases, group, case):
    """S1's per-thread and per-tile code compiled by g++, with host loops for
    the block's threads and the launches (tiles of 4 x 2 terms), against the
    plain version per segment in canonical affine and against refimpl
    sums."""
    terms, n_segments = SEGMENT_EDGES[case]
    basis = edge_bases[group]
    zero = rc.point_zero(group)
    points = [zero if p == _O else basis[int(p[1])] if p[0] == _P else basis[int(p[1])].neg() for _, p in terms]
    segs = [s for s, _ in terms]
    want = [zero] * n_segments
    for s, pt in zip(segs, points):
        want[s] = want[s].add(pt)
    jac = _jacobian(group, points, random.Random(case))
    seg_ids = torch.tensor(segs)
    launches = []
    got = _affine_points(group, _host_sums(host_lib, jac, seg_ids, n_segments, 4, 2, launches))
    assert got == want
    assert _affine_points(group, segsum.segment_sums_plain(jac, seg_ids, n_segments)) == want
    assert len(launches) == {"many_tiles": 3, "double_and_cancel": 3, "below_tile": 1}.get(case, 2), launches
    if case == "double_and_cancel":
        assert want[1].is_zero() and want[4].is_zero() and want[5].is_zero() and not want[9].is_zero()


def test_wrappers_take_no_other_device():
    x = torch.zeros((2, 2, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        batch_exp.batch_exp_g2_windowed(x, x, torch.zeros((2, 16), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        segsum.segment_sums(G.JacobianBatch(x, x, x), torch.zeros(2, dtype=torch.int64, device="meta"), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_kernels_match_plain_on_gpu(k9_case, segment_cases, group):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if group == "g2":
        _, aff, k, want = k9_case
        before = batch_exp.LAUNCHES["batch_exp_g2_windowed"]
        got = batch_exp.batch_exp_g2_windowed(aff.x.cuda(), aff.y.cuda(), k.cuda())
        assert batch_exp.LAUNCHES["batch_exp_g2_windowed"] == before + 1
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    _, _, _, segs, jac = segment_cases[group]
    seg_ids = torch.tensor(segs)
    before = segsum.LAUNCHES["segment_sums"]
    got = segsum.segment_sums(G.JacobianBatch(*(t.cuda() for t in jac)), seg_ids.cuda(), 12)
    assert segsum.LAUNCHES["segment_sums"] == before + 1
    want = segsum.segment_sums_plain(jac, seg_ids, 12)
    assert _affine_points(group, G.JacobianBatch(*(t.cpu() for t in got))) == _affine_points(group, want)


# ---------------------------------------------------------------------------
# MPCParameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def radix_dir(tmp_path_factory):
    """Radix files of a size-3 phase-1 ceremony (tests/test_golden_phase2.py's)."""
    d = tmp_path_factory.mktemp("radix")
    new_challenge(str(d / "c1"), 3, 4)
    p1_contribute(str(d / "c1"), str(d / "r1"), 3, 4, participant_rng("golden phase2", system_entropy=bytes(1024)),
                  backend=ExactBackend())
    prepare_phase2(str(d / "r1"), 3, 4, ExactBackend(), out_dir=str(d))
    for name, circuit in CIRCUITS.items():
        (d / f"{name}.json").write_text(json.dumps(circuit))
    (d / "mul_witness.json").write_text(json.dumps(MUL_WITNESS))
    return d


def _radix(d):
    return lambda exp: str(d / f"phase1radix2m{exp}")


@pytest.fixture(scope="module")
def port_new(radix_dir):
    """The port's `new` of each circuit, unfiltered (as the CLI runs it)."""
    return {name: mpc.MPCParameters.new(CircomCircuit.from_json(c), False, _radix(radix_dir), CPU)
            for name, c in CIRCUITS.items()}


@pytest.mark.parametrize("name", sorted(CIRCUITS))
@pytest.mark.parametrize("filtered", [False, True], ids=["unfiltered", "filtered"])
def test_new_matches_jax(radix_dir, port_new, name, filtered):
    want = jmpc.MPCParameters.new(JCircomCircuit.from_json(CIRCUITS[name]), filtered, _radix(radix_dir))
    if filtered:
        got = mpc.MPCParameters.new(CircomCircuit.from_json(CIRCUITS[name]), True, _radix(radix_dir), CPU)
    else:
        got = port_new[name]
        assert bool(got.params.a.inf.any() or got.params.b_g1.inf.any())  # infinities written, not raised on
    assert got.cs_hash == want.cs_hash
    assert got.write() == want.write()


def test_golden_params_fixture(radix_dir):
    mp = mpc.MPCParameters.new(CircomCircuit.from_json(MUL_JSON), True, _radix(radix_dir), CPU)
    mp.contribute(ChaChaRng.from_digest_be(GOLDEN_SEED), CPU)
    with open(os.path.join(REPO, "tests", "fixtures", "golden_params_s3.bin"), "rb") as f:
        assert mp.write() == f.read()


@pytest.fixture(scope="module")
def chains(port_new):
    """(before, after) .params bytes of one contribution to the unfiltered
    Num2Bits parameters, made by the port and by the JAX package."""
    before = port_new["num2bits"].write()
    ours = mpc.MPCParameters.read(before, backend=CPU)
    ours.contribute(ChaChaRng.from_digest_be(bytes(range(1, 65))), CPU)
    theirs = jmpc.MPCParameters.read(before)
    theirs.contribute(JChaChaRng.from_digest_be(bytes(range(2, 66))))
    return before, {"port": ours.write(), "jax": theirs.write()}


@pytest.mark.parametrize("maker", ["port", "jax"])
def test_verify_contribution_accepts_both_packages(chains, maker):
    before, after = chains[0], chains[1][maker]
    got = mpc.verify_contribution(mpc.MPCParameters.read(before, backend=CPU), mpc.MPCParameters.read(after, backend=CPU),
                                  CPU)
    want = jmpc.verify_contribution(jmpc.MPCParameters.read(before), jmpc.MPCParameters.read(after))
    assert got == want


def _tampered(after: bytes, how: str) -> mpc.MPCParameters:
    mp = mpc.MPCParameters.read(after, backend=CPU)
    if how == "transcript":
        pk = mp.contributions[-1]
        pk.transcript = bytes([pk.transcript[0] ^ 1]) + pk.transcript[1:]
    elif how == "l":
        other = convert.points_to_affine([rc.G1_GEN.mul(12345)], "g1", "cpu")
        for t, o in zip(mp.params.l[:2], other[:2]):
            t[0] = o[0]
    else:
        mp.params.vk.delta_g2 = mp.params.vk.delta_g2.double()
    return mp


@pytest.mark.parametrize("how", ["transcript", "l", "delta_g2"])
def test_verify_contribution_rejects_tampering(chains, how):
    before, after = chains[0], chains[1]["port"]
    with pytest.raises(ValueError):
        mpc.verify_contribution(mpc.MPCParameters.read(before, backend=CPU), _tampered(after, how), CPU)


def test_device_parameters_read_modes(port_new):
    data = port_new["num2bits"].write()
    mp = mpc.MPCParameters.read(data, backend=CPU)
    assert mp == port_new["num2bits"] and mp.write() == data
    with pytest.raises(ValueError, match="infinity"):
        mpc.MPCParameters.read(data, disallow_points_at_infinity=True, backend=CPU)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_CHAIN = r"""
import sys
sys.modules["jax"] = None  # any import of either now raises ImportError
sys.modules["phase2_bn254_tpu"] = None
from phase2_bn254_tpu_torch.__main__ import main
from phase2_bn254_tpu_torch.cli import phase2
from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
phase2.participant_rng = lambda *a: ChaChaRng.from_digest_be(bytes(range(64)))  # contribute's and prove's rng
cpu = ["--device", "cpu"]
assert main(["new", "mul.json", "circom1.params", ".", *cpu]) == 0
assert main(["contribute", "circom1.params", "circom2.params", "some entropy", *cpu]) == 0
assert main(["verify_contribution", "mul.json", "circom1.params", "circom2.params", ".", *cpu]) == 0
assert main(["prove", "mul.json", "mul_witness.json", "circom2.params", "proof.json", "public.json", *cpu]) == 0
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "phase2_bn254_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
"""


@pytest.fixture(scope="module")
def cli_chain(radix_dir):
    """The CLI chain in a subprocess that cannot import jax or the JAX
    package; returns the directory (radix files, .params, proof)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("PHASE2_TPU_NO_CACHE", None)  # set by tests/conftest.py; the port must not need it
    res = subprocess.run([sys.executable, "-c", _CHAIN], cwd=str(radix_dir), env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return radix_dir


def test_cli_chain_without_jax(cli_chain):
    """new == the JAX package's new; contribute == the JAX package's
    contribute with the same ChaCha seed; the proof was verified by prove."""
    d = cli_chain
    want = jmpc.MPCParameters.new(JCircomCircuit.from_json(MUL_JSON), False, _radix(d))
    assert (d / "circom1.params").read_bytes() == want.write()
    want.contribute(JChaChaRng.from_digest_be(bytes(range(64))))
    assert (d / "circom2.params").read_bytes() == want.write()
    assert json.loads((d / "public.json").read_text()) == ["6"]


def test_beacon_matches_jax(cli_chain, tmp_path):
    """beacon (iterations exponent 10) == the JAX package's contribute with
    the same beacon rng; its exponent stays in [10, 63]."""
    d, beacon = cli_chain, "00" * 31 + "01"
    cli2.main_beacon([str(d / "circom2.params"), beacon, "10", str(tmp_path / "circom3.params"), "--device", "cpu"])
    want = jmpc.MPCParameters.read((d / "circom2.params").read_bytes())
    want.contribute(jbeacon_rng(beacon, 10, progress=False))
    assert (tmp_path / "circom3.params").read_bytes() == want.write()
    with pytest.raises(SystemExit):
        cli2.main_beacon([str(d / "circom2.params"), beacon, "9", str(tmp_path / "x.params"), "--device", "cpu"])


@pytest.mark.parametrize("tool", ["export_keys", "generate_verifier", "copy_json", "snarkjs_verify"])
def test_host_tools_match_jax(cli_chain, tmp_path, capsys, tool):
    d, params = cli_chain, str(cli_chain / "circom2.params")
    outs = {}
    for who, cli in (("port", cli2), ("jax", jcli2)):
        out = tmp_path / who
        out.mkdir()
        if tool == "export_keys":
            cli.main_export_keys([params, str(out / "vk.json"), str(out / "pk.json")])
            outs[who] = [(out / n).read_text() for n in ("vk.json", "pk.json")]
        elif tool == "generate_verifier":  # the same text but header lines 4-5, which name each template's origin
            cli.main_generate_verifier([params, str(out / "verifier.sol")])
            lines = (out / "verifier.sol").read_text().splitlines()
            assert all(line.startswith("//") for line in lines[3:5])
            outs[who] = lines[:3] + lines[5:]
        elif tool == "copy_json":
            (out / "ref.json").write_text(json.dumps({"a": 1, "protocol": "plonk", "pi_a": []}))
            cli.main_copy_json([str(out / "ref.json"), str(d / "proof.json"), str(out / "merged.json")])
            outs[who] = (out / "merged.json").read_text()
        else:
            jcli2.main_export_keys([params, str(out / "vk.json"), str(out / "pk.json")])
            vk, proof, public = str(out / "vk.json"), str(d / "proof.json"), str(d / "public.json")
            assert cli.main_snarkjs_verify([vk, proof, public]) == 0
            (out / "wrong.json").write_text(json.dumps(["7"]))
            with pytest.raises(SystemExit):
                cli.main_snarkjs_verify([vk, proof, str(out / "wrong.json")])
            outs[who] = capsys.readouterr().out.splitlines()[-2:]
    assert outs["port"] == outs["jax"]


def test_cuda_device_never_falls_back(radix_dir, tmp_path):
    """The phase-2 tools' default device is cuda; without a GPU they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli2.main_new([str(radix_dir / "mul.json"), str(tmp_path / "x.params"), str(radix_dir)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mpc.MPCParameters.new(CircomCircuit.from_json(MUL_JSON), False, _radix(radix_dir))
