"""The port's BLS12-381 GLV path and BLS decompression on the CPU, against
the JAX package.

* `bls12_381/glv.py`: the constants, the basis, `decompose`, `phi` and
  `mul_glv` equal the JAX package's `bls12_381/glv.py`;
* the device splits `device.decompose_glv_t` / `decompose_glv_signed_t`
  equal the JAX package's `bls12_381/device.decompose_glv_t` /
  `decompose_glv_signed_t` row for row (one jitted call of each, the only
  JAX functions this file runs), on 32 scalars that hold the Barrett
  rounding's edges for BLS12-381 (0, 1, 2, r - 1, LAMBDA, r - LAMBDA, (r -
  1)/2, (r + 1)/2, ...), and recompose to k mod r;
* the plain K7-BLS and K1-BLS (the wrappers on CPU tensors), through
  `device.glv_ladder` / `glv_signed_ladder` and normalized, equal host
  `Point.mul` and JAX `glv.mul_glv`, an infinity lane and a zero scalar
  among them; `glv_batch_mul` / `glv_signed_batch_mul` on host points;
* the slice: zcash bytes -> decode_batch (the plain D1-BLS) -> each of the
  three G1 ladders (K8-BLS, K7-BLS, K1-BLS) -> normalize -> encode_batch,
  the same bytes from all three and the host chain's;
* the CUDA sources' per-point K7-BLS, K1-BLS and D1-BLS functions compiled
  by g++ (CUDA qualifiers defined away), limb for limb and flag for flag
  with the plain versions, D1-BLS on x values without a square root too,
  K7-BLS also on a batch of only k = 0, 1 and r - 1 (no table, the last
  window alone).

The JAX Pallas GLV ladders are not run: in interpret mode they take
minutes (`tests/test_bls_glv.py` gates them behind PHASE2_TPU_SLOW_TESTS).
The kernels on a card: tests/test_torch_bls12_381_gpu.py. Inputs from
seeded generators; tolerance zero (exact equality of limbs, digits,
integers and bytes).
"""

import ctypes
import os
import random
import subprocess

import numpy as np
import pytest
import torch

from phase2_bn254_tpu.bls12_381 import curve as jcurve
from phase2_bn254_tpu.bls12_381 import device as jdevice
from phase2_bn254_tpu.bls12_381 import glv as jglv
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.bls12_381 import codecs_device as C
from phase2_bn254_tpu_torch.bls12_381 import curve as pcurve
from phase2_bn254_tpu_torch.bls12_381 import device as D
from phase2_bn254_tpu_torch.bls12_381 import glv as pglv
from phase2_bn254_tpu_torch.bls12_381.field import Fq2, Q, R_MOD
from phase2_bn254_tpu_torch.curve import group as G
from phase2_bn254_tpu_torch.ops import _build, batch_exp

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module in any run (its tensors are a few
    dozen limbs wide); the count is restored for the modules after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


R = R_MOD
LAMBDA = pglv.LAMBDA
# the Barrett rounding's edges for BLS12-381 (b2 = -1: c1 = round(k / r) is
# 0 or 1, and turns at (r + 1)/2), the split's extremes, then random scalars
EDGE = [0, 1, 2, R - 1, LAMBDA, R - LAMBDA, (R - 1) // 2, (R + 1) // 2, R - 2, LAMBDA - 1, LAMBDA + 1,
        (1 << 128) - 1, 1 << 128, pglv._B1, pglv._A2, pglv._B1 - 1, (1 << 254) + 1, 16 ** 63 + 15]
N = 32
INF_LANE = 5  # this lane's input point is at infinity
ZERO_LANE = 0  # and this lane's scalar is 0 (EDGE[0])


def _scalars() -> list[int]:
    rng = random.Random("bls glv scalars")
    return EDGE + [rng.randrange(R) for _ in range(N - len(EDGE))]


def _host(points) -> list:
    """JAX-package host points -> the port's host points (the same values)."""
    def el(v):
        return v if isinstance(v, int) else Fq2(v.c0, v.c1)

    return [pcurve.point_zero(p.group) if p.inf else pcurve.Point(el(p.x), el(p.y), False, p.group) for p in points]


def _key(p):
    if p.inf:
        return None
    return tuple((v,) if isinstance(v, int) else (v.c0, v.c1) for v in (p.x, p.y))


def _same_points(got, want) -> bool:
    """Host points of either package, equal by value."""
    return [_key(p) for p in got] == [_key(p) for p in want]


@pytest.fixture(scope="module")
def case():
    """The module's inputs, made once: N scalars (EDGE first), 8 random G1
    points tiled over the lanes (lane INF_LANE at infinity), their batch on
    the CPU, the port's splits of the scalars, and the host products."""
    rng = random.Random("bls glv points")
    base = [jcurve.G1_GEN.mul(rng.randrange(1, R)) for _ in range(8)]
    pts = [base[i % len(base)] for i in range(N)]
    pts[INF_LANE] = jcurve.point_zero("g1")
    vals = _scalars()
    k = D.scalars_to_canon(vals, "cpu")
    return {"pts": pts, "vals": vals, "k": k, "batch": D.points_to_batch(_host(pts), "g1", "cpu"),
            "glv": D.decompose_glv_t(k), "glv_signed": D.decompose_glv_signed_t(k),
            "want": [p.mul(v) for p, v in zip(pts, vals)]}


# ---------------------------------------------------------------------------
# the host module and the device splits
# ---------------------------------------------------------------------------

def test_glv_module_matches_jax(case):
    """bls12_381/glv.py == the JAX package's: Z, LAMBDA, BETA, the basis
    ((1, 0xac45...0000), (0xac45...ffff, -1)), MAX_COMPONENT_BITS,
    decompose on every scalar, phi and mul_glv on a few points."""
    assert (pglv.Z, pglv.LAMBDA, pglv.BETA, pglv.MAX_COMPONENT_BITS) == (jglv.Z, jglv.LAMBDA, jglv.BETA,
                                                                         jglv.MAX_COMPONENT_BITS)
    basis = ((pglv._A1, pglv._B1), (pglv._A2, pglv._B2))
    assert basis == ((jglv._A1, jglv._B1), (jglv._A2, jglv._B2))
    assert basis == ((1, 0xAC45A4010001A4020000000100000000), (0xAC45A4010001A40200000000FFFFFFFF, -1))
    assert [pglv.decompose(v) for v in case["vals"]] == [jglv.decompose(v) for v in case["vals"]]
    pts = case["pts"][:4] + [case["pts"][INF_LANE]]
    assert _same_points([pglv.phi(p) for p in _host(pts)], [jglv.phi(p) for p in pts])
    vals = case["vals"][4:9]
    got = [pglv.mul_glv(p, v) for p, v in zip(_host(pts), vals)]
    assert _same_points(got, [jglv.mul_glv(p, v) for p, v in zip(pts, vals)])
    assert _same_points(got, [p.mul(v) for p, v in zip(pts, vals)])


def test_device_splits_match_jax_row_for_row(case):
    """The port's decompose_glv_t / decompose_glv_signed_t (canonical (N,
    16) digits in) == the JAX package's (transposed (17, N) uint32 in) row
    for row: 33 windows of |k1|, |k2| and the two sign rows; 26 signed
    base-32 digits each. The digits recompose to k mod r, and the plan sizes
    the JAX package's."""
    sc_t = np.asarray(jdevice.scalars_to_canon(case["vals"])).T
    jd1, jd2, jnegs = (np.asarray(a) for a in jdevice.decompose_glv_t(sc_t))
    js1, js2 = (np.asarray(a) for a in jdevice.decompose_glv_signed_t(sc_t))
    d1, d2, negs = case["glv"]
    s1, s2 = case["glv_signed"]
    assert d1.shape == d2.shape == (33, N) and negs.shape == (2, N) and s1.shape == s2.shape == (26, N)
    for mine, theirs in ((d1, jd1), (d2, jd2), (negs, jnegs), (s1, js1), (s2, js2)):
        assert np.array_equal(mine.numpy(), theirs.astype(np.int64))
    assert D.GLV_PLAN.windows5 == jdevice._glv_plan().windows5 == 26

    def value(rows, base):
        return [sum(int(d) * base ** (rows.shape[0] - 1 - w) for w, d in enumerate(col)) for col in rows.T.tolist()]

    sign = 1 - 2 * negs
    for k1, k2, v in zip((a * b for a, b in zip(value(d1, 16), sign[0].tolist())),
                         (a * b for a, b in zip(value(d2, 16), sign[1].tolist())), case["vals"]):
        assert (k1 + k2 * LAMBDA - v) % R == 0
    for k1, k2, v in zip(value(s1, 32), value(s2, 32), case["vals"]):
        assert (k1 + k2 * LAMBDA - v) % R == 0


# ---------------------------------------------------------------------------
# the plain ladders and the slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ladders(case):
    """K7-BLS and K1-BLS (plain, through device.glv_ladder /
    glv_signed_ladder) on the module's batch, Jacobian."""
    return {"glv": D.glv_ladder(case["batch"], case["k"]), "glv_signed": D.glv_signed_ladder(case["batch"], case["k"])}


@pytest.mark.parametrize("kind", ["glv", "glv_signed"])
def test_plain_glv_ladder_matches_host_mul(case, ladders, kind):
    """Plain K7-BLS / K1-BLS + normalize == host Point.mul on every lane
    (the infinity input and the zero scalar give infinity) and == JAX
    glv.mul_glv on a few."""
    aff = G.jac_normalize(D.FQ_OPS, ladders[kind])
    got = D.batch_to_points(aff, "g1")
    assert _same_points(got, case["want"])
    assert aff.inf.tolist() == [i in (INF_LANE, ZERO_LANE) for i in range(N)]
    lanes = [1, 6, 7, 20]
    assert _same_points([got[i] for i in lanes], [jglv.mul_glv(case["pts"][i], case["vals"][i]) for i in lanes])


def test_glv_batch_muls_on_host_points():
    """glv_batch_mul / glv_signed_batch_mul (the counterparts of JAX
    pallas_batch_mul_glv / _glv_signed) on host points == host Point.mul,
    an infinity input, the scalars 0, 1 and r - 1 among them. The scalars'
    components stay below 2^24 (the plain ladders start at the batch's first
    nonzero window; the full width runs on the module's case above)."""
    rng = random.Random("glv batch mul")
    pts = [jcurve.G1_GEN.mul(rng.randrange(1, R)) for _ in range(3)] + [jcurve.point_zero("g1")] * 2
    vals = [0, 1, R - 1, (5 << 20) + 3 + 9 * LAMBDA, 7]
    want = [p.mul(v) for p, v in zip(pts, vals)]
    assert _same_points(D.glv_batch_mul(_host(pts), vals, device="cpu"), want)
    assert _same_points(D.glv_signed_batch_mul(_host(pts), vals, device="cpu"), want)


def test_slice_three_g1_ladders_write_the_same_bytes(case, ladders):
    """zcash bytes of the finite lanes -> decode_batch (plain D1-BLS) ->
    K8-BLS, K7-BLS, K1-BLS -> normalize -> encode_batch: three equal byte
    strings, equal to the host chain (host decode, Point.mul, host encode).
    The decoded lanes equal the module's batch limb for limb, so the GLV
    ladders' outputs on it (the `ladders` fixture) are those of the decoded
    points; K8-BLS runs on the decoded batch."""
    lanes = [i for i in range(N) if i not in (INF_LANE, ZERO_LANE)]
    raw = b"".join(jcurve.g1_to_compressed(case["pts"][i]) for i in lanes)
    batch = C.decode_batch(raw, "g1", len(lanes), True, device="cpu")
    assert torch.equal(batch.x, case["batch"].x[lanes]) and torch.equal(batch.y, case["batch"].y[lanes])
    jacs = [D.ladder(batch, case["k"][lanes], "g1")] + [G.JacobianBatch(*(t[lanes] for t in ladders[kind]))
                                                       for kind in ("glv", "glv_signed")]
    outs = [C.encode_batch(G.jac_normalize(D.FQ_OPS, jac), "g1", True) for jac in jacs]
    want = b"".join(jcurve.g1_to_compressed(case["want"][i]) for i in lanes)
    assert outs[0] == outs[1] == outs[2] == want


# ---------------------------------------------------------------------------
# the CUDA sources on the host
# ---------------------------------------------------------------------------

_HOST_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "batch_exp_g1.cu"
#include "batch_exp_glv.cu"
#include "decompress.cu"
extern "C" void host_k7(const int64_t* x, const int64_t* y, const int64_t* d1, const int64_t* d2,
                        const int64_t* negs, int64_t* ox, int64_t* oy, int64_t* oz, int n, int nw) {
  for (int i = 0; i < n; ++i) batch_exp_bls_glv_point(x, y, d1, d2, negs, ox, oy, oz, i, n, nw);
}
extern "C" void host_k1(const int64_t* x, const int64_t* y, const int64_t* d1, const int64_t* d2,
                        int64_t* ox, int64_t* oy, int64_t* oz, int n, int nw) {
  for (int i = 0; i < n; ++i) batch_exp_bls_glv_signed_point(x, y, d1, d2, ox, oy, oz, i, n, nw);
}
extern "C" void host_d1(int g2, const int64_t* x, const bool* greatest, int64_t* ox, int64_t* oy, bool* valid,
                        int n) {
  for (int64_t i = 0; i < n; ++i) {
    if (g2) decompress_bls_g2_point(x, greatest, ox, oy, valid, i);
    else decompress_bls_g1_point(x, greatest, ox, oy, valid, i);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("bls_glv_shim")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(d / "shim.so")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(d / "shim.so"))


def _ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


@pytest.mark.parametrize("kind", ["glv", "glv_signed"])
def test_cuda_sources_glv_ladder_on_host_matches_plain(case, ladders, host_lib, kind):
    """csrc/batch_exp_glv.cu's and batch_exp_g1.cu's BLS instantiations
    (batch_exp_glv_point<BFp>, glv_signed_ladder_point<BFp> with BLS beta;
    field.cuh's 12-limb C++ path) compiled by g++, limb for limb with the
    plain versions (the `ladders` fixture: the wrappers on CPU tensors) on
    every lane whose input is finite (the wrappers' callers set the
    infinity lanes after the kernel)."""
    b = case["batch"]
    digits = case[kind]
    out = [torch.empty_like(b.x) for _ in range(3)]
    fn = host_lib.host_k7 if kind == "glv" else host_lib.host_k1
    fn(*_ptrs(b.x, b.y, *digits, *out), ctypes.c_int(N), ctypes.c_int(digits[0].shape[0]))
    live = ~b.inf
    assert all(torch.equal(o[live], w[live]) for o, w in zip(out, ladders[kind]))


def test_cuda_source_k7_bls_edge_lanes_on_host(host_lib):
    """K7-BLS's per-lane work on the lanes that build no table: k = 0 (no
    nonzero digit: the last window alone), 1 and r - 1, on a batch of only
    such lanes (the plain version starts at its last window); the g++-built
    code limb for limb with the plain version, and host Point.mul after
    normalizing."""
    rng = random.Random("bls k7 edge lanes")
    vals = [0, 1, R - 1, 1, R - 1, 0]
    pts = [jcurve.G1_GEN.mul(rng.randrange(1, R)) for _ in vals]
    b = D.points_to_batch(_host(pts), "g1", "cpu")
    digits = D.decompose_glv_t(D.scalars_to_canon(vals, "cpu"))
    assert int(((digits[0] != 0) | (digits[1] != 0)).int().argmax(0).max()) == digits[0].shape[0] - 1
    want = batch_exp.batch_exp_bls_glv_plain(b.x, b.y, *digits)
    out = [torch.empty_like(b.x) for _ in range(3)]
    host_lib.host_k7(*_ptrs(b.x, b.y, *digits, *out), ctypes.c_int(len(vals)), ctypes.c_int(digits[0].shape[0]))
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    got = D.batch_to_points(G.jac_normalize(D.FQ_OPS, G.JacobianBatch(*out)), "g1")
    assert _same_points(got, [p.mul(v) for p, v in zip(pts, vals)])


def _d1_inputs(group: str):
    """x of 6 random points of the group (both y orders among them), then 3
    x values without a point; random flags."""
    rng = random.Random(f"bls d1 {group}")
    gen = jcurve.G1_GEN if group == "g1" else jcurve.G2_GEN
    pts = [gen.mul(rng.randrange(1, R)) for _ in range(3)]
    xs = [p.x for p in pts + [p.neg() for p in pts]]
    while len(xs) < 9:
        x = rng.randrange(Q) if group == "g1" else Fq2(rng.randrange(Q), rng.randrange(Q))
        if jcurve.get_point_from_x(x, False, group) is None:
            xs.append(x)
    if group == "g1":
        dig = convert.ints_to_limbs(xs, "cpu", C.NL)
    else:
        dig = torch.stack([convert.ints_to_limbs([x.c0 for x in xs], "cpu", C.NL),
                           convert.ints_to_limbs([x.c1 for x in xs], "cpu", C.NL)], dim=1).contiguous()
    return xs, dig, torch.tensor([rng.random() < 0.5 for _ in xs])


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_cuda_source_d1_bls_on_host_matches_plain(host_lib, group):
    """csrc/decompress.cu's BLS12-381 instantiation (decompress_g1 /
    decompress_g2<Bls12381D1>) compiled by g++ == the plain D1-BLS
    (`_g1_decompress` / `_g2_decompress`), limbs and valid flags; the flags
    are false exactly on the x values without a point, and the valid points
    are the host's get_point_from_x."""
    xs, dig, greatest = _d1_inputs(group)
    want, want_valid = C.decompress_plain(dig, greatest, group)
    ox, oy, valid = torch.empty_like(dig), torch.empty_like(dig), torch.empty_like(greatest)
    host_lib.host_d1(int(group == "g2"), *_ptrs(dig, greatest, ox, oy, valid), len(xs))
    assert torch.equal(ox, want.x) and torch.equal(oy, want.y) and torch.equal(valid, want_valid)
    assert valid.tolist() == [True] * 6 + [False] * 3
    got = D.batch_to_points(G.AffineBatch(ox[:6], oy[:6], torch.zeros(6, dtype=torch.bool)), group)
    want_pts = [jcurve.get_point_from_x(x, bool(g), group) for x, g in zip(xs[:6], greatest[:6].tolist())]
    assert _same_points(got, want_pts)


def test_new_wrappers_take_no_other_device():
    """K7-BLS, K1-BLS and D1-BLS: a tensor on neither the CPU nor a CUDA
    device raises (no fallback)."""
    x = torch.zeros((2, 24), dtype=torch.int64, device="meta")
    d = torch.zeros((26, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        batch_exp.batch_exp_bls_glv(x, x, d, d, d[:2])
    with pytest.raises(ValueError, match="no kernel"):
        batch_exp.batch_exp_bls_glv_signed(x, x, d, d)
    with pytest.raises(ValueError, match="no kernel"):
        C.decompress(x, torch.zeros(2, dtype=torch.bool, device="meta"), "g1")
