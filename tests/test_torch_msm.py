"""The port's Pippenger MSM (ops/msm.py: prep, K3, K4, K5) against the JAX
package's helpers and refimpl, on the CPU (plain versions).

* `window_digits`, `window_groups`, `pick_window` against
  `phase2_bn254_tpu.ops.msm._window_digits` and `ops.pallas_msm`;
* `msm` / `msm_sets` against sum k_i P_i from refimpl integers (the
  points are known multiples m_i G, so the sum is (sum k_i m_i) G) at
  N in {1, 2, 255, 300} and c in {7, 8, 9}, G1 and G2, on the
  distributions of tests/test_msm.py: uniform, all-equal scalars (whose
  bucket runs hit the doubling and the cancelling mixed add), a ones mix
  with points at infinity, several hot buckets, all zero, and scalars
  >= 2^252 (the grouped top window);
* `TorchBackend.msm` on host points against the same sum;
* K3 and K5 plain against a per-bucket loop over refimpl points, K4 plain
  against sum_l l S_l from refimpl;
* the sub-run table of `prep_windows` (every digit's run cut into sub-runs
  of at most SUBRUN points) against the digits;
* K3's sub-runs and tree at their edges (runs of exactly SUBRUN points, one
  more, several; equal partials, whose tree add doubles; cancelling
  partials; points at infinity inside a sub-run; the top window's short
  digits): bucket sums against refimpl integers, the MSM against refimpl;
* the kernels' per-thread code (csrc/msm.cu), compiled for the host with
  g++ and run thread by thread in the kernels' order, against the plain
  versions (the kernels themselves run only on a GPU: the `gpu` test);
  K5's level functions at its edges (a top window or every window at
  infinity, a window sum equal to the running point or to its negation,
  S = 1, 2, 5 sets, G1 and G2).

Tolerance: exact. K3 and K5 agree with their plain versions limb for limb;
K4 adds in another order than its plain version, so those two are compared
after normalizing (the affine points); MSM results are compared as points.
"""

import ctypes
import os
import random
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase2_bn254_tpu.ops import msm as jmsm
from phase2_bn254_tpu.ops import pallas_msm
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.curve import group as G
from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
from phase2_bn254_tpu_torch.ops import _build
from phase2_bn254_tpu_torch.ops import msm as M
from phase2_bn254_tpu_torch.ops.backend import TorchBackend
from phase2_bn254_tpu_torch.refimpl import curve as rc
from phase2_bn254_tpu_torch.refimpl.field import R_MOD

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GEN = {"g1": rc.G1_GEN, "g2": rc.G2_GEN}
OPS = {"g1": FQ, "g2": FQ2}


def _uniform(rng, n):
    return [int(v) for v in rng.integers(0, 2**63, size=(n, 4)).dot([1, 2**63, 2**126, 2**189]) % R_MOD]


def _top(rng, n):
    """Scalars >= 2^252: every top-window digit is nonzero."""
    return [(1 << 252) + v % (R_MOD - (1 << 252)) for v in _uniform(rng, n)]


def _multiples(rng, n, pattern=()):
    """Point discrete logs: `pattern` first, then a + i d for random a, d."""
    a, d = _uniform(rng, 2)
    return list(pattern) + [(a + i * d) % R_MOD for i in range(n - len(pattern))]


def _points(group, logs):
    """The points m G as an AffineBatch; a step between neighbouring logs
    that repeats is an addition of the step's point (cheap host arithmetic)."""
    gen, pts, steps = GEN[group], [], {}
    for i, m in enumerate(logs):
        step = (m - logs[i - 1]) % R_MOD if i else None
        if step in steps:
            pts.append(pts[-1].add(steps[step]))
        else:
            pts.append(gen.mul(m % R_MOD) if m % R_MOD else rc.point_zero(group))
            if step is not None:
                steps[step] = gen.mul(step)
    return convert.points_to_affine(pts, group, "cpu")


def _want(group, logs, scalars, inf=()):
    return GEN[group].mul(sum(k * m for i, (k, m) in enumerate(zip(scalars, logs)) if i not in inf) % R_MOD)


def _msm_points(jac, group):
    aff = G.jac_normalize(OPS[group], G.JacobianBatch(*(t.reshape(-1, *t.shape[-(2 if group == "g2" else 1):])
                                                        for t in jac)))
    return convert.affine_to_points(aff, group)


def test_window_helpers_match_jax():
    rng = np.random.default_rng(1)
    vals = _uniform(rng, 20) + [R_MOD - 1, 0, 1, (1 << 253) + 5]
    limbs = convert.ints_to_limbs(vals, "cpu")
    jl = jnp.asarray(limbs.numpy().astype(np.uint32))
    for c in (7, 8, 9, 13):
        assert M.num_windows(c) == len(pallas_msm._window_groups(c))
        for w in range(M.num_windows(c)):
            want = np.asarray(jmsm._window_digits(jl, c, w)).astype(np.int64)
            assert np.array_equal(M.window_digits(limbs, c, w).numpy(), want), (c, w)
    for n in (1, 2, 255, 300, 2048, 1 << 16, 1 << 20, 1 << 24):
        assert M.pick_window(n) == pallas_msm.pick_window(n)


# (name, group, n, c, shifts, scalars(rng, n), point pattern, infinity indices)
CASES = [
    ("uniform", "g1", 300, 9, (0, 1), _uniform, (), ()),
    ("uniform_top", "g2", 255, 8, (0,), lambda r, n: _uniform(r, n - 40) + _top(r, 40), (), ()),
    # equal scalars: each bucket's run is m = 1, 2, 3, -6, 5, ... in index
    # order, so its running sums hit P == Q (1 + 2 == 3) and P == -Q (6 - 6)
    ("equal", "g1", 255, 7, (0, 1), lambda r, n: [_uniform(r, 1)[0]] * n, (1, 2, 3, -6, 5), ()),
    ("equal", "g2", 2, 9, (0,), lambda r, n: [_uniform(r, 1)[0]] * n, (), ()),
    ("ones_inf", "g1", 300, 8, (0,), lambda r, n: [1] * (n // 2) + [0] * 5 + _uniform(r, n - n // 2 - 5), (),
     (3, 9, 200)),
    ("hot", "g1", 255, 9, (0,), lambda r, n: [[5, R_MOD - 1, 1 << 252][i % 3] for i in range(n)], (), ()),
    ("hot_top", "g2", 300, 7, (0,), lambda r, n: [[7, (1 << 253) + 9, 12345][i % 3] for i in range(n)], (), ()),
    ("zero", "g1", 2, 8, (0,), lambda r, n: [0] * n, (), ()),
    ("one_point", "g1", 1, 7, (0,), _top, (), ()),
    ("ones_inf", "g2", 2, 8, (0, 1), lambda r, n: [1, _top(r, 1)[0]], (), (1,)),
    ("zero", "g2", 1, 9, (0,), lambda r, n: [0] * n, (), ()),
]


@pytest.mark.parametrize("name,group,n,c,shifts,scalars,pattern,inf", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_msm_matches_refimpl(name, group, n, c, shifts, scalars, pattern, inf):
    rng = np.random.default_rng(sum(map(ord, name)))
    ks = scalars(rng, n)
    logs = _multiples(rng, n + max(shifts), pattern)
    pts = _points(group, logs)
    pts = pts._replace(inf=torch.tensor([i in inf for i in range(len(logs))]))
    if shifts == (0,):
        got = _msm_points(G.JacobianBatch(*(t[None] for t in M.msm(pts, convert.ints_to_limbs(ks, "cpu"), c))), group)
    else:
        got = _msm_points(M.msm_sets([(pts, convert.ints_to_limbs(ks, "cpu"), shifts)], c), group)
    assert got == [_want(group, logs[s : s + n], ks, {i - s for i in inf}) for s in shifts]


def test_backend_msm_matches_refimpl():
    """TorchBackend.msm (msm_async + msm_wait) on host points, scalars given
    as ints not yet reduced mod r."""
    rng = np.random.default_rng(4)
    logs, ks = _multiples(rng, 3), _uniform(rng, 3)
    be = TorchBackend("cpu")
    got = be.msm(be.from_points([GEN["g1"].mul(m) for m in logs], "g1"), [k + R_MOD for k in ks])
    assert got == _want("g1", logs, ks)


@pytest.fixture(scope="module")
def stages():
    """One small G1 MSM's stages: inputs, buckets, window sums, result."""
    rng = np.random.default_rng(7)
    n, c = 40, 7
    ks = _uniform(rng, n - 8) + [3] * 4 + _top(rng, 4)
    logs = _multiples(rng, n + 1, (4, 4))
    pts = _points("g1", logs)
    prep = M.prep_windows(convert.ints_to_limbs(ks, "cpu"), c)
    shifts = torch.tensor([0, 1])
    buckets = M.bucket_accumulate(pts.x, pts.y, pts.inf, shifts, *prep[:5])
    sums = M.bucket_reduce(buckets)
    return dict(ks=ks, logs=logs, pts=pts, prep=prep, shifts=shifts, buckets=buckets, sums=sums,
                out=M.combine_windows(sums, c), c=c, n=n)


def _host(jac, shape):
    """Jacobian batch -> refimpl points (nested lists of `shape`)."""
    flat = _msm_points(G.JacobianBatch(*(t.reshape(-1, 16) for t in jac)), "g1")
    return np.array(flat, dtype=object).reshape(shape)


def test_stages_match_per_lane_loops(stages):
    """K3 plain against each digit's points summed with refimpl; K4 plain
    against sum_l l S_l; K5 plain against sum_w 2^(c w) T_w."""
    c, n, prep = stages["c"], stages["n"], stages["prep"]
    nwin, b = prep.starts.shape
    buckets = _host(stages["buckets"], (2, nwin, b))
    digits = M.all_window_digits(convert.ints_to_limbs(stages["ks"], "cpu"), c).T
    for s in (0, 1):
        pts = [GEN["g1"].mul(m) for m in stages["logs"][s : s + n]]
        for w in range(nwin):
            for d in range(b):
                want = rc.point_zero("g1")
                for i in range(n):
                    if d and int(digits[w, i]) == d:
                        want = want.add(pts[i])
                assert buckets[s, w, d] == want, (s, w, d)
        sums = _host(stages["sums"], (2, nwin))
        for w in range(nwin):
            want = rc.point_zero("g1")
            for lane in range(b):
                want = want.add(buckets[s, w, lane].mul(lane))
            assert sums[s, w] == want
        want = rc.point_zero("g1")
        for w in range(nwin):
            want = want.add(sums[s, w].mul(1 << (c * w)))
        assert _host(stages["out"], (2,))[s] == want == _want("g1", stages["logs"][s : s + n], stages["ks"])


@pytest.mark.parametrize("n,c,scalars", [(40, 7, "uniform"), (300, 9, "equal"), (300, 8, "ones"), (0, 7, "none")])
def test_subrun_table_covers_each_run(n, c, scalars):
    """Every digit's run of the sorted order, cut in order into sub-runs of
    at most SUBRUN points, within the static subruns(N, c) a window."""
    rng = np.random.default_rng(n + c)
    ks = {"uniform": _uniform(rng, n), "equal": [12345] * n, "ones": [1] * (n // 2) + _uniform(rng, n - n // 2),
          "none": []}[scalars]
    prep = M.prep_windows(convert.ints_to_limbs(ks, "cpu").reshape(n, 16), c)
    digits = M.all_window_digits(convert.ints_to_limbs(ks, "cpu").reshape(n, 16), c).T
    assert prep.runs.shape == (M.num_windows(c), M.subruns(n, c))
    lo, length, rank, nsub = M.subrun_table(*prep[1:5])
    b, L = 1 << c, M.SUBRUN
    for w in range(M.num_windows(c)):
        live = prep.runs[w] < b
        assert int(live.sum()) <= M.subruns(n, c) - 1 and not bool(live[int(live.sum()):].any())
        got, seen = {}, {}
        for j in live.nonzero().squeeze(1).tolist():
            d = int(prep.runs[w, j])
            assert 0 < int(length[w, j]) <= L and int(rank[w, j]) == seen.get(d, 0)
            seen[d] = seen.get(d, 0) + 1
            got.setdefault(d, []).extend(prep.orders[w, lo[w, j] : lo[w, j] + length[w, j]].tolist())
        want = {}
        for i, d in enumerate(digits[w].tolist()):
            if d:
                want.setdefault(d, []).append(i)
        assert got == want
        for d, idx in want.items():
            assert int(nsub[w, prep.first[w, d]]) == -(-len(idx) // L) == int(-(-prep.counts[w, d] // L))


_HOST_SHIM = r"""
#include <cstdint>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "msm.cu"
// K3's three passes and K4's steps, thread by thread, in the kernels' order
// (splits, skips: null in the unsigned mode, without an excluded lane)
template <class F>
void acc(const int64_t* x, const int64_t* y, const bool* inf, const int64_t* shifts, const int64_t* orders,
         const int64_t* starts, const int64_t* counts, const int64_t* first, const int64_t* runs,
         const int64_t* splits, int64_t* px, int64_t* py, int64_t* pz, int64_t* ox, int64_t* oy, int64_t* oz, int nsets,
         int n, int nwin, int m, int b, int sub, int levels) {
  int64_t parts = (int64_t)nsets * nwin * m;
  for (int64_t t = 0; t < parts; ++t)
    accumulate_subrun<F>(x, y, inf, shifts, orders, starts, counts, first, runs, px, py, pz, t, n, nwin, m, b, sub,
                         splits);
  for (int level = 0; level < levels; ++level)
    for (int64_t t = 0; t < parts; ++t) accumulate_tree_step<F>(px, py, pz, counts, first, runs, t, nwin, m, b, sub, level);
  for (int64_t t = 0; t < (int64_t)nsets * nwin * b; ++t)
    accumulate_collect<F>(px, py, pz, counts, first, ox, oy, oz, t, nwin, m, b);
}
template <class F>
void reduce(const int64_t* bx, const int64_t* by, const int64_t* bz, const int64_t* skips, int64_t* ox, int64_t* oy,
            int64_t* oz, int nsets, int nwin, int b, int nt, bool sgn) {
  std::vector<Jac<F>> run(nt), wsum(nt), held(nt);
  for (int64_t row = 0; row < (int64_t)nsets * nwin; ++row) {
    for (int j = 0; j < nt; ++j) reduce_range<F>(bx, by, bz, row, b, nt, j, run[j], wsum[j], skips ? skips[row] : -1);
    for (int k = 1; k < nt; k <<= 1) {
      held = run;  // what every thread holds before the step
      for (int j = 0; j < nt; ++j) run[j] = reduce_suffix_step<F>(run[j], held.data(), j, k, nt);
    }
    for (int j = 0; j < nt; ++j) held[j] = reduce_weigh<F>(run[j], wsum[j], j, b / nt, sgn);
    for (int stride = nt / 2; stride >= 1; stride >>= 1)
      for (int j = 0; j < nt; ++j) reduce_tree_step<F>(held.data(), j, stride);
    store_jac(ox, oy, oz, row, held[0]);
  }
}
#define SHIM(G, F)                                                                                                \
  extern "C" void host_accumulate_##G(const int64_t* x, const int64_t* y, const bool* inf, const int64_t* shifts, \
                                      const int64_t* orders, const int64_t* starts, const int64_t* counts,        \
                                      const int64_t* first, const int64_t* runs, const int64_t* splits,           \
                                      int64_t* px, int64_t* py, int64_t* pz, int64_t* ox, int64_t* oy,            \
                                      int64_t* oz, int nsets, int n, int nwin, int m, int b, int sub,             \
                                      int levels) {                                                               \
    acc<F>(x, y, inf, shifts, orders, starts, counts, first, runs, splits, px, py, pz, ox, oy, oz, nsets, n,      \
           nwin, m, b, sub, levels);                                                                              \
  }                                                                                                               \
  extern "C" void host_reduce_##G(const int64_t* bx, const int64_t* by, const int64_t* bz, const int64_t* skips,  \
                                  int64_t* ox, int64_t* oy, int64_t* oz, int nsets, int nwin, int b, int nt,      \
                                  int sgn) {                                                                      \
    reduce<F>(bx, by, bz, skips, ox, oy, oz, nsets, nwin, b, nt, sgn != 0);                                       \
  }
SHIM(g1, Fp)
SHIM(g2, Fp2)
// K5's level functions in order, every product on this thread (bx .. weights
// null without the fold)
#define COMBINE(G, F)                                                                                             \
  extern "C" void host_combine_##G(const int64_t* sx, const int64_t* sy, const int64_t* sz, const int64_t* bx,    \
                                   const int64_t* by, const int64_t* bz, const int64_t* lanes,                    \
                                   const int64_t* weights, int64_t* ox, int64_t* oy, int64_t* oz, int nsets,      \
                                   int nwin, int c, int b) {                                                      \
    for (int64_t s = 0; s < nsets; ++s)                                                                           \
      store_jac(ox, oy, oz, s,                                                                                    \
                combine_windows_set<F>(sx, sy, sz, s, nwin, c, SerialProducts(), bx, by, bz, lanes, weights, b)); \
  }
COMBINE(g1, Fp)
COMBINE(g2, Fp2)
// what K5 adds to its fold counters for each set of a launch
extern "C" void host_set_folds(const int64_t* weights, int nsets, int nwin, int* out) {
  for (int s = 0; s < nsets; ++s) out[s] = set_folds(weights, s, nwin);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("msm_shim")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(d / "shim.so")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(d / "shim.so"))


def _ptrs(*ts):
    """Data pointers; None passes a null pointer."""
    return [ctypes.c_void_p(None if t is None else t.data_ptr()) for t in ts]


def _host_accumulate(host_lib, group, pts, shifts, prep):
    """K3's per-thread code on the host (signed where prep has splits): (S,
    nwin, B) bucket sums."""
    (nwin, n), b, m = prep.orders.shape, prep.starts.shape[1], prep.runs.shape[1]
    el = tuple(pts.x.shape[1:])
    parts = [torch.empty((len(shifts), nwin, m, *el), dtype=torch.int64) for _ in range(3)]
    out = [torch.empty((len(shifts), nwin, b, *el), dtype=torch.int64) for _ in range(3)]
    getattr(host_lib, f"host_accumulate_{group}")(*_ptrs(pts.x, pts.y, pts.inf, shifts, *prep[:5], prep.splits,
                                                         *parts, *out),
                                                  len(shifts), n, nwin, m, b, M.SUBRUN, M.tree_levels(n))
    return G.JacobianBatch(*out)


def _host_reduce(host_lib, group, buckets, signed=False, exclude=None):
    """K4's per-thread code on the host: (S, nwin) window sums."""
    nsets, nwin, b = buckets.x.shape[:3]
    out = [torch.empty((nsets, nwin, *buckets.x.shape[3:]), dtype=torch.int64) for _ in range(3)]
    getattr(host_lib, f"host_reduce_{group}")(*_ptrs(*buckets, exclude, *out), nsets, nwin, b, M.reduce_threads(b),
                                              int(signed))
    return G.JacobianBatch(*out)


def _host_combine(host_lib, group, sums, c, buckets=None, hot=None):
    """K5's level functions on the host, every product on one thread: (S,)
    points."""
    nsets, nwin = sums.x.shape[:2]
    out = [torch.empty((nsets, *sums.x.shape[2:]), dtype=torch.int64) for _ in range(3)]
    fold = (None,) * 5 if hot is None else (*buckets, *hot)
    getattr(host_lib, f"host_combine_{group}")(*_ptrs(*sums, *fold, *out), nsets, nwin, c,
                                               0 if buckets is None else buckets.x.shape[2])
    return G.JacobianBatch(*out)


def _affine(group, jac):
    """Window sums (S, nwin) -> refimpl points, for comparing Jacobian
    coordinates that differ (another order of adds)."""
    return _msm_points(G.JacobianBatch(*(t.reshape(-1, *t.shape[2:]) for t in jac)), group)


def test_cuda_sources_arithmetic_on_host_matches_plain(stages, host_lib):
    """csrc/msm.cu's per-thread functions compiled by g++ (CUDA qualifiers
    defined away), run on the CPU: K3 and K5 limb for limb, K4 after
    normalizing."""
    pts, prep, shifts, c = stages["pts"], stages["prep"], stages["shifts"], stages["c"]
    nwin = prep.orders.shape[0]
    out = _host_accumulate(host_lib, "g1", pts, shifts, prep)
    assert all(torch.equal(a, w) for a, w in zip(out, stages["buckets"]))
    sums = _host_reduce(host_lib, "g1", stages["buckets"])
    assert _host(sums, (2, nwin)).tolist() == _host(stages["sums"], (2, nwin)).tolist()
    res = _host_combine(host_lib, "g1", stages["sums"], c)
    assert all(torch.equal(a, w) for a, w in zip(res, stages["out"]))


def _rand_el(group, n, rng):
    """n random canonical Fq (Fq2) values, int64 (n, 16) ((n, 2, 16))."""
    from phase2_bn254_tpu_torch.refimpl.field import Q

    def fq():
        return convert.ints_to_limbs([v % Q for v in _uniform(rng, n)], "cpu")

    return fq() if group == "g1" else torch.stack([fq(), fq()], dim=1)


def _window_sums(group, rows, rng):
    """(S, nwin) Jacobian window sums: rows[s][w] a discrete log m (the
    point m G with a random z) or None (infinity: z = 0, random x and y,
    as a cancelling add leaves them)."""
    f, nwin = OPS[group], len(rows[0])
    logs = [m for row in rows for m in row]
    aff = convert.points_to_affine([GEN[group].mul(m or 1) for m in logs], group, "cpu")
    z = _rand_el(group, len(logs), rng)
    z2 = f.mul(z, z)
    jac = G.JacobianBatch(f.mul(aff.x, z2), f.mul(aff.y, f.mul(z2, z)), z)
    inf = torch.tensor([m is None for m in logs])
    junk = G.JacobianBatch(_rand_el(group, len(logs), rng), _rand_el(group, len(logs), rng), torch.zeros_like(z))
    out = G.JacobianBatch(*(f.select(inf, b, a) for a, b in zip(jac, junk)))
    return G.JacobianBatch(*(t.reshape(len(rows), nwin, *t.shape[1:]) for t in out))


def _k5_row(kind, c, nwin, rng):
    """One set's window logs (least significant first) for a K5 edge case."""
    row = [m % (R_MOD - 1) + 1 for m in _uniform(rng, nwin)]

    def running(w):  # the log of K5's point just before it adds T_w
        return sum(row[v] << (c * (v - w)) for v in range(w + 1, nwin)) % R_MOD

    if kind == "top_infinity":
        row[-2:] = [None, None]
    elif kind == "all_infinity":
        row = [None] * nwin
    elif kind == "equal":  # T_1 == the running point: the add doubles
        row[1] = running(1)
    elif kind == "negation":  # T_2 == -(the running point): infinity, then T_1
        row[2] = R_MOD - running(2)
    return row


K5_KINDS = ("random", "top_infinity", "all_infinity", "equal", "negation")
K5_CASES = [("g1", ("random",)), ("g1", ("top_infinity", "all_infinity")), ("g1", K5_KINDS),
            ("g2", ("equal", "negation")), ("g2", K5_KINDS)]


@pytest.mark.parametrize("group,kinds", K5_CASES, ids=[f"{g}-S{len(k)}-{k[0]}" for g, k in K5_CASES])
def test_combine_levels_on_host_match_plain(group, kinds, host_lib):
    """K5's level functions (csrc/msm.cu jac_double_levels, jac_add_levels,
    combine_windows_set from the highest finite window) run in order by g++
    against combine_windows_plain limb for limb, S = 1, 2, 5 sets: a top
    window at infinity, all windows at infinity, a window sum equal to the
    running point and one equal to its negation; the plain result against
    sum_w 2^(c w) T_w from refimpl."""
    rng = np.random.default_rng(len(kinds) + 10 * (group == "g2"))
    c, nwin = 9, 5
    rows = [_k5_row(kind, c, nwin, rng) for kind in kinds]
    sums = _window_sums(group, rows, rng)
    want = M.combine_windows_plain(sums, c)
    got = _host_combine(host_lib, group, sums, c)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    logs = [sum((m or 0) << (c * w) for w, m in enumerate(row)) % R_MOD for row in rows]
    assert _msm_points(want, group) == [GEN[group].mul(m) if m else rc.point_zero(group) for m in logs]


def test_cuda_sources_g2_accumulate_on_host_matches_plain(host_lib):
    """K3 and K4 over Fq2 (the G2 templates), equal scalars so that the runs
    are long and hit the doubling and cancelling cases."""
    rng = np.random.default_rng(3)
    n, c = 12, 7
    logs = _multiples(rng, n, (1, 2, 3, -6, 5))
    pts = _points("g2", logs)
    prep = M.prep_windows(convert.ints_to_limbs([_uniform(rng, 1)[0]] * n, "cpu"), c)
    shifts = torch.tensor([0])
    want = M.bucket_accumulate(pts.x, pts.y, pts.inf, shifts, *prep[:5])
    out = _host_accumulate(host_lib, "g2", pts, shifts, prep)
    assert all(torch.equal(a, w) for a, w in zip(out, want))
    assert _affine("g2", _host_reduce(host_lib, "g2", want)) == _affine("g2", M.bucket_reduce(want))


def _digit_runs(rng, L):
    """Window 0 holds runs of exactly L, L + 1 and 2 L points (digits 5, 6,
    7) and three others; above it, each scalar is one of three random
    values."""
    ds = [5] * L + [6] * (L + 1) + [7] * (2 * L) + [8, 9, 10]
    high = [v >> 9 << 9 for v in _uniform(rng, 3)]
    ks = [high[i % 3] + d for i, d in enumerate(ds)]
    return [ks[i] for i in rng.permutation(len(ks))], _multiples(rng, len(ks)), ()


def _equal_partials(rng, L):
    """4 L copies of one point, one scalar: every partial is L P, so the
    tree adds P == Q twice (doubling)."""
    m = _uniform(rng, 1)[0]
    return [_uniform(rng, 1)[0]] * (4 * L), [m] * (4 * L), ()


def _cancelling_partials(rng, L):
    """One scalar; L points m G, then L points -m G, then L + 1 others: the
    first two partials cancel (P == -Q), the third adds to infinity."""
    m = _uniform(rng, 1)[0]
    return [_uniform(rng, 1)[0]] * (3 * L + 1), [m] * L + [R_MOD - m] * L + _multiples(rng, L + 1), ()


def _infinity_inside(rng, L):
    """One scalar over 2 L + 3 points (3 sub-runs), points at infinity at
    ranks 0, 3, L - 1 and L, and the whole third sub-run."""
    n = 2 * L + 3
    return [_uniform(rng, 1)[0]] * n, _multiples(rng, n + 1), (0, 3, L - 1, L, 2 * L, 2 * L + 1, 2 * L + 2, n)


def _top_window(rng, L):
    """300 scalars t 2^252 + d, t in 1..3 (the top window's 2-bit digits at
    c = 9: about 100 points each), d in 1..7."""
    ks = [int(t) * (1 << 252) + int(d) for t, d in zip(rng.integers(1, 4, 300), rng.integers(1, 8, 300))]
    return ks, _multiples(rng, 300), ()


# (name, group, c, shifts, build(rng, L) -> (scalars, point logs, infinity indices))
EDGES = [
    ("runs", "g1", 9, (0,), _digit_runs),
    ("equal_partials", "g1", 8, (0,), _equal_partials),
    ("cancelling_partials", "g2", 8, (0,), _cancelling_partials),
    ("infinity_inside", "g1", 9, (0, 1), _infinity_inside),
    ("top_window", "g2", 9, (0,), _top_window),
]


@pytest.mark.parametrize("name,group,c,shifts,build", EDGES, ids=[e[0] for e in EDGES])
def test_subrun_edges_match_refimpl(name, group, c, shifts, build, host_lib):
    """K3 plain at the edges of its sub-runs and tree: each bucket sum
    against (sum of its points' logs) G, the MSM against refimpl; K3's
    per-thread code on the host == plain limb for limb, K4's == plain after
    normalizing."""
    rng = np.random.default_rng(sum(map(ord, name)))
    ks, logs, inf = build(rng, M.SUBRUN)
    n = len(ks)
    assert n <= 300 and len(logs) == n + max(shifts)
    pts = _points(group, logs)._replace(inf=torch.tensor([i in inf for i in range(len(logs))]))
    k = convert.ints_to_limbs(ks, "cpu")
    prep = M.prep_windows(k, c)
    shift_t = torch.tensor(shifts)
    buckets = M.bucket_accumulate(pts.x, pts.y, pts.inf, shift_t, *prep[:5])
    digits = M.all_window_digits(k, c).T.tolist()
    for s in shifts:
        want = {}
        for w, row in enumerate(digits):
            for i, d in enumerate(row):
                if d and i + s not in inf:
                    want[w, d] = (want.get((w, d), 0) + logs[i + s]) % R_MOD
        z = OPS[group].is_zero(buckets.z[shifts.index(s)])
        assert sorted(map(tuple, (~z).nonzero().tolist())) == sorted(key for key, v in want.items() if v)
        live = sorted(key for key, v in want.items() if v)
        if live:
            w_idx, d_idx = torch.tensor(live).T
            got = _msm_points(G.JacobianBatch(*(t[shifts.index(s), w_idx, d_idx] for t in buckets)), group)
            assert got == [GEN[group].mul(want[key]) for key in live]
    host = _host_accumulate(host_lib, group, pts, shift_t, prep)
    assert all(torch.equal(a, w) for a, w in zip(host, buckets))
    sums = M.bucket_reduce(buckets)
    assert _affine(group, _host_reduce(host_lib, group, buckets)) == _affine(group, sums)
    got = _msm_points(M.combine_windows(sums, c), group)
    assert got == [_want(group, logs[s : s + n], ks, {i - s for i in inf}) for s in shifts]


def test_wrappers_take_no_other_device():
    x = torch.zeros((2, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        M.bucket_reduce(G.JacobianBatch(x[None, None], x[None, None], x[None, None]))


@pytest.mark.gpu
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("scalars", ["uniform", "hot"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_kernels_match_plain_on_gpu(group, scalars, signed):
    """The kernels against their plain versions on the same inputs, in the
    unsigned and the signed mode; "hot": all-equal scalars, one bucket of
    300 points a window, which the gate folds (K4 leaves it out, K5 adds it
    with its weight)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    n, c = 300, 8
    ks = _uniform(rng, n - 20) + [9] * 20 if scalars == "uniform" else [_uniform(rng, 1)[0]] * n
    logs = _multiples(rng, n + 1, (1, 2, 3, -6, 5))
    pts = _points(group, logs)
    prep = (M.prep_windows_signed if signed else M.prep_windows)(convert.ints_to_limbs(ks, "cpu"), c)
    hot = M.Hot(*(t.expand(2, -1).contiguous() for t in M.hot_buckets(prep, n)))
    assert bool((hot.lane >= 0).any()) == (scalars == "hot")
    shifts = torch.tensor([0, 1])
    plain_b = M.bucket_accumulate(pts.x, pts.y, pts.inf, shifts, *prep[:5], prep.splits)
    plain_s = M.bucket_reduce(plain_b, signed, hot.lane)
    plain_o = M.combine_windows(plain_s, c, plain_b, hot)
    cuda = [t.cuda() for t in (pts.x, pts.y, pts.inf, shifts, *prep[:5])]
    splits = None if prep.splits is None else prep.splits.cuda()
    hot_cuda = M.Hot(*(t.cuda() for t in hot))
    before = dict(M.LAUNCHES)
    M.reset_fold_counts()
    got_b = M.bucket_accumulate(*cuda, splits)
    got_s = M.bucket_reduce(got_b, signed, hot_cuda.lane)
    got_o = M.combine_windows(G.JacobianBatch(*(t.cpu().cuda() for t in plain_s)), c,
                              G.JacobianBatch(*(t.cpu().cuda() for t in plain_b)), hot_cuda)
    tag = "_signed" if signed else ""
    assert M.LAUNCHES[f"bucket_accumulate{tag}"] == before[f"bucket_accumulate{tag}"] + M.accumulate_launches(n)
    assert M.LAUNCHES[f"bucket_reduce{tag}"] == before[f"bucket_reduce{tag}"] + 1
    assert M.LAUNCHES["combine_windows"] == before["combine_windows"] + 1
    assert M.fold_counts() == ({"sets": 2, "launches": 1} if scalars == "hot" else {"sets": 0, "launches": 0})
    assert all(torch.equal(a.cpu(), w) for a, w in zip(got_b, plain_b))
    assert _msm_points(G.JacobianBatch(*(t.cpu() for t in got_s)), group) == _msm_points(plain_s, group)
    assert all(torch.equal(a.cpu(), w) for a, w in zip(got_o, plain_o))
    assert _msm_points(plain_o, group) == [_want(group, logs[s : s + n], ks) for s in (0, 1)]
