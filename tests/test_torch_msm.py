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
* K3 and K5 plain against a per-lane loop over refimpl points, K4 plain
  against sum_l (l // g) S_l from refimpl;
* the kernels' per-thread code (csrc/msm.cu), compiled for the host with
  g++, against the plain versions (the kernels themselves run only on a
  GPU: the `gpu` test).

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
        assert M.window_groups(c) == pallas_msm._window_groups(c).tolist()
        assert M.num_windows(c) == len(M.window_groups(c))
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
    buckets = M.bucket_accumulate(pts.x, pts.y, pts.inf, shifts, *prep[:4])
    sums = M.bucket_reduce(buckets, prep.groups)
    return dict(ks=ks, logs=logs, pts=pts, prep=prep, shifts=shifts, buckets=buckets, sums=sums,
                out=M.combine_windows(sums, c), c=c, n=n)


def _host(jac, shape):
    """Jacobian batch -> refimpl points (nested lists of `shape`)."""
    flat = _msm_points(G.JacobianBatch(*(t.reshape(-1, 16) for t in jac)), "g1")
    return np.array(flat, dtype=object).reshape(shape)


def test_stages_match_per_lane_loops(stages):
    """K3 plain against each lane's run summed with refimpl; K4 plain
    against sum_l (l // g) S_l; K5 plain against sum_w 2^(c w) T_w."""
    c, n, prep = stages["c"], stages["n"], stages["prep"]
    nwin, b = prep.starts.shape
    buckets = _host(stages["buckets"], (2, nwin, b))
    digits = M.all_window_digits(convert.ints_to_limbs(stages["ks"], "cpu"), c).T
    for s in (0, 1):
        pts = [GEN["g1"].mul(m) for m in stages["logs"][s : s + n]]
        for w in range(nwin):
            g = int(prep.groups[w])
            for d in range(1, b // g):
                members = [pts[i] for i in range(n) if int(digits[w, i]) == d]
                sub = -(-len(members) // g)
                for part in range(g):
                    want = rc.point_zero("g1")
                    for p in members[part * sub : (part + 1) * sub]:
                        want = want.add(p)
                    assert buckets[s, w, d * g + part] == want, (s, w, d, part)
        sums = _host(stages["sums"], (2, nwin))
        for w in range(nwin):
            want = rc.point_zero("g1")
            for lane in range(b):
                want = want.add(buckets[s, w, lane].mul(lane // int(prep.groups[w])))
            assert sums[s, w] == want
        want = rc.point_zero("g1")
        for w in range(nwin):
            want = want.add(sums[s, w].mul(1 << (c * w)))
        assert _host(stages["out"], (2,))[s] == want == _want("g1", stages["logs"][s : s + n], stages["ks"])


_HOST_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "msm.cu"
template <class F>
void acc(const int64_t* x, const int64_t* y, const bool* inf, const int64_t* shifts, const int64_t* orders,
         const int64_t* starts, const int64_t* counts, const int64_t* groups, int64_t* ox, int64_t* oy, int64_t* oz,
         int nsets, int n, int nwin, int b) {
  for (int64_t t = 0; t < (int64_t)nsets * nwin * b; ++t)
    bucket_accumulate_lane<F>(x, y, inf, shifts, orders, starts, counts, groups, ox, oy, oz, t, n, nwin, b);
}
extern "C" void host_accumulate_g1(const int64_t* x, const int64_t* y, const bool* inf, const int64_t* shifts,
                                   const int64_t* orders, const int64_t* starts, const int64_t* counts,
                                   const int64_t* groups, int64_t* ox, int64_t* oy, int64_t* oz, int nsets, int n,
                                   int nwin, int b) {
  acc<Fp>(x, y, inf, shifts, orders, starts, counts, groups, ox, oy, oz, nsets, n, nwin, b);
}
extern "C" void host_accumulate_g2(const int64_t* x, const int64_t* y, const bool* inf, const int64_t* shifts,
                                   const int64_t* orders, const int64_t* starts, const int64_t* counts,
                                   const int64_t* groups, int64_t* ox, int64_t* oy, int64_t* oz, int nsets, int n,
                                   int nwin, int b) {
  acc<Fp2>(x, y, inf, shifts, orders, starts, counts, groups, ox, oy, oz, nsets, n, nwin, b);
}
extern "C" void host_reduce_g1(const int64_t* bx, const int64_t* by, const int64_t* bz, const int64_t* groups,
                               int64_t* ox, int64_t* oy, int64_t* oz, int nsets, int nwin, int b) {
  for (int64_t t = 0; t < (int64_t)nsets * nwin; ++t) bucket_reduce_window<Fp>(bx, by, bz, groups, ox, oy, oz, t, nwin, b);
}
extern "C" void host_combine_g1(const int64_t* sx, const int64_t* sy, const int64_t* sz, int64_t* ox, int64_t* oy,
                                int64_t* oz, int nsets, int nwin, int c) {
  for (int64_t s = 0; s < nsets; ++s) combine_windows_point<Fp>(sx, sy, sz, ox, oy, oz, s, nwin, c);
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
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def test_cuda_sources_arithmetic_on_host_matches_plain(stages, host_lib):
    """csrc/msm.cu's per-thread functions compiled by g++ (CUDA qualifiers
    defined away), run on the CPU: K3 and K5 limb for limb, K4 after
    normalizing."""
    pts, prep, shifts, c = stages["pts"], stages["prep"], stages["shifts"], stages["c"]
    (nwin, n), b = prep.orders.shape, prep.starts.shape[1]
    out = [torch.empty_like(t) for t in stages["buckets"]]
    host_lib.host_accumulate_g1(*_ptrs(pts.x, pts.y, pts.inf, shifts, *prep[:4], *out), 2, n, nwin, b)
    assert all(torch.equal(a, w) for a, w in zip(out, stages["buckets"]))
    sums = [torch.empty_like(t) for t in stages["sums"]]
    host_lib.host_reduce_g1(*_ptrs(*stages["buckets"], prep.groups, *sums), 2, nwin, b)
    assert _host(sums, (2, nwin)).tolist() == _host(stages["sums"], (2, nwin)).tolist()
    res = [torch.empty_like(t) for t in stages["out"]]
    host_lib.host_combine_g1(*_ptrs(*stages["sums"], *res), 2, nwin, c)
    assert all(torch.equal(a, w) for a, w in zip(res, stages["out"]))


def test_cuda_sources_g2_accumulate_on_host_matches_plain(host_lib):
    """K3 over Fq2 (the G2 template), equal scalars so that the runs are long
    and hit the doubling and cancelling cases."""
    rng = np.random.default_rng(3)
    n, c = 12, 7
    logs = _multiples(rng, n, (1, 2, 3, -6, 5))
    pts = _points("g2", logs)
    prep = M.prep_windows(convert.ints_to_limbs([_uniform(rng, 1)[0]] * n, "cpu"), c)
    shifts = torch.tensor([0])
    want = M.bucket_accumulate(pts.x, pts.y, pts.inf, shifts, *prep[:4])
    out = [torch.empty_like(t) for t in want]
    host_lib.host_accumulate_g2(*_ptrs(pts.x, pts.y, pts.inf, shifts, *prep[:4], *out), 1, n, *prep.starts.shape)
    assert all(torch.equal(a, w) for a, w in zip(out, want))


def test_wrappers_take_no_other_device():
    x = torch.zeros((2, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        M.bucket_reduce(G.JacobianBatch(x[None, None], x[None, None], x[None, None]), x[0])


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_kernels_match_plain_on_gpu(group):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    n, c = 300, 8
    ks = _uniform(rng, n - 20) + [9] * 20
    logs = _multiples(rng, n + 1, (1, 2, 3, -6, 5))
    pts = _points(group, logs)
    prep = M.prep_windows(convert.ints_to_limbs(ks, "cpu"), c)
    shifts = torch.tensor([0, 1])
    plain_b = M.bucket_accumulate(pts.x, pts.y, pts.inf, shifts, *prep[:4])
    plain_s = M.bucket_reduce(plain_b, prep.groups)
    plain_o = M.combine_windows(plain_s, c)
    cuda = [t.cuda() for t in (pts.x, pts.y, pts.inf, shifts, *prep[:4])]
    before = dict(M.LAUNCHES)
    got_b = M.bucket_accumulate(*cuda)
    got_s = M.bucket_reduce(got_b, cuda[-1])
    got_o = M.combine_windows(G.JacobianBatch(*(t.cpu().cuda() for t in plain_s)), c)
    assert all(M.LAUNCHES[k] == before[k] + 1 for k in before)
    assert all(torch.equal(a.cpu(), w) for a, w in zip(got_b, plain_b))
    assert _msm_points(G.JacobianBatch(*(t.cpu() for t in got_s)), group) == _msm_points(plain_s, group)
    assert all(torch.equal(a.cpu(), w) for a, w in zip(got_o, plain_o))
