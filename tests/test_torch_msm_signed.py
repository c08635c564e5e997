"""The signed-digit mode of the port's Pippenger MSM (PHASE2_TPU_MSM_SIGNED)
and its hot-bucket fold (ops/msm.py, csrc/msm.cu), on the CPU (plain
versions), against the JAX package and refimpl:

* `MsmMode.from_env` against `pallas_msm._signed_mode` on the switch's
  values; `pick_window_signed` against the JAX one;
* `signed_digits` against the integers (sum_w e_w 2^(c w) == k, every digit
  in [-2^(c-1), 2^(c-1))) on scalars whose carries run across windows;
* `prep_windows_signed` against `_prep_windows_signed` at c = 8, 9, 13, 16:
  starts, splits and counts equal, each bucket's negative and positive runs
  of `orders` equal as sets of indices (the JAX sort is not stable);
* `hot_buckets` (d*, the weight and the gate) against the JAX prep's
  `dstars` and `occs` and the gate of `msm_pallas_or_none`, unsigned and
  signed, on uniform, all-equal, ones-with-infinity, several-hot and zero
  scalars; the unsigned counts with points at infinity against the JAX
  prep's;
* `msm_sets(..., signed=True)` against sum k_i P_i from refimpl, G1 and G2,
  on the cases of tests/test_torch_msm.py (uniform, R - 1 and scalars >=
  2^252, all-equal, ones with points at infinity, several hot buckets,
  zero) and a constant whose digits are all negative, with the fold where
  the gate takes it (asserted); the unsigned fold likewise;
* csrc/msm.cu's per-thread code compiled by g++ (CUDA qualifiers defined
  away) and run thread by thread: K3 with splits and K5 with the fold limb
  for limb against the plain versions, K4 with signed weights and an
  excluded lane after normalizing; K5's count of the sets and launches that
  fold (`set_folds`) against its rule;
* with PHASE2_TPU_SLOW_TESTS, the JAX package's signed Pallas MSM in
  interpret mode (`msm_pallas_or_none(..., signed=True)`, G1, N = 256, c =
  8) against the port's.

Tolerance: exact. Points are compared as points; K3 and K5 with their plain
versions limb for limb, K4 as affine points.
"""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase2_bn254_tpu.ops import pallas_msm
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.curve import group as G
from phase2_bn254_tpu_torch.ops import msm as M
from phase2_bn254_tpu_torch.ops.backend import MsmMode, TorchBackend
from phase2_bn254_tpu_torch.refimpl import curve as rc
from phase2_bn254_tpu_torch.refimpl.field import R_MOD
from test_torch_msm import (_host_accumulate, _host_combine, _host_reduce, _msm_points, _multiples, _points, _top,
                            _uniform, _want, host_lib)

# one torch thread per pytest-xdist worker (tests/test_torch_msm.py says why)
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.mark.parametrize("value", ["1", "true", " ON ", "0", "", "yes", None])
def test_switch_matches_jax_signed_mode(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("PHASE2_TPU_MSM_SIGNED", raising=False)
    else:
        monkeypatch.setenv("PHASE2_TPU_MSM_SIGNED", value)
    want = pallas_msm._signed_mode()
    assert MsmMode.from_env(os.environ).signed == want
    assert TorchBackend("cpu").msm_mode.signed == want
    assert TorchBackend("cpu", msm_mode=MsmMode(not want)).msm_mode.signed != want


def test_pick_window_signed_matches_jax():
    """pick_window_signed, and the lane-group factors the gate divides by
    (only the top window's differs from 1)."""
    for n in (1, 2, 255, 256, 300, 2048, 1 << 13, 1 << 16, (1 << 18) - 3, 1 << 18, 1 << 20, 1 << 24):
        assert M.pick_window_signed(n) == pallas_msm.pick_window_signed(n)
    for c in range(8, 17):
        assert M.window_groups(c) == pallas_msm._window_groups(c).tolist()
        assert M.window_groups_signed(c) == pallas_msm._window_groups_signed(c).tolist()
        assert set(M.window_groups(c)[:-1]) | set(M.window_groups_signed(c)[:-1]) == {1}


def _carries(c: int) -> list[int]:
    """Scalars below r whose signed recoding carries across many windows:
    runs of digits 2^(c-1) - 1 (which pass a carry on) after a digit >=
    2^(c-1), digits just below and at 2^(c-1), and r - 1."""
    half, nwin = 1 << (c - 1), M.num_windows(c)
    out = [0, 1, half - 1, half, (1 << c) - 1, R_MOD - 1, (1 << 253) + 7]
    out.append(sum((half - 1) << (c * w) for w in range(1, nwin - 1)) + half)  # one carry through every window
    out.append(sum(((1 << c) - 1) << (c * w) for w in range(nwin - 1)))  # every digit -1
    out.append(sum((half if w % 2 else half - 1) << (c * w) for w in range(nwin - 1)))
    return [k % R_MOD for k in out]


@pytest.mark.parametrize("c", [8, 9, 11, 13, 15, 16])
def test_signed_digits_recode_each_scalar(c):
    rng = np.random.default_rng(c)
    ks = _carries(c) + _uniform(rng, 20)
    e = M.signed_digits(convert.ints_to_limbs(ks, "cpu"), c)
    half = 1 << (c - 1)
    assert int(e.min()) >= -half and int(e.max()) < half
    for k, row in zip(ks, e.tolist()):
        assert sum(d << (c * w) for w, d in enumerate(row)) == k


def _scalar_mix(rng, n: int) -> list[int]:
    """n scalars: carry runs, a negative-digit constant, zeros, uniform."""
    ks = _carries(8) + [12345678901234567890] * 20 + [0] * 10
    return (ks + _uniform(rng, n))[:n]


@pytest.mark.parametrize("c", [8, 9, 13, 16])
def test_signed_prep_matches_jax(c):
    n = 256
    rng = np.random.default_rng(100 + c)
    ks = _scalar_mix(rng, n)
    inf = np.zeros(n, dtype=bool)
    inf[[3, 40, 41, 200]] = True
    k = convert.ints_to_limbs(ks, "cpu")
    prep = M.prep_windows_signed(k, c, torch.from_numpy(inf))
    j_orders, j_starts, j_splits, j_counts, _, _ = (
        np.asarray(t).astype(np.int64)
        for t in pallas_msm._prep_windows_signed(jnp.asarray(k.numpy().astype(np.uint32)), jnp.asarray(inf), c))
    assert prep.starts.shape == (M.num_windows(c), 1 << (c - 1))
    assert np.array_equal(prep.starts.numpy(), j_starts)
    assert np.array_equal(prep.splits.numpy(), j_splits)
    assert np.array_equal(prep.counts.numpy(), j_counts)
    # each bucket's negative run, positive run and the zero / infinity tail as
    # sets: sort JAX's orders by (segment, index); the port's sort is stable
    for w in range(M.num_windows(c)):
        bounds = np.concatenate([np.stack([j_starts[w], j_splits[w]], 1).reshape(-1),
                                 [j_starts[w, -1] + j_counts[w, -1]]])
        seg = np.searchsorted(bounds, np.arange(n), side="right")
        assert np.array_equal(prep.orders[w].numpy(), j_orders[w][np.lexsort((j_orders[w], seg))]), w
    assert prep.runs.shape == (M.num_windows(c), M.subruns(n, c, signed=True))


def _gate_case(name, rng, n):
    """(scalars, infinity indices) of a gate case."""
    if name == "uniform":
        return _uniform(rng, n), ()
    if name == "all_equal":
        return [_uniform(rng, 1)[0]] * n, ()
    if name == "ones_inf":  # a witness' ones, points at infinity among them
        return [1] * (n // 2) + _uniform(rng, n - n // 2), (0, 5, 130)
    if name == "several_hot":  # two hot buckets a window: the JAX package leaves Pallas
        return [[7, (1 << 200) + 99][i % 2] for i in range(n)], ()
    return [0] * n, ()


@pytest.mark.parametrize("name", ["uniform", "all_equal", "ones_inf", "several_hot", "zero"])
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_fold_gate_matches_jax(name, signed):
    """d*, weight and gate of `hot_buckets` against the JAX prep's dstars
    and occs and msm_pallas_or_none's gate (pallas_msm.py:914-935: mean =
    max(1, N / B), gate = 4 mean + 64; exclude where occ_all > gate >=
    occ2; no Pallas path where occ_all == 0 or occ2 > gate)."""
    n, c = 256, 8
    rng = np.random.default_rng(len(name) + 7 * signed)
    ks, inf_idx = _gate_case(name, rng, n)
    inf = np.zeros(n, dtype=bool)
    inf[list(inf_idx)] = True
    k = convert.ints_to_limbs(ks, "cpu")
    jk, jinf = jnp.asarray(k.numpy().astype(np.uint32)), jnp.asarray(inf)
    if signed:
        prep = M.prep_windows_signed(k, c, torch.from_numpy(inf))
        *_, j_counts, dstars, occs = pallas_msm._prep_windows_signed(jk, jinf, c)
        b = 1 << (c - 1)
    else:
        prep = M.prep_windows(k, c, torch.from_numpy(inf))
        _, _, j_counts, dstars, occs = pallas_msm._prep_windows(jk, jinf, c)
        b = 1 << c
        counts = np.asarray(j_counts).astype(np.int64)
        counts[:, 0] = 0
        assert np.array_equal(prep.counts.numpy(), counts)
    occ_all, occ2, _ = (int(v) for v in np.asarray(occs))
    gate = 4 * max(1, n // b) + 64
    fold = occ_all != 0 and occ_all > gate and occ2 <= gate
    assert fold == (name in ("all_equal", "ones_inf"))  # the cases are what they say
    hot = M.hot_buckets(prep, n)
    dstars = torch.from_numpy(np.asarray(dstars).astype(np.int64))
    if fold:
        assert torch.equal(hot.lane, dstars) and torch.equal(hot.weight, dstars + signed)
    else:
        assert bool((hot.lane == -1).all()) and bool((hot.weight == 0).all())


def _affine(group, jac):
    return _msm_points(G.JacobianBatch(*(t.reshape(-1, *t.shape[2:]) for t in jac)), group)


# name: (n, shifts, scalars(rng, n), point pattern, infinity indices, whether the gate folds)
SETS = {
    "uniform": (24, (0, 1), _uniform, (), (), False),
    "uniform_top": (24, (0,), lambda r, n: [R_MOD - 1] + _uniform(r, n - 9) + _top(r, 8), (), (), False),
    # equal scalars: each bucket's run is m = 1, 2, 3, -6, 5, ... in index
    # order, so its running sums hit P == Q (1 + 2 == 3) and P == -Q (6 - 6)
    "equal": (80, (0, 1), lambda r, n: [_uniform(r, 1)[0]] * n, (1, 2, 3, -6, 5), (), True),
    "negative_digits": (72, (0,), lambda r, n: [sum(0xE0 << (8 * w) for w in range(31))] * n, (), (), True),
    "ones_inf": (90, (0, 1), lambda r, n: [1] * 75 + [0] * 5 + _uniform(r, n - 80), (), (3, 9, 80), True),
    "several_hot": (160, (0,), lambda r, n: [[5, 7][i % 2] for i in range(n)], (), (), False),
    "zero": (2, (0,), lambda r, n: [0] * n, (), (), False),
}
# (group, signed, the sets of one msm_sets call: one K4 and one K5 launch)
CALLS = [
    ("g1", True, ("uniform", "zero", "equal", "negative_digits", "ones_inf", "several_hot")),
    ("g2", True, ("uniform_top", "equal", "zero")),
    ("g1", False, ("equal", "ones_inf")),
]


def _stages(group, signed, names):
    """One msm_sets call's inputs and stages before K5: (sets, the refimpl
    MSMs, whether each set's gate folds, c, buckets, hot, sums)."""
    rng = np.random.default_rng(len(names) + 10 * signed)
    sets, wants, folds = [], [], []
    for name in names:
        n, shifts, scalars, pattern, inf, fold = SETS[name]
        ks = scalars(rng, n)
        logs = _multiples(rng, n + max(shifts), pattern)
        pts = _points(group, logs)._replace(inf=torch.tensor([i in inf for i in range(n + max(shifts))]))
        sets.append((pts, convert.ints_to_limbs(ks, "cpu"), shifts))
        wants += [_want(group, logs[s : s + n], ks, {i - s for i in inf}) for s in shifts]
        folds += [fold] * len(shifts)
    c = (M.pick_window_signed if signed else M.pick_window)(max(k.shape[0] for _, k, _ in sets))
    buckets, hot = M.accumulate_sets(sets, c, signed)
    return sets, wants, folds, c, buckets, hot, M.bucket_reduce(buckets, signed, hot.lane)


def _cat(batches):
    return G.JacobianBatch(*(torch.cat(t) for t in zip(*batches)))


@pytest.fixture(scope="module")
def calls():
    """_stages of every CALLS entry, and K5 (with the fold table) of each:
    one combine_windows over the sets of all the calls of a group and a
    window size, each call's buckets padded to the widest B (K5 reads only
    the lanes of its table), since the plain chain's time hardly grows with
    the sets; then each call's rows."""
    out = {call: _stages(*call) for call in CALLS}
    for group, c in {(call[0], out[call][3]) for call in CALLS}:
        mine = [call for call in CALLS if call[0] == group and out[call][3] == c]
        b = max(out[call][4].x.shape[2] for call in mine)
        padded = [G.JacobianBatch(*(torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3) + (0, b - t.shape[2]))
                                    for t in out[call][4])) for call in mine]
        res = M.combine_windows(_cat([out[call][6] for call in mine]), c, _cat(padded),
                                M.Hot(*(torch.cat(t) for t in zip(*(out[call][5] for call in mine)))))
        row = 0
        for call in mine:
            rows = out[call][6].x.shape[0]
            out[call] = (*out[call], G.JacobianBatch(*(t[row : row + rows] for t in res)))
            row += rows
    return out


@pytest.mark.parametrize("group,signed,names", CALLS,
                         ids=[f"{g}-{'signed' if s else 'unsigned'}-{len(n)}sets" for g, s, n in CALLS])
def test_msm_matches_refimpl(group, signed, names, calls, host_lib):
    """One msm_sets call's stages (accumulate_sets, K4, K5 with the fold
    table) on sets that fold and sets that do not (asserted per set): the
    MSMs == sum k_i P_i from refimpl; csrc/msm.cu's per-thread functions,
    run in the kernels' order by g++, == the plain versions: K3 (with
    splits) on each set limb for limb, K4 (signed weights, the excluded
    lanes) after normalizing, K5 with the fold limb for limb."""
    sets, wants, folds, c, buckets, hot, sums, res = calls[group, signed, names]
    assert (hot.lane >= 0).any(1).tolist() == folds
    assert _msm_points(res, group) == wants

    row = 0
    for pts, k, shifts in sets:
        host = _host_accumulate(host_lib, group, pts, torch.tensor(shifts), M.prep_set(pts, k, shifts, c, signed))
        assert all(torch.equal(a, w[row : row + len(shifts)]) for a, w in zip(host, buckets))
        row += len(shifts)
    host = _host_reduce(host_lib, group, buckets, signed, hot.lane)
    assert _affine(group, host) == _affine(group, sums)
    host = _host_combine(host_lib, group, sums, c, buckets, hot)
    assert all(torch.equal(a, w) for a, w in zip(host, res))


@pytest.mark.parametrize("rows", [(0, 0, 0), (1, 0, 1), (0, 1, 1), (0, 0, 1), (1, 1, 1)])
def test_fold_count_on_host(rows, host_lib):
    """csrc/msm.cu's set_folds, what K5 adds to its fold counters for each
    set of a launch (1: the set folds in some window; 3: it does and no set
    below it does, the launch's first), against that rule."""
    weights = torch.zeros((len(rows), 5), dtype=torch.int64)
    for s, f in enumerate(rows):
        weights[s, s % 5] = f * (7 + s)
    out = (ctypes.c_int * len(rows))()
    host_lib.host_set_folds(ctypes.c_void_p(weights.data_ptr()), len(rows), 5, out)
    assert list(out) == [0 if not f else 1 if any(rows[:s]) else 3 for s, f in enumerate(rows)]


def test_backend_msm_signed_matches_refimpl():
    """TorchBackend.msm under MsmMode(True): host points, scalars not yet
    reduced mod r, msm_sets' default window."""
    rng = np.random.default_rng(9)
    logs, ks = _multiples(rng, 3), _uniform(rng, 3)
    be = TorchBackend("cpu", msm_mode=MsmMode(True))
    got = be.msm(be.from_points([rc.G1_GEN.mul(m) for m in logs], "g1"), [k + R_MOD for k in ks])
    assert got == _want("g1", logs, ks)


@pytest.mark.skipif(not os.environ.get("PHASE2_TPU_SLOW_TESTS"),
                    reason="the JAX package's Pallas MSM in interpret mode is compile-heavy on XLA:CPU "
                           "(its own test is gated so, tests/test_msm.py)")
def test_signed_msm_matches_jax_pallas_interpret():
    """The JAX package's signed Pallas MSM (G1, N = 256, c = 8; R - 1, a
    zero, a duplicate pair, a point at infinity) == the port's signed MSM."""
    import jax

    from phase2_bn254_tpu.curve import codecs as jcodecs
    from phase2_bn254_tpu.curve import group as JG
    from phase2_bn254_tpu.ops.backend import _field_ops
    from phase2_bn254_tpu.refimpl import curve as jrc

    n, c = 256, 8
    rng = np.random.default_rng(256)
    ks = _uniform(rng, n)
    ks[4:6] = [ks[4]] * 2
    ks[7], ks[11] = 0, R_MOD - 1
    logs = _multiples(rng, n)
    logs[5] = logs[4]
    pts = _points("g1", logs)._replace(inf=torch.tensor([i == 9 for i in range(n)]))
    k = convert.ints_to_limbs(ks, "cpu")
    got = _msm_points(M.msm_sets([(pts, k, (0,))], c, signed=True), "g1")
    jbatch = jcodecs.points_to_batch([jrc.G1_GEN.mul(m) for m in logs], "g1")
    jbatch = JG.AffineBatch(jbatch.x, jbatch.y, jbatch.inf.at[9].set(True))
    jac = pallas_msm.msm_pallas_or_none("g1", jbatch, jnp.asarray(k.numpy().astype(np.uint32)), c=c, btile=128,
                                        signed=True)
    out = JG.jac_normalize(_field_ops("g1"), jax.tree.map(lambda a: a[None], jac))
    want = jcodecs.batch_to_points(out, "g1")[0]
    assert got == [_want("g1", logs, ks, {9})]
    assert (want.x, want.y, want.inf) == (got[0].x, got[0].y, got[0].inf)
