"""Pippenger multi-scalar multiplication (counterpart of
`phase2_bn254_tpu/ops/pallas_msm.py` and of the helpers of `ops/msm.py`).

`msm(points, scalars)` = sum_i k_i P_i over c-bit windows of the canonical
scalars, least significant window first (w = 0 .. nwin - 1):

1. `prep_windows` (glue): every window's digits, one batched `torch.sort` of
   the digits (stable, so each bucket's points keep their index order), the
   `torch.searchsorted` start and count of every bucket, and the table of
   sub-runs: each bucket's run of the sorted order cut into sub-runs of at
   most SUBRUN points (`cumsum` and `searchsorted` on the counts, at most
   ceil(N / SUBRUN) + B sub-runs a window, so no shape depends on the data).
   Nothing is pulled to the host.
2. K3 `bucket_accumulate`: S[w, d], the sum of the points of digit d in
   window w (points at infinity skipped). One thread mixed-adds the points of
   each sub-run; a tree of ceil(log2(ceil(N / SUBRUN))) levels, one launch
   each, sums each digit's partials; a last launch collects them. No thread
   adds more than SUBRUN points, whatever the digit distribution.
3. K4 `bucket_reduce`: T[w] = sum_d d S[w, d], one block per window: each
   thread a range of buckets, then a suffix scan and a tree across the block.
4. K5 `combine_windows`: sum_w 2^(c w) T[w], most significant window first.

The signed-digit mode (JAX `PHASE2_TPU_MSM_SIGNED`, `_prep_windows_signed`;
`msm_sets(..., signed=True)`, which `TorchBackend` takes from
`ops.backend.MsmMode`): digits e in [-2^(c-1), 2^(c-1) - 1] by the carry
recoding (`signed_digits`), B = 2^(c-1) buckets indexed by |e| - 1
(`prep_windows_signed`: each bucket's run negatives first, `splits` where
its positives begin), K3 negating the y of a point sorted below its
bucket's split, and K4 weighting lane l by l + 1; the window is
`pick_window_signed`'s.

The hot-bucket fold (JAX `_combine_kernel`'s exclude mode), in both modes:
where a set's digits are skewed as `msm_pallas_or_none` gates it
(`hot_buckets`), K4 leaves each window's heaviest bucket d* out and K5 adds
e* S[w, d*] (e* = d*, signed d* + 1) into the window. The gate is computed
on the device from the prep's counts, so K4 and K5 take a table (lane -1,
weight 0 where a set does not fold) and no host sync decides it.

`msm_sets` runs several MSMs through one K4 and one K5 launch. Each set is
(points, scalars, shifts): one digit sort and one K3 call sum
scalars[i] * points[shift + i] for each of its shifts, so `power_pairs`'
v[:-1] and v[1:] are one set of shifts (0, 1), and the prover's G1 queries
are three sets of shift 0.

Each kernel (csrc/msm.cu) has a wrapper, a plain PyTorch version and a launch
count (`LAUNCHES[<wrapper name>]`, K3 and K4 in the signed mode under
`<name>_signed`; one K3 call makes `accumulate_launches(N)` launches, K4 and
K5 one). K5 counts its fold itself, on the device (`fold_counts`). The
wrapper takes the plain version for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises.

The plain versions: K3 adds the same points in the same order, with the same
signs, as the kernel, wave k adding the k-th point of every sub-run that
long, then the same tree, pair for pair, so the two agree limb for limb. K4
weights each nonzero bucket by double-and-add and folds each window in log2
steps; it adds in another order than the kernel, so the two agree on the
affine point of each window sum. K5 is the kernel's loop, limb for limb.

There is one path for every N (no size gates).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..curve import group as G
from ..field.fq2 import FQ, FQ2
from . import _build

SCALAR_BITS = 254  # canonical scalars < r < 2^254
# the most points one K3 thread adds (L); PERF.md says why this value
SUBRUN = 32
# K4's threads a block, at most (csrc/msm.cu kReduceThreads)
REDUCE_THREADS = 256

# kernel launches by wrapper name (K3, K4 in the signed mode apart); only a
# launch of the kernel counts
LAUNCHES = {"bucket_accumulate": 0, "bucket_reduce": 0, "combine_windows": 0, "bucket_accumulate_signed": 0,
            "bucket_reduce_signed": 0}
# K5's own count of the hot-bucket fold, an int64 (2,) tensor a device that
# the kernel adds to: the sets that folded and the launches in which any did
_FOLDS: dict = {}


def fold_counts() -> dict:
    """The sets and the K5 launches that took the hot-bucket fold on the card
    since `reset_fold_counts`, as K5 counted them; waits for the device."""
    sets, launches = (sum(v) for v in zip((0, 0), *(t.tolist() for t in _FOLDS.values())))
    return {"sets": sets, "launches": launches}


def reset_fold_counts() -> None:
    for t in _FOLDS.values():
        t.zero_()


def pick_window(n: int) -> int:
    """Window size (JAX `pallas_msm.pick_window`): c ~ log2(N) - 7, clamped
    to [8, 13]."""
    return max(8, min(13, n.bit_length() - 8))


def pick_window_signed(n: int) -> int:
    """Window size of the signed mode (JAX `pallas_msm.pick_window_signed`):
    c = log2(N) - 4, clamped to [8, 16]."""
    return max(8, min(16, n.bit_length() - 4))


def num_windows(c: int) -> int:
    return -(-SCALAR_BITS // c)


def window_digits(scalars: torch.Tensor, c: int, w: int) -> torch.Tensor:
    """The w-th c-bit window of canonical scalars, int64 (N, 16) 16-bit
    digits -> int64 (N,) (JAX `ops.msm._window_digits`; c <= 16)."""
    return all_window_digits(scalars, c)[:, w]


def all_window_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """Every window's digits at once: int64 (N, nwin). A window spans at most
    two 16-bit limbs; three are read."""
    lo = c * torch.arange(num_windows(c), device=scalars.device)
    limb, shift = lo // 16, lo % 16
    s = torch.nn.functional.pad(scalars, (0, 2))
    v = s[:, limb] | (s[:, limb + 1] << 16) | (s[:, limb + 2] << 32)
    return (v >> shift) & ((1 << c) - 1)


def signed_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """Every window's signed digit, int64 (N, nwin) in [-2^(c-1), 2^(c-1) -
    1] (JAX `_prep_windows_signed`'s recoding: e = d + carry, and e >=
    2^(c-1) becomes e - 2^c with a carry of 1 into the next window). The
    carry into window w is that out of the last window below w whose digit
    is not 2^(c-1) - 1 (such a digit passes its carry on), so no loop over
    the windows. Canonical scalars (< r) leave no carry out of the top
    window."""
    d = all_window_digits(scalars, c).T.contiguous()  # (nwin, N): the scan runs down the columns
    half = 1 << (c - 1)
    nwin = d.shape[0]
    idx = torch.arange(nwin, device=d.device)[:, None].expand_as(d)
    last = torch.cummax(torch.where(d != half - 1, idx, -1), dim=0).values
    below = torch.nn.functional.pad(last[:-1], (0, 0, 1, 0), value=-1)
    carry = (below >= 0) & (d.gather(0, below.clamp(min=0)) >= half)
    e = d + carry
    return torch.where(e >= half, e - (1 << c), e).T


def window_groups(c: int) -> list[int]:
    """JAX `pallas_msm._window_groups`: each window's lane-group factor,
    2^(c - its digit bits) (1 but for the top window). Only the fold's gate
    reads it: it divides the JAX package's occupancies."""
    return [1 << (c - min(c, SCALAR_BITS - c * w)) for w in range(num_windows(c))]


def window_groups_signed(c: int) -> list[int]:
    """JAX `pallas_msm._window_groups_signed`, for the gate as
    `window_groups`."""
    nwin = num_windows(c)
    return [1] * (nwin - 1) + [1 << max(c - 1 - (SCALAR_BITS - c * (nwin - 1)), 0)]


def subruns(n: int, c: int, signed: bool = False) -> int:
    """Sub-runs a window has room for: ceil(n / SUBRUN) + B (B = 2^c, signed
    2^(c-1)), at least the sum over buckets of ceil(count / SUBRUN)."""
    return -(-n // SUBRUN) + (1 << (c - signed))


def tree_levels(n: int) -> int:
    """K3's tree levels for n scalars: ceil(log2(ceil(n / SUBRUN))), enough
    for a digit that takes every point."""
    return max(-(-n // SUBRUN) - 1, 0).bit_length()


def accumulate_launches(n: int) -> int:
    """Kernel launches of one K3 call on n scalars: pass A, the tree, the
    collect."""
    return 2 + tree_levels(n)


def reduce_threads(b: int) -> int:
    """K4's threads a block for B = b buckets (a power of two dividing b)."""
    return min(REDUCE_THREADS, b)


class Prep(NamedTuple):
    """prep_windows' output, int64 on the scalars' device: orders (nwin, N),
    the point indices sorted by bucket; starts, counts (nwin, B), each
    bucket's run of that order (unsigned digit 0's count is 0: it adds
    nothing); first (nwin, B), the index of its first sub-run; runs (nwin,
    M), the bucket of each sub-run, B past the last (M = subruns(N, c,
    signed)); splits (nwin, B), signed mode only (else None), where each
    bucket's positive digits begin in the sorted order."""

    orders: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    first: torch.Tensor
    runs: torch.Tensor
    c: int
    splits: torch.Tensor | None = None


class Hot(NamedTuple):
    """The hot-bucket fold's table, int64 (..., nwin) each: lane, the bucket
    K4 leaves out of each window's sum (-1: none), and weight, what K5
    multiplies that bucket's sum by (0: no fold)."""

    lane: torch.Tensor
    weight: torch.Tensor


def _subrun_index(counts: torch.Tensor, n: int, c: int, signed: bool):
    """(first, runs) of the sub-run table for each bucket's count."""
    nwin = counts.shape[0]
    nsub = (counts + SUBRUN - 1) // SUBRUN
    ends = torch.cumsum(nsub, 1)
    index = torch.arange(subruns(n, c, signed), device=counts.device).expand(nwin, -1).contiguous()
    return ends - nsub, torch.searchsorted(ends, index, side="right")


def prep_windows(scalars: torch.Tensor, c: int, inf: torch.Tensor | None = None) -> Prep:
    """Digits, per-window sort, bucket bounds and sub-runs (JAX
    `_prep_windows` without its occupancy outputs, which `hot_buckets`
    computes from the counts). inf (N,) bool, where given: those scalars'
    digits are 0 (their points add nothing), as the JAX prep masks them, so
    the counts are the JAX package's; K3 skips points at infinity anyway. No
    host sync."""
    dev = scalars.device
    digits = all_window_digits(scalars, c).T
    if inf is not None:
        digits = digits.masked_fill(inf, 0)
    sorted_digits, orders = torch.sort(digits.contiguous(), dim=1, stable=True)
    nwin, n = digits.shape
    buckets = torch.arange(1 << c, device=dev).expand(nwin, -1).contiguous()
    starts = torch.searchsorted(sorted_digits, buckets, side="left")
    counts = torch.searchsorted(sorted_digits, buckets, side="right") - starts
    counts[:, 0] = 0
    return Prep(orders, starts, counts, *_subrun_index(counts, n, c, False), c)


def prep_windows_signed(scalars: torch.Tensor, c: int, inf: torch.Tensor | None = None) -> Prep:
    """The signed mode's prep (JAX `_prep_windows_signed`): B = 2^(c-1)
    buckets, bucket |e| - 1 for a digit e != 0; one batched stable sort on
    the key 2 (|e| - 1) + (e > 0), so each bucket's run is its negative
    digits, then its positive ones, from `splits` on; zero digits and the
    scalars of inf (points at infinity) key to 2 B, past every bucket. One
    `searchsorted` of the keys 0 .. 2 B gives starts, splits and ends. The
    sub-runs as `prep_windows`'. The JAX package's top-window lane groups
    (`_window_groups_signed`) are not ported: they spread the TPU's wave
    grid, and K3's sub-runs bound every thread whatever the digits (as for
    the unsigned `_window_groups`). No host sync."""
    dev = scalars.device
    b = 1 << (c - 1)
    e = signed_digits(scalars, c).T
    keys = torch.where(e == 0, 2 * b, 2 * (e.abs() - 1) + (e > 0))
    if inf is not None:
        keys = keys.masked_fill(inf, 2 * b)
    sorted_keys, orders = torch.sort(keys.contiguous(), dim=1, stable=True)
    nwin, n = keys.shape
    bounds = torch.searchsorted(sorted_keys, torch.arange(2 * b + 1, device=dev).expand(nwin, -1).contiguous())
    starts, splits = bounds[:, 0:-1:2].contiguous(), bounds[:, 1::2].contiguous()
    counts = bounds[:, 2::2] - starts
    return Prep(orders, starts, counts, *_subrun_index(counts, n, c, True), c, splits)


def _padded(n: int) -> int:
    """The JAX backend's MSM size for n scalars (`_next_pow2(n)`: a power of
    two, at least 32), which its gate divides."""
    p = 32
    while p < n:
        p <<= 1
    return p


def hot_buckets(prep: Prep, n: int) -> Hot:
    """The fold's table for one set of n scalars, (nwin,) each, as
    `msm_pallas_or_none` decides it: d* the first heaviest bucket of each
    window, occ_all / occ2 the largest count with / without each window's
    d*, each window's counts divided (rounded up) by its lane-group factor
    (`window_groups` / `window_groups_signed`); the fold is taken, in every
    window of the set, where occ_all > 4 max(1, N / B) + 64 >= occ2 (N the
    JAX package's padded size of n), with weight d* (signed: d* + 1). Where
    occ2 too is above that bound the JAX package leaves its Pallas path for
    the XLA one, which has no fold; there, and where the set has no nonzero
    digit, this table folds nothing and the set takes the normal path. On
    the device, no host sync, in few launches: a window's largest count
    without d* is its second largest (`topk`), and dividing by the factor,
    which only the top window has, keeps the order."""
    signed = prep.splits is not None
    counts = prep.counts
    b = counts.shape[1]
    group = (window_groups_signed if signed else window_groups)(prep.c)[-1]
    dstar = counts.argmax(1)
    occ = counts.topk(2, 1).values  # (nwin, 2): each window's occupancy with and without d*
    if group > 1:
        occ = torch.cat([occ[:-1], (occ[-1:] + group - 1) // group])
    occ_all, occ2 = occ.amax(0)
    gate = 4 * max(1, _padded(n) // b) + 64
    fold = (occ_all > gate) & (occ2 <= gate)
    return Hot(torch.where(fold, dstar, -1), torch.where(fold, dstar + 1 if signed else dstar, 0))


def prep_set(points: G.AffineBatch, scalars: torch.Tensor, shifts, c: int, signed: bool = False) -> Prep:
    """The prep of one `msm_sets` set: a scalar's digits count for nothing
    where its point is at infinity under every shift (K3 skips the points at
    infinity of each shift itself)."""
    n = scalars.shape[0]
    inf = points.inf[shifts[0] : shifts[0] + n]
    for s in shifts[1:]:
        inf = inf & points.inf[s : s + n]
    return (prep_windows_signed if signed else prep_windows)(scalars, c, inf)


def _field(x: torch.Tensor):
    return FQ if x.dim() == 2 else FQ2


def _group(x: torch.Tensor, g1_dims: int) -> str:
    """"g1" for Fq coordinates (x has g1_dims dimensions), "g2" for Fq2."""
    return "g1" if x.dim() == g1_dims else "g2"


# ---------------------------------------------------------------------------
# K3: bucket accumulation
# ---------------------------------------------------------------------------

def subrun_table(starts, counts, first, runs):
    """Each sub-run's (lo, length, rank, count): its start in the sorted
    order, its points (0 past the last sub-run), its index among its digit's
    sub-runs and their number; (nwin, M) each."""
    b = starts.shape[1]
    d = runs.clamp(max=b - 1)
    live = runs < b
    rank = torch.arange(runs.shape[1], device=runs.device)[None, :] - first.gather(1, d)
    cnt = counts.gather(1, d) * live
    lo = starts.gather(1, d) + rank * SUBRUN
    length = (cnt - rank * SUBRUN).clamp(0, SUBRUN)
    return lo, length, rank, (cnt + SUBRUN - 1) // SUBRUN


def bucket_accumulate_plain(x, y, inf, shifts, orders, starts, counts, first, runs, splits=None) -> G.JacobianBatch:
    """Plain PyTorch K3. x, y: (N', 16) or (N', 2, 16) Montgomery affine,
    inf (N',) (skipped); shifts (S,): set s takes points shifts[s] ..
    shifts[s] + N - 1; the rest as `Prep` (splits: the signed mode, where a
    point sorted below its bucket's split adds with its y negated). Returns
    (S, nwin, B) Jacobian bucket sums. Wave k mixed-adds the k-th point of
    every sub-run longer than k; tree level k adds, for each bucket, its
    partial of rank i + 2^k into the one of rank i (i a multiple of 2^(k +
    1)); then each bucket takes its first partial."""
    f = _field(x)
    nwin, b = starts.shape
    m, nsets = runs.shape[1], shifts.shape[0]
    lo, length, rank, nsub = (t.reshape(-1).repeat(nsets) for t in subrun_table(starts, counts, first, runs))
    split = None if splits is None else splits.gather(1, runs.clamp(max=b - 1)).reshape(-1).repeat(nsets)
    acc = G.jac_zero(f, (nsets * nwin * m,), x.device)
    for k in range(int(length.max()) if length.numel() else 0):
        lanes = (length > k).nonzero().squeeze(1)
        idx = orders[lanes // m % nwin, lo[lanes] + k] + shifts[lanes // (nwin * m)]
        live = ~inf[idx]
        lanes, idx = lanes[live], idx[live]
        qy = y[idx]
        if split is not None:
            qy = f.select(lo[lanes] + k < split[lanes], f.neg(qy), qy)
        acc = G.put(acc, lanes, G.jac_madd(f, G.take(acc, lanes), x[idx], qy))
    half = 1
    while nsub.numel() and half < int(nsub.max()):
        lanes = ((rank % (2 * half) == 0) & (rank + half < nsub)).nonzero().squeeze(1)
        acc = G.put(acc, lanes, G.jac_add_sparse(f, G.take(acc, lanes), G.take(acc, lanes + half)))
        half *= 2
    rows = torch.arange(nsets * nwin, device=x.device)[:, None]
    src = (rows * m + first.repeat(nsets, 1)).reshape(-1)
    has = (counts.repeat(nsets, 1) > 0).reshape(-1)
    zero = G.jac_zero(f, has.shape, x.device)
    out = (f.select(has, a[src], z) for a, z in zip(acc, zero))
    return G.JacobianBatch(*(t.reshape(nsets, nwin, b, *t.shape[1:]) for t in out))


def bucket_accumulate(x, y, inf, shifts, orders, starts, counts, first, runs, splits=None) -> G.JacobianBatch:
    """K3: bucket sums (signed mode where splits is given). CPU tensors take
    the plain version; CUDA tensors launch csrc/msm.cu (accumulate_launches(N)
    launches, counted under "bucket_accumulate" or, signed,
    "bucket_accumulate_signed")."""
    if not _build.on_card("bucket_accumulate", x):
        return bucket_accumulate_plain(x, y, inf, shifts, orders, starts, counts, first, runs, splits)
    (nwin, n), b, m, nsets = orders.shape, starts.shape[1], runs.shape[1], shifts.shape[0]
    el = tuple(x.shape[1:])
    for name, t, shape in (("x", x, (x.shape[0], *el)), ("y", y, (x.shape[0], *el)), ("shifts", shifts, (nsets,)),
                           ("orders", orders, (nwin, n)), ("starts", starts, (nwin, b)),
                           ("counts", counts, (nwin, b)), ("first", first, (nwin, b)), ("runs", runs, (nwin, m))):
        _build.check("bucket_accumulate", name, t, shape, x.device)
    if splits is not None:
        _build.check("bucket_accumulate", "splits", splits, (nwin, b), x.device)
    _build.check("bucket_accumulate", "inf", inf, x.shape[:1], x.device, torch.bool)
    parts = [torch.empty((nsets, nwin, m, *el), dtype=x.dtype, device=x.device) for _ in range(3)]
    out = [torch.empty((nsets, nwin, b, *el), dtype=x.dtype, device=x.device) for _ in range(3)]
    levels = tree_levels(n)
    _build.launch(f"p2_bucket_accumulate_{_group(x, 2)}", x.device, x, y, inf, shifts, orders, starts, counts, first,
                  runs, splits, *parts, *out, nsets, n, nwin, m, b, SUBRUN, levels)
    LAUNCHES["bucket_accumulate" if splits is None else "bucket_accumulate_signed"] += accumulate_launches(n)
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# K4: bucket reduction
# ---------------------------------------------------------------------------

def _fold(f, p: G.JacobianBatch, width: int) -> G.JacobianBatch:
    """Sum of the first `width` points of each row of (rows, width) lanes in
    log2(width) halving steps; returns (rows,)."""
    el = p.x.shape[2:]
    while width > 1:
        half = (width + 1) // 2
        lo = G.JacobianBatch(*(t[:, : width - half].reshape(-1, *el) for t in p))
        hi = G.JacobianBatch(*(t[:, half:width].reshape(-1, *el) for t in p))
        s = G.jac_add_sparse(f, lo, hi)
        p = G.JacobianBatch(*(torch.cat([u.reshape(t.shape[0], -1, *el), t[:, width - half : half]], 1)
                              for u, t in zip(s, p)))
        width = half
    return G.JacobianBatch(*(t[:, 0] for t in p))


def bucket_reduce_plain(buckets: G.JacobianBatch, signed: bool = False,
                        exclude: torch.Tensor | None = None) -> G.JacobianBatch:
    """Plain PyTorch K4. buckets (S, nwin, B) Jacobian -> (S, nwin) window
    sums sum_l w_l S_l, w_l = l (signed: l + 1), leaving out lane
    exclude[s, w] of each window (-1: none): every nonzero bucket of weight
    > 0 times its weight by double-and-add over the weight's bits
    (vectorized over those buckets), then a log-step fold of each window's
    products. The JAX package's log-step suffix scan takes B log2(B) adds
    per window whatever the occupancy; this takes about (c + 1) adds per
    nonzero bucket."""
    x = buckets.x
    f = _field(x[:, 0, 0])
    nsets, nwin, b = x.shape[:3]
    el = tuple(x.shape[3:])
    rows = nsets * nwin
    flat = G.JacobianBatch(*(t.reshape(rows * b, *el) for t in buckets))
    lane = torch.arange(rows * b, device=x.device) % b
    keep = (lane + signed > 0) & ~f.is_zero(flat.z)
    if exclude is not None:
        keep &= lane != exclude.reshape(-1).repeat_interleave(b)
    idx = keep.nonzero().squeeze(1)
    if not idx.numel():
        return G.jac_zero(f, (nsets, nwin), x.device)
    pts, w = G.take(flat, idx), lane[idx] + signed
    acc = G.jac_zero(f, (idx.numel(),), x.device)
    for bit in range(int(w.max()).bit_length() - 1, -1, -1):
        live = (~f.is_zero(acc.z)).nonzero().squeeze(1)
        acc = G.put(acc, live, G.jac_double(f, G.take(acc, live)))
        sel = ((w >> bit) & 1).nonzero().squeeze(1)
        acc = G.put(acc, sel, G.jac_add_sparse(f, G.take(acc, sel), G.take(pts, sel)))
    row = idx // b
    per_row = torch.bincount(row, minlength=rows)
    rank = torch.arange(idx.numel(), device=x.device) - (torch.cumsum(per_row, 0) - per_row)[row]
    width = int(per_row.max())
    grid = G.put(G.jac_zero(f, (rows * width,), x.device), row * width + rank, acc)
    out = _fold(f, G.JacobianBatch(*(t.reshape(rows, width, *el) for t in grid)), width)
    return G.JacobianBatch(*(t.reshape(nsets, nwin, *el) for t in out))


def bucket_reduce(buckets: G.JacobianBatch, signed: bool = False,
                  exclude: torch.Tensor | None = None) -> G.JacobianBatch:
    """K4: window sums (lane weights l + 1 where signed; exclude (S, nwin)
    as the plain version's). CPU tensors take the plain version; CUDA
    tensors launch csrc/msm.cu (one block of reduce_threads(B) threads per
    set and window; counted under "bucket_reduce" or "bucket_reduce_signed")."""
    x = buckets.x
    if not _build.on_card("bucket_reduce", x):
        return bucket_reduce_plain(buckets, signed, exclude)
    nsets, nwin, b = x.shape[:3]
    for name, t in zip("xyz", buckets):
        _build.check("bucket_reduce", name, t, x.shape, x.device)
    if exclude is not None:
        _build.check("bucket_reduce", "exclude", exclude, (nsets, nwin), x.device)
    out = [torch.empty((nsets, nwin, *x.shape[3:]), dtype=x.dtype, device=x.device) for _ in range(3)]
    _build.launch(f"p2_bucket_reduce_{_group(x, 4)}", x.device, *buckets, exclude, *out, nsets, nwin, b,
                  reduce_threads(b), int(signed))
    LAUNCHES["bucket_reduce_signed" if signed else "bucket_reduce"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# K5: window combination
# ---------------------------------------------------------------------------

def _hot_sums(buckets: G.JacobianBatch, hot: Hot) -> G.JacobianBatch:
    """S[s, w, hot.lane[s, w]] (lane 0 where it is -1), (S, nwin)."""
    nsets, nwin, b = buckets.x.shape[:3]
    el = tuple(buckets.x.shape[3:])
    rows = torch.arange(nsets * nwin, device=buckets.x.device)
    idx = rows * b + hot.lane.reshape(-1).clamp(min=0)
    return G.JacobianBatch(*(t.reshape(-1, *el)[idx].reshape(nsets, nwin, *el) for t in buckets))


def combine_windows_plain(sums: G.JacobianBatch, c: int, buckets: G.JacobianBatch | None = None,
                          hot: Hot | None = None) -> G.JacobianBatch:
    """Plain PyTorch K5: sum_w 2^(c w) (T_w + e_w H_w), H_w = buckets[s, w,
    hot.lane] and e_w = hot.weight (the fold; none without hot). One chain,
    MSB first, over the c w + i below each window's top: double (the finite
    points only), add H_w where bit i of e_w is set, and at i = 0 add T_w;
    so the fold costs its adds, no doubling. The adds are jac_add_sparse
    (jac_add's limbs, arithmetic only where both points are finite). sums:
    (S, nwin) Jacobian; returns (S,)."""
    f = _field(sums.x[:, 0])
    nsets, nwin = sums.x.shape[:2]
    p = G.jac_zero(f, (nsets,), sums.x.device)
    h = None if hot is None else _hot_sums(buckets, hot)
    for w in range(nwin - 1, -1, -1):
        for i in range(c - 1, -1, -1):
            live = (~f.is_zero(p.z)).nonzero().squeeze(1)
            if live.numel():
                p = G.put(p, live, G.jac_double(f, G.take(p, live)))
            if h is not None:
                sel = ((hot.weight[:, w] >> i) & 1).nonzero().squeeze(1)
                if sel.numel():
                    p = G.put(p, sel, G.jac_add_sparse(f, G.take(p, sel), G.JacobianBatch(*(t[sel, w] for t in h))))
        p = G.jac_add_sparse(f, p, G.JacobianBatch(*(t[:, w] for t in sums)))
    return p


def combine_windows(sums: G.JacobianBatch, c: int, buckets: G.JacobianBatch | None = None,
                    hot: Hot | None = None) -> G.JacobianBatch:
    """K5: the MSMs from their window sums, with the hot-bucket fold where
    hot (over `buckets`, K3's (S, nwin, B) sums) is given. CPU tensors take
    the plain version; CUDA tensors launch csrc/msm.cu (with the fold table,
    the kernel adds to `fold_counts`)."""
    x = sums.x
    if not _build.on_card("combine_windows", x):
        return combine_windows_plain(sums, c, buckets, hot)
    nsets, nwin = x.shape[:2]
    for name, t in zip("xyz", sums):
        _build.check("combine_windows", name, t, x.shape, x.device)
    b, fold = 0, (None,) * 6
    if hot is not None:
        b = buckets.x.shape[2]
        for name, t in zip("xyz", buckets):
            _build.check("combine_windows", f"buckets {name}", t, (nsets, nwin, b, *x.shape[2:]), x.device)
        for name, t in zip(hot._fields, hot):
            _build.check("combine_windows", name, t, (nsets, nwin), x.device)
        if x.device not in _FOLDS:
            _FOLDS[x.device] = torch.zeros(2, dtype=torch.int64, device=x.device)
        fold = (*buckets, *hot, _FOLDS[x.device])
    out = [torch.empty((nsets, *x.shape[2:]), dtype=x.dtype, device=x.device) for _ in range(3)]
    _build.launch(f"p2_combine_windows_{_group(x, 3)}", x.device, *sums, *fold, *out, nsets, nwin, c, b)
    LAUNCHES["combine_windows"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------

def accumulate_sets(sets, c: int, signed: bool = False) -> tuple[G.JacobianBatch, Hot]:
    """K3 of every set of `msm_sets`, one call each, on `prep_set`'s prep:
    the (S, nwin, B) Jacobian bucket sums of all the sets' shifts, in order,
    and their fold table (`hot_buckets` of each set, for each of its
    shifts)."""
    parts, hots = [], []
    for points, scalars, shifts in sets:
        if points.x.shape[0] < max(shifts) + scalars.shape[0]:
            raise ValueError(f"msm: {points.x.shape[0]} points, fewer than {scalars.shape[0]} scalars at shift "
                             f"{max(shifts)}")
        prep = prep_set(points, scalars, shifts, c, signed)
        shift_t = torch.tensor(shifts, dtype=torch.int64).to(points.x.device)
        parts.append(bucket_accumulate(points.x, points.y, points.inf, shift_t, *prep[:5], prep.splits))
        hots.append(Hot(*(t.expand(len(shifts), -1) for t in hot_buckets(prep, scalars.shape[0]))))
    hot = Hot(*(torch.cat(t).contiguous() for t in zip(*hots)))
    return (parts[0] if len(parts) == 1 else G.JacobianBatch(*(torch.cat(t) for t in zip(*parts)))), hot


def msm_sets(sets, c: int | None = None, signed: bool = False) -> G.JacobianBatch:
    """sum_i scalars[i] * points[shift + i] for each (points, scalars,
    shifts) set of one group and each of its shifts: one K3 call per set,
    one K4 and one K5 launch for all, at window size c (by default
    pick_window's, or pick_window_signed's, of the largest set), unsigned or
    signed digits, with the hot-bucket fold where a set's gate takes it.
    points: Montgomery affine ((N', 16) or (N', 2, 16) coordinates, inf
    (N',)) with N' >= max(shifts) + N; scalars: canonical int64 (N, 16).
    Returns (S,) Jacobian points, Montgomery, on the points' device, without
    waiting for the device."""
    n = max(k.shape[0] for _, k, _ in sets)
    c = (pick_window_signed(n) if signed else pick_window(n)) if c is None else c
    buckets, hot = accumulate_sets(sets, c, signed)
    return combine_windows(bucket_reduce(buckets, signed, hot.lane), c, buckets, hot)


def msm(points: G.AffineBatch, scalars: torch.Tensor, c: int | None = None, signed: bool = False) -> G.JacobianBatch:
    """sum_i scalars[i] * points[i]: one Jacobian point (batch ())."""
    return G.JacobianBatch(*(t[0] for t in msm_sets([(points, scalars, (0,))], c, signed)))
