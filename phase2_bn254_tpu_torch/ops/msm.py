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

`msm_sets` runs several MSMs through one K4 and one K5 launch. Each set is
(points, scalars, shifts): one digit sort and one K3 call sum
scalars[i] * points[shift + i] for each of its shifts, so `power_pairs`'
v[:-1] and v[1:] are one set of shifts (0, 1), and the prover's G1 queries
are three sets of shift 0.

Each kernel (csrc/msm.cu) has a wrapper, a plain PyTorch version and a launch
count (`LAUNCHES[<wrapper name>]`; one K3 call makes `accumulate_launches(N)`
launches, K4 and K5 one). The wrapper takes the plain version for tensors on
the CPU; on a CUDA tensor it launches the kernel or raises.

The plain versions: K3 adds the same points in the same order as the
kernel, wave k adding the k-th point of every sub-run that long, then the
same tree, pair for pair, so the two agree limb for limb. K4 weights each
nonzero bucket by double-and-add and folds each window in log2 steps; it
adds in another order than the kernel, so the two agree on the affine point
of each window sum. K5 is the kernel's loop, limb for limb.

There is one path for every N (no size gates) and no digit-distribution
gate.
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

# kernel launches by wrapper name; only a launch of the kernel counts
LAUNCHES = {"bucket_accumulate": 0, "bucket_reduce": 0, "combine_windows": 0}


def pick_window(n: int) -> int:
    """Window size (JAX `pallas_msm.pick_window`): c ~ log2(N) - 7, clamped
    to [8, 13]."""
    return max(8, min(13, n.bit_length() - 8))


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


def subruns(n: int, c: int) -> int:
    """Sub-runs a window has room for: ceil(n / SUBRUN) + 2^c, at least the
    sum over digits of ceil(count / SUBRUN)."""
    return -(-n // SUBRUN) + (1 << c)


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
    the point indices sorted by digit; starts, counts (nwin, B), each digit's
    run of that order (digit 0's count is 0: it adds nothing); first (nwin,
    B), the index of its first sub-run; runs (nwin, M), the digit of each
    sub-run, B past the last (M = subruns(N, c))."""

    orders: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    first: torch.Tensor
    runs: torch.Tensor
    c: int


def prep_windows(scalars: torch.Tensor, c: int) -> Prep:
    """Digits, per-window sort, bucket bounds and sub-runs (JAX
    `_prep_windows` without its hot-bucket and occupancy outputs, which only
    the TPU's wave grid needs, and without its infinity mask: K3 skips those
    points). No host sync."""
    dev = scalars.device
    digits = all_window_digits(scalars, c).T.contiguous()
    sorted_digits, orders = torch.sort(digits, dim=1, stable=True)
    nwin, n = digits.shape
    buckets = torch.arange(1 << c, device=dev).expand(nwin, -1).contiguous()
    starts = torch.searchsorted(sorted_digits, buckets, side="left")
    counts = torch.searchsorted(sorted_digits, buckets, side="right") - starts
    counts[:, 0] = 0
    nsub = (counts + SUBRUN - 1) // SUBRUN
    ends = torch.cumsum(nsub, 1)
    index = torch.arange(subruns(n, c), device=dev).expand(nwin, -1).contiguous()
    runs = torch.searchsorted(ends, index, side="right")
    return Prep(orders, starts, counts, ends - nsub, runs, c)


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


def bucket_accumulate_plain(x, y, inf, shifts, orders, starts, counts, first, runs) -> G.JacobianBatch:
    """Plain PyTorch K3. x, y: (N', 16) or (N', 2, 16) Montgomery affine,
    inf (N',) (skipped); shifts (S,): set s takes points shifts[s] ..
    shifts[s] + N - 1; the rest as `Prep`. Returns (S, nwin, B) Jacobian
    bucket sums. Wave k mixed-adds the k-th point of every sub-run longer
    than k; tree level k adds, for each digit, its partial of rank i + 2^k
    into the one of rank i (i a multiple of 2^(k + 1)); then each digit
    takes its first partial."""
    f = _field(x)
    nwin, b = starts.shape
    m, nsets = runs.shape[1], shifts.shape[0]
    lo, length, rank, nsub = (t.reshape(-1).repeat(nsets) for t in subrun_table(starts, counts, first, runs))
    acc = G.jac_zero(f, (nsets * nwin * m,), x.device)
    for k in range(int(length.max()) if length.numel() else 0):
        lanes = (length > k).nonzero().squeeze(1)
        idx = orders[lanes // m % nwin, lo[lanes] + k] + shifts[lanes // (nwin * m)]
        lanes, idx = lanes[~inf[idx]], idx[~inf[idx]]
        acc = G.put(acc, lanes, G.jac_madd(f, G.take(acc, lanes), x[idx], y[idx]))
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


def bucket_accumulate(x, y, inf, shifts, orders, starts, counts, first, runs) -> G.JacobianBatch:
    """K3: bucket sums. CPU tensors take the plain version; CUDA tensors
    launch csrc/msm.cu (accumulate_launches(N) launches)."""
    if not _build.on_card("bucket_accumulate", x):
        return bucket_accumulate_plain(x, y, inf, shifts, orders, starts, counts, first, runs)
    (nwin, n), b, m, nsets = orders.shape, starts.shape[1], runs.shape[1], shifts.shape[0]
    el = tuple(x.shape[1:])
    for name, t, shape in (("x", x, (x.shape[0], *el)), ("y", y, (x.shape[0], *el)), ("shifts", shifts, (nsets,)),
                           ("orders", orders, (nwin, n)), ("starts", starts, (nwin, b)),
                           ("counts", counts, (nwin, b)), ("first", first, (nwin, b)), ("runs", runs, (nwin, m))):
        _build.check("bucket_accumulate", name, t, shape, x.device)
    _build.check("bucket_accumulate", "inf", inf, x.shape[:1], x.device, torch.bool)
    parts = [torch.empty((nsets, nwin, m, *el), dtype=x.dtype, device=x.device) for _ in range(3)]
    out = [torch.empty((nsets, nwin, b, *el), dtype=x.dtype, device=x.device) for _ in range(3)]
    levels = tree_levels(n)
    _build.launch(f"p2_bucket_accumulate_{_group(x, 2)}", x.device, x, y, inf, shifts, orders, starts, counts, first,
                  runs, *parts, *out, nsets, n, nwin, m, b, SUBRUN, levels)
    LAUNCHES["bucket_accumulate"] += accumulate_launches(n)
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


def bucket_reduce_plain(buckets: G.JacobianBatch) -> G.JacobianBatch:
    """Plain PyTorch K4. buckets (S, nwin, B) Jacobian -> (S, nwin) window
    sums sum_l l S_l: every nonzero bucket of lane l > 0 times l by
    double-and-add over l's bits (vectorized over those buckets), then a
    log-step fold of each window's products. The JAX package's log-step
    suffix scan takes B log2(B) adds per window whatever the occupancy; this
    takes about (c + 1) adds per nonzero bucket."""
    x = buckets.x
    f = _field(x[:, 0, 0])
    nsets, nwin, b = x.shape[:3]
    el = tuple(x.shape[3:])
    rows = nsets * nwin
    flat = G.JacobianBatch(*(t.reshape(rows * b, *el) for t in buckets))
    weight = torch.arange(rows * b, device=x.device) % b
    idx = ((weight > 0) & ~f.is_zero(flat.z)).nonzero().squeeze(1)
    if not idx.numel():
        return G.jac_zero(f, (nsets, nwin), x.device)
    pts, w = G.take(flat, idx), weight[idx]
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


def bucket_reduce(buckets: G.JacobianBatch) -> G.JacobianBatch:
    """K4: window sums. CPU tensors take the plain version; CUDA tensors
    launch csrc/msm.cu (one block of reduce_threads(B) threads per set and
    window)."""
    x = buckets.x
    if not _build.on_card("bucket_reduce", x):
        return bucket_reduce_plain(buckets)
    nsets, nwin, b = x.shape[:3]
    for name, t in zip("xyz", buckets):
        _build.check("bucket_reduce", name, t, x.shape, x.device)
    out = [torch.empty((nsets, nwin, *x.shape[3:]), dtype=x.dtype, device=x.device) for _ in range(3)]
    _build.launch(f"p2_bucket_reduce_{_group(x, 4)}", x.device, *buckets, *out, nsets, nwin, b, reduce_threads(b))
    LAUNCHES["bucket_reduce"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# K5: window combination
# ---------------------------------------------------------------------------

def combine_windows_plain(sums: G.JacobianBatch, c: int) -> G.JacobianBatch:
    """Plain PyTorch K5: sum_w 2^(c w) T_w, MSB first, c doublings and one
    add per window. sums: (S, nwin) Jacobian; returns (S,)."""
    f = _field(sums.x[:, 0])
    p = G.jac_zero(f, sums.x.shape[:1], sums.x.device)
    for w in range(sums.x.shape[1] - 1, -1, -1):
        for _ in range(c):
            p = G.jac_double(f, p)
        p = G.jac_add(f, p, G.JacobianBatch(*(t[:, w] for t in sums)))
    return p


def combine_windows(sums: G.JacobianBatch, c: int) -> G.JacobianBatch:
    """K5: the MSMs from their window sums. CPU tensors take the plain
    version; CUDA tensors launch csrc/msm.cu."""
    x = sums.x
    if not _build.on_card("combine_windows", x):
        return combine_windows_plain(sums, c)
    for name, t in zip("xyz", sums):
        _build.check("combine_windows", name, t, x.shape, x.device)
    out = [torch.empty((x.shape[0], *x.shape[2:]), dtype=x.dtype, device=x.device) for _ in range(3)]
    _build.launch(f"p2_combine_windows_{_group(x, 3)}", x.device, *sums, *out, x.shape[0], x.shape[1], c)
    LAUNCHES["combine_windows"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------

def accumulate_sets(sets, c: int) -> G.JacobianBatch:
    """K3 of every set of `msm_sets`, one call each: the (S, nwin, B)
    Jacobian bucket sums of all the sets' shifts, in order."""
    parts = []
    for points, scalars, shifts in sets:
        if points.x.shape[0] < max(shifts) + scalars.shape[0]:
            raise ValueError(f"msm: {points.x.shape[0]} points, fewer than {scalars.shape[0]} scalars at shift "
                             f"{max(shifts)}")
        prep = prep_windows(scalars, c)
        shift_t = torch.tensor(shifts, dtype=torch.int64).to(points.x.device)
        parts.append(bucket_accumulate(points.x, points.y, points.inf, shift_t, *prep[:5]))
    return parts[0] if len(parts) == 1 else G.JacobianBatch(*(torch.cat(t) for t in zip(*parts)))


def msm_sets(sets, c: int | None = None) -> G.JacobianBatch:
    """sum_i scalars[i] * points[shift + i] for each (points, scalars,
    shifts) set of one group and each of its shifts: one K3 call per set,
    one K4 and one K5 launch for all, at window size c (by default that of
    the largest set). points: Montgomery affine ((N', 16) or (N', 2, 16)
    coordinates, inf (N',)) with N' >= max(shifts) + N; scalars: canonical
    int64 (N, 16). Returns (S,) Jacobian points, Montgomery, on the points'
    device, without waiting for the device."""
    c = pick_window(max(k.shape[0] for _, k, _ in sets)) if c is None else c
    return combine_windows(bucket_reduce(accumulate_sets(sets, c)), c)


def msm(points: G.AffineBatch, scalars: torch.Tensor, c: int | None = None) -> G.JacobianBatch:
    """sum_i scalars[i] * points[i]: one Jacobian point (batch ())."""
    return G.JacobianBatch(*(t[0] for t in msm_sets([(points, scalars, (0,))], c)))
