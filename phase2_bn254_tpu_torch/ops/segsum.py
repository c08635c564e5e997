"""Segmented point multiply-and-sum: the phase-2 QAP evaluation on the
device (counterpart of `phase2_bn254_tpu/ops/segsum.py`).

Each query of `MPCParameters.new` is a sparse matrix times a vector of
points: out[s] = sum of coeff_t * basis[base_t] over the terms t of segment
(variable) s. Here

1. the term bases are gathered from the basis, which stays decoded on the
   device;
2. one batch scalar multiplication covers all terms: on G1 the ladder that
   the caller names, K1 (`batch_exp.batch_exp_glv_signed`, the default) or
   K7 (`batch_exp.batch_exp_glv`, under PHASE2_TPU_NO_SIGNED5, as JAX
   `segsum.py:104-115` chooses), and K9 (`batch_exp.batch_exp_g2_windowed`)
   on G2;
3. S1 `segment_sums`: the sum of each segment's products by a one-pass
   segmented reduction (csrc/segsum.cu): each block adds a tile of
   `THREADS` x `TERMS` consecutive terms, every segment that ends in the
   tile is written, and the segments that cross tiles leave two carries a
   tile, reduced by the next launch the same way until one tile holds them
   (`reduce_levels`: 2 launches at 2^16 terms, 3 at 2^20); an empty segment
   is the point at infinity.

No padding: the JAX version pads the terms to a power of two with
generator x 0. The sums are Jacobian; any order of additions gives the same
affine point, so the bytes written after normalizing are the JAX package's.

S1 has a wrapper, a plain PyTorch version and a launch count
(`LAUNCHES["segment_sums"]`, one per launch). The plain version is the JAX
package's scan (`segmented_scan_plain`, JAX `_seg_scan_last`, limb for limb)
and a gather of each segment's last lane. The kernel adds in another order,
so its Jacobian limbs may differ from the plain version's: the two agree on
the affine point of every segment, which is what the tests and chip_smoke.py
compare. The wrapper takes the plain version for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..curve import group as G
from ..field.fq2 import FQ, FQ2
from . import _build, batch_exp

# kernel launches by wrapper name; only a launch of the kernel counts
LAUNCHES = {"segment_sums": 0}
# a tile of S1: THREADS threads (a block) of TERMS consecutive terms each;
# 128 x 4, chosen from chip_smoke.py's S1_TILE_SWEEP on an H100 (PERF.md
# gives every tile's times)
THREADS, TERMS = 128, 4


def _field(x: torch.Tensor):
    return FQ if x.dim() == 2 else FQ2


def segment_starts(seg_ids: torch.Tensor) -> torch.Tensor:
    """For sorted segment ids (N,), the first lane of each lane's segment."""
    return torch.searchsorted(seg_ids, seg_ids, side="left")


def segmented_scan_plain(jac: G.JacobianBatch, starts: torch.Tensor) -> G.JacobianBatch:
    """The JAX `_seg_scan_last` scan: round d adds lane i - d into lane i
    where i - d lies in i's segment, acc[i] first; the other lanes keep
    their point as it is (the JAX scan adds infinity there, which gives the
    same point, with other limbs where acc[i] is infinity)."""
    f = _field(jac.x)
    n = jac.x.shape[0]
    idx = torch.arange(n, device=jac.x.device)
    acc, d = jac, 1
    while d < n:
        ok = (idx - d) >= starts
        summed = G.jac_add(f, acc, G.JacobianBatch(*(torch.roll(t, d, 0) for t in acc)))
        acc = G.JacobianBatch(*(f.select(ok, s, a) for s, a in zip(summed, acc)))
        d *= 2
    return acc


def segment_sums_plain(jac: G.JacobianBatch, seg_ids: torch.Tensor, n_segments: int) -> G.JacobianBatch:
    """Plain PyTorch S1: `segmented_scan_plain`, then each segment's last
    lane; an empty segment is infinity (0, 1, 0)."""
    f = _field(jac.x)
    zero = G.jac_zero(f, (n_segments,), jac.x.device)
    if jac.x.shape[0] == 0:
        return zero
    segs = torch.arange(n_segments, device=jac.x.device)
    first = torch.searchsorted(seg_ids, segs, side="left")
    last = torch.searchsorted(seg_ids, segs, side="right") - 1
    ends = G.take(segmented_scan_plain(jac, segment_starts(seg_ids)), last.clamp(min=0))
    empty = last < first
    return G.JacobianBatch(*(f.select(empty, a, b) for a, b in zip(zero, ends)))


def reduce_levels(jac: G.JacobianBatch, seg_ids: torch.Tensor, n_segments: int, level, threads: int,
                  terms: int) -> G.JacobianBatch:
    """S1's launches: out (n_segments,) starts at infinity, and `level(src,
    seg, out, carry, carry_seg, n)`, one launch of csrc/segsum.cu over n
    entries in tiles of threads x terms, writes the segments that end in a
    tile and two carries a tile; the carries are the next launch's entries,
    until one tile holds them all. The wrapper passes the kernel's launch;
    the host tests pass the same per-thread code compiled by g++."""
    x = jac.x
    out = G.jac_zero(_field(x), (n_segments,), x.device)
    src, seg, n = list(jac), seg_ids, x.shape[0]
    while n > 0:
        tiles = -(-n // (threads * terms))
        carry = [torch.empty((2 * tiles, *x.shape[1:]), dtype=x.dtype, device=x.device) for _ in range(3)]
        carry_seg = torch.empty(2 * tiles, dtype=torch.int64, device=x.device)
        level(src, seg, out, carry, carry_seg, n)
        if tiles == 1:
            break
        src, seg, n = carry, carry_seg, 2 * tiles
    return out


def segment_sums(jac: G.JacobianBatch, seg_ids: torch.Tensor, n_segments: int) -> G.JacobianBatch:
    """S1: the sum of the points of each segment (n_segments,), Jacobian;
    jac (N,), seg_ids int64 (N,) sorted ascending, each below n_segments; an
    empty segment is infinity. CPU tensors take the plain version; CUDA
    tensors launch csrc/segsum.cu once per level (`reduce_levels`)."""
    x = jac.x
    if not _build.on_card("segment_sums", x):
        return segment_sums_plain(jac, seg_ids, n_segments)
    for name, t in zip("xyz", jac):
        _build.check("segment_sums", name, t, x.shape, x.device)
    _build.check("segment_sums", "seg_ids", seg_ids, (x.shape[0],), x.device)
    entry = f"p2_segment_sums_{'g1' if x.dim() == 2 else 'g2'}"
    threads, terms = THREADS, TERMS

    def level(src, seg, out, carry, carry_seg, n):
        _build.launch(entry, x.device, *src, seg, *out, *carry, carry_seg, n, threads, terms)
        LAUNCHES["segment_sums"] += 1

    return reduce_levels(jac, seg_ids, n_segments, level, threads, terms)


def term_products(basis: G.AffineBatch, base_idx: torch.Tensor, coeffs: torch.Tensor,
                  g1_ladder: str = "glv_signed") -> G.JacobianBatch:
    """coeffs[t] * basis[base_idx[t]] for every term (N,), Jacobian: on G1
    the ladder g1_ladder names ("glv_signed" K1 or "glv" K7,
    `backend.Ladders.terms_g1`), K9 on G2. basis: finite Montgomery affine
    points; base_idx int64 (N,); coeffs canonical Fr int64 (N, 16)."""
    x, y = basis.x[base_idx].contiguous(), basis.y[base_idx].contiguous()
    if x.dim() == 2:
        return batch_exp.batch_exp_g1(g1_ladder, x, y, coeffs)
    return batch_exp.batch_exp_g2_windowed(x, y, coeffs)


def segmented_msm(basis: G.AffineBatch, base_idx: torch.Tensor, coeffs: torch.Tensor, seg_ids: torch.Tensor,
                  n_segments: int, g1_ladder: str = "glv_signed") -> G.JacobianBatch:
    """out[s] = sum of coeffs[t] * basis[base_idx[t]] over the terms t with
    seg_ids[t] == s (JAX `segmented_msm`, on term arrays): Jacobian (n_segments,)
    on the basis' device, without waiting for the device. seg_ids int64
    (N,) sorted ascending; empty segments give infinity. g1_ladder: as
    `term_products` takes it."""
    if base_idx.shape[0] == 0:
        return G.jac_zero(_field(basis.x), (n_segments,), basis.x.device)
    return segment_sums(term_products(basis, base_idx, coeffs, g1_ladder), seg_ids, n_segments)
