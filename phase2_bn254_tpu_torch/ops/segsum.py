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
3. S1 `segmented_scan`: a segmented Hillis-Steele inclusive scan of the
   products (log2 N full-width rounds, one kernel launch each,
   csrc/segsum.cu), and a gather of each segment's last lane; an empty
   segment is the point at infinity.

No padding: the JAX version pads the terms to a power of two with
generator x 0. The sums are Jacobian; any order of additions gives the same
affine point, so the bytes written after normalizing are the JAX package's.

S1 has a wrapper, a plain PyTorch version (the JAX scan, limb for limb) and
a launch count (`LAUNCHES["segmented_scan"]`, one per round launched). The
wrapper takes the plain version for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..curve import group as G
from ..field.fq2 import FQ, FQ2
from . import _build, batch_exp

# kernel launches by wrapper name; only a launch of the kernel counts
LAUNCHES = {"segmented_scan": 0}


def _field(x: torch.Tensor):
    return FQ if x.dim() == 2 else FQ2


def segment_starts(seg_ids: torch.Tensor) -> torch.Tensor:
    """For sorted segment ids (N,), the first lane of each lane's segment."""
    return torch.searchsorted(seg_ids, seg_ids, side="left")


def segmented_scan_plain(jac: G.JacobianBatch, starts: torch.Tensor) -> G.JacobianBatch:
    """Plain PyTorch S1 (the JAX `_seg_scan_last` scan): round d adds lane
    i - d into lane i where i - d lies in i's segment, acc[i] first; the
    other lanes keep their point as it is (the JAX scan adds infinity there,
    which gives the same point, with other limbs where acc[i] is infinity)."""
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


def segmented_scan(jac: G.JacobianBatch, starts: torch.Tensor) -> G.JacobianBatch:
    """S1: the segmented inclusive scan of Jacobian points (N,) with each
    lane's segment start (N,). CPU tensors take the plain version; CUDA
    tensors launch csrc/segsum.cu once per round (ceil(log2 N) launches)."""
    x = jac.x
    if not _build.on_card("segmented_scan", x):
        return segmented_scan_plain(jac, starts)
    n = x.shape[0]
    for name, t in zip("xyz", jac):
        _build.check("segmented_scan", name, t, x.shape, x.device)
    _build.check("segmented_scan", "starts", starts, (n,), x.device)
    entry = f"p2_seg_scan_round_{'g1' if x.dim() == 2 else 'g2'}"
    bufs = [[torch.empty_like(x) for _ in range(3)] for _ in range(2)]
    src, d, k = list(jac), 1, 0
    while d < n:
        dst = bufs[k % 2]
        _build.launch(entry, x.device, *src, starts, *dst, n, d)
        LAUNCHES["segmented_scan"] += 1
        src, d, k = dst, 2 * d, k + 1
    return G.JacobianBatch(*src)


def segment_sums(jac: G.JacobianBatch, seg_ids: torch.Tensor, n_segments: int) -> G.JacobianBatch:
    """sum of the points of each segment (n_segments,), Jacobian; jac (N,),
    seg_ids (N,) sorted ascending; an empty segment is infinity (z = 0)."""
    f = _field(jac.x)
    segs = torch.arange(n_segments, device=jac.x.device)
    first = torch.searchsorted(seg_ids, segs, side="left")
    last = torch.searchsorted(seg_ids, segs, side="right") - 1
    scanned = segmented_scan(jac, segment_starts(seg_ids))
    ends = G.take(scanned, last.clamp(min=0))
    empty = last < first
    return ends._replace(z=f.select(empty, torch.zeros_like(ends.z), ends.z))


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
