"""The group-element iNTT of prepare_phase2 with host-RAM residency
(counterpart of `phase2_bn254_tpu/ceremony/streaming.py`).

prepare_phase2 needs inverse NTTs over point vectors at every degree up to
2^size (powersoftau/src/bin/prepare_phase2.rs:62-110; a butterfly's
twiddle is a full point-scalar ladder). The decoded vectors live in host
RAM (`HostPoints`: Montgomery int64 digits, pinned where a card is used)
and `group_intt_streamed` moves them through the device:

* in-core, where the vectors of a call fit the device budget (half of the
  card's free memory, `torch.cuda.mem_get_info`, with what the caching
  allocator holds unused; no limit on the CPU): the vectors are stacked as
  rows of one batch, so the three G1 vectors of a degree run together:
  `ops.ntt.group_ntt_staged` (one N1 launch a stage over every row, one N2
  for 1/N), then the batched normalization and the encoding, both on the
  device;
* otherwise the four-step decomposition, one vector at a time, in blocks
  of rows that fill the budget. N = R C, a[j1 + R j2]:

      pass 1 (rows j1 < R):   B[j1][k2] = DFT_C(a[j1 + R *])[k2] w^(j1 k2) / N
      pass 2 (rows k2 < C):   out[k2 + C k1] = DFT_R(B[*][k2])[k1]

  with w = omega_N^-1: the row DFTs are `ops.ntt.group_dft_rows` (no 1/m),
  the inter-row twiddles and 1/N one N2 launch a block with per-lane
  scalars (from two tables of w^e, e split at a bit, as K6's factors are).
  B stays Jacobian in host RAM (the JAX package normalizes it; a batched
  normalization costs more here than the extra coordinate). Each pass-2
  block is normalized and encoded on the device, and its bytes go to their
  points' places in the output. The DFT value is unique and the normalized
  affine output canonical, so both paths write the JAX package's bytes.

Either way what comes back to the host is the radix file's bytes of each
vector (uncompressed, infinity permitted), not the points. Unlike the JAX
package, which moves one four-step row per device call, a call moves as
many rows as the budget holds, and a degree that fits runs in-core. The
batched normalization is the port's plain-torch `curve.group.jac_normalize`,
in chunks of NORMALIZE_CHUNK points so that its temporaries stay a few GB.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..curve import codecs
from ..curve import group as G
from ..field import fp
from ..field.fq2 import FQ, FQ2
from ..ops import ntt
from ..refimpl.field import R_MOD

NORMALIZE_CHUNK = 1 << 18  # points per batched inverse (its temporaries: some 4 KB a point)
ENCODE_CHUNK = 1 << 18  # points per device encode (its temporaries: some 1 KB a point)
POINT_BYTES = {"g1": 64, "g2": 128}  # an uncompressed point in a radix file
# device bytes of one coordinate (16 int64 digits an Fq element) and the
# coordinates a point takes in the in-core iNTT: the affine input (2), the
# Jacobian batch (3) and its bit-reversed copy (3)
COORD_BYTES = {"g1": 128, "g2": 256}
IN_CORE_COORDS = 8


def _field(group: str):
    return FQ if group == "g1" else FQ2


@dataclass
class HostPoints:
    """Affine points in host RAM: Montgomery digits int64 (n, 16) on G1,
    (n, 2, 16) on G2, and the infinity mask (n,)."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor
    group: str

    @property
    def n(self) -> int:
        return self.inf.shape[0]

    def slice(self, start: int, stop: int) -> "HostPoints":
        """Points [start, stop), sharing this one's memory."""
        return HostPoints(self.x[start:stop], self.y[start:stop], self.inf[start:stop], self.group)

    def row(self, idx, device) -> G.AffineBatch:
        """Points idx (a slice or an index tensor) as an AffineBatch on
        `device`."""
        return G.AffineBatch(*(t[idx].to(device, non_blocking=True) for t in (self.x, self.y, self.inf)))


def host_empty(group: str, n: int, pin: bool) -> HostPoints:
    """n uninitialised host points (pinned memory with pin)."""
    shape = (n, fp.NLIMBS) if group == "g1" else (n, 2, fp.NLIMBS)
    x, y = (torch.empty(shape, dtype=fp.DTYPE, pin_memory=pin) for _ in range(2))
    return HostPoints(x, y, torch.empty(n, dtype=torch.bool, pin_memory=pin), group)


def pointset_to_host(ps, out: HostPoints) -> HostPoints:
    """The affine points of a decoded `ops.backend.PointSet` copied into
    `out`, host points of the same count; returns out."""
    for d, s in zip((out.x, out.y, out.inf), ps.affine):
        d.copy_(s)
    return out


def device_budget(device: torch.device) -> int | None:
    """Bytes the iNTT may hold on `device`: half of the card's free memory
    (what the caching allocator keeps unused counted free); None on the CPU."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)) // 2


def normalize(jac: G.JacobianBatch) -> G.AffineBatch:
    """Jacobian -> affine (plain torch `curve.group.jac_normalize`),
    NORMALIZE_CHUNK points at a time; infinity comes out with its flag."""
    f = FQ if jac.x.dim() == 2 else FQ2
    n = jac.x.shape[0]
    if n <= NORMALIZE_CHUNK:
        return G.jac_normalize(f, jac)
    x, y = torch.empty_like(jac.x), torch.empty_like(jac.y)
    inf = torch.empty(n, dtype=torch.bool, device=jac.x.device)
    for s in range(0, n, NORMALIZE_CHUNK):
        part = G.jac_normalize(f, G.JacobianBatch(*(c[s : s + NORMALIZE_CHUNK] for c in jac)))
        for d, v in zip((x, y, inf), part):
            d[s : s + NORMALIZE_CHUNK] = v
    return G.AffineBatch(x, y, inf)


def intt_device(aff: G.AffineBatch, exp: int) -> G.AffineBatch:
    """The inverse NTT of each row of 2^exp consecutive affine points on
    one device (the in-core path): Jacobian, `ntt.group_ntt_staged`,
    normalized; natural order."""
    f = FQ if aff.x.dim() == 2 else FQ2
    return normalize(ntt.group_ntt_staged(exp, G.affine_to_jac(f, aff), inverse=True))


def group_intt_streamed(srcs: list[HostPoints], exp: int, device, rows_per_block: int | None = None
                        ) -> list[bytes]:
    """The inverse group NTT of each vector of srcs (of one group, 2^exp
    points each), natural order, as radix-file bytes (`encode`). In-core
    where the vectors fit the device budget, else the four-step in blocks
    that fill it; `rows_per_block` forces the four-step with blocks of that
    many rows."""
    n = 1 << exp
    group = srcs[0].group
    if any(s.n != n or s.group != group for s in srcs):
        raise ValueError(f"group_intt_streamed: want {group} vectors of {n} points")
    dev = torch.device(device)
    if n == 1:
        return [encode(s.row(slice(None), dev), group) for s in srcs]
    budget = device_budget(dev)
    if rows_per_block is None and (budget is None or len(srcs) * n * IN_CORE_COORDS * COORD_BYTES[group] <= budget):
        return _in_core(srcs, exp, dev)
    return [_four_step(s, exp, dev, rows_per_block, budget) for s in srcs]


def _in_core(srcs: list[HostPoints], exp: int, dev: torch.device) -> list[bytes]:
    n = 1 << exp
    rows = [s.row(slice(None), dev) for s in srcs]
    out = intt_device(G.AffineBatch(*(torch.cat(c) for c in zip(*rows))), exp)
    return [encode(G.AffineBatch(*(c[v * n : (v + 1) * n] for c in out)), srcs[0].group) for v in range(len(srcs))]


def _block_rows(length: int, count: int, group: str, rows_per_block: int | None, budget: int | None) -> int:
    """Rows of `length` points a four-step block takes: rows_per_block, or
    as many as the budget holds (all of them without a budget)."""
    if rows_per_block is None:
        rows_per_block = count if budget is None else budget // (length * IN_CORE_COORDS * COORD_BYTES[group])
    return max(1, min(rows_per_block, count))


@functools.lru_cache(maxsize=8)
def _twiddle_tables(exp: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(lo, hi, b): Montgomery w^e / N = lo[e mod 2^b] hi[e >> b] for e <
    N, w = omega_N^-1 (the 1/N folded into lo)."""
    d = ntt.Domain(exp)
    bits = (exp + 1) // 2
    lo = ntt.geometric(d.omegainv, bits, device, start=d.minv)
    hi = ntt.geometric(pow(d.omegainv, 1 << bits, R_MOD), exp - bits, device)
    return lo, hi, bits


def _inter_twiddles(exp: int, j1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """w^(j1 k2) / N, canonical Fr digits (len(j1) len(k2), 16)."""
    lo, hi, bits = _twiddle_tables(exp, j1.device)
    e = (j1[:, None] * k2[None, :] % (1 << exp)).reshape(-1)
    return fp.from_mont(ntt.CTX, fp.mont_mul(ntt.CTX, lo[e & ((1 << bits) - 1)], hi[e >> bits]))


def _four_step(src: HostPoints, exp: int, dev: torch.device, rows_per_block: int | None,
               budget: int | None) -> bytes:
    n = 1 << exp
    exp_r = (exp - 1) // 2  # R <= C / 2: pass 2's rows are the shorter, pass 1 does the inter-row twiddles
    exp_c = exp - exp_r
    R, C = 1 << exp_r, 1 << exp_c
    f, pin = _field(src.group), dev.type == "cuda"
    inter = [torch.empty(src.x.shape, dtype=fp.DTYPE, pin_memory=pin) for _ in range(3)]  # B[j1 C + k2], Jacobian
    k2 = torch.arange(C, device=dev)
    block = _block_rows(C, R, src.group, rows_per_block, budget)
    for a in range(0, R, block):
        j1 = torch.arange(a, min(a + block, R))
        jac = G.affine_to_jac(f, src.row((j1[:, None] + R * torch.arange(C)[None, :]).reshape(-1), dev))
        jac = ntt.jac_scalar_mul(ntt.group_dft_rows(exp_c, jac, inverse=True),
                                 _inter_twiddles(exp, j1.to(dev), k2))
        for d, c in zip(inter, jac):
            d[a * C : (a + len(j1)) * C] = c.cpu()

    size = POINT_BYTES[src.group]
    result = np.empty((n, size), dtype=np.uint8)
    block = _block_rows(R, C, src.group, rows_per_block, budget)
    for a in range(0, C, block):
        k = torch.arange(a, min(a + block, C))
        idx = (k[:, None] + C * torch.arange(R)[None, :]).reshape(-1)  # B[j1][k2] and out[k2 + C k1]
        jac = G.JacobianBatch(*(c[idx].to(dev) for c in inter))
        data = encode(normalize(ntt.group_dft_rows(exp_r, jac, inverse=True)), src.group)
        result[idx.numpy()] = np.frombuffer(data, dtype=np.uint8).reshape(-1, size)
    return result.tobytes()


def encode(aff: G.AffineBatch, group: str) -> bytes:
    """Affine points on a device as radix-file bytes (uncompressed, infinity
    permitted), ENCODE_CHUNK at a time where they lie."""
    n = aff.inf.shape[0]
    return b"".join(codecs.encode_batch(G.AffineBatch(*(c[s : s + ENCODE_CHUNK] for c in aff)), group, False,
                                        allow_infinity=True)
                    for s in range(0, n, ENCODE_CHUNK))
