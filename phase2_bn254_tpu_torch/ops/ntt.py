"""Radix-2 NTT over Fr for evaluation domains (counterpart of the scalar half
of `phase2_bn254_tpu/ops/ntt.py`, and of its Pallas four-step kernel K6,
`ops/pallas_ntt.py` `ntt_pallas` / `_lane_dft_pass`).

`ntt(exp, coeffs, inverse)`: int64 (2^exp, 16) Montgomery Fr -> the
natural-order DFT out[k] = sum_j a_j w^(jk), w = omega (or omegainv, and then
times 1/m), bellman's serial_fft semantics. It runs the four-step method as
two launches of one kernel, K6 `lane_dft` (csrc/ntt.cu), for N = R C with
R = 2^(exp // 2), C = 2^(exp - exp // 2):

1. rows j1 < R of the matrix a[j1 + R j2]: a C-point DFT over j2 with root
   w^R, times the inter-twiddle w^(j1 k2) (and 1/N for the inverse), stored
   transposed, b[k2 R + j1];
2. rows k2 < C of b: an R-point DFT over j1 with root w^C, stored at
   out[k2 + C k1].

For exp = 1 (R = 1) the first pass is the whole DFT, 1/N included. One path
for every exp from 1 to 24 (C <= 4096 elements in a block's shared memory);
above 24 `ntt` raises NotImplementedError (ROADMAP.md queue 2, K6 item).

The twiddle tables are built on the tensors' device by log-doubling
(`geometric`): the stage table w_C^j (j < C/2) of each pass and the two
halves of the inter-twiddle, w^i (i < C) and scale w^(C i) (i < R), whose
product at i = e mod C, e div C is w^e scale for e = j1 k2 < N.

`lane_dft` launches the kernel for CUDA tensors (or raises) and counts the
launch in `LAUNCHES["lane_dft"]`; for CPU tensors it takes the plain version,
`lane_dft_plain`, the same function in whole-tensor torch ops (its DFT,
`dft_rows_plain`, is the JAX package's `_ntt_xla` stage loop, ops/ntt.py:
110-130, batched over rows). Values are fully reduced, so the two agree limb
for limb.

The pointwise coset helpers (`distribute_powers`, `coset_ntt`, `icoset_ntt`,
`divide_by_z_on_coset`) are plain torch on the tensors' device.
"""

from __future__ import annotations

import functools

import torch

from .. import convert
from ..field import fp
from ..refimpl.field import FR_GENERATOR, FR_ROOT_OF_UNITY, FR_S, R_MOD
from . import _build

CTX = fp.FR_CTX
MULT_GEN = FR_GENERATOR  # Fr::multiplicative_generator() = 7
MAX_EXP = 24  # the longer pass holds C = 2^(exp - exp // 2) <= 4096 elements (128 KiB) in shared memory

# kernel launches; only a launch of the kernel counts
LAUNCHES = {"lane_dft": 0}


class Domain:
    """Evaluation-domain constants for size m = 2^exp (JAX `ops.ntt.Domain`,
    bellman domain.rs:52-99)."""

    def __init__(self, exp: int):
        if not 0 <= exp <= FR_S:
            raise ValueError(f"domain exponent {exp} outside [0, {FR_S}]")
        self.exp = exp
        self.m = 1 << exp
        self.omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - exp), R_MOD)
        self.omegainv = pow(self.omega, -1, R_MOD)
        self.minv = pow(self.m, -1, R_MOD)
        self.gen = MULT_GEN
        self.geninv = pow(MULT_GEN, -1, R_MOD)


def geometric(ratio: int, log2n: int, device, start: int = 1) -> torch.Tensor:
    """Montgomery limbs of start * ratio^i for i < 2^log2n, int64
    (2^log2n, 16) on `device`: log2n doubling steps P_2k = [P_k, P_k ratio^k]
    (the host computes only the log2n constants ratio^(2^j))."""
    consts = [start % R_MOD] + [pow(ratio, 1 << j, R_MOD) for j in range(log2n)]
    mont = convert.ints_to_limbs([CTX.to_mont_int(v) for v in consts], device)
    out = mont[:1]
    for j in range(log2n):
        out = torch.cat([out, fp.mont_mul(CTX, out, mont[1 + j])])
    return out


@functools.lru_cache(maxsize=None)
def _bitrev(log2n: int, device: torch.device) -> torch.Tensor:
    idx = torch.arange(1 << log2n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log2n):
        rev |= ((idx >> b) & 1) << (log2n - 1 - b)
    return rev


@functools.lru_cache(maxsize=8)
def _tables(exp: int, inverse: bool, device: torch.device):
    """(stage table of pass 1, inter-twiddle w^i (i < C), scale w^(C i)
    (i < R), stage table of pass 2), on `device`."""
    d = Domain(exp)
    w = d.omegainv if inverse else d.omega
    log2r = exp // 2
    log2c = exp - log2r
    scale = d.minv if inverse else 1
    stage1 = geometric(pow(w, 1 << log2r, R_MOD), log2c - 1, device)
    lo = geometric(w, log2c, device)
    hi = geometric(pow(w, 1 << log2c, R_MOD), log2r, device, start=scale)
    stage2 = geometric(pow(w, 1 << log2c, R_MOD), log2r - 1, device) if log2r else None
    return stage1, lo, hi, stage2


def ntt(exp: int, coeffs: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The DFT of int64 (2^exp, 16) Montgomery Fr coeffs (JAX `ops.ntt.ntt`),
    by two K6 passes; a new tensor on the coeffs' device."""
    return _four_step(exp, coeffs, inverse, lane_dft)


def ntt_plain(exp: int, coeffs: torch.Tensor, inverse: bool) -> torch.Tensor:
    """`ntt` through the plain version of both passes, on any device."""
    return _four_step(exp, coeffs, inverse, lane_dft_plain)


def _four_step(exp: int, coeffs: torch.Tensor, inverse: bool, lane) -> torch.Tensor:
    if exp > MAX_EXP:
        raise NotImplementedError(f"ntt at exp {exp}: K6 takes exp <= {MAX_EXP} (ROADMAP.md queue 2, the K6 item: "
                                  "a third pass for exp 25-28)")
    d = Domain(exp)
    if tuple(coeffs.shape) != (d.m, fp.NLIMBS):
        raise ValueError(f"ntt: want ({d.m}, {fp.NLIMBS}) limbs, got {tuple(coeffs.shape)}")
    if d.m == 1:
        return coeffs.clone()
    log2r = exp // 2
    log2c = exp - log2r
    r, c = 1 << log2r, 1 << log2c
    stage1, lo, hi, stage2 = _tables(exp, inverse, coeffs.device)
    b = lane(coeffs, r, log2c, 1, r, 1, r, stage1, lo, hi, log2c)
    if log2r == 0:
        return b
    return lane(b, c, log2r, r, 1, 1, c, stage2)


# ---------------------------------------------------------------------------
# K6: one pass
# ---------------------------------------------------------------------------

def dft_rows_plain(x: torch.Tensor, log2c: int, stage_tw: torch.Tensor) -> torch.Tensor:
    """Radix-2 DIT DFT along axis 1 of (rows, C, 16) Montgomery limbs in
    bit-reversed order -> natural order; stage_tw[j] = w^j, j < C/2. The
    JAX `_ntt_xla` stage loop, batched over rows."""
    rows, c = x.shape[:2]
    for s in range(1, log2c + 1):
        mlen, half = 1 << s, 1 << (s - 1)
        tw = stage_tw[torch.arange(half, device=x.device) << (log2c - s)]
        x = x.reshape(rows, c // mlen, mlen, fp.NLIMBS)
        even, odd = x[:, :, :half], x[:, :, half:]
        t = fp.mont_mul(CTX, odd, tw)
        x = torch.cat([fp.add(CTX, even, t), fp.sub(CTX, even, t)], dim=2).reshape(rows, c, fp.NLIMBS)
    return x


def lane_dft_plain(x, rows, log2c, irs, ics, ors, ocs, stage_tw, tw_lo=None, tw_hi=None, lo_bits=0) -> torch.Tensor:
    """Plain PyTorch K6: the pass of `lane_dft` in whole-tensor ops."""
    c = 1 << log2c
    view = torch.as_strided(x, (rows, c, fp.NLIMBS), (irs * fp.NLIMBS, ics * fp.NLIMBS, 1))
    y = dft_rows_plain(view[:, _bitrev(log2c, x.device)], log2c, stage_tw)
    if tw_lo is not None:
        e = torch.arange(rows, device=x.device)[:, None] * torch.arange(c, device=x.device)[None, :]
        y = fp.mont_mul(CTX, y, fp.mont_mul(CTX, tw_lo[e & ((1 << lo_bits) - 1)], tw_hi[e >> lo_bits]))
    out = torch.empty_like(x)
    torch.as_strided(out, (rows, c, fp.NLIMBS), (ors * fp.NLIMBS, ocs * fp.NLIMBS, 1)).copy_(y)
    return out


def lane_dft(x, rows, log2c, irs, ics, ors, ocs, stage_tw, tw_lo=None, tw_hi=None, lo_bits=0) -> torch.Tensor:
    """K6: one four-step pass (see csrc/ntt.cu) over x, int64 (rows 2^log2c,
    16) Montgomery Fr: row r, element j at x[r irs + j ics]; element k of
    row r's DFT (times tw_lo[e mod 2^lo_bits] tw_hi[e >> lo_bits], e = r k,
    when tw_lo is given) goes to out[r ors + k ocs]. Returns out, a new
    tensor. CPU tensors take the plain version; CUDA tensors launch
    csrc/ntt.cu."""
    c = 1 << log2c
    n = rows * c
    for name, (rs, cs) in (("input", (irs, ics)), ("output", (ors, ocs))):
        if (rows - 1) * rs + (c - 1) * cs >= n or min(rs, cs) < 1:
            raise ValueError(f"lane_dft: {name} strides ({rs}, {cs}) leave the {n} elements")
    if not _build.on_card("lane_dft", x):
        return lane_dft_plain(x, rows, log2c, irs, ics, ors, ocs, stage_tw, tw_lo, tw_hi, lo_bits)
    if log2c < 1 or c > 1 << (MAX_EXP - MAX_EXP // 2):
        raise ValueError(f"lane_dft: pass length 2^{log2c} outside [2, {1 << (MAX_EXP - MAX_EXP // 2)}]")
    _build.check("lane_dft", "x", x, (n, fp.NLIMBS), x.device)
    _build.check("lane_dft", "stage_tw", stage_tw, (c // 2, fp.NLIMBS), x.device)
    if tw_lo is not None:
        _build.check("lane_dft", "tw_lo", tw_lo, (1 << lo_bits, fp.NLIMBS), x.device)
        _build.check("lane_dft", "tw_hi", tw_hi, (-(-n // (1 << lo_bits)), fp.NLIMBS), x.device)
    out = torch.empty_like(x)
    _build.launch("p2_lane_dft", x.device, x, out, stage_tw, tw_lo, tw_hi, rows, log2c, lo_bits, irs, ics, ors, ocs)
    LAUNCHES["lane_dft"] += 1
    return out


# ---------------------------------------------------------------------------
# pointwise coset helpers (JAX ops/ntt.py:265-296)
# ---------------------------------------------------------------------------

def distribute_powers(exp: int, coeffs: torch.Tensor, g: int) -> torch.Tensor:
    """coeffs[i] * g^i (domain.rs:176-189); g is a host int."""
    return fp.mont_mul(CTX, coeffs, geometric(g, exp, coeffs.device))


def coset_ntt(exp: int, coeffs: torch.Tensor) -> torch.Tensor:
    return ntt(exp, distribute_powers(exp, coeffs, MULT_GEN), False)


def icoset_ntt(exp: int, coeffs: torch.Tensor) -> torch.Tensor:
    return distribute_powers(exp, ntt(exp, coeffs, True), Domain(exp).geninv)


def divide_by_z_on_coset(exp: int, coeffs: torch.Tensor) -> torch.Tensor:
    """Multiply by 1/(g^m - 1): z is constant on the coset (domain.rs:217-230)."""
    zinv = pow(pow(MULT_GEN, 1 << exp, R_MOD) - 1, -1, R_MOD)
    return fp.mont_mul(CTX, coeffs, convert.ints_to_limbs([CTX.to_mont_int(zinv)], coeffs.device)[0])
