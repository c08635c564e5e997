"""Radix-2 NTT over Fr for evaluation domains (counterpart of
`phase2_bn254_tpu/ops/ntt.py`, and of its Pallas four-step kernel K6,
`ops/pallas_ntt.py` `ntt_pallas` / `_lane_dft_pass`), and over group
elements (the end of this module).

`ntt(exp, coeffs, inverse)`: int64 (2^exp, 16) Montgomery Fr -> the
natural-order DFT out[k] = sum_j a_j w^(jk), w = omega (or omegainv, and then
times 1/m), bellman's serial_fft semantics, for every exp from 0 to 28 (Fr's
two-adicity). It runs the four-step method generalised to k passes,
`four_step`, one launch of K6 `lane_dft` (csrc/ntt.cu) per entry of the
pass plan (`pass_plan`: log2 lengths n_0, n_1, ... of at most 2^12
elements, the most a block's shared memory holds; two passes up to exp 24,
three above). With N = n_0 M, pass 0 takes rows j' < M of a[j' + M j]: an
n_0-point DFT over j, times the inter-twiddle w^(j' k) (and 1/N for the
inverse), stored at b[k M + j']. The rest is N / n_0 independent M-point
DFTs, each contiguous in b, and pass 1 splits each of them the same way in
place; the last pass (no twiddle) writes the digits k_0, k_1, ... of the
output index in reverse: out[k_0 + n_0 k_1 + n_0 n_1 k_2]. A pass's row
therefore has a two-level address (its batch and its row in the batch), see
`Pass`. The intermediates between passes are packed (int32 (N, 8): 8 32-bit
limbs, 32 bytes an element where the int64 layout takes 128); `ntt`'s input
and output keep the int64 layout the rest of the port uses.

Tables (built once per exp, direction, factors and device by log-doubling,
`geometric`, and kept, packed): each pass's stage table w_C^j (j < C/2)
and, but for the last pass, the two halves of its inter-twiddle. The
coset helpers fold their pointwise factors into the passes: `coset_ntt`
multiplies each input a_i by g^i in pass 0's load, and `icoset_ntt`
multiplies each output by geninv^k (times 1/(g^N - 1) with divide_by_z) in
the last pass's store, each factor split as lo[i mod 2^b] hi[i >> b] as the
inter-twiddle is. So a coset NTT is one `ntt` call, with no pointwise pass
and no table built per call.

`lane_dft` launches the kernel for CUDA tensors (or raises) and counts the
launch in `LAUNCHES["lane_dft"]`; for CPU tensors it takes the plain
version, `lane_dft_plain`, the same function in whole-tensor torch ops (its
DFT, `dft_rows_plain`, is the JAX package's `_ntt_xla` stage loop, ops/ntt.py:
110-130, batched over rows). Values are fully reduced, so the two agree limb
for limb.

`distribute_powers` and `divide_by_z_on_coset` stay the pointwise helpers
they are in the JAX package (plain torch on the tensors' device).

The group NTT (JAX `ops/ntt.py:133-260`; prepare_phase2's Lagrange
conversion, through `ceremony/streaming.py`): `group_ntt_staged(exp, pts,
inverse)` over every row of 2^exp consecutive Jacobian points (G1 (N, 16)
or G2 (N, 2, 16), Montgomery), natural order in and out: each row's
bit-reversed gather, then per stage one launch of N1 `group_ntt_stage`
over all the rows (a butterfly's twiddle w^j, canonical, read from
`Domain.twiddles_canonical` by the pair's index, is a windowed ladder over
the Jacobian point b: (a, b) -> (a + w b, a - w b)), and for the inverse
one launch of N2 `jac_scalar_mul` (each point times 1/m); csrc/group_ntt.cu.
Both wrappers update the points in place, count their launches in
`LAUNCHES` and take their plain versions (`group_ntt_stage_plain`,
`jac_scalar_mul_plain`, over `jac_ladder_plain`, the kernels' ladder limb
for limb) for CPU tensors; on a CUDA tensor they launch or raise.

Memory: besides its input (128 bytes an element), `ntt` at exp holds its
output and one packed intermediate (the middle of three passes runs in
place), 160 bytes an element (`device_bytes`): 5 GiB at 2^25, 40 GiB at
2^28, where input, output and intermediate take 72 GiB together. Where the
card runs out, it raises MemoryError with those numbers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import convert
from ..curve import group as G
from ..field import fp
from ..field.fq2 import FQ, FQ2
from ..refimpl.field import FR_GENERATOR, FR_ROOT_OF_UNITY, FR_S, R_MOD
from . import _build, batch_exp

CTX = fp.FR_CTX
MULT_GEN = FR_GENERATOR  # Fr::multiplicative_generator() = 7
MAX_PASS_LOG = 12  # a pass's row, 2^12 packed elements (128 KiB), in one block's shared memory
TWO_PASS_MAX_EXP = 2 * MAX_PASS_LOG

# kernel launches; only a launch of the kernel counts
LAUNCHES = {"lane_dft": 0, "group_ntt_stage": 0, "jac_scalar_mul": 0}


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

    def twiddles_canonical(self, inverse: bool, device) -> torch.Tensor:
        """w^j for j < m/2 (w = omega, or omegainv for the inverse),
        canonical Fr digits int64 (m/2, 16) on `device` (JAX
        `Domain.twiddles_canonical`), built there by `geometric` and kept;
        needs m >= 2."""
        return _twiddles_canonical(self.exp, inverse, torch.device(device))

    def bitrev(self, device) -> torch.Tensor:
        """The bit-reversal permutation of [0, m), int64 on `device` (JAX
        `Domain.bitrev`)."""
        return _bitrev(self.exp, torch.device(device))


@functools.lru_cache(maxsize=None)
def _twiddles_canonical(exp: int, inverse: bool, device: torch.device) -> torch.Tensor:
    d = Domain(exp)
    return fp.from_mont(CTX, geometric(d.omegainv if inverse else d.omega, exp - 1, device))


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


def pack(digits: torch.Tensor) -> torch.Tensor:
    """int64 (..., 16) 16-bit digits -> int32 (..., 8) 32-bit limbs (the
    bits of each uint32 limb)."""
    w = digits[..., 0::2] | (digits[..., 1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack(limbs: torch.Tensor) -> torch.Tensor:
    """int32 (..., 8) -> int64 (..., 16) digits (inverse of `pack`)."""
    w = limbs.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2)


def pass_plan(exp: int) -> tuple[int, ...]:
    """log2 lengths of `ntt`'s passes at exp, first pass first: none at exp
    0, one at exp 1, two up to exp 24 and three above, as even as they go
    with the longer ones first (24: 12, 12; 25: 9, 8, 8; 28: 10, 9, 9); each
    at most MAX_PASS_LOG."""
    Domain(exp)  # the range check
    k = min(exp, 2 if exp <= TWO_PASS_MAX_EXP else 3)
    return tuple(exp // k + (i < exp % k) for i in range(k)) if k else ()


def device_bytes(exp: int) -> int:
    """Device bytes `ntt` holds at exp beyond its input: the int64 output
    and, with two passes or more, one packed intermediate."""
    m = 1 << exp
    return 128 * m + (32 * m if len(pass_plan(exp)) > 1 else 0)


class Factors(NamedTuple):
    """A per-element factor lo[i mod 2^bits] * hi[i >> bits], packed tables."""
    lo: torch.Tensor
    hi: torch.Tensor
    bits: int


class Pass(NamedTuple):
    """One K6 pass: `rows` rows of 2^log2c elements; row r = (r_hi, r_lo),
    r_lo = r mod 2^rlo_bits, element j at in[r_hi ins[0] + r_lo ins[1] + j
    ins[2]], output k at out[r_hi outs[0] + r_lo outs[1] + k outs[2]]; the
    stage table w_C^j (j < C/2); the inter-twiddle at e = r_lo k; factors
    by input and by output address (None: none)."""
    rows: int
    log2c: int
    rlo_bits: int
    ins: tuple[int, int, int]
    outs: tuple[int, int, int]
    stage: torch.Tensor
    twiddle: Factors | None = None
    load: Factors | None = None
    store: Factors | None = None


def _factors(ratio: int, bits: int, total_bits: int, device, scale: int = 1) -> Factors:
    """scale * ratio^i for i < 2^total_bits, split at bit `bits`."""
    lo = pack(geometric(ratio, bits, device, start=scale))
    hi = pack(geometric(pow(ratio, 1 << bits, R_MOD), total_bits - bits, device))
    return Factors(lo, hi, bits)


@functools.lru_cache(maxsize=16)
def _plan_passes(exp: int, inverse: bool, plan: tuple[int, ...], pre: int | None, post: tuple[int, int] | None,
                 device: torch.device) -> tuple[Pass, ...]:
    """The passes of `four_step` (see the module docstring), with their
    tables on `device`."""
    d = Domain(exp)
    w = d.omegainv if inverse else d.omega
    passes = []
    prefix = 0  # log2 of the passes' output digits so far (the batches)
    for p, lc in enumerate(plan):
        suffix = exp - prefix - lc  # log2 of the rows in a batch
        stage = pack(geometric(pow(w, 1 << (exp - lc), R_MOD), lc - 1, device))
        last = p == len(plan) - 1
        if not last:
            # row = batch * S + r_lo: address batch (C S) + r_lo + S j, in and out
            strides = (1 << (lc + suffix), 1, 1 << suffix)
            spec = dict(rows=1 << (prefix + suffix), rlo_bits=suffix, ins=strides, outs=strides)
        else:
            # S = 1, row = batch, in at batch C + j; the batch's digits reversed on output:
            # batch = (k_0, k_1) -> k_0 + n_0 k_1, and k at stride 2^prefix
            split = plan[-2] if p >= 2 else prefix
            lo_out = 1 << (prefix - split)
            spec = dict(rows=1 << prefix, rlo_bits=split, ins=(1 << (lc + split), 1 << lc, 1),
                        outs=(1, lo_out, 1 << prefix))
        twiddle = None
        if p == 0:  # the inter-twiddle w^(r k) (r < M, k < n_0), 1/N of the inverse folded in
            twiddle = _factors(w, lc, exp, device, scale=d.minv if inverse else 1)
        elif not last:
            twiddle = _factors(pow(w, 1 << prefix, R_MOD), lc, exp - prefix, device)
        load = _factors(pre, exp - lc, exp, device) if p == 0 and pre is not None else None
        store = _factors(post[0], prefix, exp, device, scale=post[1]) if last and post is not None else None
        passes.append(Pass(log2c=lc, stage=stage, twiddle=twiddle, load=load, store=store, **spec))
        prefix += lc
    return tuple(passes)


def four_step(exp: int, coeffs: torch.Tensor, inverse: bool, plan: tuple[int, ...] | None = None,
              pre: int | None = None, post: tuple[int, int] | None = None, lane=None) -> torch.Tensor:
    """The k-pass NTT of int64 (2^exp, 16) Montgomery Fr coeffs over `plan`
    (at most three log2 pass lengths summing to exp, each at most
    MAX_PASS_LOG; by default `pass_plan(exp)`): with pre = g, input i is
    first multiplied by g^i; with post = (ratio, scale), output k by scale
    ratio^k. One `lane` call (`lane_dft`, the default, or `lane_dft_plain`)
    per pass; a new tensor on the coeffs' device."""
    lane = lane or lane_dft
    d = Domain(exp)
    if tuple(coeffs.shape) != (d.m, fp.NLIMBS) or coeffs.dtype != torch.int64:
        raise ValueError(f"ntt: want int64 ({d.m}, {fp.NLIMBS}) limbs, got {coeffs.dtype} {tuple(coeffs.shape)}")
    plan = pass_plan(exp) if plan is None else tuple(plan)
    if sum(plan) != exp or len(plan) > 3 or not all(1 <= lc <= MAX_PASS_LOG for lc in plan):
        raise ValueError(f"ntt: plan {plan} is not at most 3 lengths of 2^1..2^{MAX_PASS_LOG} elements "
                         f"summing to 2^{exp} (a pass's row address has two levels)")
    if not plan:
        x = coeffs.clone()
        if pre is not None or post is not None:
            scale = post[1] if post is not None else 1
            x = fp.mont_mul(CTX, x, convert.ints_to_limbs([CTX.to_mont_int(scale)], x.device)[0])
        return x
    try:
        passes = _plan_passes(exp, inverse, plan, pre, post, coeffs.device)
        # the output first, then the one packed intermediate, which the middle
        # pass updates in place: every call asks the caching allocator for
        # the same two sizes in the same order, so at 2^28 no large cached
        # block is split for a smaller one and the card holds the call
        result = torch.empty_like(coeffs)
        x = coeffs
        for p, spec in enumerate(passes):
            last = p == len(passes) - 1
            x = lane(x, spec, packed_out=not last, out=result if last else x if p else None)
        return x
    except torch.OutOfMemoryError as e:
        raise MemoryError(f"ntt at exp {exp}: the card ran out of memory; the call needs {device_bytes(exp)} bytes "
                          f"beside its {128 * d.m}-byte input") from e


def ntt(exp: int, coeffs: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The DFT of int64 (2^exp, 16) Montgomery Fr coeffs (JAX `ops.ntt.ntt`),
    by `pass_plan(exp)`'s K6 passes; a new tensor on the coeffs' device."""
    return four_step(exp, coeffs, inverse)


def ntt_plain(exp: int, coeffs: torch.Tensor, inverse: bool) -> torch.Tensor:
    """`ntt` through the plain version of each pass, on any device."""
    return four_step(exp, coeffs, inverse, lane=lane_dft_plain)


# ---------------------------------------------------------------------------
# K6: one pass
# ---------------------------------------------------------------------------

def dft_rows_plain(x: torch.Tensor, log2c: int, stage_tw: torch.Tensor) -> torch.Tensor:
    """Radix-2 DIT DFT along axis 1 of (rows, C, 16) Montgomery limbs in
    bit-reversed order -> natural order; stage_tw[j] = w^j, j < C/2 (int64
    digits). The JAX `_ntt_xla` stage loop, batched over rows."""
    rows, c = x.shape[:2]
    for s in range(1, log2c + 1):
        mlen, half = 1 << s, 1 << (s - 1)
        tw = stage_tw[torch.arange(half, device=x.device) << (log2c - s)]
        x = x.reshape(rows, c // mlen, mlen, fp.NLIMBS)
        even, odd = x[:, :, :half], x[:, :, half:]
        t = fp.mont_mul(CTX, odd, tw)
        x = torch.cat([fp.add(CTX, even, t), fp.sub(CTX, even, t)], dim=2).reshape(rows, c, fp.NLIMBS)
    return x


@functools.lru_cache(maxsize=None)
def _bitrev(log2n: int, device: torch.device) -> torch.Tensor:
    idx = torch.arange(1 << log2n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log2n):
        rev |= ((idx >> b) & 1) << (log2n - 1 - b)
    return rev


def _addresses(spec: Pass, strides: tuple[int, int, int], device) -> torch.Tensor:
    """(rows, C) element addresses of a pass's input or output."""
    r = torch.arange(spec.rows, device=device)[:, None]
    j = torch.arange(1 << spec.log2c, device=device)[None, :]
    return (r >> spec.rlo_bits) * strides[0] + (r & ((1 << spec.rlo_bits) - 1)) * strides[1] + j * strides[2]


def _times(y: torch.Tensor, f: Factors, e: torch.Tensor) -> torch.Tensor:
    """y * f.lo[e mod 2^bits] * f.hi[e >> bits] (Montgomery)."""
    lo, hi = unpack(f.lo), unpack(f.hi)
    return fp.mont_mul(CTX, y, fp.mont_mul(CTX, lo[e & ((1 << f.bits) - 1)], hi[e >> f.bits]))


def lane_dft_plain(x: torch.Tensor, spec: Pass, packed_out: bool = False, out: torch.Tensor | None = None):
    """Plain PyTorch K6: the pass of `lane_dft` in whole-tensor ops."""
    digits = unpack(x) if x.dtype == torch.int32 else x
    src = _addresses(spec, spec.ins, x.device)
    v = digits[src]
    if spec.load is not None:
        v = _times(v, spec.load, src)
    y = dft_rows_plain(v[:, _bitrev(spec.log2c, x.device)], spec.log2c, unpack(spec.stage))
    if spec.twiddle is not None:
        r_lo = torch.arange(spec.rows, device=x.device)[:, None] & ((1 << spec.rlo_bits) - 1)
        y = _times(y, spec.twiddle, r_lo * torch.arange(1 << spec.log2c, device=x.device)[None, :])
    dst = _addresses(spec, spec.outs, x.device)
    if spec.store is not None:
        y = _times(y, spec.store, dst)
    res = torch.empty_like(digits)
    res[dst] = y
    res = pack(res) if packed_out else res
    return res if out is None else out.copy_(res)


def lane_dft(x: torch.Tensor, spec: Pass, packed_out: bool = False, out: torch.Tensor | None = None):
    """K6: one pass (see csrc/ntt.cu and `Pass`) over x, int64 (N, 16)
    digits or int32 (N, 8) packed Montgomery Fr, N = rows 2^log2c, into
    `out` (packed with packed_out; a new tensor where out is None; x itself
    where the pass's input and output addresses are the same). Returns
    out. CPU tensors take the plain version; CUDA tensors launch
    csrc/ntt.cu."""
    c = 1 << spec.log2c
    n = spec.rows * c
    for name, strides in (("input", spec.ins), ("output", spec.outs)):
        hi_rows = (spec.rows - 1) >> spec.rlo_bits
        lo_rows = min(spec.rows, 1 << spec.rlo_bits) - 1
        if hi_rows * strides[0] + lo_rows * strides[1] + (c - 1) * strides[2] >= n or min(strides) < 0:
            raise ValueError(f"lane_dft: {name} strides {strides} leave the {n} elements")
    if out is x and spec.ins != spec.outs:
        raise ValueError("lane_dft: in place only where the input and output addresses are the same")
    if not _build.on_card("lane_dft", x):
        return lane_dft_plain(x, spec, packed_out, out)
    if not 1 <= spec.log2c <= MAX_PASS_LOG:
        raise ValueError(f"lane_dft: pass length 2^{spec.log2c} outside [2, 2^{MAX_PASS_LOG}]")
    packed_in = x.dtype == torch.int32
    _build.check("lane_dft", "x", x, (n, 8 if packed_in else fp.NLIMBS), x.device, x.dtype)
    _build.check("lane_dft", "stage", spec.stage, (c // 2, 8), x.device, torch.int32)
    tables = []
    for name, f, size in (("twiddle", spec.twiddle, None), ("load", spec.load, None), ("store", spec.store, None)):
        if f is None:
            tables += [None, None, 0]
            continue
        _build.check("lane_dft", f"{name}.lo", f.lo, (1 << f.bits, 8), x.device, torch.int32)
        _build.check("lane_dft", f"{name}.hi", f.hi, (f.hi.shape[0], 8), x.device, torch.int32)
        tables += [f.lo, f.hi, f.bits]
    shape, dtype = ((n, 8), torch.int32) if packed_out else ((n, fp.NLIMBS), torch.int64)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=x.device)
    _build.check("lane_dft", "out", out, shape, x.device, dtype)
    (tw_lo, tw_hi, tw_bits), (fin_lo, fin_hi, fin_bits), (fout_lo, fout_hi, fout_bits) = \
        tables[0:3], tables[3:6], tables[6:9]
    _build.launch("p2_lane_dft", x.device, x, out, spec.stage, tw_lo, tw_hi, fin_lo, fin_hi, fout_lo, fout_hi,
                  spec.rows, spec.log2c, spec.rlo_bits, tw_bits, fin_bits, fout_bits, *spec.ins, *spec.outs,
                  int(packed_in), int(packed_out))
    LAUNCHES["lane_dft"] += 1
    return out


# ---------------------------------------------------------------------------
# coset helpers (JAX ops/ntt.py:265-296)
# ---------------------------------------------------------------------------

def distribute_powers(exp: int, coeffs: torch.Tensor, g: int) -> torch.Tensor:
    """coeffs[i] * g^i (domain.rs:176-189); g is a host int. Pointwise,
    plain torch: `coset_ntt` folds the same factors into its first pass."""
    return fp.mont_mul(CTX, coeffs, geometric(g, exp, coeffs.device))


def coset_ntt(exp: int, coeffs: torch.Tensor) -> torch.Tensor:
    """ntt(distribute_powers(coeffs, g)), the powers applied in pass 0's load."""
    return four_step(exp, coeffs, False, pre=MULT_GEN)


def z_inverse(exp: int) -> int:
    """1/(g^m - 1): z is constant on the coset (domain.rs:217-230)."""
    return pow(pow(MULT_GEN, 1 << exp, R_MOD) - 1, -1, R_MOD)


def icoset_ntt(exp: int, coeffs: torch.Tensor, divide_by_z: bool = False) -> torch.Tensor:
    """distribute_powers(ntt^-1(coeffs), geninv), the powers applied in the
    last pass's store; with divide_by_z, of divide_by_z_on_coset(coeffs),
    its constant folded into the same factors."""
    return four_step(exp, coeffs, True, post=(Domain(exp).geninv, z_inverse(exp) if divide_by_z else 1))


def divide_by_z_on_coset(exp: int, coeffs: torch.Tensor) -> torch.Tensor:
    """Multiply by 1/(g^m - 1): z is constant on the coset (domain.rs:217-230)."""
    return fp.mont_mul(CTX, coeffs, convert.ints_to_limbs([CTX.to_mont_int(z_inverse(exp))], coeffs.device)[0])


# ---------------------------------------------------------------------------
# the group NTT (JAX ops/ntt.py:133-260): N1 `group_ntt_stage`, N2
# `jac_scalar_mul` (csrc/group_ntt.cu)
# ---------------------------------------------------------------------------

def _group_field(x: torch.Tensor):
    """FQ for G1 coordinates (N, 16), FQ2 for G2 (N, 2, 16)."""
    return FQ if x.dim() == 2 else FQ2


def _select(f, mask: torch.Tensor, a: G.JacobianBatch, b: G.JacobianBatch) -> G.JacobianBatch:
    return G.JacobianBatch(*(f.select(mask, u, v) for u, v in zip(a, b)))


def jac_ladder_plain(base: G.JacobianBatch, scalars: torch.Tensor) -> G.JacobianBatch:
    """k_i B_i for Jacobian bases B (any point) and canonical scalars k
    (N, 16): the kernels' per-lane ladder (csrc/group_ntt.cu `jac_ladder`,
    the windowed ladder of K8 / K9 over a Jacobian base), limb for limb. k
    above (r - 1)/2 runs as (r - k)(-B) (`batch_exp.half_recode`); T[j] = j
    B by general adds (`jac_add_sparse`: `jac_add`'s limbs, the doubling
    only on the lanes that need it), up to the batch's largest digit; per
    4-bit window,
    most significant first, a lane that has met a nonzero digit doubles 4
    times, and a nonzero digit d adds T[d] (into infinity that returns T[d],
    the kernel's start). A lane whose scalar is 0 stays (0, 1, 0)."""
    f = _group_field(base.x)
    n, dev = scalars.shape[0], scalars.device
    k, neg = batch_exp.half_recode(scalars)
    base = base._replace(y=f.select(neg, f.neg(base.y), base.y))
    digits = batch_exp.scalar_windows_msb(k)
    first = batch_exp._first_live_window(digits)
    acc = G.jac_zero(f, (n,), dev)
    if first == digits.shape[0]:
        return acc
    entries = [acc, base]
    for _ in range(2, int(digits[first:].max()) + 1):
        entries.append(G.jac_add_sparse(f, entries[-1], base))  # step 2 doubles
    table = G.JacobianBatch(*(torch.stack(c) for c in zip(*entries)))
    started = torch.zeros(n, dtype=torch.bool, device=dev)
    for w, d in enumerate(digits[first:]):
        if w:
            dbl = acc
            for _ in range(4):
                dbl = G.jac_double(f, dbl)
            acc = _select(f, started, dbl, acc)
        live = d != 0
        acc = _select(f, live, G.jac_add_sparse(f, acc, batch_exp._gather(table, d)), acc)
        started |= live
    return acc


def _pairs(n: int, log2c: int, s: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(even, odd, twiddle index) of every pair of stage s over rows of
    2^log2c points, n points in all (csrc/group_ntt.cu group_ntt_pair)."""
    p = torch.arange(n // 2, device=device)
    row, idx = p >> (log2c - 1), p & ((1 << (log2c - 1)) - 1)
    j = idx & ((1 << (s - 1)) - 1)
    even = (row << log2c) + ((idx >> (s - 1)) << s) + j
    return even, even + (1 << (s - 1)), j << (log2c - s)


def group_ntt_stage_plain(jac: G.JacobianBatch, tw: torch.Tensor, log2c: int, s: int) -> G.JacobianBatch:
    """Plain PyTorch N1: `group_ntt_stage` in whole-tensor ops (JAX
    `_group_stage`), in place; returns jac."""
    f = _group_field(jac.x)
    even, odd, t_idx = _pairs(jac.x.shape[0], log2c, s, jac.x.device)
    a = G.take(jac, even)
    t = jac_ladder_plain(G.take(jac, odd), tw[t_idx])
    lo, hi = G.jac_add(f, a, t), G.jac_add(f, a, t._replace(y=f.neg(t.y)))
    for c, u, v in zip(jac, lo, hi):
        c[even] = u
        c[odd] = v
    return jac


def _check_points(wrapper: str, jac: G.JacobianBatch) -> tuple[int, str]:
    x = jac.x
    if x.dim() not in (2, 3) or x.shape[-1] != fp.NLIMBS or (x.dim() == 3 and x.shape[1] != 2):
        raise ValueError(f"{wrapper}: want (N, 16) or (N, 2, 16) coordinates, got {tuple(x.shape)}")
    for name, t in zip("xyz", jac):
        _build.check(wrapper, name, t, x.shape, x.device)
    return x.shape[0], "g1" if x.dim() == 2 else "g2"


def group_ntt_stage(jac: G.JacobianBatch, tw: torch.Tensor, log2c: int, s: int) -> G.JacobianBatch:
    """N1: radix-2 DIT stage s (1 <= s <= log2c) over every row of 2^log2c
    consecutive Jacobian points of jac, in place: pair (e, o) = (e, e +
    2^(s-1)) becomes (a + w b, a - w b), w = tw[j 2^(log2c - s)], j = e mod
    2^(s-1); tw: the row length's canonical twiddles, int64 (2^(log2c-1),
    16). Returns jac. CPU tensors take the plain version; CUDA tensors launch
    csrc/group_ntt.cu."""
    if not 1 <= s <= log2c:
        raise ValueError(f"group_ntt_stage: stage {s} of a 2^{log2c}-point DFT")
    if jac.x.shape[0] % (1 << log2c):
        raise ValueError(f"group_ntt_stage: {jac.x.shape[0]} points are not rows of 2^{log2c}")
    if not _build.on_card("group_ntt_stage", jac.x):
        return group_ntt_stage_plain(jac, tw, log2c, s)
    n, group = _check_points("group_ntt_stage", jac)
    _build.check("group_ntt_stage", "tw", tw, (1 << (log2c - 1), fp.NLIMBS), jac.x.device)
    _build.launch(f"p2_group_ntt_stage_{group}", jac.x.device, *jac, tw, n >> log2c, log2c, s)
    LAUNCHES["group_ntt_stage"] += 1
    return jac


def jac_scalar_mul_plain(jac: G.JacobianBatch, scalars: torch.Tensor) -> G.JacobianBatch:
    """Plain PyTorch N2: `jac_scalar_mul` in whole-tensor ops, in place."""
    out = jac_ladder_plain(jac, scalars.expand(jac.x.shape[0], -1))
    for c, v in zip(jac, out):
        c.copy_(v)
    return jac


def jac_scalar_mul(jac: G.JacobianBatch, scalars: torch.Tensor) -> G.JacobianBatch:
    """N2 (JAX `_jac_scalar_mul`): point i of jac (any Jacobian point) times
    scalars[i], canonical Fr digits int64 (N, 16), or times scalars[0] for
    every point where scalars is (1, 16); in place, returns jac. CPU
    tensors take the plain version; CUDA tensors launch csrc/group_ntt.cu."""
    n = jac.x.shape[0]
    if scalars.dim() != 2 or scalars.shape[0] not in (1, n):
        raise ValueError(f"jac_scalar_mul: {tuple(scalars.shape)} scalars for {n} points")
    if not _build.on_card("jac_scalar_mul", jac.x):
        return jac_scalar_mul_plain(jac, scalars)
    n, group = _check_points("jac_scalar_mul", jac)
    _build.check("jac_scalar_mul", "scalars", scalars, (scalars.shape[0], fp.NLIMBS), jac.x.device)
    _build.launch(f"p2_jac_scalar_mul_{group}", jac.x.device, *jac, scalars, n, int(scalars.shape[0] == n))
    LAUNCHES["jac_scalar_mul"] += 1
    return jac


def group_dft_rows(exp: int, pts: G.JacobianBatch, inverse: bool) -> G.JacobianBatch:
    """The DFT of every row of 2^exp consecutive Jacobian points of pts
    (omega, or omegainv for the inverse; no 1/m): each row's bit-reversed
    gather, then `exp` N1 launches over all the rows. A new batch in
    natural order (pts itself at exp 0)."""
    d = Domain(exp)
    if d.m == 1:
        return pts
    n, dev = pts.x.shape[0], pts.x.device
    rev = d.bitrev(dev)
    x = G.JacobianBatch(*(c.reshape(n // d.m, d.m, *c.shape[1:])[:, rev].reshape(c.shape) for c in pts))
    tw = d.twiddles_canonical(inverse, dev)
    for s in range(1, exp + 1):
        group_ntt_stage(x, tw, exp, s)
    return x


def group_ntt_staged(exp: int, pts: G.JacobianBatch, inverse: bool) -> G.JacobianBatch:
    """Group NTT over each row of 2^exp consecutive Jacobian points (JAX
    `group_ntt_staged`, one vector per row): `group_dft_rows`, then for the
    inverse every point times 1/m by one N2 launch. Natural order in and
    out; exp 0 returns pts."""
    d = Domain(exp)
    if d.m == 1:
        return pts
    x = group_dft_rows(exp, pts, inverse)
    if inverse:
        jac_scalar_mul(x, convert.ints_to_limbs([d.minv], x.x.device))
    return x


def group_ntt(exp: int, pts: G.JacobianBatch, inverse: bool) -> G.JacobianBatch:
    """JAX `group_ntt`, the same transform as one jitted program; eager
    PyTorch has no second form, so it is `group_ntt_staged`."""
    return group_ntt_staged(exp, pts, inverse)
