#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `phase2_bn254_tpu_torch` through its own entry points and fails (exit
code 1, no result line) if CUDA is missing, if the package is not beside this
script, or if any phase fails. It imports the port only (its own copy of the
ceremony protocol, `cli.phase1`, `ceremony`, `crypto`, of the exact
reference `refimpl`, and of `groth16` and `phase2.circom`), and fails if jax
or the JAX package got loaded. The
phases:

1. the card's name, power limit and SM clock; build the kernels (csrc/,
   nvcc, sm_90a);
2. the kernels' field code (csrc/fieldops.cu: the PTX product, square, sum
   and difference) against field/fp.py on 2^16 Fq and 2^16 Fr pairs, and
   against field/fq2.py on 2^16 Fq2 pairs, the edge operands first, limb for
   limb; K1 and K2 against their plain PyTorch versions on the card, at the
   contribute chunk shape (2^16 points) with the edge scalars in the first
   lanes: Jacobian limbs identical; time per call and bound; ptxas
   registers and spills;
3. the golden size-4 / batch-16 response, byte for byte;
4. a size-10 / batch-256 response byte-identical to the exact host backend;
5. new_constrained + compute_constrained at size 21, batch 2^16 (the
   reference ceremony's design depth): hash chain, spot checks of every
   element kind against refimpl, K1 / K2 launch counts, wall time by phase,
   a torch.profiler breakdown of one chunk of each group, and the
   response's blake2b;
6. K3, K4, K5 (the Pippenger MSM) and D1 (decompression) against their plain
   versions on the card at the verify chunk shape (2^16 points, c = 9), G1
   and G2, uniform and all-equal scalars, with msm_sets' hot-bucket fold
   table (the default path's gate folds the all-equal sets); time per call
   and bound; K3 at the sub-run lengths of SUBRUN_SWEEP; K3's and K4's
   launch geometry and ptxas registers and spills;
7. verify the golden size-4 pair (new challenge == the exact host
   backend's), a size-10 response (passes), and that response with one
   valid but wrong point (rejected);
8. verify_transform_constrained at size 21, batch 2^16, on phase 5's
   response: pass, hash chain, spot checks of the new challenge against
   refimpl decompression, K3-K5 / D1 launch counts (the K5 launches taking
   the fold, and the signed kernels, none), wall time by phase, and a
   torch.profiler breakdown of one chunk's power_pairs;
9. K6 (a pass of the k-pass Fr NTT) against its plain version, limb for
   limb, forward and inverse, at exp 1, 2, 3, 10, 18 and 20 on ntt's own
   pass plan and at 18 and 20 on forced three-pass plans; the prover's
   coset_ntt and icoset_ntt(divide_by_z), their factors folded into the
   passes, at exp 10, 18 and 20; at exp 24-28 a round trip and 300 outputs
   of a sparse input against a DFT on host integers (an exp the card's
   memory does not hold prints the bytes it needed); time per call, bound
   and launches; ptxas registers of K6;
10. `prove` (the port's CLI) on a seeded circom-shaped circuit of 2^18
   constraints (half booleanity constraints on random bits, half products
   of random field elements), with parameters from the port's generator:
   the proof verifies, `snarkjs_verify` of the written JSON agrees and
   rejects a changed public input; the wall time and K6 / K3-K5 launch
   counts of `prove` as a user runs it, then a second run with every part
   timed, the witness' share of 0 and 1 scalars, a torch.profiler
   breakdown of the h pipeline and its device launches, the K5 launches
   that take the default path's hot-bucket fold, and the blake2b of a proof
   with seeded r and s; K3, K4, K5 against their plain versions on the sets
   that run's MSMs took (K3 on those sets, the witness' ones and all; K4,
   K5 on the prover's own buckets and fold table);
11. scripts/fixtures' circuit and witness with fixed r and s: the proof on
   the card equals the plain versions' proof on the CPU, byte for byte;
   the witness' share of 0 and 1 scalars;
12. K9 (the G2 windowed ladder) against its plain version at 2^16 points
   with the edge scalars first, limb for limb, and S1 (the segment sums) on
   2^16 G1 and G2 terms with a third of them in one segment, empty segments
   and infinity terms, every segment in canonical affine (the kernel adds
   in another order than the plain scan); time per call, launches and
   bound, and S1 at the tiles of S1_TILE_SWEEP; K9 on 2^18 G2 terms whose
   coefficients follow the B matrix of scripts/fixtures/circuit.json (1
   and r - 1); ptxas registers of K9 and S1;
13. the phase-2 ceremony on phase 10's circuit (2^18 constraints): a radix
   file written with the port's kernels from seeded tau, alpha, beta; `new`,
   `contribute`, `beacon` (2^10) and `verify_contribution` twice through the
   port's CLI functions, each timed as a user runs it, with its K1 / K9 /
   S1 / K3-K5 launches, and the blake2b of `new`'s .params and of the
   radix file; copies with one l point or delta_g2 changed are
   rejected; `prove` on the result verifies; K9 and S1 against their plain
   versions on the sets `new` took (plain on a prefix; S1 on the segments
   that lie wholly in it), with S1's time, launches and tile sweep;
   scripts/fixtures' circuit: `new` + `contribute` on the card equal the
   plain versions' on the CPU, byte for byte (run last, after phase 15: its
   CPU half takes minutes);
14. K7 (the unsigned GLV ladder), K8 (the plain G1 ladder) and K10 (the
   unsigned GLS ladder) against their plain versions at 2^16 points with
   the edge scalars (the Babai tie among them) first: limb for limb on the
   first PLAIN_LADDER_N lanes, which the plain versions take; time per call
   and bound;
15. the ceremony's other ladder configurations end to end, selected as the
   JAX package selects them (PHASE2_TPU_NO_SIGNED5: K7 + K10;
   PHASE2_TPU_NO_GLV + PHASE2_TPU_NO_GLS: K8 + K9): compute_constrained at
   size 21 (CONFIG_SIZE), batch 2^16, from phase 5's challenge and seed,
   gives phase 5's response hash with the configuration's kernels launched
   once per chunk call and the default ones never; wall time and ladder device time (per
   launch of each); and
   `new` at 2^18 constraints under PHASE2_TPU_NO_SIGNED5 (the G1 terms on
   K7) writes phase 13's .params bytes; K7 against its plain version on the
   set `new` took (plain on its first PLAIN_SCAN_N lanes);
16. the BLS12-381 engine (`bls12_381/`): its 12-limb field code (fieldops.cu)
   against field/fp.py / fq2.py on 2^16 Fq and 2^16 Fq2 pairs, the edge
   operands first; K8-BLS and K9-BLS (the windowed ladders over BLS12-381's
   Fq and Fq2) and K7-BLS and K1-BLS (the GLV ladders over its Fq, on the
   device splits of bls12_381/device.py) against their plain versions at
   2^16 points with the edge scalars (the GLV split's among them) first,
   limb for limb on the first PLAIN_BLS_N lanes; D1-BLS (decompression)
   against its plain version on the x of 2^16 compressed points of each
   group, NONRESIDUES of them without a point (limbs and valid flags); the
   slice at 2^16 compressed G1 and 2^16 compressed G2 points (decode_batch
   with D1-BLS, then each of the group's ladders: G1 device.ladder (K8-BLS),
   glv_ladder (K7-BLS) and glv_signed_ladder (K1-BLS), G2 device.ladder
   (K9-BLS); each normalized and encoded, each part timed, the kernels'
   launches counted from zero around it), the G1 ladders' bytes equal, the
   bytes on BLS_SAMPLE lanes spread over the batch against the host chain
   (host decode, Point.mul, host encode), and tampered encodings (no
   compression flag, an infinity flag, x = q, a non-residue x) rejected;
   time per call, bound (MULS_PER_BLS_*), ptxas registers and spills;
17. the MSMs under PHASE2_TPU_MSM_SIGNED=1 (signed digits, B = 2^(c-1)
   buckets, c from pick_window_signed): K3 (signed), K4 (signed) and K5
   with the hot-bucket fold against their plain versions at 2^16 points, 2
   sets, c = 13, G1 and G2, on uniform, all-equal and ones-mix scalars (the
   gate folds the last two): K3 and K5 limb for limb (K5's plain version
   one call a group over the three mixes' sets), K4 as affine points;
   time per call, bound, plain ms, ptxas registers and spills; the signed
   MSM (prep, K3, K4, K5) timed at c = 10..16 (SIGNED_SWEEP) on 2^16 points
   and on the prover's 2^18 G1 sets, beside the unsigned default; then
   through the CLI functions: verify_transform_constrained at size 21 on
   phase 5's response (passes, its new challenge == phase 8's byte for
   byte, wall time by part), phase 7's size-10 response with a wrong point
   (rejected), `prove` on phase 10's circuit (verifies; with seeded r and s
   the proof's blake2b == phase 10's; then K3, K4 and K5 against their
   plain versions on the sets that run's MSMs took, at their own windows,
   c = 16 on G1 and 14 on G2, as in phase 10) and verify_contribution on
   phase 13's files (1->2 passes, the copy with a changed l is rejected
   with phase 13's message); each with its signed K3 / K4 launches (the
   unsigned ones none) and its K5 launches that take the fold;
18. the phase-1 -> phase-2 bridge: N1 (the group NTT's butterfly stage) and
   N2 (its Jacobian ladder) against their plain versions at 2^16 pairs /
   points, G1 and G2, with edge twiddles (0, 1, r - 1) and equal points
   first, limb for limb and in canonical affine on a prefix and on a row of
   random points (z != 1); time per call, bound (k B counted by the fewest
   of the port's ladders, as every ladder's), ptxas registers and spills;
   prepare_phase2 (the CLI function) on
   phase 5's size-21 response, every degree 0..21, as a user runs it, with
   its N1 / N2 launches and the files' bytes, then again with every part
   timed (decode, group iNTT G1 / G2 with their normalize and encode, H
   bases, their encode, the rest); the files of PREPARE_DEGREES byte-equal to write_radix's from
   phase 5's tau, alpha and beta; `new` on phase 10's circuit from the
   prepared directory (its .params blake2b); reduce_powers of phase 8's new
   challenge from 21 to 18 (the reduced_hash header, every region the
   original's prefix); verify_transcript on phase 7's size-10 pair.

K5 counts the sets and the launches that take the hot-bucket fold itself,
on the device (msm.fold_counts), read after the timed run.

Each kernel's bound is the larger of two times: the bytes of its inputs and
outputs over the card's memory rate, and its 32-bit integer multiplies over
the card's multiply rate (132 SMs x 64 per SM per clock x the SM clock
nvidia-smi reads). The multiplies are those the function needs on this
run's inputs, at the costs of the kernels' field code (MULS_PER_FQ_PRODUCT,
MULS_PER_FQ_SQUARE, MULS_PER_FQ2_PRODUCT, MULS_PER_FQ2_SQUARE,
FIELD_PRODUCTS, FIELD_SQUARES, OP_MULS; an Fr product costs what an Fq
product does), all counted in 32-bit multiplies; a G2 record also carries
its count with an Fq2 product as three Fq products (`muls_three_fq`), as
before the fused Fq2 routines. For a ladder
(k P for canonical scalars k) that is, lane by lane, the fewest that any of
the port's ladders for the same function takes on this data
(_function_muls: K1, K7, K8 on G1; K2, K10, K9 on G2; K1-BLS, K7-BLS,
K8-BLS on BLS12-381's G1, K9-BLS on its G2), each counted
from a scalar's first nonzero window with the multiples its digits use
(_k1_muls, _k2_muls, _k7_muls, _k10_muls,
_windowed_muls); this ladder's own count stands beside it
(ladder_muls). Then one add per finite term after the first of its
segment (_s1_muls), the products of an NTT other than by 1 (_ntt_muls), a mixed
add per point of a bucket after its first (_k3_muls), the adds of a
serial running sum over the weighted buckets, the fold's excluded one left
out (_k4_muls), K5's chain with the fold (_k5_muls), N1 / N2's ladder
from a Jacobian base (the port's only one; N1 with its two butterfly adds,
_jac_ladder_muls); the kernel's own count stands beside each
(kernel_muls). K5, whose time is a chain's latency,
also prints its chain in dependent products (_k5_chain).

Prints one JSON line of the kernels' results, the card's nvidia-smi line,
and last `{"ok": true, "device": {...}}`. Needs no network; starts no
process that outlives it.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # every phase runs on the card
SEED = bytes(range(64))
SMOKE_SIZE, SMOKE_BATCH = 21, 1 << 16
KERNEL_N = 1 << 16  # the contribute and verify chunk shape
MSM_WRAPPERS = ("bucket_accumulate", "bucket_reduce", "combine_windows")  # K3, K4, K5 (ops/msm.py)
# K3's sub-run lengths L timed beside the module's (phase 6)
SUBRUN_SWEEP = (16, 32, 64)
# S1's tiles (threads a block, terms a thread) timed beside the module's
# (phases 12 and 13)
S1_TILE_SWEEP = ((128, 8), (128, 4), (64, 8), (64, 4), (32, 8), (128, 16))
NONRESIDUES = 16  # D1 inputs whose x^3 + b has no square root

# Peak rates of the card the bounds are taken against
MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
MULS_PER_SM_PER_CLOCK = 64  # 32-bit integer multiply / multiply-add, compute capability 9.0 (CUDA programming guide)
# 32-bit multiplies of one Fq Montgomery product, csrc/field.cuh `mul` (CIOS
# on 8 x 32-bit limbs): 64 limb products a_j b_i and 64 reduction products
# m p_j of 32 x 32 -> 64 bits (a low and a high half each), and 8 low
# products m = t_0 p'
MULS_PER_FQ_PRODUCT = 2 * (64 + 64) + 8
# ... and of one Fq square, `sqr`: the 28 cross products a_i a_j (i < j)
# once and the 8 squares a_i^2, then the same reduction
MULS_PER_FQ_SQUARE = 2 * (36 + 64) + 8
# ... of one Fq2 product, field.cuh's fused routine (ops/_ptx.py
# ptx_mul_fq2, Karatsuba with lazy reduction): three unreduced 8 x 8-limb
# products (64 limb products each, a low and a high half), then two
# Montgomery reductions of 8 rows (8 limb products m q_j and one m each)
MULS_PER_FQ2_PRODUCT = 3 * 2 * 64 + 2 * (2 * 64 + 8)
# ... and of one Fq2 square (ptx_sqr_fq2): two unreduced products, two
# reductions
MULS_PER_FQ2_SQUARE = 2 * 2 * 64 + 2 * (2 * 64 + 8)
# products and squares (G1: Fq, G2: Fq2) per group operation of
# csrc/field.cuh: dbl-2009-l, add-2007-bl, the part of add-2007-bl before
# its P == Q test (then the doubling), madd-2007-bl
FIELD_PRODUCTS = {"dbl": 2, "add": 11, "add_head": 6, "madd": 7}
FIELD_SQUARES = {"dbl": 5, "add": 5, "add_head": 2, "madd": 4}


def _op_muls(product: int, square: int) -> dict:
    return {op: FIELD_PRODUCTS[op] * product + FIELD_SQUARES[op] * square for op in FIELD_PRODUCTS}


# ... and the same at BLS12-381 width (ops/_ptx.py on 12 x 32-bit limbs):
# 144 limb products a_j b_i and 144 reduction products m q_j (a low and a
# high half each), 12 products m; a square's 66 cross products and 12
# squares; an Fq2 product's three unreduced 12 x 12 products and two
# reductions of 12 rows, a square's two and two
MULS_PER_BLS_FQ_PRODUCT = 2 * (144 + 144) + 12  # 588
MULS_PER_BLS_FQ_SQUARE = 2 * (78 + 144) + 12  # 456
MULS_PER_BLS_FQ2_PRODUCT = 3 * 2 * 144 + 2 * (2 * 144 + 12)  # 1464
MULS_PER_BLS_FQ2_SQUARE = 2 * 2 * 144 + 2 * (2 * 144 + 12)  # 1176

# 32-bit multiplies per group operation: the unit every bound and count
# below is in
OP_MULS = {"g1": _op_muls(MULS_PER_FQ_PRODUCT, MULS_PER_FQ_SQUARE),
           "g2": _op_muls(MULS_PER_FQ2_PRODUCT, MULS_PER_FQ2_SQUARE),
           "bls_g1": _op_muls(MULS_PER_BLS_FQ_PRODUCT, MULS_PER_BLS_FQ_SQUARE),
           "bls_g2": _op_muls(MULS_PER_BLS_FQ2_PRODUCT, MULS_PER_BLS_FQ2_SQUARE)}


@contextlib.contextmanager
def _three_fq_products():
    """G2 counted as before the fused Fq2 routines: an Fq2 product as three
    Fq products (792 multiplies), a square as two (528). Inside it every
    G2 count below gives that older figure, which records carry beside the
    current one (`muls_three_fq`)."""
    global MULS_PER_FQ2_PRODUCT
    saved = MULS_PER_FQ2_PRODUCT, OP_MULS["g2"]
    MULS_PER_FQ2_PRODUCT = 3 * MULS_PER_FQ_PRODUCT
    OP_MULS["g2"] = _op_muls(MULS_PER_FQ2_PRODUCT, 2 * MULS_PER_FQ_PRODUCT)
    try:
        yield
    finally:
        MULS_PER_FQ2_PRODUCT, OP_MULS["g2"] = saved


def _three_fq(fn, *args) -> int:
    """fn(*args) (a G2 multiply count) at the costs of `_three_fq_products`."""
    with _three_fq_products():
        return int(fn(*args))


def _three_fq_fields(card, nbytes_: int, muls: int) -> dict:
    """A G2 record's count and bound at the costs of `_three_fq_products`."""
    return {"muls_three_fq": muls, "bound_ms_three_fq": card.bound(nbytes_, muls)[0]}


# dependent Fq products of a group operation on one thread, and in the
# levels of independent products K5's warp runs one product a lane
CHAIN_PRODUCTS = {"g1": {"dbl": 7, "add": 16}, "g2": {"dbl": 16, "add": 43}}
CHAIN_LEVELS = {"dbl": 3, "add": 5}


def log(msg: str) -> None:
    print(msg, flush=True)


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Card:
    """The card's nvidia-smi line and its peak rates."""

    def __init__(self):
        import torch

        self.line = _smi("name,power.limit")
        self.sm_mhz = float(_smi("clocks.max.sm").split()[0])
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.muls_per_s = self.sms * MULS_PER_SM_PER_CLOCK * self.sm_mhz * 1e6

    def bound(self, nbytes: int, muls: int) -> tuple[float, str]:
        """(least ms, what bounds it) for moving nbytes and doing muls 32-bit
        multiplies."""
        t_bytes = nbytes / MEM_BYTES_PER_S
        t_ops = muls / self.muls_per_s
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cuda_ms(fn, reps: int) -> float:
    """ms per call of fn on the current stream, after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """ms per call of fn's device work alone, after one warm-up call: a spin
    kernel (torch.cuda._sleep) holds the stream while the host enqueues all
    reps, so the CUDA events around them see the kernels back to back and
    none of the host's time between launches, which at small sizes is
    longer than the kernels' (torch.profiler, tried for this first, came back
    empty in some processes)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms at 1980 MHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """(result, ms) of one call, CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def record(card: Card, name: str, source: str, replaces: str, err: int, ms: float, plain_ms: float,
           work: tuple[int, int], **extra) -> dict:
    bound_ms, bound_by = card.bound(*work)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, **extra}


def max_limb_err(got, want) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_build(card: Card) -> None:
    from phase2_bn254_tpu_torch.ops import _build

    log(f"phase 1 card: {card.line}; {card.sms} SMs, max SM clock {card.sm_mhz:.0f} MHz: "
        f"{card.muls_per_s / 1e12:.3f} T 32-bit multiplies/s, {MEM_BYTES_PER_S / 1e12:.2f} TB/s")
    t0 = time.time()
    path = _build.build()
    _build.load()
    log(f"phase 1 build: {os.path.relpath(path, REPO)} in {time.time() - t0:.1f} s")
    with open(os.path.join(_build.BUILD_DIR, f"ptxas_{_build._source_hash()}.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas: " + line.strip())


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _tiled_points(group: str, n: int, device, rng: random.Random, distinct: int = 256):
    """n points, `distinct` random multiples m_j G tiled (point i is m_{i %
    distinct} G); returns (AffineBatch, [m_j])."""
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.refimpl import curve as rc
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    logs = [rng.randrange(1, R_MOD) for _ in range(distinct)]
    base = convert.points_to_affine([gen.mul(m) for m in logs], group, device)
    reps = -(-n // distinct)
    tile = [t.repeat((reps,) + (1,) * (t.dim() - 1))[:n].contiguous() for t in base]
    return type(base)(*tile), logs


def _edge_scalars(n: int, rng: random.Random) -> list[int]:
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD
    from phase2_bn254_tpu_torch.refimpl.glv import LAMBDA

    edge = [1, 2, R_MOD - 1, R_MOD // 2, (R_MOD - 1) // 2, LAMBDA, R_MOD - LAMBDA, (1 << 128) - 1, 1 << 253,
            (1 << 252) + 1, 0]
    return edge + [rng.randrange(R_MOD) for _ in range(n - len(edge))]


def _ladder_doublings(nonzero, bits: int):
    """Doublings (N,) a windowed ladder needs over windows nonzero (W, N),
    most significant first: `bits` for each window below a point's first
    nonzero one (a point without one needs none)."""
    first = nonzero.int().argmax(0)
    return bits * (nonzero.shape[0] - 1 - first) * nonzero.any(0)


def _table_muls(ops: dict, top, mixed: bool = False):
    """Multiplies (N,) of the multiples jP, j = 2..top (N,), the largest
    digit magnitude each point uses: 2P through the add's doubling branch,
    then one add each; `mixed` (K1's table): 2P by a doubling, then one
    mixed add of the affine P each."""
    more = (top - 1).clamp(min=0)
    if mixed:
        return (more > 0) * ops["dbl"] + (more - 1).clamp(min=0) * ops["madd"]
    return (more > 0) * (ops["add_head"] + ops["dbl"]) + (more - 1).clamp(min=0) * ops["add"]


def _fq_product(group: str) -> int:
    """Multiplies of one Fq product of a G1 key ("g1": BN254, "bls_g1")."""
    return MULS_PER_BLS_FQ_PRODUCT if group.startswith("bls_") else MULS_PER_FQ_PRODUCT


def _k1_muls(d1, d2, group: str = "g1"):
    """Multiplies (N,) k P takes on these GLV digits (signed base 32, MSB
    first) by K1's ladder (K1-BLS's with group "bls_g1"), as far as this
    data needs it: the multiples up to each point's largest digit magnitude
    by a doubling and mixed adds (with their beta x where d2 has a nonzero
    digit), 5 doublings per window after the first nonzero one, one add per
    nonzero digit after the first."""
    ops = OP_MULS[group]
    nz1, nz2 = d1 != 0, d2 != 0
    top = d1.abs().amax(0).maximum(d2.abs().amax(0))
    adds = (nz1.sum(0) + nz2.sum(0) - 1).clamp(min=0)
    return (_table_muls(ops, top, mixed=True) + top * nz2.any(0) * _fq_product(group)
            + _ladder_doublings(nz1 | nz2, 5) * ops["dbl"] + adds * ops["add"])


def _k1_kernel_muls(d1, d2, group: str = "g1") -> int:
    """Multiplies K1 (csrc/batch_exp_g1.cu; K1-BLS with group "bls_g1")
    does on these digits: the table (16 beta x, 2P by a doubling, 3P..16P by
    mixed adds), 5 doublings per window after each point's first nonzero
    one, and one add per nonzero digit after the first (an add into infinity
    or of infinity costs none)."""
    ops = OP_MULS[group]
    n = d1.shape[1]
    nz1, nz2 = d1 != 0, d2 != 0
    table = 16 * _fq_product(group) + ops["dbl"] + 14 * ops["madd"]
    adds = int((nz1.sum(0) + nz2.sum(0) - 1).clamp(min=0).sum())
    return n * table + int(_ladder_doublings(nz1 | nz2, 5).sum()) * ops["dbl"] + adds * ops["add"]


def _psi_muls(nz):
    """Multiplies of psi, psi^2, psi^3 (2 Fq2 products, 4 Fq products, 2
    Fq2 products; ladders.cuh psi_pow) for the digits of parts 1, 2, 3
    where nz (4, W, N) holds, summed per point."""
    return ((2 * nz[1].sum(0) + 2 * nz[3].sum(0)) * MULS_PER_FQ2_PRODUCT
            + 4 * nz[2].sum(0) * MULS_PER_FQ_PRODUCT)


def _psi_window_muls() -> int:
    """... of psi, psi^2, psi^3 of one window's gathered entries."""
    return 4 * MULS_PER_FQ2_PRODUCT + 4 * MULS_PER_FQ_PRODUCT


def _k2_muls(digits):
    """Multiplies (N,) k Q takes on these GLS digits (4, W, N) by K2's
    ladder, as far as this data needs it: the multiples up to each point's
    largest digit magnitude by a doubling and mixed adds, psi, psi^2, psi^3
    of each nonzero digit of parts 1, 2, 3, 5 doublings per window after
    the first nonzero one, one add per nonzero digit after the first."""
    ops = OP_MULS["g2"]
    nz = digits != 0
    adds = (nz.sum((0, 1)) - 1).clamp(min=0)
    return (_table_muls(ops, digits.abs().amax((0, 1)), mixed=True) + _psi_muls(nz)
            + _ladder_doublings(nz.any(0), 5) * ops["dbl"] + adds * ops["add"])


def _k2_kernel_muls(digits) -> int:
    """Multiplies K2 (csrc/batch_exp_g2.cu) does: the table (2Q by a
    doubling, 3Q..16Q by mixed adds); from each point's first window with a
    nonzero digit (the last if it has none) psi, psi^2, psi^3 of the
    gathered entries in every window, 5 doublings in each after that first;
    one add per nonzero digit after the first."""
    import torch

    ops = OP_MULS["g2"]
    _, nw, n = digits.shape
    live = (digits != 0).any(0)
    first = torch.where(live.any(0), live.int().argmax(0), nw - 1)
    windows = int((nw - first).sum())
    table = ops["dbl"] + 14 * ops["madd"]
    adds = int(((digits != 0).sum((0, 1)) - 1).clamp(min=0).sum())
    return n * table + windows * _psi_window_muls() + (windows - n) * 5 * ops["dbl"] + adds * ops["add"]


def _function_muls(group: str, scalars) -> int:
    """Multiplies k P needs on `group` for these canonical scalars (N, 16):
    lane by lane the fewest that any of the port's ladders for that function
    takes on this data (G1: K1 on the signed GLV split, K7 on the unsigned
    one, K8 on the scalar; G2: K2, K10, K9; "bls_g1": K1-BLS, K7-BLS,
    K8-BLS at BLS12-381's costs on its splits; "bls_g2": K9-BLS). Every
    ladder's bound counts these, whichever ladder it is."""
    import torch
    from phase2_bn254_tpu_torch.bls12_381 import device as bls
    from phase2_bn254_tpu_torch.ops import gls, glv

    if group == "g1":
        counts = [_k1_muls(*glv.decompose_signed(scalars)), _k7_muls(*glv.decompose(scalars))]
    elif group == "bls_g1":
        counts = [_k1_muls(*bls.decompose_glv_signed_t(scalars), group),
                  _k7_muls(*bls.decompose_glv_t(scalars), group)]
    elif group == "bls_g2":
        counts = []
    else:
        counts = [_k2_muls(gls.decompose_signed(scalars)), _k10_muls(*gls.decompose(scalars))]
    return int(torch.stack(counts + [_windowed_muls(group, scalars)]).amin(0).sum())


def phase_kernels(card: Card, n: int = KERNEL_N) -> list[dict]:
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.ops import batch_exp, gls, glv

    dev = torch.device(DEVICE)
    rng = random.Random(2024)
    cases = [
        ("batch_exp_glv_signed", "g1", FQ, batch_exp.batch_exp_glv_signed, batch_exp.batch_exp_glv_signed_plain,
         lambda k: glv.decompose_signed(k), _k1_muls, _k1_kernel_muls,
         "phase2_bn254_tpu_torch/csrc/batch_exp_g1.cu",
         "phase2_bn254_tpu/ops/pallas_exp.py:728"),
        ("batch_exp_gls_signed", "g2", FQ2, batch_exp.batch_exp_gls_signed, batch_exp.batch_exp_gls_signed_plain,
         lambda k: (gls.decompose_signed(k),), _k2_muls, _k2_kernel_muls,
         "phase2_bn254_tpu_torch/csrc/batch_exp_g2.cu",
         "phase2_bn254_tpu/ops/pallas_exp.py:1073"),
    ]
    records = []
    for name, group, f, kernel, plain, split, muls, kernel_muls, source, replaces in cases:
        pts, _ = _tiled_points(group, n, dev, rng)
        x, y = pts.x, pts.y
        k = convert.ints_to_limbs(_edge_scalars(n, rng), dev)
        digits = split(k)
        got = kernel(x, y, *digits)
        want, plain_ms = once_ms(lambda: plain(x, y, *digits))
        same_jac = all(torch.equal(a, b) for a, b in zip(got, want))
        ga, wa = G.jac_normalize(f, got), G.jac_normalize(f, want)
        err = max_limb_err(ga[:2], wa[:2])
        if err != 0 or not torch.equal(ga.inf, wa.inf) or not same_jac:
            raise AssertionError(f"{name}: kernel and plain version differ (max abs limb error {err} after "
                                 f"normalizing; Jacobian limbs identical: {same_jac})")
        ms = cuda_ms(lambda: kernel(x, y, *digits), 5)
        need, own, does = _function_muls(group, k), int(muls(*digits).sum()), kernel_muls(*digits)
        work = (nbytes(x, y, *digits, *got), need)
        extra = _three_fq_fields(card, work[0], _three_fq(_function_muls, group, k)) if group == "g2" else {}
        rec = record(card, name, source, replaces, err, ms, plain_ms, work,
                     muls=need, ladder_muls=own, kernel_muls=does, **extra)
        log(f"phase 2 {name}: N={n} kernel == plain limb for limb (Jacobian, {int(ga.inf.sum())} at infinity); "
            f"kernel {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call, "
            f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}: {need / n:.0f} multiplies/point; this ladder "
            f"needs {own / n:.0f}, the kernel does {does / n:.0f})"
            + (f"; at three Fq products an Fq2 product: bound {extra['bound_ms_three_fq']:.3f} ms, "
               f"{extra['muls_three_fq'] / n:.0f} multiplies/point" if extra else ""))
        records.append(rec)
    for line in _ptxas_of(("batch_exp_glv_signed_kernel", "batch_exp_gls_signed_kernel")):
        log(f"  ptxas: {line}")
    return records


FIELD_N = 1 << 16  # the pairs of each field phase 2 holds the field code on


def phase_field() -> None:
    """Phase 2, first: the kernels' field code (csrc/fieldops.cu, the PTX of
    field_ptx.cuh) against field/fp.py (Fq2: field/fq2.py) on the card,
    FIELD_N pairs of Fq, of Fr and of Fq2 with ops.fieldops.edge_pairs /
    edge_pairs_fq2 first: a b, a^2, a + b, a - b limb for limb."""
    from phase2_bn254_tpu_torch.ops import fieldops

    rng = random.Random(2)
    for field in ("fq", "fr", "fq2"):
        pairs = fieldops.edge_pairs_fq2(rng) if field == "fq2" else fieldops.edge_pairs(field, rng)
        edge = len(pairs)
        pairs += [(fieldops.random_element(field, rng), fieldops.random_element(field, rng))
                  for _ in range(FIELD_N - edge)]
        a, b = (fieldops.to_limbs([pair[k] for pair in pairs], field, DEVICE) for k in (0, 1))
        got = fieldops.field_ops(a, b, field)
        err = max_limb_err(got, fieldops.field_ops_plain(a, b, field))
        if err:
            raise AssertionError(f"field code {field}: the kernel and its plain version differ (max abs limb error "
                                 f"{err})")
        ms = cuda_ms(lambda: fieldops.field_ops(a, b, field), 5)
        log(f"phase 2 field {field}: {FIELD_N} pairs ({edge} edge pairs first): a b, a^2, a + b, a - b == "
            f"field/{'fq2' if field == 'fq2' else 'fp'}.py limb for limb; {ms:.4f} ms a launch")
    for line in _ptxas_of(("field_ops_kernel",)):
        log(f"  ptxas: {line}")


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def _challenge(workdir: str, size: int, batch: int) -> str:
    from phase2_bn254_tpu_torch.cli.phase1 import new_constrained

    path = os.path.join(workdir, f"challenge_{size}")
    if not os.path.exists(path):
        new_constrained(path, size, batch)
    return path


def _torch_response(workdir: str, size: int, batch: int) -> str:
    """compute_constrained on the card with the fixed ChaCha seed; returns
    the response path."""
    from phase2_bn254_tpu_torch.cli.phase1 import compute_constrained
    from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng

    response = os.path.join(workdir, f"response_{size}")
    compute_constrained(_challenge(workdir, size, batch), response, size, batch, ChaChaRng.from_digest_be(SEED), DEVICE)
    return response


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def phase_golden(workdir: str) -> None:
    got = _read(_torch_response(workdir, 4, 16))
    if got != _read(os.path.join(REPO, "tests", "fixtures", "golden_response_s4_b16.bin")):
        raise AssertionError("size-4 response differs from tests/fixtures/golden_response_s4_b16.bin")
    log(f"phase 3 golden: size 4 batch 16 response == fixture ({len(got)} bytes, "
        f"blake2b {hashlib.blake2b(got).hexdigest()[:16]})")


def phase_parity(workdir: str) -> None:
    from phase2_bn254_tpu_torch.cli.phase1 import contribute
    from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
    from phase2_bn254_tpu_torch.refimpl.backend import ExactBackend

    t0 = time.time()
    got = _read(_torch_response(workdir, 10, 256))
    t1 = time.time()
    response = os.path.join(workdir, "response_10_exact")
    contribute(_challenge(workdir, 10, 256), response, 10, 256, ChaChaRng.from_digest_be(SEED), backend=ExactBackend())
    if got != _read(response):
        raise AssertionError("size-10 response differs from the exact host backend's")
    log(f"phase 4 parity: size 10 batch 256 response == ExactBackend ({len(got)} bytes; "
        f"torch {t1 - t0:.1f} s, exact {time.time() - t1:.1f} s)")


# ---------------------------------------------------------------------------
# phases 5 and 8: the paths, timed
# ---------------------------------------------------------------------------

class _Timers:
    """Wall time by phase of one run of a path (wrapped functions, host
    clock) and device time of the wrapped kernels (CUDA events)."""

    def __init__(self):
        self.wall: dict[str, float] = {}
        self.events: dict[str, list] = {}
        self._undo = []

    def wall_of(self, key: str, owner, attr: str, sync: bool = False, sync_start: bool = False) -> None:
        """Add the wall time of owner.attr's calls to wall[key]; with sync,
        up to the end of the device work they queued; with sync_start, from
        the end of the device work queued before them."""
        import torch

        fn = getattr(owner, attr)
        self.wall.setdefault(key, 0.0)

        def inner(*a, **k):
            if sync_start:
                torch.cuda.synchronize()
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                if sync:
                    torch.cuda.synchronize()
                self.wall[key] += time.time() - t0

        setattr(owner, attr, inner)
        self._undo.append((owner, attr, fn))

    def keep(self, key: str, owner, attr: str, into: dict) -> None:
        """Keep the last result of owner.attr in into[key]."""
        fn = getattr(owner, attr)

        def inner(*a, **k):
            into[key] = fn(*a, **k)
            return into[key]

        setattr(owner, attr, inner)
        self._undo.append((owner, attr, fn))

    def args_of(self, key: str, owner, attr: str, into: dict) -> None:
        """Append the positional arguments of owner.attr's calls to
        into[key]."""
        fn = getattr(owner, attr)

        def inner(*a, **k):
            into.setdefault(key, []).append(a)
            return fn(*a, **k)

        setattr(owner, attr, inner)
        self._undo.append((owner, attr, fn))

    def device_of(self, key: str, owner, attr: str) -> None:
        import torch

        fn = getattr(owner, attr)
        self.events.setdefault(key, [])

        def inner(*a, **k):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            self.events[key].append((s, e))
            return out

        setattr(owner, attr, inner)
        self._undo.append((owner, attr, fn))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)

    def device_s(self, key: str) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events[key]) / 1000.0


def _spot_indices(params, rng: random.Random):
    """>= 64 indices of every element kind, chunk edges included:
    (kind, indices)."""
    b = params.batch_size
    for kind, lo, hi in (("tau_g1", 0, params.powers_length), ("tau_g1", params.powers_length, params.powers_g1_length),
                         ("tau_g2", 0, params.powers_length), ("alpha_g1", 0, params.powers_length),
                         ("beta_g1", 0, params.powers_length)):
        edges = {lo, lo + 1, hi - 1}
        for s in range(lo, hi, b):
            edges.update({s, s + b - 1})
        idx = sorted(i for i in edges if lo <= i < hi)
        idx = sorted(set(idx[:48] + idx[-8:] + rng.sample(range(lo, hi), min(64, hi - lo))))
        if len(idx) < 64:
            raise AssertionError(f"{kind}: only {len(idx)} indices to check")
        yield kind, idx


def _spot_check(response: str, params, key, rng: random.Random) -> int:
    """Every element kind of the response against G * coeff * tau^i."""
    from phase2_bn254_tpu_torch.refimpl import curve as rc
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    coeffs = {"tau_g1": 1, "tau_g2": 1, "alpha_g1": key.alpha, "beta_g1": key.beta}
    checked = 0
    with open(response, "rb") as f:
        for kind, idx in _spot_indices(params, rng):
            group = "g2" if kind == "tau_g2" else "g1"
            gen = rc.G2_GEN if group == "g2" else rc.G1_GEN
            esize = params.element_size(kind, True)
            for i in idx:
                f.seek(params.position(kind, i, True))
                got = rc.point_from_bytes(f.read(esize), group, True, check=False)
                if got != gen.mul(coeffs[kind] * pow(key.tau, i, R_MOD) % R_MOD):
                    raise AssertionError(f"{kind}[{i}] differs from G * coeff * tau^{i}")
                checked += 1
    return checked


def phase_contribute(workdir: str, records: list[dict], size: int = SMOKE_SIZE, batch: int = SMOKE_BATCH) -> bytes:
    """Phase 5; returns the response hash."""
    import torch
    from phase2_bn254_tpu_torch.ceremony.keypair import keypair
    from phase2_bn254_tpu_torch.ceremony.params import HASH_SIZE, CeremonyParams
    from phase2_bn254_tpu_torch.cli import phase1
    from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
    from phase2_bn254_tpu_torch.crypto.hashing import calculate_hash
    from phase2_bn254_tpu_torch.ops import batch_exp
    from phase2_bn254_tpu_torch.ops.backend import TorchBackend

    params = CeremonyParams(size, batch)
    response = os.path.join(workdir, f"response_{size}")
    t0 = time.time()
    challenge = _challenge(workdir, size, batch)
    t_new = time.time() - t0

    timers = _Timers()
    for name in ("decode", "pow_mul", "encode"):
        timers.wall_of(name, TorchBackend, name)
    timers.wall_of("hashing", phase1, "calculate_hash")
    for name in batch_exp.LAUNCHES:
        timers.device_of("ladders", batch_exp, name)
        batch_exp.LAUNCHES[name] = 0
    try:
        t0 = time.time()
        response_hash = phase1.compute_constrained(challenge, response, size, batch, ChaChaRng.from_digest_be(SEED),
                                                   DEVICE)
        torch.cuda.synchronize()
        total = time.time() - t0
    finally:
        timers.restore()
    launches = dict(batch_exp.LAUNCHES)

    want = _chunk_launches(params, "batch_exp_glv_signed", "batch_exp_gls_signed")
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want} (one per chunk call)")
    for r in records:
        if r["name"] in launches:
            r["launches"] = launches[r["name"]]

    challenge_hash = calculate_hash(challenge)
    if calculate_hash(response) != response_hash:
        raise AssertionError("the response file's hash differs from the one compute_constrained returned")
    with open(response, "rb") as f:
        if f.read(HASH_SIZE) != challenge_hash:
            raise AssertionError("hash chain: the response does not start with the challenge hash")
    if os.path.getsize(response) != params.contribution_size:
        raise AssertionError("response has the wrong size")
    _, key = keypair(ChaChaRng.from_digest_be(SEED), challenge_hash)
    t0 = time.time()
    checked = _spot_check(response, params, key, random.Random(7))
    t_check = time.time() - t0

    w = timers.wall
    other = total - sum(w.values())
    log(f"phase 5 contribute: size {size} batch {batch}: {params.powers_g1_length} tau_g1 + 2x{params.powers_length} "
        f"alpha/beta_g1 G1 and {params.powers_length} tau_g2 G2 points; K1 launches {launches['batch_exp_glv_signed']}, "
        f"K2 launches {launches['batch_exp_gls_signed']} (== chunk calls)")
    log(f"  wall s: total {total:.3f} | decode {w['decode']:.3f} | pow_mul enqueue (glue: tau powers, split, "
        f"normalize start; ladder launch) {w['pow_mul']:.3f} | encode (wait for the device, normalize finish, codec, "
        f"bytes) {w['encode']:.3f} | hashing (challenge + response) {w['hashing']:.3f} | "
        f"other (keypair, file I/O) {other:.3f}")
    log(f"  device s: K1 + K2 kernels {timers.device_s('ladders'):.3f} (CUDA events); new_constrained {t_new:.3f} s")
    log(f"  hash chain ok; {checked} spot checks == refimpl ({t_check:.1f} s); response blake2b "
        f"{hashlib.blake2b(_read(response)).hexdigest()[:16]} (the file's)")
    for group in ("g1", "g2"):
        _profile_contribute_chunk(group, batch)
    return response_hash


def _chunk_launches(params, g1: str, g2: str) -> dict:
    """The ladder launches of one contribution: one per chunk call of the
    G1 wrapper g1 (tau_g1 in both sections, alpha_g1 and beta_g1 in the low
    one) and of the G2 wrapper g2 (tau_g2), none of the others."""
    from phase2_bn254_tpu_torch.ops import batch_exp

    low = len(list(params.chunks("low")))
    high = len(list(params.chunks("high")))
    return {**dict.fromkeys(batch_exp.LAUNCHES, 0), g1: 3 * low + high, g2: low}


def _profile(fn, kinds, counts_out: dict | None = None) -> str:
    """Run fn under torch.profiler; device time by kind (the first kind
    whose key is in a kernel's name; "copies" for copies and sets, "glue
    kernels" for the rest) and the device's idle share between the first
    and the last device activity; the launches of each kind go into
    counts_out where given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        raise AssertionError("torch.profiler recorded no device activity")
    sums = {k: 0.0 for k in (*kinds, "glue kernels", "copies")}
    counts = dict.fromkeys(sums, 0)
    for start, end, name in spans:
        kind = next((k for k, keys in kinds.items() if any(s in name for s in keys)), None)
        kind = kind or ("copies" if "Memcpy" in name or "Memset" in name else "glue kernels")
        sums[kind] += end - start
        counts[kind] += 1
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, _ in sorted(spans):
        if cur_end is None or start > cur_end:
            busy += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(e for _, e, _ in spans) - min(s for s, _, _ in spans)
    if counts_out is not None:
        counts_out.update(counts)
    parts = ", ".join(f"{k} {v / 1000:.3f} ms ({counts[k]})" for k, v in sums.items())
    return (f"host wall {wall * 1000:.3f} ms; device {parts}; "
            f"idle {100 * (1 - busy / window):.1f}% of the {window / 1000:.3f} ms device window")


def _profile_contribute_chunk(group: str, n: int) -> None:
    """One chunk's pow_mul + encode."""
    from phase2_bn254_tpu_torch.ops.backend import TorchBackend
    from phase2_bn254_tpu_torch.refimpl import curve as rc

    be = TorchBackend(DEVICE)
    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    ps = be.decode(rc.point_to_bytes(gen, False) * n, group, n, False, False)
    be.encode(be.pow_mul(ps, 5, 0, None), True)  # warm-up
    out = _profile(lambda: be.encode(be.pow_mul(ps, 7, 1 << 20, 3), True), {"ladder": ("batch_exp",)})
    log(f"  profile {group} chunk of {n}: {out}")


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

def _k3_muls(group: str, prep, nsets: int) -> int:
    """Multiplies of the function K3 computes: one mixed add per point of a
    bucket after its first (the first lands on infinity); the inputs hold no
    point at infinity."""
    return nsets * int((prep.counts - 1).clamp(min=0).sum()) * OP_MULS[group]["madd"]


def _k3_kernel_muls(group: str, prep, nsets: int) -> int:
    """Multiplies K3 does: a mixed add per point of a sub-run after its
    first, and a tree add per sub-run of a bucket after its first."""
    from phase2_bn254_tpu_torch.ops import msm as M

    nsub = (prep.counts + M.SUBRUN - 1) // M.SUBRUN
    ops = OP_MULS[group]
    madds, adds = int((prep.counts - nsub).sum()), int((nsub - 1).clamp(min=0).sum())
    return nsets * (madds * ops["madd"] + adds * ops["add"])


def _k4_lanes(group: str, buckets, exclude=None):
    """Finiteness of each bucket (S, nwin, B), the lane that K4 leaves out
    (the fold's, -1 none) counted as infinity."""
    import torch
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2

    fin = ~(FQ if group == "g1" else FQ2).is_zero(buckets.z)
    if exclude is not None:
        fin &= torch.arange(fin.shape[-1], device=fin.device) != exclude[..., None]
    return fin


def _k4_muls(group: str, buckets, signed: bool = False, exclude=None) -> int:
    """Multiplies of the function K4 computes, as a serial running sum over
    the weighted lanes does it (B - 1 .. 1; signed, B - 1 .. 0: a lane's
    weight is one more, which the running sum's add at lane 0 pays): an add
    per finite bucket after the first, and an add into the total at each
    lane where the running sum is finite, after the first."""
    finite = _k4_lanes(group, buckets, exclude)
    if not signed:
        finite = finite[..., 1:]
    running = finite.flip(-1).cumsum(-1).flip(-1) > 0
    adds = (finite.sum(-1) - 1).clamp(min=0) + (running.sum(-1) - 1).clamp(min=0)
    return int(adds.sum()) * OP_MULS[group]["add"]


def _k4_kernel_muls(group: str, buckets, signed: bool = False, exclude=None) -> int:
    """Multiplies K4 does (csrc/msm.cu's schedule, followed on finiteness
    flags): an add of two finite points costs a full add (a sum that
    cancels is taken as finite), an add with infinity nothing, and the
    log2(B / T) doublings of every thread but the first their full cost."""
    import torch
    from phase2_bn254_tpu_torch.ops import msm as M

    rows, b = buckets.z.shape[0] * buckets.z.shape[1], buckets.z.shape[2]
    nt = M.reduce_threads(b)
    m = b // nt
    fin = _k4_lanes(group, buckets, exclude).reshape(rows, nt, m)
    adds = 0
    run = torch.zeros((rows, nt), dtype=torch.bool, device=fin.device)
    wsum = torch.zeros_like(run)
    for i in range(m - 1, 0, -1):
        adds += int((run & fin[..., i]).sum())
        run |= fin[..., i]
        adds += int((wsum & run).sum())
        wsum |= run
    adds += int((run & fin[..., 0]).sum())
    run |= fin[..., 0]
    k = 1
    while k < nt:
        up = torch.zeros_like(run)
        up[:, : nt - k] = run[:, k:]
        adds += int((run & up).sum())
        run = run | up
        k *= 2
    if not signed:
        run[:, 0] = False
    adds += int((wsum & run).sum())
    terms = wsum | run
    stride = nt // 2
    while stride >= 1:
        adds += int((terms[:, :stride] & terms[:, stride : 2 * stride]).sum())
        terms[:, :stride] |= terms[:, stride : 2 * stride]
        stride //= 2
    ops = OP_MULS[group]
    return adds * ops["add"] + rows * (nt - 1) * (m.bit_length() - 1) * ops["dbl"]


def _k5_walk(group: str, sums, c: int, buckets=None, hot=None):
    """K5's chain on finiteness flags, per set (lists of S): its doublings
    (one a step of c per window from the first finite add on) and its adds
    after the first (of T_w where finite, of the fold's H_w where finite
    and its bit of e_w set); a sum that cancels is taken as finite."""
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.ops import msm as M

    f = FQ if group == "g1" else FQ2
    fin_t = (~f.is_zero(sums.z)).tolist()
    fin_h = None if hot is None else (~f.is_zero(M._hot_sums(buckets, hot).z)).tolist()
    weights = None if hot is None else hot.weight.tolist()
    dbls, adds = [], []
    for s, row in enumerate(fin_t):
        started, d, a = False, 0, 0
        for w in range(len(row) - 1, -1, -1):
            for i in range(c - 1, -1, -1):
                d += started
                if fin_h is not None and fin_h[s][w] and (weights[s][w] >> i) & 1:
                    a += started
                    started = True
            if row[w]:
                a += started
                started = True
        dbls.append(d)
        adds.append(a)
    return dbls, adds


def _k5_muls(group: str, sums, c: int, buckets=None, hot=None) -> int:
    """Multiplies of the function K5 computes (and does): the doublings and
    adds of its chain, with the fold where hot is given (_k5_walk)."""
    dbls, adds = _k5_walk(group, sums, c, buckets, hot)
    ops = OP_MULS[group]
    return sum(dbls) * ops["dbl"] + sum(adds) * ops["add"]


def _k5_chain(group: str, sums, c: int, buckets=None, hot=None) -> dict:
    """K5's critical path in dependent Fq products, the longest set's: the
    one-thread chain from infinity over every window (c nwin doublings and
    the chain's adds; the design before the warp form), the one-thread
    chain from its first finite term, and the warp form's levels (3 a
    doubling, 5 an add, one product's latency each: K5's floor at this
    design)."""
    dbls, adds = _k5_walk(group, sums, c, buckets, hot)
    nwin = sums.z.shape[1]
    prods = CHAIN_PRODUCTS[group]
    return {"from_infinity": max(c * nwin * prods["dbl"] + a * prods["add"] for a in adds),
            "one_thread": max(d * prods["dbl"] + a * prods["add"] for d, a in zip(dbls, adds)),
            "warp_levels": max(d * CHAIN_LEVELS["dbl"] + a * CHAIN_LEVELS["add"] for d, a in zip(dbls, adds))}


def _d1_muls(group: str, n: int) -> int:
    """Multiplies of D1 (csrc/decompress.cu; D1-BLS with group "bls_g1" /
    "bls_g2", BLS12-381's q and 12-limb costs), square-and-multiply from the
    top bit of each public exponent; G2 counts the usual branch (alpha !=
    -1) in Fq2 products and squares, and its conversions in Fq products."""
    if group.startswith("bls_"):
        from phase2_bn254_tpu_torch.bls12_381.field import Q

        prod, sq = MULS_PER_BLS_FQ_PRODUCT, MULS_PER_BLS_FQ_SQUARE
        p2, s2 = MULS_PER_BLS_FQ2_PRODUCT, MULS_PER_BLS_FQ2_SQUARE
    else:
        from phase2_bn254_tpu_torch.refimpl.field import Q

        prod, sq = MULS_PER_FQ_PRODUCT, MULS_PER_FQ_SQUARE
        p2, s2 = MULS_PER_FQ2_PRODUCT, MULS_PER_FQ2_SQUARE

    def pow_cost(e, sqr, mul):
        return (e.bit_length() - 1) * sqr + (bin(e).count("1") - 1) * mul

    if group.endswith("g1"):  # to Montgomery, x^2 and x^3, the root, two from-Montgomery, y^2 == rhs
        per = prod + (sq + prod) + pow_cost((Q + 1) // 4, sq, prod) + 2 * prod + sq
    else:  # to Montgomery, v, a1, alpha, a0, a1 v, (1 + alpha)^((q-1)/2), its product, four from-Montgomery, y^2
        per = (2 * prod + (s2 + p2) + pow_cost((Q - 3) // 4, s2, p2) + (s2 + p2) + p2 + p2
               + pow_cost((Q - 1) // 2, s2, p2) + p2 + 4 * prod + s2)
    return n * per


def _msm_reference(group: str, logs: list[int], scalars: list[int], shift: int, n: int):
    """sum_i k_i P_(i + shift) for the tiled points P_i = m_(i % 256) G."""
    from phase2_bn254_tpu_torch.refimpl import curve as rc
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    d = len(logs)
    return gen.mul(sum(k * logs[(i + shift) % d] for i, k in enumerate(scalars[:n])) % R_MOD)


def _jac_points(group: str, jac) -> list:
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2

    return convert.affine_to_points(G.jac_normalize(FQ if group == "g1" else FQ2, jac), group)


def _msm_case(group: str, n: int, scalars: list[int], rng: random.Random, signed: bool = False,
              plain_k5: bool = True) -> dict:
    """One power_pairs-shaped MSM (n scalars, n + 1 tiled points, shifts 0
    and 1) through K3, K4, K5 on the card as msm_sets runs them (the window
    of pick_window, or pick_window_signed where signed; the fold table of
    hot_buckets), each against its plain version, and the results against
    refimpl. Without plain_k5 the K5 comparison is left to the caller
    (_k5_plain_batched): out["k5_inputs"] holds K5's inputs and result."""
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.ops import msm as M

    f = FQ if group == "g1" else FQ2
    dev = torch.device(DEVICE)
    pts, logs = _tiled_points(group, n + 1, dev, rng)
    k = convert.ints_to_limbs(scalars, dev)
    c = M.pick_window_signed(n) if signed else M.pick_window(n)
    prep = M.prep_set(pts, k, (0, 1), c, signed)
    hot = M.Hot(*(t.expand(2, -1).contiguous() for t in M.hot_buckets(prep, n)))
    shifts = torch.tensor([0, 1], device=dev)
    args = (pts.x, pts.y, pts.inf, shifts, *prep[:5], prep.splits)
    out = {"c": c, "fold_sets": int((hot.lane >= 0).any(1).sum())}

    buckets = M.bucket_accumulate(*args)
    out["k3_ms"] = cuda_ms(lambda: M.bucket_accumulate(*args), 3)
    out["k3_work"] = (nbytes(*args[:-1], *([] if prep.splits is None else [prep.splits]), *buckets),
                      _k3_muls(group, prep, 2))
    out["k3_kernel_muls"] = _k3_kernel_muls(group, prep, 2)
    if group == "g2":
        out["k3_three_fq"] = _three_fq(_k3_muls, group, prep, 2)
    want, out["k3_plain_ms"] = once_ms(lambda: M.bucket_accumulate_plain(*args))
    out["k3_err"] = max_limb_err(buckets, want)
    if out["k3_err"]:
        raise AssertionError(f"K3 {group}: kernel and plain version differ (max abs limb error {out['k3_err']})")

    sums = M.bucket_reduce(buckets, signed, hot.lane)
    out["k4_ms"] = cuda_ms(lambda: M.bucket_reduce(buckets, signed, hot.lane), 3)
    want, out["k4_plain_ms"] = once_ms(lambda: M.bucket_reduce_plain(buckets, signed, hot.lane))
    flat = [G.JacobianBatch(*(t.reshape(-1, *t.shape[2:]) for t in s)) for s in (sums, want)]
    got_aff, want_aff = (G.jac_normalize(f, s) for s in flat)
    out["k4_err"] = max_limb_err(got_aff, want_aff)
    if out["k4_err"]:
        raise AssertionError(f"K4 {group}: kernel and plain version differ on the affine window sums")
    out["k4_work"] = (nbytes(*buckets, hot.lane, *sums), _k4_muls(group, buckets, signed, hot.lane))
    out["k4_kernel_muls"] = _k4_kernel_muls(group, buckets, signed, hot.lane)
    if group == "g2":
        out["k4_three_fq"] = _three_fq(_k4_muls, group, buckets, signed, hot.lane)

    res = M.combine_windows(sums, c, buckets, hot)
    out["k5_ms"] = cuda_ms(lambda: M.combine_windows(sums, c, buckets, hot), 3)
    if plain_k5:
        want, out["k5_plain_ms"] = once_ms(lambda: M.combine_windows_plain(sums, c, buckets, hot))
        out["k5_err"] = max_limb_err(res, want)
        if out["k5_err"]:
            raise AssertionError(f"K5 {group}: kernel and plain version differ (max abs limb error "
                                 f"{out['k5_err']})")
    else:
        out["k5_inputs"] = (sums, buckets, hot, res)
    folded = 2 * 3 * nbytes(buckets.x[:, :, 0]) if out["fold_sets"] else 0  # the H_w it reads
    out["k5_work"] = (nbytes(*sums, *hot, *res) + folded, _k5_muls(group, sums, c, buckets, hot))
    out["k5_chain"] = _k5_chain(group, sums, c, buckets, hot)
    if group == "g2":
        out["k5_three_fq"] = _three_fq(_k5_muls, group, sums, c, buckets, hot)

    got = _jac_points(group, res)
    for s in (0, 1):
        if got[s] != _msm_reference(group, logs, scalars, s, n):
            raise AssertionError(f"MSM {group} set {s}: differs from refimpl")
    out["args"], out["scalars"] = args, k
    return out


def _subrun_sweep(case: dict) -> dict:
    """K3's ms per call (prep included, as msm_sets runs it) at each sub-run
    length L of SUBRUN_SWEEP on a case's inputs; the module's constant is
    restored after."""
    from phase2_bn254_tpu_torch.ops import msm as M

    x, y, inf, shifts = case["args"][:4]
    kept, out = M.SUBRUN, {}
    try:
        for length in SUBRUN_SWEEP:
            M.SUBRUN = length
            out[length] = cuda_ms(lambda: M.bucket_accumulate(x, y, inf, shifts,
                                                              *M.prep_windows(case["scalars"], case["c"])[:5]), 3)
    finally:
        M.SUBRUN = kept
    return out


def _d1_inputs(group: str, n: int, rng: random.Random):
    """n random x coordinates, the first NONRESIDUES without a square root
    of x^3 + b, the rest with one, and random flags: (x ints, flags)."""
    from phase2_bn254_tpu_torch.refimpl.field import B_G2, Fq2, Q, legendre

    good, bad = [], []
    while len(good) < n - NONRESIDUES or len(bad) < NONRESIDUES:
        if group == "g1":
            x = rng.randrange(Q)
            square = legendre((x * x * x + 3) % Q, Q) == 1
        else:
            x = Fq2(rng.randrange(Q), rng.randrange(Q))
            square = legendre((x * x * x + B_G2).norm(), Q) == 1
        (good if square else bad).append(x)
    return bad[:NONRESIDUES] + good[: n - NONRESIDUES], [rng.random() < 0.5 for _ in range(n)]


def _x_digits(group: str, xs, device):
    import torch
    from phase2_bn254_tpu_torch import convert

    if group == "g1":
        return convert.ints_to_limbs(xs, device)
    return torch.stack([convert.ints_to_limbs([x.c0 for x in xs], device),
                        convert.ints_to_limbs([x.c1 for x in xs], device)], dim=1).contiguous()


def _d1_case(group: str, n: int, rng: random.Random) -> dict:
    """D1 on the card against its plain version (limbs and mask), the mask
    against host residuosity, 64 valid points against refimpl, and a
    non-residue through the codec raising."""
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.curve import codecs
    from phase2_bn254_tpu_torch.ops import decompress as D
    from phase2_bn254_tpu_torch.refimpl import curve as rc

    dev = torch.device(DEVICE)
    xs, flags = _d1_inputs(group, n, rng)
    x = _x_digits(group, xs, dev)
    greatest = torch.tensor(flags, device=dev)
    got, valid = D.decompress(x, greatest, group)
    (want, want_valid), plain_ms = once_ms(lambda: D.decompress_plain(x, greatest, group))
    err = max_limb_err(got[:2], want[:2])
    if err or not torch.equal(valid, want_valid):
        raise AssertionError(f"D1 {group}: kernel and plain version differ (max abs limb error {err})")
    expect = torch.arange(n, device=dev) >= NONRESIDUES
    if not torch.equal(valid, expect):
        raise AssertionError(f"D1 {group}: the valid mask differs from the host's residuosity")
    sample = sorted(rng.sample(range(NONRESIDUES, n), min(64, n - NONRESIDUES)))
    idx = torch.tensor(sample, device=dev)
    pts = convert.affine_to_points(type(got)(got.x[idx], got.y[idx], got.inf[idx]), group)
    for i, p in zip(sample, pts):
        if p != rc.get_point_from_x(xs[i], flags[i], group):
            raise AssertionError(f"D1 {group}: point {i} differs from refimpl decompression")
    x0 = xs[0]  # no square root; file order c1 || c0, flags clear
    bad = x0.to_bytes(32, "big") if group == "g1" else x0.c1.to_bytes(32, "big") + x0.c0.to_bytes(32, "big")
    try:
        codecs.decode_batch(bad, group, 1, True, False, dev)
    except ValueError:
        pass
    else:
        raise AssertionError(f"D1 {group}: a compressed x without a square root decoded")
    ms = cuda_ms(lambda: D.decompress(x, greatest, group), 5)
    out = {"ms": ms, "plain_ms": plain_ms, "err": err,
           "work": (nbytes(x, greatest, *got[:2], valid), _d1_muls(group, n))}
    if group == "g2":
        out["three_fq"] = _three_fq(_d1_muls, group, n)
    return out


def _ptxas_of(keys) -> list[str]:
    """The ptxas report (-Xptxas -v, kept by _build.build) of the kernels
    whose names hold one of keys: each entry's name, its spills and its
    registers."""
    from phase2_bn254_tpu_torch.ops import _build

    out, keep = [], False
    with open(os.path.join(_build.BUILD_DIR, f"ptxas_{_build._source_hash()}.log")) as f:
        for line in f:
            if "Compiling entry function" in line:
                keep = any(k in line for k in keys)
                if keep:
                    out.append(line.split("'")[1])
            elif keep and ("registers" in line or "spill" in line):
                out.append("    " + line.strip().removeprefix("ptxas info    : "))
    return out


def _msm_geometry(n: int, c: int, nsets: int, reduce_sets: int | None = None, signed: bool = False) -> str:
    """K3's launches for one call on n scalars and nsets shifts, and K4's for
    reduce_sets (by default nsets) sets: blocks x threads."""
    from phase2_bn254_tpu_torch.ops import msm as M

    nwin, b = M.num_windows(c), 1 << (c - signed)
    reduce_sets = nsets if reduce_sets is None else reduce_sets
    parts, buckets = nsets * nwin * M.subruns(n, c, signed), nsets * nwin * b

    def grid(threads):
        return f"{-(-threads // 128)} x 128"

    return (f"K3 pass A {grid(parts)} (one thread per set, window and sub-run: {M.subruns(n, c, signed)} sub-runs a "
            f"window, at most {M.SUBRUN} points each), {M.tree_levels(n)} tree launches of {grid(parts)}, collect "
            f"{grid(buckets)}; K4 {reduce_sets * nwin} x {M.reduce_threads(b)} (one block per set and window)")


def phase_msm_kernels(card: Card, records: list[dict], n: int = KERNEL_N) -> None:
    from phase2_bn254_tpu_torch.ops import msm as M
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    rng = random.Random(99)
    res = {}
    for group in ("g1", "g2"):
        uniform = _msm_case(group, n, _edge_scalars(n, rng), rng)
        hot = _msm_case(group, n, [rng.randrange(R_MOD)] * n, rng)
        sweep = {"uniform": _subrun_sweep(uniform), "all-equal": _subrun_sweep(hot)}
        d1 = _d1_case(group, n, rng)
        res[group] = uniform, hot, sweep, d1
        c = uniform["c"]
        log(f"phase 6 MSM {group}: N={n} (+1 points, 2 sets), c={c}: K3, K5 == plain limb for limb, K4 == plain "
            f"after normalizing, on uniform and all-equal scalars, with msm_sets' fold table; results == refimpl")
        for label, case in (("uniform", uniform), ("all-equal", hot)):
            log(f"  {label} scalars (the gate folds {case['fold_sets']} of 2 sets): K3 {case['k3_ms']:.3f} ms (plain "
                f"{case['k3_plain_ms']:.3f}), K4 {case['k4_ms']:.3f} ms (plain {case['k4_plain_ms']:.3f}), K5 "
                f"{case['k5_ms']:.3f} ms (plain {case['k5_plain_ms']:.3f})")
            for key, what in (("k3", "K3"), ("k4", "K4"), ("k5", "K5")):
                b, by = card.bound(*case[f"{key}_work"])
                own = case.get(f"{key}_kernel_muls")
                log(f"    bound {what}: {b:.3f} ms ({by}; {case[f'{key}_work'][1]} multiplies, "
                    f"{case[f'{key}_work'][0]} bytes" + (f"; the kernel does {own})" if own else ")"))
        for label, times in sweep.items():
            log(f"  K3 with its sub-run table at L = " + ", ".join(f"{k}: {v:.3f} ms" for k, v in times.items())
                + f" ({label} scalars, prep included; L = {M.SUBRUN} is the module's)")
        b, by = card.bound(*d1["work"])
        log(f"phase 6 D1 {group}: N={n} ({NONRESIDUES} without a root, flags random): kernel == plain limb for limb "
            f"and mask; mask == host residuosity; 64 points == refimpl; a non-residue through decode_batch raises; "
            f"kernel {d1['ms']:.3f} ms, plain {d1['plain_ms']:.3f} ms, bound {b:.3f} ms ({by})")
    for group in ("g1", "g2"):
        case = res[group][0]
        chain = case["k5_chain"]
        log(f"  K5 {group} chain (the longest set's, dependent Fq products): {chain['from_infinity']} from infinity "
            f"over every window on one thread (the design before the warp form), {chain['one_thread']} from the "
            f"highest finite window on one thread, {chain['warp_levels']} levels in the warp form: "
            f"{1e3 * case['k5_ms'] / chain['warp_levels']:.3f} us a level; bound "
            f"{card.bound(*case['k5_work'])[0]:.5f} ms")
    geometry = _msm_geometry(n, res["g1"][0]["c"], 2)
    log(f"  launches of one call at N={n}: {geometry}; K5 one warp per set")
    for line in _ptxas_of(("bucket_accumulate", "bucket_reduce", "combine_windows")):
        log(f"  ptxas: {line}")

    sources = "phase2_bn254_tpu_torch/csrc/msm.cu"
    for name, key, replaces in (("bucket_accumulate", "k3", "phase2_bn254_tpu/ops/pallas_msm.py:198"),
                                ("bucket_reduce", "k4", "phase2_bn254_tpu/ops/pallas_msm.py:328"),
                                ("combine_windows", "k5", "phase2_bn254_tpu/ops/pallas_msm.py:591")):
        per = {}
        for group in ("g1", "g2"):
            uniform, hot, sweep = res[group][:3]
            bound_ms, bound_by = card.bound(*uniform[f"{key}_work"])
            per[group] = {"ms": uniform[f"{key}_ms"], "plain_ms": uniform[f"{key}_plain_ms"],
                          "max_abs_err": max(uniform[f"{key}_err"], hot[f"{key}_err"]), "bound_ms": bound_ms,
                          "bound_by": bound_by, "muls": uniform[f"{key}_work"][1],
                          "all_equal": {"ms": hot[f"{key}_ms"], "plain_ms": hot[f"{key}_plain_ms"],
                                        "bound_ms": card.bound(*hot[f"{key}_work"])[0],
                                        "fold_sets": hot["fold_sets"]}}
            if f"{key}_three_fq" in uniform:
                per[group].update(_three_fq_fields(card, uniform[f"{key}_work"][0], uniform[f"{key}_three_fq"]))
            if f"{key}_kernel_muls" in uniform:
                per[group]["kernel_muls"] = uniform[f"{key}_kernel_muls"]
                per[group]["all_equal"]["kernel_muls"] = hot[f"{key}_kernel_muls"]
            if key == "k3":
                per[group]["subrun_ms"] = sweep
        g1 = per["g1"]
        extra = {}
        if key in ("k3", "k4"):
            extra = {"muls": g1["muls"], "kernel_muls": g1["kernel_muls"],
                     "geometry": geometry}
        if key == "k5":
            extra = {"chain": res["g1"][0]["k5_chain"]}
            per["g2"]["chain"] = res["g2"][0]["k5_chain"]
        records.append(record(card, name, sources, replaces, max(p["max_abs_err"] for p in per.values()), g1["ms"],
                              g1["plain_ms"], res["g1"][0][f"{key}_work"], g2=per["g2"], **extra,
                              shape=f"N={n}, c={res['g1'][0]['c']}, 2 sets, uniform scalars; g2 and all-equal beside"))
    per = {}
    for group in ("g1", "g2"):
        d1 = res[group][3]
        bound_ms, bound_by = card.bound(*d1["work"])
        per[group] = {"ms": d1["ms"], "plain_ms": d1["plain_ms"], "max_abs_err": d1["err"], "bound_ms": bound_ms,
                      "bound_by": bound_by}
        if "three_fq" in d1:
            per[group].update(_three_fq_fields(card, d1["work"][0], d1["three_fq"]))
    records.append(record(card, "decompress", "phase2_bn254_tpu_torch/csrc/decompress.cu",
                          "phase2_bn254_tpu/curve/codecs.py:101 (XLA glue, not a Pallas kernel)",
                          max(p["max_abs_err"] for p in per.values()), per["g1"]["ms"], per["g1"]["plain_ms"],
                          res["g1"][3]["work"], g2=per["g2"], shape=f"N={n} compressed points"))


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

def _replace_point(src: str, dst: str, params, kind: str, index: int, point) -> None:
    from phase2_bn254_tpu_torch.refimpl import curve as rc

    shutil.copyfile(src, dst)
    with open(dst, "r+b") as f:
        f.seek(params.position(kind, index, True))
        f.write(rc.point_to_bytes(point, True))


def phase_verify_small(workdir: str, size: int = 10, batch: int = 256) -> None:
    from phase2_bn254_tpu_torch.ceremony.params import CeremonyParams
    from phase2_bn254_tpu_torch.cli import phase1
    from phase2_bn254_tpu_torch.ops.backend import TorchBackend
    from phase2_bn254_tpu_torch.refimpl import curve as rc
    from phase2_bn254_tpu_torch.refimpl.backend import ExactBackend

    fixtures = os.path.join(REPO, "tests", "fixtures")
    challenge = os.path.join(fixtures, "golden_challenge_s4_b16.bin")
    response = os.path.join(fixtures, "golden_response_s4_b16.bin")
    out = {}
    for name, backend in (("torch", TorchBackend(DEVICE)), ("exact", ExactBackend())):
        out[name] = os.path.join(workdir, f"new_challenge_4_{name}")
        phase1.verify_transform(challenge, response, out[name], 4, 16, backend)
    if _read(out["torch"]) != _read(out["exact"]):
        raise AssertionError("size-4 new challenge differs from the exact host backend's")
    log(f"phase 7 golden: size 4 verify passes; new challenge == ExactBackend's ({os.path.getsize(out['torch'])} bytes)")

    t0 = time.time()
    challenge = _challenge(workdir, size, batch)
    response = os.path.join(workdir, f"response_{size}")  # phase 4's
    phase1.verify_transform_constrained(challenge, response, os.path.join(workdir, f"new_{size}"), size, batch, DEVICE)
    t1 = time.time()
    params = CeremonyParams(size, batch)
    index = params.powers_length - batch // 2  # in the last low chunk; not a head point
    tampered = os.path.join(workdir, f"response_{size}_tampered")
    _replace_point(response, tampered, params, "tau_g1", index, rc.G1_GEN.mul(12345))
    try:
        phase1.verify_transform_constrained(challenge, tampered, os.path.join(workdir, f"new_{size}_t"), size, batch,
                                            DEVICE)
    except ValueError as e:
        if "INVALID CONTRIBUTION" not in str(e):
            raise
    else:
        raise AssertionError(f"a size-{size} response with a valid but wrong tau_g1[{index}] verified")
    log(f"phase 7 size {size} batch {batch}: the response verifies ({t1 - t0:.1f} s); with tau_g1[{index}] replaced "
        f"by another valid point it is rejected ({time.time() - t1:.1f} s)")


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

def _check_new_challenge(response: str, new_challenge: str, params, rng: random.Random) -> int:
    """The new challenge's uncompressed elements == refimpl decompression of
    the response's compressed ones, >= 64 indices per kind and beta_g2."""
    from phase2_bn254_tpu_torch.refimpl import curve as rc

    checked = 0
    picks = list(_spot_indices(params, rng)) + [("beta_g2", [0])]
    with open(response, "rb") as fr, open(new_challenge, "rb") as fn:
        for kind, idx in picks:
            group = "g2" if kind in ("tau_g2", "beta_g2") else "g1"
            for i in idx:
                fr.seek(params.position(kind, i, True))
                want = rc.point_to_bytes(rc.point_from_bytes(fr.read(params.element_size(kind, True)), group, True,
                                                             check=False), False)
                fn.seek(params.position(kind, i, False))
                if fn.read(params.element_size(kind, False)) != want:
                    raise AssertionError(f"new challenge {kind}[{i}] differs from the response's point")
                checked += 1
    return checked


def phase_verify(workdir: str, records: list[dict], size: int = SMOKE_SIZE, batch: int = SMOKE_BATCH) -> bytes:
    """Phase 8; returns the new challenge's hash."""
    import torch
    from phase2_bn254_tpu_torch.ceremony.params import HASH_SIZE, CeremonyParams
    from phase2_bn254_tpu_torch.cli import phase1
    from phase2_bn254_tpu_torch.crypto.hashing import calculate_hash
    from phase2_bn254_tpu_torch.ops import backend as B
    from phase2_bn254_tpu_torch.ops import decompress as D
    from phase2_bn254_tpu_torch.ops import msm as M

    params = CeremonyParams(size, batch)
    challenge = _challenge(workdir, size, batch)
    response = os.path.join(workdir, f"response_{size}")  # phase 5's
    new_challenge = os.path.join(workdir, f"new_challenge_{size}")

    timers = _verify_timers("prep_windows")
    for name in MSM_WRAPPERS:
        timers.device_of("msm", M, name)
    for name in M.LAUNCHES:
        M.LAUNCHES[name] = 0
    timers.device_of("d1", D, "decompress")
    D.LAUNCHES["decompress"] = 0
    M.reset_fold_counts()
    pp_sizes = []  # scalars of each power_pairs call
    counted = B.TorchBackend.power_pairs

    def power_pairs(self, ps):
        pp_sizes.append(ps.n - 1)
        return counted(self, ps)

    B.TorchBackend.power_pairs = power_pairs
    try:
        t0 = time.time()
        new_hash = phase1.verify_transform_constrained(challenge, response, new_challenge, size, batch, DEVICE)
        torch.cuda.synchronize()
        total = time.time() - t0
    finally:
        B.TorchBackend.power_pairs = counted
        timers.restore()
    launches, folds = {**M.LAUNCHES, **D.LAUNCHES}, M.fold_counts()

    low = len(list(params.chunks("low")))
    high = len(list(params.chunks("high")))
    want_pp = 4 * low + high + 1  # every chunk of every kind, and the seam
    if len(pp_sizes) != want_pp:
        raise AssertionError(f"{len(pp_sizes)} power_pairs calls, want {want_pp}")
    want = {**dict.fromkeys(M.LAUNCHES, 0), **dict.fromkeys(MSM_WRAPPERS, want_pp),
            "decompress": 2 * (4 * low + high), "bucket_accumulate": sum(M.accumulate_launches(n) for n in pp_sizes)}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want} (K3: one call of accumulate_launches(N) "
                             f"launches, K4, K5: one launch per power_pairs, which runs its two MSMs as two sets; "
                             f"the signed kernels none; D1: one per compressed chunk decode, verify and "
                             f"decompress)")
    for r in records:
        if r["name"] in launches:
            r["launches"] = launches[r["name"]]

    if new_hash != calculate_hash(new_challenge):
        raise AssertionError("the new challenge's hash differs from the one verify returned")
    with open(new_challenge, "rb") as f:
        if f.read(HASH_SIZE) != calculate_hash(response):
            raise AssertionError("hash chain: the new challenge does not start with the response's hash")
    if os.path.getsize(new_challenge) != params.accumulator_size:
        raise AssertionError("new challenge has the wrong size")
    t0 = time.time()
    checked = _check_new_challenge(response, new_challenge, params, random.Random(8))
    t_check = time.time() - t0

    log(f"phase 8 verify: size {size} batch {batch}: passes; {want_pp} power_pairs ({2 * want_pp} MSMs) -> K3, K4, K5 "
        f"launches {launches['bucket_accumulate']} ({want_pp} calls; {M.accumulate_launches(batch)} launches a call "
        f"at N={batch}), {launches['bucket_reduce']}, {launches['combine_windows']} (of them taking the hot-bucket "
        f"fold {folds['launches']}, in {folds['sets']} sets, as K5 counted them: the coefficients are uniform), the "
        f"signed kernels none; D1 launches {launches['decompress']} (== compressed chunk decodes)")
    log(f"  wall s: {_verify_wall(timers, total)}")
    log(f"  device s (CUDA events): K3 + K4 + K5 {timers.device_s('msm'):.3f}, D1 {timers.device_s('d1'):.3f}")
    log(f"  new challenge hash chain ok; {checked} spot checks == refimpl decompression of the response "
        f"({t_check:.1f} s)")
    _profile_power_pairs(response, params)
    return new_hash


def _verify_timers(prep: str) -> _Timers:
    """Timers of a verification's parts (phases 8 and 17): prep, the MSM
    prep that power_pairs enqueues (msm.prep_windows or
    prep_windows_signed)."""
    from phase2_bn254_tpu_torch.ceremony import accumulator
    from phase2_bn254_tpu_torch.cli import phase1
    from phase2_bn254_tpu_torch.ops import backend as B
    from phase2_bn254_tpu_torch.ops import msm as M

    timers = _Timers()
    for name in ("decode", "power_pairs", "encode"):
        timers.wall_of(name, B.TorchBackend, name)
    timers.wall_of("coefficients", B, "random_scalars")
    timers.wall_of("prep", M, prep)
    timers.wall_of("ratios", accumulator._RatioAccumulator, "add")
    timers.wall_of("pairings", accumulator.SameRatioBatch, "flush")
    timers.wall_of("hashing", phase1, "calculate_hash")
    return timers


def _verify_wall(timers: _Timers, total: float) -> str:
    w = timers.wall
    other = total - sum(w[k] for k in ("decode", "power_pairs", "ratios", "pairings", "encode", "hashing"))
    return (f"total {total:.3f} | decode (codec, D1, valid-mask sync) {w['decode']:.3f} | power_pairs "
            f"{w['power_pairs']:.3f} (of it coefficients {w['coefficients']:.3f}, prep enqueue {w['prep']:.3f}; the "
            f"rest launches and the wait for the two results) | host ratio accumulation {w['ratios']:.3f} | host "
            f"pairings {w['pairings']:.3f} | decompress-encode {w['encode']:.3f} | hashing {w['hashing']:.3f} | other "
            f"(heads, file I/O) {other:.3f}")


def _profile_power_pairs(response: str, params) -> None:
    """One tau_g1 chunk's power_pairs (decoded from the response)."""
    from phase2_bn254_tpu_torch.ops.backend import TorchBackend

    n = params.batch_size + 1
    with open(response, "rb") as f:
        f.seek(params.position("tau_g1", 0, True))
        raw = f.read(n * params.element_size("tau_g1", True))
    be = TorchBackend(DEVICE)
    ps = be.decode(raw, "g1", n, True, True)
    be.power_pairs(ps)  # warm-up
    out = _profile(lambda: be.power_pairs(ps), {"K3": ("bucket_accumulate",), "K4": ("bucket_reduce",),
                                                "K5": ("combine_windows",), "sort": ("sort", "Sort", "radix")})
    log(f"  profile power_pairs of one tau_g1 chunk ({n} points): {out}")


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

NTT_EXPS = (1, 2, 3, 10, 18, 20)  # kernel == plain, forward and inverse
NTT_THREE_PASS = {18: (6, 6, 6), 20: (7, 7, 6)}  # forced three-pass plans, kernel == plain
NTT_BIG_EXPS = (24, 25, 26, 27, 28)  # round trip and a sparse spot check against host integers
PROVE_EXP = 18  # the prover's domain (phase 10)


def _fr_random(m: int, gen) -> "torch.Tensor":
    """m canonical Fr values (also valid Montgomery forms) as int64 (m, 16)
    limbs on the card: random 16-bit limbs, the top one below r's; drawn
    with `gen` on its own device, the same values for the same seed."""
    import torch
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    x = torch.randint(0, 1 << 16, (m, 16), generator=gen, dtype=torch.int64, device=gen.device)
    x[:, 15] = torch.randint(0, R_MOD >> 240, (m,), generator=gen, dtype=torch.int64, device=gen.device)
    return x.to(DEVICE)


def _ntt_butterfly_products(exp: int, plan) -> int:
    """Products of the row DFTs of `plan`'s passes, those by w^0 = 1 left
    out: a C-point row does C/2 log2(C) butterflies, C - 1 of them with
    twiddle 1."""
    return sum((1 << (exp - lc)) * ((1 << lc) // 2 * lc - ((1 << lc) - 1)) for lc in plan)


def _ntt_muls(exp: int, plan=None, factors: int = 0) -> int:
    """Multiplies of the Fr Montgomery products an NTT at 2^exp needs on
    `plan` (default ntt.pass_plan): the butterflies' products other than by
    1, one inter-twiddle product per element between passes (the
    inverse's 1/N among them) and one per element for each folded factor
    (`factors`: 1 for coset_ntt's g^i, 1 for icoset_ntt's geninv^k / z).
    The bound counts these."""
    from phase2_bn254_tpu_torch.ops import ntt

    plan = ntt.pass_plan(exp) if plan is None else plan
    m = 1 << exp
    return (_ntt_butterfly_products(exp, plan) + m * (max(len(plan) - 1, 0) + factors)) * MULS_PER_FQ_PRODUCT


def _ntt_kernel_muls(exp: int, plan=None, factors: int = 0) -> int:
    """Multiplies csrc/ntt.cu does for one call: the butterflies' products
    but by 1 (the kernel skips those too), and two products per element for
    each inter-twiddle and folded factor, since it builds each factor as lo *
    hi rather than reading it from an N-entry table. A cost of the design,
    recorded beside the bound."""
    from phase2_bn254_tpu_torch.ops import ntt

    plan = ntt.pass_plan(exp) if plan is None else plan
    twiddled = max(len(plan) - 1, 1 if len(plan) else 0)
    return (_ntt_butterfly_products(exp, plan) + 2 * (1 << exp) * (twiddled + factors)) * MULS_PER_FQ_PRODUCT


def _ntt_bytes(exp: int) -> int:
    """Bytes an `ntt` must move: its input and output, int64 digits, 128
    bytes an element (the tables, a few thousand 32-byte entries, left
    out)."""
    return 128 * 2 * (1 << exp)


def _ntt_case(card: Card, exp: int, x, inverse: bool, plan=None, pre=None, post=None, reps: int = 5) -> dict:
    """One four_step call on the card against its plain version on the same
    input, limb for limb; times and bound."""
    import torch
    from phase2_bn254_tpu_torch.ops import ntt

    before = ntt.LAUNCHES["lane_dft"]
    got = ntt.four_step(exp, x, inverse, plan, pre, post)
    launches = ntt.LAUNCHES["lane_dft"] - before
    want, plain_ms = once_ms(lambda: ntt.four_step(exp, x, inverse, plan, pre, post, lane=ntt.lane_dft_plain))
    if not torch.equal(got, want):
        raise AssertionError(f"K6 exp {exp} inverse {inverse} plan {plan} factors {pre, post}: kernel and plain "
                             f"version differ (max abs limb error {max_limb_err([got], [want])})")
    factors = (pre is not None) + (post is not None)
    call_ms = cuda_ms(lambda: ntt.four_step(exp, x, inverse, plan, pre, post), reps)
    ms = device_ms(lambda: ntt.four_step(exp, x, inverse, plan, pre, post), reps)
    bound_ms, bound_by = card.bound(_ntt_bytes(exp), _ntt_muls(exp, plan, factors))
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "launches": launches, "muls": _ntt_muls(exp, plan, factors),
            "kernel_muls": _ntt_kernel_muls(exp, plan, factors)}


def _ntt_big(card: Card, exp: int) -> dict:
    """ntt at 2^exp, too large for the plain version: inverse(forward(x))
    == x (x drawn again from its seed after the forward call, so that the
    card holds at most an input, an output and one packed intermediate), and
    300 outputs of a 4-term input against a DFT on host integers, both
    directions; the forward call's kernel time."""
    import torch
    from phase2_bn254_tpu_torch.field import fp
    from phase2_bn254_tpu_torch.ops import ntt
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    m = 1 << exp
    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    x = _fr_random(m, torch.Generator(device=dev).manual_seed(exp))
    ms = device_ms(lambda: ntt.ntt(exp, x, False), 2)  # each call's output dropped before the next
    y = ntt.ntt(exp, x, False)
    del x
    z = ntt.ntt(exp, y, True)
    del y
    if not torch.equal(z, _fr_random(m, torch.Generator(device=dev).manual_seed(exp))):
        raise AssertionError(f"K6 exp {exp}: the inverse of the forward NTT is not the input")
    del z
    rng = random.Random(exp)
    nonzero = {rng.randrange(m): rng.randrange(R_MOD) for _ in range(4)}
    sparse = torch.zeros((m, 16), dtype=torch.int64, device=dev)
    for j, v in nonzero.items():
        sparse[j] = torch.tensor(fp.int_to_limbs(fp.FR_CTX.to_mont_int(v)), device=dev)
    ks = sorted({0, 1, m - 1} | {rng.randrange(m) for _ in range(297)})
    d = ntt.Domain(exp)
    for inverse in (False, True):
        out = ntt.ntt(exp, sparse, inverse)[torch.tensor(ks, device=dev)].cpu()
        w, scale = (d.omegainv, d.minv) if inverse else (d.omega, 1)
        for k, limbs in zip(ks, out):
            want = sum(v * pow(w, j * k % m, R_MOD) for j, v in nonzero.items()) * scale % R_MOD
            if fp.FR_CTX.from_mont_int(fp.limbs_to_int(limbs)) != want:
                raise AssertionError(f"K6 exp {exp} inverse {inverse}: output {k} differs from the host DFT")
    del sparse, out
    bound_ms, bound_by = card.bound(_ntt_bytes(exp), _ntt_muls(exp))
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "spot": len(ks), "plan": ntt.pass_plan(exp),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def phase_ntt(card: Card, records: list[dict]) -> None:
    import torch
    from phase2_bn254_tpu_torch.ops import ntt

    gen = torch.Generator().manual_seed(9)
    per = {}
    for exp in NTT_EXPS:
        x = _fr_random(1 << exp, gen)
        for inverse in (False, True):
            per[(exp, inverse)] = _ntt_case(card, exp, x, inverse)
        for inverse in (False, True) if exp in NTT_THREE_PASS else ():
            per[(exp, inverse, "3")] = _ntt_case(card, exp, x, inverse, NTT_THREE_PASS[exp])
        del x
    log("phase 9 K6 (lane_dft): ntt == ntt_plain limb for limb, forward and inverse, at exp "
        + ", ".join(map(str, NTT_EXPS)) + " (kernel ms: one call's device time with the host's launch time hidden, "
        "device_ms; the call's, CUDA events, beside; launches one per pass of ntt.pass_plan), and with "
        "forced three-pass plans " + ", ".join(f"{e}: {p}" for e, p in NTT_THREE_PASS.items()))
    for key, p in per.items():
        exp, inverse = key[:2]
        log(f"  exp {exp} {'inverse' if inverse else 'forward'}{' three passes' if len(key) > 2 else ''}: kernel "
            f"{p['ms']:.4f} ms ({p['launches']} launches; the call {p['call_ms']:.4f} ms), plain {p['plain_ms']:.3f} "
            f"ms, bound {p['bound_ms']:.4f} ms ({p['bound_by']}: {p['muls']} multiplies, {_ntt_bytes(exp)} bytes; the "
            f"kernel does {p['kernel_muls']})")

    # the prover's folded coset forms against their plain versions
    cosets = {}
    for exp in (10, PROVE_EXP, 20):
        x = _fr_random(1 << exp, gen)
        cosets[(exp, "coset_ntt")] = _ntt_case(card, exp, x, False, pre=ntt.MULT_GEN)
        cosets[(exp, "icoset_ntt(divide_by_z)")] = _ntt_case(card, exp, x, True,
                                                              post=(ntt.Domain(exp).geninv, ntt.z_inverse(exp)))
        if not torch.equal(ntt.coset_ntt(exp, x),
                           ntt.ntt_plain(exp, ntt.distribute_powers(exp, x, ntt.MULT_GEN), False)):
            raise AssertionError(f"coset_ntt at exp {exp} differs from ntt(distribute_powers)")
        del x
    for (exp, name), p in cosets.items():
        log(f"  {name} exp {exp} (factors folded into the passes): kernel == plain limb for limb; kernel "
            f"{p['ms']:.4f} ms ({p['launches']} launches; the call {p['call_ms']:.4f} ms), plain {p['plain_ms']:.3f} "
            f"ms, bound {p['bound_ms']:.4f} ms ({p['bound_by']}: {p['muls']} multiplies; the kernel does "
            f"{p['kernel_muls']})")

    big = {}
    for exp in NTT_BIG_EXPS:
        # skipped only where the input and ntt's own bytes exceed the card's memory; any other
        # out-of-memory error is a fault and fails the phase
        need, total = 128 * (1 << exp) + ntt.device_bytes(exp), torch.cuda.mem_get_info()[1]
        if need > total:
            big[exp] = {"skipped": f"{need} bytes needed (input {128 << exp} + ntt {ntt.device_bytes(exp)}); the card "
                                   f"has {total} bytes"}
            log(f"  exp {exp}: the card's memory does not hold it: {big[exp]['skipped']}")
            continue
        torch.cuda.reset_peak_memory_stats()
        big[exp] = _ntt_big(card, exp)
        b = big[exp]
        log(f"  exp {exp} (plan {b['plan']}): inverse(forward(x)) == x; {b['spot']} outputs of a 4-term input == "
            f"host DFT, both directions; forward kernel {b['ms']:.3f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}); peak device memory {b['peak_bytes']} bytes; plain not run (its temporaries exceed "
            f"the card's memory)")
    torch.cuda.empty_cache()
    for line in _ptxas_of(("lane_dft_kernel",)):
        log(f"  ptxas: {line}")
    main = per[(PROVE_EXP, False)]
    rec = record(card, "lane_dft", "phase2_bn254_tpu_torch/csrc/ntt.cu", "phase2_bn254_tpu/ops/pallas_ntt.py:229",
                 0, main["ms"], main["plain_ms"], (_ntt_bytes(PROVE_EXP), _ntt_muls(PROVE_EXP)),
                 shape=f"one ntt() call (2 launches) at 2^{PROVE_EXP}, forward; other exps and forms beside",
                 by_exp={f"{k[0]}{'i' if k[1] else ''}{'_3pass' if len(k) > 2 else ''}": p for k, p in per.items()},
                 cosets={f"{name} {exp}": p for (exp, name), p in cosets.items()},
                 big={str(e): b for e, b in big.items()}, muls=_ntt_muls(PROVE_EXP),
                 kernel_muls=_ntt_kernel_muls(PROVE_EXP))
    records.append(rec)


# ---------------------------------------------------------------------------
# phases 10 and 11: the prover
# ---------------------------------------------------------------------------

def write_circuit(workdir: str, exp: int, seed: int) -> tuple[str, str]:
    """A circom-shaped circuit of 2^exp constraints once the prover's three
    input constraints are added, and its witness, as circuit.json and
    witness.json: half the constraints booleanity b * b = b on random bits,
    half products x_(i+1) = x_i * y_i of random field elements, x_0 the
    public input and x_K the output."""
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    rng = random.Random(seed)
    total = (1 << exp) - 3
    k = total // 2
    nbits = total - k
    xs = [rng.randrange(R_MOD)]
    ys = [rng.randrange(R_MOD) for _ in range(k)]
    for y in ys:
        xs.append(xs[-1] * y % R_MOD)
    bits = [rng.randrange(2) for _ in range(nbits)]
    # variables: 0 one, 1 output x_K, 2 public x_0, then y_0.., x_1..x_(K-1), the bits
    x_idx = [2] + [3 + k + i for i in range(k - 1)] + [1]
    b0 = 3 + 2 * k - 1
    cons = [[{str(x_idx[i]): "1"}, {str(3 + i): "1"}, {str(x_idx[i + 1]): "1"}] for i in range(k)]
    cons += [[{str(b0 + j): "1"}] * 3 for j in range(nbits)]
    witness = [1, xs[k], xs[0]] + ys + xs[1:k] + bits
    circuit = {"constraints": cons, "nPubInputs": 1, "nOutputs": 1, "nVars": len(witness)}
    paths = os.path.join(workdir, f"circuit_{exp}.json"), os.path.join(workdir, f"witness_{exp}.json")
    with open(paths[0], "w") as f:
        json.dump(circuit, f)
    with open(paths[1], "w") as f:
        json.dump([str(v) for v in witness], f)
    return paths


def write_params(circuit_json: str, path: str, seed: int, device: str) -> None:
    """A .params file (params || cs_hash || u32 0 contributions) of the
    circuit from the port's generator, toxic waste from a ChaCha seed."""
    from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
    from phase2_bn254_tpu_torch.groth16.generator import generate_parameters_bytes
    from phase2_bn254_tpu_torch.phase2.circom import CircomCircuit
    from phase2_bn254_tpu_torch.refimpl.sampling import rand_fr, rand_g1, rand_g2

    rng = ChaChaRng.from_digest_be(hashlib.blake2b(seed.to_bytes(8, "little")).digest())
    g1, g2 = rand_g1(rng), rand_g2(rng)
    toxic = [rand_fr(rng) for _ in range(5)]
    params = generate_parameters_bytes(CircomCircuit.from_json_file(circuit_json), g1, g2, *toxic, device)
    with open(path, "wb") as f:
        f.write(params + hashlib.blake2b(params).digest() + (0).to_bytes(4, "big"))


def witness_shares(assignment) -> dict:
    """The share of scalars equal to 0 and to 1 in each query the prover
    runs on the aux values: l (every aux value), a and b (the values of the
    variables that occur in A, in B), as groth16.prover.create_proof forms
    them. (zero share, one share, count) per query."""
    auxs, inputs = assignment.aux_assignment, assignment.input_assignment
    queries = {"l": auxs,
               "a": inputs + [v for v, d in zip(auxs, assignment.a_aux_density) if d],
               "b": [v for v, d in zip(inputs, assignment.b_input_density) if d]
               + [v for v, d in zip(auxs, assignment.b_aux_density) if d]}
    return {name: (sum(v == 0 for v in vals) / max(len(vals), 1), sum(v == 1 for v in vals) / max(len(vals), 1),
                   len(vals)) for name, vals in queries.items()}


def _shares_text(shares: dict) -> str:
    return "; ".join(f"{name} ({n} scalars): {100 * zero:.2f}% zero, {100 * one:.2f}% one"
                     for name, (zero, one, n) in shares.items())


def _k3_sets(group: str, sets, c: int, signed: bool = False) -> dict:
    """K3 over each (points, scalars, shifts) set as msm.accumulate_sets
    calls it, and its plain version: time (CUDA events), work, and the
    largest limb difference."""
    import torch
    from phase2_bn254_tpu_torch.ops import msm as M

    args, need, own = [], 0, 0
    for points, scalars, shifts in sets:
        prep = M.prep_set(points, scalars, shifts, c, signed)
        shift_t = torch.tensor(shifts, dtype=torch.int64, device=points.x.device)
        args.append((points.x, points.y, points.inf, shift_t, *prep[:5], prep.splits))
        need += _k3_muls(group, prep, len(shifts))
        own += _k3_kernel_muls(group, prep, len(shifts))
    parts, ms = once_ms(lambda: [M.bucket_accumulate(*a) for a in args])
    want, plain_ms = once_ms(lambda: [M.bucket_accumulate_plain(*a) for a in args])
    return {"ms": ms, "plain_ms": plain_ms, "err": max(max_limb_err(got, w) for got, w in zip(parts, want)),
            "work": (sum(nbytes(*(t for t in a if t is not None)) for a in args) + sum(nbytes(*p) for p in parts),
                     need),
            "kernel_muls": own}


def _prover_msm_kernels(card: Card, captured: list, signed: bool = False) -> dict:
    """K3, K4 and K5 at the prover's own shapes, on the sets its msm_sets
    calls took in a run of `prove` (three G1 sets sharing one K4 and one K5
    launch, one G2 set), in the default or the signed mode (its window is
    then pick_window_signed's), each against its plain version: K3 on those
    sets (the witness' ones and all), K4 and K5 on the very buckets and fold
    table the prover builds (msm.accumulate_sets, as msm_sets runs it).
    Returns {kernel: {group: times, bound, error, shape}}."""
    import torch
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.ops import msm as M

    label = "phase 17 signed" if signed else "phase 10"
    per_kernel = {"bucket_accumulate": {}, "bucket_reduce": {}, "combine_windows": {}}
    for (sets,) in captured:
        group = "g1" if sets[0][0].x.dim() == 2 else "g2"
        f = FQ if group == "g1" else FQ2
        n = max(k.shape[0] for _, k, _ in sets)
        c = M.pick_window_signed(n) if signed else M.pick_window(n)
        sizes = [k.shape[0] for _, k, _ in sets]
        (buckets, hot), k3_ms = once_ms(lambda: M.accumulate_sets(sets, c, signed))
        fold_sets = int((hot.lane >= 0).any(1).sum())
        k3 = _k3_sets(group, sets, c, signed)
        if k3["err"]:
            raise AssertionError(f"K3 {group} at the prover's shape: kernel and plain version differ "
                                 f"(max abs limb error {k3['err']})")
        sums, k4_ms = once_ms(lambda: M.bucket_reduce(buckets, signed, hot.lane))
        # the plain version a set at a time: at c = 16 its double-and-add holds every bucket of a set at once
        want, k4_plain_ms = once_ms(lambda: [M.bucket_reduce_plain(G.JacobianBatch(*(t[i : i + 1] for t in buckets)),
                                                                   signed, hot.lane[i : i + 1])
                                             for i in range(buckets.x.shape[0])])
        want = G.JacobianBatch(*(torch.cat(t) for t in zip(*want)))
        flat = [G.JacobianBatch(*(t.reshape(-1, *t.shape[2:]) for t in x)) for x in (sums, want)]
        k4_err = max_limb_err(*(G.jac_normalize(f, x) for x in flat))
        if k4_err:
            raise AssertionError(f"K4 {group} at the prover's shape: kernel and plain version differ on the affine "
                                 f"window sums")
        res, k5_ms = once_ms(lambda: M.combine_windows(sums, c, buckets, hot))
        want, k5_plain_ms = once_ms(lambda: M.combine_windows_plain(sums, c, buckets, hot))
        k5_err = max_limb_err(res, want)
        if k5_err:
            raise AssertionError(f"K5 {group} at the prover's shape: kernel and plain version differ (max abs limb "
                                 f"error {k5_err})")
        folded = 2 * 3 * nbytes(buckets.x[:, :, 0]) if fold_sets else 0  # the H_w K5 reads
        work = {"bucket_accumulate": k3["work"],
                "bucket_reduce": (nbytes(*buckets, hot.lane, *sums), _k4_muls(group, buckets, signed, hot.lane)),
                "combine_windows": (nbytes(*sums, *hot, *res) + folded, _k5_muls(group, sums, c, buckets, hot))}
        own = {"bucket_accumulate": k3["kernel_muls"],
               "bucket_reduce": _k4_kernel_muls(group, buckets, signed, hot.lane)}
        times = {"bucket_accumulate": (k3["ms"], k3["plain_ms"], k3["err"]),
                 "bucket_reduce": (k4_ms, k4_plain_ms, k4_err), "combine_windows": (k5_ms, k5_plain_ms, k5_err)}
        shape = (f"{len(sets)} set(s) of {sizes} scalars, c={c}{' signed' if signed else ''}, the hot-bucket fold "
                 f"in {fold_sets} of them")
        for name, (ms, plain_ms, err) in times.items():
            bound_ms, bound_by = card.bound(*work[name])
            per_kernel[name][group] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": bound_ms,
                                       "bound_by": bound_by, "shape": shape, "muls": work[name][1]}
            if name in own:
                per_kernel[name][group]["kernel_muls"] = own[name]
        per_kernel["bucket_accumulate"][group]["with_prep_ms"] = k3_ms
        launches = sum(M.accumulate_launches(n) for n in sizes)
        log(f"{label} MSM kernels at the prover's {group} shape ({shape}): K3 == plain limb for limb (kernel "
            f"{k3['ms']:.3f} ms in {launches} launches, plain {k3['plain_ms']:.3f} ms, bound "
            f"{card.bound(*k3['work'])[0]:.3f} ms: {k3['work'][1]} multiplies, the kernel does "
            f"{k3['kernel_muls']}); K3 with its digit sort, as msm_sets runs it, {k3_ms:.3f} ms; on those "
            f"buckets K4 == plain after normalizing (kernel {k4_ms:.3f} ms, plain {k4_plain_ms:.3f} ms, bound "
            f"{card.bound(*work['bucket_reduce'])[0]:.3f} ms: {work['bucket_reduce'][1]} multiplies, the kernel "
            f"does {own['bucket_reduce']}), K5 == plain limb for limb (kernel {k5_ms:.3f} ms, plain "
            f"{k5_plain_ms:.3f} ms, bound {card.bound(*work['combine_windows'])[0]:.5f} ms; chain "
            f"{_k5_chain(group, sums, c, buckets, hot)['warp_levels']} levels), with msm_sets' fold table (the fold "
            f"in {fold_sets} of {len(sets)} sets)")
        log(f"  launches of K3 on the largest set and of K4: {_msm_geometry(n, c, 1, len(sets), signed)}")
        del buckets, hot, sums, res, want, flat
    return per_kernel


def phase_prove(card: Card, workdir: str, records: list[dict], exp: int = PROVE_EXP) -> str:
    """`prove` three times: as a user runs it, for the wall time and the
    kernel launches; with every part timed, which also keeps the prover's
    MSM inputs for `_prover_msm_kernels`; and as a user runs it again. Then
    once with seeded r and s, whose proof's blake2b it returns."""
    import torch
    from phase2_bn254_tpu_torch.cli import phase2 as cli2
    from phase2_bn254_tpu_torch.groth16 import prover
    from phase2_bn254_tpu_torch.groth16.source import ParametersSource
    from phase2_bn254_tpu_torch.ops import batch_exp, ntt
    from phase2_bn254_tpu_torch.ops import msm as M
    from phase2_bn254_tpu_torch.phase2 import circom
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    t0 = time.time()
    circuit_json, witness_json = write_circuit(workdir, exp, seed=18)
    t_circuit = time.time() - t0
    params = os.path.join(workdir, f"circuit_{exp}.params")
    for counts in (batch_exp.LAUNCHES, ntt.LAUNCHES):
        for name in counts:
            counts[name] = 0
    t0 = time.time()
    write_params(circuit_json, params, seed=18, device=DEVICE)
    torch.cuda.synchronize()
    t_params = time.time() - t0
    gen_launches = {**dict(batch_exp.LAUNCHES), "lane_dft": ntt.LAUNCHES["lane_dft"]}
    proof_json, public_json = os.path.join(workdir, "proof.json"), os.path.join(workdir, "public.json")
    argv = [circuit_json, witness_json, params, proof_json, public_json, "--device", DEVICE]

    def as_a_user_runs_it():
        """(wall s, kernel launches, K5 launches and sets that fold) of one
        `prove`."""
        for counts in (ntt.LAUNCHES, M.LAUNCHES):
            for name in counts:
                counts[name] = 0
        k3_sizes = []  # scalars of each K3 call
        k3 = M.bucket_accumulate

        def counted(*a):
            k3_sizes.append(a[4].shape[1])
            return k3(*a)

        M.bucket_accumulate = counted
        M.reset_fold_counts()
        try:
            t0 = time.time()
            cli2.main_prove(argv)
            torch.cuda.synchronize()
            total = time.time() - t0
        finally:
            M.bucket_accumulate = k3
        launches, folds = {**ntt.LAUNCHES, **M.LAUNCHES}, M.fold_counts()
        want = {**dict.fromkeys(ntt.LAUNCHES, 0), **dict.fromkeys(M.LAUNCHES, 0), "lane_dft": 14,
                "bucket_accumulate": sum(M.accumulate_launches(n) for n in k3_sizes), "bucket_reduce": 2,
                "combine_windows": 2}
        if launches != want or len(k3_sizes) != 4:
            raise AssertionError(f"kernel launches {launches}, want {want} in 4 K3 calls, got {len(k3_sizes)} (7 "
                                 f"NTTs of 2 passes; 3 G1 MSMs sharing one K4 and K5 launch, 1 G2 MSM; a K3 call "
                                 f"makes accumulate_launches(N) launches; the signed kernels none)")
        return total, launches, folds

    total, launches, folds = as_a_user_runs_it()
    for r in records:
        if r["name"] == "lane_dft":
            r["launches"] = launches["lane_dft"]
        elif r["name"] in M.LAUNCHES:
            r["prove_launches"] = launches[r["name"]]
        if r["name"] == "combine_windows":
            r["prove_fold_launches"] = folds["launches"]

    # every part timed; h up to the end of its device work
    timers = _Timers()
    timers.wall_of("json", circom.json, "load")
    timers.wall_of("synthesis", prover, "prepare_prover")
    timers.wall_of("h", prover, "_h_coefficients", sync=True)
    timers.wall_of("decode", prover._Bases, "_decoded")
    timers.wall_of("msm_launch", prover._Bases, "msm_async")
    timers.wall_of("msm_wait", prover._Bases, "wait")
    timers.wall_of("combine", prover, "combine")
    timers.wall_of("pairings", cli2, "prepare_verifying_key")
    timers.wall_of("pairings", cli2, "verify_proof")
    timers.device_of("ntt", ntt, "lane_dft")
    for name in MSM_WRAPPERS:
        timers.device_of("msm", M, name)
    kept = {}
    timers.keep("assignment", prover, "prepare_prover", kept)
    timers.args_of("msm_sets", M, "msm_sets", kept)
    try:
        t0 = time.time()
        cli2.main_prove(argv)
        torch.cuda.synchronize()
        timed_total = time.time() - t0
    finally:
        timers.restore()
    total_again, _, _ = as_a_user_runs_it()

    with open(params, "rb") as f:
        vk_json = circom.verification_key_json(ParametersSource(f))
    with open(proof_json) as f:
        proof = f.read()
    with open(public_json) as f:
        publics = json.load(f)
    if not circom.snarkjs_verify(vk_json, proof, json.dumps(publics)):
        raise AssertionError("snarkjs_verify rejects the proof that prove verified")
    wrong = [publics[0], str((int(publics[1]) + 1) % R_MOD)]
    if circom.snarkjs_verify(vk_json, proof, json.dumps(wrong)):
        raise AssertionError("the proof verifies with a changed public input")

    w = timers.wall
    other = timed_total - sum(w[k] for k in ("json", "synthesis", "h", "msm_launch", "msm_wait", "combine", "pairings"))
    log(f"phase 10 prove: 2^{exp} constraints ({os.path.getsize(circuit_json)} bytes of circuit JSON, written in "
        f"{t_circuit:.1f} s); params from the port's generator in {t_params:.3f} s ({os.path.getsize(params)} bytes; "
        f"launches {gen_launches}); prove verifies, snarkjs_verify agrees, a changed public input is rejected")
    log(f"  proof wall time {total:.3f} s, again {total_again:.3f} s after the timed run (`prove` as a user runs "
        f"it); K6 launches {launches['lane_dft']}, "
        f"K3 / K4 / K5 launches {launches['bucket_accumulate']} / {launches['bucket_reduce']} / "
        f"{launches['combine_windows']} (K5 launches taking the hot-bucket fold {folds['launches']}, in "
        f"{folds['sets']} of the 4 sets, as K5 counted them: the gate of the default path), the signed kernels "
        f"none")
    log(f"  second run, every part timed ({timed_total:.3f} s; h waits for its device work, which `prove` does "
        f"not): JSON parse {w['json']:.3f} | synthesis {w['synthesis']:.3f} | h (NTTs and glue, to the device's "
        f"end) {w['h']:.3f} | MSM launch {w['msm_launch']:.3f} (of it params decode {w['decode']:.3f}) | MSM wait "
        f"{w['msm_wait']:.3f} | host combination {w['combine']:.3f} | pairings {w['pairings']:.3f} | other (circuit "
        f"from JSON, witness, vk read, files) {other:.3f}; device s (CUDA events): K6 {timers.device_s('ntt'):.3f}, "
        f"K3 + K4 + K5 {timers.device_s('msm'):.3f}")
    assignment = kept["assignment"]
    log(f"  witness (the circuit's assumed mix): {_shares_text(witness_shares(assignment))}")
    dev = torch.device(DEVICE)
    prover._h_coefficients(assignment, dev)  # warm
    h_counts = {}
    out = _profile(lambda: prover._h_coefficients(assignment, dev), {"K6": ("lane_dft",)}, h_counts)
    log(f"  profile _h_coefficients at 2^{exp}: {out}")
    log(f"  h step: {sum(h_counts.values())} device launches (K6 {h_counts['K6']}, glue kernels "
        f"{h_counts['glue kernels']}, copies and sets {h_counts['copies']}); {w['h']:.3f} s in the timed run")
    seeded = _seeded_proof_hash(argv)
    log(f"  proof with r, s from a seeded ChaChaRng (`prove` as a user runs it otherwise): blake2b {seeded}")
    per_kernel = _prover_msm_kernels(card, kept["msm_sets"])
    for r in records:
        if r["name"] in per_kernel:
            r["prove_shape"] = per_kernel[r["name"]]
    return seeded


def _seeded_proof_hash(argv: list[str]) -> str:
    """blake2b of proof.json from `prove` with argv, its r and s drawn from
    ChaChaRng.from_digest_be(SEED) instead of the operating system's
    entropy, so that two trees' proofs can be compared byte for byte."""
    from phase2_bn254_tpu_torch.cli import phase2 as cli2
    from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng

    rng = cli2.participant_rng
    cli2.participant_rng = lambda *a: ChaChaRng.from_digest_be(SEED)
    try:
        cli2.main_prove(argv)
    finally:
        cli2.participant_rng = rng
    return hashlib.blake2b(_read(argv[3])).hexdigest()[:16]


def phase_fixture_proof(workdir: str) -> None:
    """scripts/fixtures' circuit and witness, fixed r and s: the proof on the
    card equals the one of the plain versions on the CPU, byte for byte."""
    from phase2_bn254_tpu_torch.groth16 import prover
    from phase2_bn254_tpu_torch.groth16.source import ParametersSource
    from phase2_bn254_tpu_torch.groth16.verifier import prepare_verifying_key, verify_proof
    from phase2_bn254_tpu_torch.ops.backend import TorchBackend
    from phase2_bn254_tpu_torch.phase2.circom import CircomCircuit, witness_from_json_file

    fixtures = os.path.join(REPO, "scripts", "fixtures")
    circuit_json = os.path.join(fixtures, "circuit.json")
    params = os.path.join(workdir, "fixture.params")
    write_params(circuit_json, params, seed=11, device=DEVICE)
    circuit = CircomCircuit.from_json_file(circuit_json).with_witness(
        witness_from_json_file(os.path.join(fixtures, "witness.json")))
    r, s = 0x0123456789ABCDEF0123456789ABCDEF, 0xFEDCBA9876543210FEDCBA9876543210
    proofs, secs = {}, {}
    for device in (DEVICE, "cpu"):
        t0 = time.time()
        with open(params, "rb") as f:
            proofs[device] = prover.create_proof(prover.prepare_prover(circuit), ParametersSource(f), r, s,
                                                 TorchBackend(device))
        secs[device] = time.time() - t0
    if proofs[DEVICE].write() != proofs["cpu"].write():
        raise AssertionError("fixture proof: the card's bytes differ from the plain versions' on the CPU")
    with open(params, "rb") as f:
        vk = ParametersSource(f).vk
    if not verify_proof(prepare_verifying_key(vk), proofs[DEVICE], circuit.get_public_inputs()):
        raise AssertionError("fixture proof does not verify")
    log(f"phase 11 fixture proof ({circuit.num_constraints} constraints, {circuit.num_inputs} inputs): card == CPU "
        f"plain versions byte for byte ({proofs[DEVICE].write()[:8].hex()}...), verifies; card {secs[DEVICE]:.1f} s, "
        f"CPU {secs['cpu']:.1f} s")
    log(f"  witness: {_shares_text(witness_shares(prover.prepare_prover(circuit)))}")


# ---------------------------------------------------------------------------
# phases 12 and 13: the phase-2 ceremony
# ---------------------------------------------------------------------------

CEREMONY_EXP = 18  # phase 13's domain: phase 10's circuit, an eighth of the reference's design depth 2^21
# the prefix of a captured set the plain S1 and K7 are held to (a segment's
# sum needs its own terms only, a ladder's lane itself)
PLAIN_SCAN_N = 1 << 17


def _windowed_muls(group: str, scalars):
    """Multiplies (N,) k P takes on these scalars by the plain windowed
    ladder (K8 on G1, K9 on G2, csrc/ladders.cuh windowed_ladder_point; on
    "bls_g1" / "bls_g2" K8-BLS / K9-BLS, with BLS12-381's r and field costs),
    as far as this data needs it: k above (r - 1)/2 as (r - k)(-P) (no
    multiplies), the multiples up to each point's largest 4-bit window by a
    doubling and mixed adds, 4 doublings per window after the first nonzero
    one, one add per nonzero window after the first (k = 1 and k = r - 1
    need none)."""
    from phase2_bn254_tpu_torch.ops import batch_exp

    ops = OP_MULS[group]
    win = batch_exp.scalar_windows_msb(batch_exp.half_recode(scalars, _scalar_modulus(group))[0])
    nz = win != 0
    adds = (nz.sum(0) - 1).clamp(min=0)
    return _table_muls(ops, win.amax(0), mixed=True) + _ladder_doublings(nz, 4) * ops["dbl"] + adds * ops["add"]


def _windowed_kernel_muls(group: str, scalars) -> int:
    """Multiplies K8 / K9 do on these scalars: what the ladder needs
    (`_windowed_muls`; the adds of T[0] are skipped and cost none) but the
    table, which the kernels build whole (T[2..15]) where a digit above 1
    occurs: by general adds on G1, by a doubling and mixed adds on G2."""
    import torch
    from phase2_bn254_tpu_torch.ops import batch_exp

    ops = OP_MULS[group]
    top = batch_exp.scalar_windows_msb(batch_exp.half_recode(scalars, _scalar_modulus(group))[0]).amax(0)
    whole = torch.where(top >= 2, torch.full_like(top, 15), top)
    return int((_windowed_muls(group, scalars) - _table_muls(ops, top, mixed=True)
                + _table_muls(ops, whole, mixed=group.endswith("g2"))).sum())


def _scalar_modulus(group: str) -> int:
    """r of the curve of `group` ("g1", "g2": BN254; "bls_g1", "bls_g2")."""
    if group.startswith("bls_"):
        from phase2_bn254_tpu_torch.bls12_381.field import R_MOD
    else:
        from phase2_bn254_tpu_torch.refimpl.field import R_MOD
    return R_MOD


def _k9_kernel_muls(scalars) -> int:
    return _windowed_kernel_muls("g2", scalars)


def _s1_muls(group: str, jac, seg_ids) -> int:
    """Multiplies the segment sums need on these terms: one add for each
    finite term after the first finite term of its segment (N - segments
    adds at most)."""
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.ops import segsum

    starts = segsum.segment_starts(seg_ids)
    fin = (~(FQ if group == "g1" else FQ2).is_zero(jac.z)).long()
    before = fin.cumsum(0) - fin  # finite terms in the lanes before i
    return int(((fin > 0) & (before - before[starts] > 0)).sum()) * OP_MULS[group]["add"]


def _s1_level_adds(fin, seg, threads: int, terms: int):
    """One launch of S1 (csrc/segsum.cu) over entries of finiteness fin
    (bool (n,)) and segments seg (n,): the adds whose two operands are both
    finite (an add with infinity costs none; a partial sum counts as finite
    where any of its terms is), and the next launch's entries, the carries
    (fin, seg), two a tile; None where one tile held them all."""
    import torch

    n, dev = fin.shape[0], fin.device
    idx = torch.arange(n, device=dev)

    def pieces(cut):  # ids of the runs of equal segments cut also where `cut` holds
        new = cut | torch.cat([torch.ones(1, dtype=torch.bool, device=dev), seg[1:] != seg[:-1]])
        gid = new.long().cumsum(0) - 1
        gfin = torch.zeros(int(gid[-1]) + 1, dtype=torch.long, device=dev).index_add_(0, gid, fin.long()) > 0
        return gid, gfin, idx[new]

    # step 1: each thread's run, restarting at segment boundaries
    gid, gfin, first = pieces(idx % terms == 0)
    cum = fin.long().cumsum(0) - fin.long()
    adds = int((fin & (cum - cum[first[gid]] > 0)).sum())
    nruns = -(-n // terms)
    tiles = -(-nruns // threads)
    lo = torch.arange(nruns, device=dev) * terms
    hi = (lo + terms).clamp(max=n)
    head, tail = gid[lo], gid[hi - 1]
    single = head == tail
    prev_same = torch.zeros(nruns, dtype=torch.bool, device=dev)
    prev_same[1:] = seg[lo[1:] - 1] == seg[lo[1:]]
    t_of = torch.arange(nruns, device=dev) % threads
    size = tiles * threads
    v = torch.zeros(size, dtype=torch.bool, device=dev)
    f = torch.ones(size, dtype=torch.bool, device=dev)
    v[:nruns] = gfin[tail]
    f[:nruns] = ~single | (t_of == 0) | ~prev_same
    v, f = v.reshape(tiles, threads), f.reshape(tiles, threads)
    # step 2: the block's scan
    d = 1
    while d < threads:
        pv, pf = torch.zeros_like(v), torch.ones_like(f)
        pv[:, d:], pf[:, d:] = v[:, :-d], f[:, :-d]
        upd = ~f & (torch.arange(threads, device=dev) >= d)
        adds += int((upd & v & pv).sum())
        v, f = torch.where(upd, v | pv, v), torch.where(upd, pf, f)
        d *= 2
    # step 3: a head added to the scanned tail of the thread before it
    scanned = v.reshape(-1)[:nruns]
    before = torch.zeros(nruns, dtype=torch.bool, device=dev)
    before[1:] = scanned[:-1]
    adds += int((~single & (t_of > 0) & prev_same & gfin[head] & before).sum())
    if tiles == 1:
        return adds, None
    # the carries: per tile its first and its last segment's piece
    tsize = threads * terms
    tgid, tfin, _ = pieces(idx % tsize == 0)
    tlo = torch.arange(tiles, device=dev) * tsize
    thi = (tlo + tsize).clamp(max=n)
    cin = torch.zeros(tiles, dtype=torch.bool, device=dev)
    cin[1:] = seg[tlo[1:] - 1] == seg[tlo[1:]]
    cout = torch.zeros(tiles, dtype=torch.bool, device=dev)
    cout[:-1] = seg[thi[:-1]] == seg[thi[:-1] - 1]
    whole = tgid[tlo] == tgid[thi - 1]
    none = torch.full((tiles,), -1, dtype=seg.dtype, device=dev)
    in_seg = torch.where(cin, seg[tlo], none)
    in_fin = cin & tfin[tgid[tlo]]
    out_seg = torch.where(cout, seg[thi - 1], none)
    out_fin = cout & ~(whole & cin) & tfin[tgid[thi - 1]]
    return adds, (torch.stack([in_fin, out_fin], 1).reshape(-1), torch.stack([in_seg, out_seg], 1).reshape(-1))


def _s1_kernel_muls(group: str, jac, seg_ids) -> int:
    """Multiplies S1's launches do on these terms (`_s1_level_adds` over
    each launch, tiles of segsum.THREADS x segsum.TERMS)."""
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.ops import segsum

    fin, seg, adds = ~(FQ if group == "g1" else FQ2).is_zero(jac.z), seg_ids, 0
    while True:
        level, carries = _s1_level_adds(fin, seg, segsum.THREADS, segsum.TERMS)
        adds += level
        if carries is None:
            return adds * OP_MULS[group]["add"]
        fin, seg = carries


def _s1_tile_sweep(jac, seg_ids, n_segments: int) -> dict:
    """S1's ms per call at each tile of S1_TILE_SWEEP, "threads x terms";
    the module's constants are restored after."""
    from phase2_bn254_tpu_torch.ops import segsum

    kept, out = (segsum.THREADS, segsum.TERMS), {}
    try:
        for threads, terms in S1_TILE_SWEEP:
            segsum.THREADS, segsum.TERMS = threads, terms
            out[f"{threads}x{terms}"] = cuda_ms(lambda: segsum.segment_sums(jac, seg_ids, n_segments), 3)
    finally:
        segsum.THREADS, segsum.TERMS = kept
    return out


def _s1_case(group: str, jac, seg_ids, n_segments: int, plain_n: int | None = None) -> dict:
    """S1 on the card over (jac, seg_ids), against its plain version on the
    first plain_n terms (all by default): every segment that lies wholly in
    that prefix, in canonical affine; times, launches and work."""
    import torch
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.ops import segsum

    f = FQ if group == "g1" else FQ2
    n = jac.x.shape[0]
    plain_n = n if plain_n is None else min(plain_n, n)
    before = segsum.LAUNCHES["segment_sums"]
    got, ms = once_ms(lambda: segsum.segment_sums(jac, seg_ids, n_segments))
    launches = segsum.LAUNCHES["segment_sums"] - before
    head = G.JacobianBatch(*(t[:plain_n] for t in jac))
    want, plain_ms = once_ms(lambda: segsum.segment_sums_plain(head, seg_ids[:plain_n], n_segments))
    whole = int(seg_ids[plain_n]) if plain_n < n else n_segments  # segments below it end in the prefix
    ga, wa = (G.jac_normalize(f, G.JacobianBatch(*(t[:whole] for t in s))) for s in (got, want))
    err = max_limb_err(ga[:2], wa[:2])
    if err or not torch.equal(ga.inf, wa.inf):
        raise AssertionError(f"S1 {group}: kernel and plain version differ on the {whole} segments of the first "
                             f"{plain_n} terms (max abs limb error {err} in canonical affine)")
    ms = cuda_ms(lambda: segsum.segment_sums(jac, seg_ids, n_segments), 3)
    return {"ms": ms, "plain_ms": plain_ms, "plain_n": plain_n, "segments_checked": whole, "err": err, "n": n,
            "launches": launches, "work": (nbytes(*jac, seg_ids, *got), _s1_muls(group, jac, seg_ids)),
            "kernel_muls": _s1_kernel_muls(group, jac, seg_ids), "tiles_ms": _s1_tile_sweep(jac, seg_ids, n_segments)}


def _k9_case(x, y, scalars, plain_n: int | None = None) -> dict:
    """K9 on the card, against its plain version on the first plain_n points
    (all by default): limb for limb, times and work."""
    from phase2_bn254_tpu_torch.ops import batch_exp

    n = x.shape[0]
    plain_n = n if plain_n is None else min(plain_n, n)
    got = batch_exp.batch_exp_g2_windowed(x, y, scalars)
    want, plain_ms = once_ms(lambda: batch_exp.batch_exp_g2_windowed_plain(x[:plain_n], y[:plain_n],
                                                                              scalars[:plain_n]))
    err = max_limb_err([t[:plain_n] for t in got], want)
    if err:
        raise AssertionError(f"K9: kernel and plain version differ on the first {plain_n} points "
                             f"(max abs limb error {err})")
    ms = cuda_ms(lambda: batch_exp.batch_exp_g2_windowed(x, y, scalars), 3)
    return {"ms": ms, "plain_ms": plain_ms, "plain_n": plain_n, "err": err, "n": n,
            "work": (nbytes(x, y, scalars, *got), _function_muls("g2", scalars)),
            "ladder_muls": int(_windowed_muls("g2", scalars).sum()),
            "kernel_muls": _k9_kernel_muls(scalars)}


FIXTURE_MIX_N = 1 << 18  # K9 on the fixture's coefficient mix (phase 12)


def _fixture_b_mix() -> dict:
    """{coefficient: count} of the B matrix of scripts/fixtures/circuit.json:
    the scalars its `new` gives K9 (one G2 term per B entry)."""
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    with open(os.path.join(REPO, "scripts", "fixtures", "circuit.json")) as f:
        constraints = json.load(f)["constraints"]
    mix = {}
    for _, b, _ in constraints:
        for v in b.values():
            mix[int(v) % R_MOD] = mix.get(int(v) % R_MOD, 0) + 1
    return mix


def _coefficient_name(v: int) -> str:
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    for name, w in (("", v), ("r - ", R_MOD - v)):
        if w & (w - 1) == 0:
            return f"{name}{w}" if w < 1 << 16 else f"{name}2^{w.bit_length() - 1}"
    return str(v)


def _skewed_terms(group: str, n: int, rng: random.Random):
    """n terms on tiled points: a third of them in segment 1 (the fixture
    circuit's share of B terms on ONE), the rest over segments 3.. with
    every fourth segment id skipped (empty segments, 0 and 2 among them);
    coefficients 1, r - 1, 0 (infinity terms) and random, as circom's are
    mostly +-1. Returns (products on the card: K1 / K9, seg_ids, number of
    segments)."""
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.ops import segsum
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    dev = torch.device(DEVICE)
    pts, _ = _tiled_points(group, n, dev, rng)
    hot = n // 3
    rest = sorted(rng.randrange(3, n // 4) for _ in range(n - hot))
    segs = [1] * hot + [s for s in rest if s % 4]
    segs += [segs[-1]] * (n - len(segs))
    coeffs = [rng.choice((1, 1, R_MOD - 1, 0, rng.randrange(R_MOD))) for _ in range(n)]
    seg_ids = torch.tensor(segs, device=dev)
    jac = segsum.term_products(pts, torch.arange(n, device=dev), convert.ints_to_limbs(coeffs, dev))
    return jac, seg_ids, n // 4


def phase_segsum_kernels(card: Card, records: list[dict], n: int = KERNEL_N) -> None:
    """Phase 12: K9 and S1 against their plain versions on the card."""
    import torch
    from phase2_bn254_tpu_torch import convert

    rng = random.Random(12)
    dev = torch.device(DEVICE)
    pts, _ = _tiled_points("g2", n, dev, rng)
    k = convert.ints_to_limbs(_edge_scalars(n, rng), dev)
    k9 = _k9_case(pts.x, pts.y, k)
    b, by = card.bound(*k9["work"])
    log(f"phase 12 K9 (batch_exp_g2_windowed): N={n} G2 points, edge scalars first: kernel == plain limb for limb; "
        f"kernel {k9['ms']:.3f} ms/call, plain {k9['plain_ms']:.3f} ms, bound {b:.3f} ms ({by}: "
        f"{k9['work'][1] / n:.0f} multiplies/point; this ladder needs {k9['ladder_muls'] / n:.0f}, the "
        f"kernel does {k9['kernel_muls'] / n:.0f})")
    scans = {}
    for group in ("g1", "g2"):
        jac, seg_ids, nseg = _skewed_terms(group, n, rng)
        scans[group] = c = _s1_case(group, jac, seg_ids, nseg)
        if group == "g2":
            c["three_fq"] = _three_fq(_s1_muls, group, jac, seg_ids)
        b, by = card.bound(*c["work"])
        log(f"phase 12 S1 (segment_sums) {group}: N={n} terms over {nseg} segments ({int(torch.bincount(seg_ids).max())} "
            f"in the largest, {nseg - int(seg_ids.unique().numel())} empty), coefficients 1, r-1, 0, random: kernel == "
            f"plain on every segment in canonical affine; kernel {c['ms']:.3f} ms ({c['launches']} launches), plain "
            f"{c['plain_ms']:.3f} ms, bound {b:.3f} ms ({by}: {c['work'][1]} multiplies, {c['work'][0]} bytes; the "
            f"kernel does {c['kernel_muls']}); by tile (threads x terms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in c["tiles_ms"].items()) + " ms")
    mix = _fixture_b_mix()
    pts, _ = _tiled_points("g2", FIXTURE_MIX_N, dev, rng)
    kmix = convert.ints_to_limbs(rng.choices(list(mix), weights=list(mix.values()), k=FIXTURE_MIX_N), dev)
    fixture = _k9_case(pts.x, pts.y, kmix, plain_n=PLAIN_LADDER_N)
    fixture["bound_ms"], fixture["bound_by"] = card.bound(*fixture["work"])
    log(f"phase 12 K9 on a G2 set with the B coefficients of scripts/fixtures/circuit.json ("
        + ", ".join(f"{_coefficient_name(v)}: {c}" for v, c in mix.items()) + f" of {sum(mix.values())}): "
        f"N={FIXTURE_MIX_N}, kernel == plain limb for limb on the first {fixture['plain_n']}; kernel "
        f"{fixture['ms']:.4f} ms, plain {fixture['plain_ms']:.3f} ms ({fixture['plain_n']} points), bound "
        f"{fixture['bound_ms']:.4f} ms ({fixture['bound_by']}: {fixture['work'][1]} multiplies, {fixture['work'][0]} "
        f"bytes; the kernel does {fixture['kernel_muls']})")
    del pts, kmix
    for line in _ptxas_of(("batch_exp_g2_windowed_kernel", "segment_sums_kernel")):
        log(f"  ptxas: {line}")
    records.append(record(card, "batch_exp_g2_windowed", "phase2_bn254_tpu_torch/csrc/batch_exp_g2_windowed.cu",
                          "phase2_bn254_tpu/ops/pallas_exp.py:449", k9["err"], k9["ms"], k9["plain_ms"], k9["work"],
                          shape=f"N={n} G2 points, edge and random scalars", muls=k9["work"][1],
                          ladder_muls=k9["ladder_muls"], kernel_muls=k9["kernel_muls"],
                          fixture_mix={k: fixture[k] for k in ("n", "ms", "plain_ms", "plain_n", "bound_ms",
                                                               "bound_by", "kernel_muls")},
                          **_three_fq_fields(card, k9["work"][0], _three_fq(_function_muls, "g2", k))))
    g2 = scans["g2"]
    b2, by2 = card.bound(*g2["work"])
    records.append(record(card, "segment_sums", "phase2_bn254_tpu_torch/csrc/segsum.cu",
                          "phase2_bn254_tpu/ops/segsum.py:46 (XLA glue, not a Pallas kernel)",
                          max(c["err"] for c in scans.values()), scans["g1"]["ms"], scans["g1"]["plain_ms"],
                          scans["g1"]["work"], shape=f"N={n} G1 terms, a third in one segment; g2 beside",
                          muls=scans["g1"]["work"][1], kernel_muls=scans["g1"]["kernel_muls"],
                          call_launches=scans["g1"]["launches"], tiles_ms=scans["g1"]["tiles_ms"],
                          g2={"ms": g2["ms"], "plain_ms": g2["plain_ms"], "bound_ms": b2, "bound_by": by2,
                              "max_abs_err": g2["err"], "muls": g2["work"][1],
                              "kernel_muls": g2["kernel_muls"], "call_launches": g2["launches"],
                              "tiles_ms": g2["tiles_ms"],
                              **_three_fq_fields(card, g2["work"][0], g2["three_fq"])}))


def radix_secrets(seed: int) -> tuple[int, int, int]:
    """(tau, alpha, beta) drawn from a ChaCha seed."""
    from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
    from phase2_bn254_tpu_torch.refimpl.sampling import rand_fr

    rng = ChaChaRng.from_digest_be(hashlib.blake2b(b"radix" + seed.to_bytes(8, "little")).digest())
    return rand_fr(rng), rand_fr(rng), rand_fr(rng)


RADIX_CHUNK = 1 << 18  # points per ladder call in write_radix


def write_radix(workdir: str, exp: int, seed: int | None = None,
                secrets: tuple[int, int, int] | None = None) -> str:
    """phase1radix2m{exp} in workdir from the secrets (tau, alpha, beta),
    by default those `radix_secrets(seed)` draws, written with the port's
    kernels: the Lagrange coefficients L_i(tau) are
    K6's inverse NTT of the tau powers (as the generator computes them), the
    G1 vectors go through K1 and the G2 one through K2; the layout of
    ceremony/prepare.py:1-13 (alpha G1, beta G1, beta G2; L_i G1; L_i G2;
    alpha L_i G1; beta L_i G1; tau^i (tau^m - 1) G1 for i < m - 1): the file
    prepare_phase2 writes from a response to the initial challenge with these
    secrets. Returns the directory."""
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.field import fp
    from phase2_bn254_tpu_torch.groth16.generator import _batch_mul
    from phase2_bn254_tpu_torch.ops import ntt
    from phase2_bn254_tpu_torch.refimpl import curve as rc
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    tau, alpha, beta = radix_secrets(seed) if secrets is None else secrets
    dev, ctx, m = torch.device(DEVICE), fp.FR_CTX, 1 << exp
    powers = ntt.geometric(tau, exp, dev)
    lag = ntt.ntt(exp, powers, True)

    def times(v, c):  # canonical limbs of v * c, v Montgomery
        return fp.from_mont(ctx, fp.mont_mul(ctx, v, convert.ints_to_limbs([ctx.to_mont_int(c % R_MOD)], dev)[0]))

    def mul(gen, scalars):  # RADIX_CHUNK at a time: a 2^21 G2 encode's temporaries outgrow the card
        return b"".join(_batch_mul(gen, scalars[i : i + RADIX_CHUNK]) for i in range(0, scalars.shape[0], RADIX_CHUNK))

    path = os.path.join(workdir, f"phase1radix2m{exp}")
    with open(path, "wb") as f:
        for p in (rc.G1_GEN.mul(alpha), rc.G1_GEN.mul(beta), rc.G2_GEN.mul(beta)):
            f.write(rc.point_to_bytes(p, False))
        f.write(mul(rc.G1_GEN, times(lag, 1)))
        f.write(mul(rc.G2_GEN, times(lag, 1)))
        f.write(mul(rc.G1_GEN, times(lag, alpha)))
        f.write(mul(rc.G1_GEN, times(lag, beta)))
        f.write(mul(rc.G1_GEN, times(powers[: m - 1], pow(tau, m, R_MOD) - 1)))
    return workdir


def _launch_counts() -> dict:
    from phase2_bn254_tpu_torch.ops import batch_exp, segsum
    from phase2_bn254_tpu_torch.ops import msm as M

    return {"batch_exp_glv_signed": batch_exp.LAUNCHES["batch_exp_glv_signed"],
            "batch_exp_g2_windowed": batch_exp.LAUNCHES["batch_exp_g2_windowed"], **segsum.LAUNCHES, **M.LAUNCHES}


def _zero_counts() -> None:
    from phase2_bn254_tpu_torch.bls12_381 import codecs_device
    from phase2_bn254_tpu_torch.ops import batch_exp, decompress, ntt, segsum
    from phase2_bn254_tpu_torch.ops import msm as M

    for counts in (batch_exp.LAUNCHES, segsum.LAUNCHES, M.LAUNCHES, ntt.LAUNCHES, decompress.LAUNCHES,
                   codecs_device.LAUNCHES):
        for name in counts:
            counts[name] = 0
    M.reset_fold_counts()


def _replace_bytes(src: str, dst: str, offset: int, data: bytes) -> None:
    shutil.copyfile(src, dst)
    with open(dst, "r+b") as f:
        f.seek(offset)
        f.write(data)


def phase_ceremony(card: Card, workdir: str, records: list[dict], exp: int = CEREMONY_EXP) -> dict:
    """Phase 13: the phase-2 ceremony through the port's CLI functions at
    2^exp constraints (phase 10's circuit), the tampered copies, `prove` on
    the result, and K9 / S1 against their plain versions on the sets `new`
    took. Returns each tampered copy's rejection message."""
    import torch
    from phase2_bn254_tpu_torch.cli import phase2 as cli2
    from phase2_bn254_tpu_torch.groth16.source import ParametersSource
    from phase2_bn254_tpu_torch.ops import batch_exp, segsum
    from phase2_bn254_tpu_torch.refimpl import curve as rc

    circuit_json = os.path.join(workdir, f"circuit_{exp}.json")
    witness_json = os.path.join(workdir, f"witness_{exp}.json")
    if not os.path.exists(circuit_json):
        write_circuit(workdir, exp, seed=18)
    radix = os.path.join(workdir, "radix")
    os.makedirs(radix, exist_ok=True)
    t0 = time.time()
    write_radix(radix, exp, seed=13)
    torch.cuda.synchronize()
    t_radix = time.time() - t0
    params = [os.path.join(workdir, f"circom{i}.params") for i in range(4)]
    steps = [
        ("new", lambda: cli2.main_new([circuit_json, params[1], radix, "--device", DEVICE])),
        ("contribute", lambda: cli2.main_contribute([params[1], params[2], "smoke entropy", "--device", DEVICE])),
        ("beacon", lambda: cli2.main_beacon([params[2], "ab" * 32, "10", params[3], "--device", DEVICE])),
        ("verify_contribution 1->2", lambda: cli2.main_verify_contribution([circuit_json, params[1], params[2], radix,
                                                                            "--device", DEVICE])),
        ("verify_contribution 2->3", lambda: cli2.main_verify_contribution([circuit_json, params[2], params[3], radix,
                                                                            "--device", DEVICE])),
    ]
    wall, launches, kept = {}, {}, {}
    tool_log = os.path.join(workdir, "ceremony_tools.log")  # the tools' own output (beacon prints 2^10 lines)
    for name, step in steps:
        _zero_counts()
        timers = _Timers()
        if name == "new":  # keep the sets new's kernels took; the wrappers add no time of their own
            timers.args_of("k1", batch_exp, "batch_exp_glv_signed", kept)
            timers.args_of("k9", batch_exp, "batch_exp_g2_windowed", kept)
            timers.args_of("terms", segsum, "term_products", kept)  # the G1 terms' scalars
            timers.args_of("s1", segsum, "segment_sums", kept)
        try:
            with open(tool_log, "a") as out, contextlib.redirect_stdout(out):
                t0 = time.time()
                step()
                torch.cuda.synchronize()
                wall[name] = time.time() - t0
        finally:
            timers.restore()
        launches[name] = _launch_counts()
    for name in ("new", "verify_contribution 1->2"):
        got = launches[name]
        if not (got["batch_exp_glv_signed"] and got["batch_exp_g2_windowed"] and got["segment_sums"]):
            raise AssertionError(f"{name}: K1, K9 and S1 must all launch: {got}")
    if not all(launches["verify_contribution 1->2"][k] for k in ("bucket_accumulate", "bucket_reduce",
                                                                 "combine_windows")):
        raise AssertionError(f"verify_contribution must launch K3-K5: {launches['verify_contribution 1->2']}")
    for name in ("contribute", "beacon"):
        if launches[name]["batch_exp_glv_signed"] != 2:
            raise AssertionError(f"{name}: want 2 K1 launches (l and h), got {launches[name]}")

    parts = _ceremony_parts(workdir, circuit_json, radix, params, tool_log)

    # tampered copies: one l point replaced by another valid point; delta_g2 changed
    with open(params[3], "rb") as f:
        src = ParametersSource(f)
        l_off, l_n = src.spans["l"][:2]
    index = l_n // 2
    delta_g2_off = 2 * 64 + 2 * 128 + 64  # alpha_g1, beta_g1, beta_g2, gamma_g2, delta_g1
    tampered = {"l": (l_off + 64 * index, rc.point_to_bytes(rc.G1_GEN.mul(424242), False)),
                "delta_g2": (delta_g2_off, rc.point_to_bytes(rc.G2_GEN.mul(77), False))}
    rejected = {}
    for what, (offset, data) in tampered.items():
        bad = os.path.join(workdir, f"circom3_{what}.params")
        _replace_bytes(params[3], bad, offset, data)
        t0 = time.time()
        try:
            with open(tool_log, "a") as out, contextlib.redirect_stdout(out):
                cli2.verify(circuit_json, params[2], bad, radix, DEVICE)
        except ValueError as e:
            rejected[what] = (str(e), time.time() - t0)
        else:
            raise AssertionError(f"verify_contribution accepted the params with a changed {what}")

    # prove on the final parameters, as a user runs it
    proof_json, public_json = os.path.join(workdir, "ceremony_proof.json"), os.path.join(workdir, "ceremony_public.json")
    with open(tool_log, "a") as out, contextlib.redirect_stdout(out):
        t0 = time.time()
        cli2.main_prove([circuit_json, witness_json, params[3], proof_json, public_json, "--device", DEVICE])
        torch.cuda.synchronize()
        wall["prove"] = time.time() - t0

    log(f"phase 13 ceremony at 2^{exp} constraints (phase 10's circuit): radix file from the port's kernels in "
        f"{t_radix:.3f} s ({os.path.getsize(os.path.join(radix, f'phase1radix2m{exp}'))} bytes); new -> contribute -> "
        f"beacon (2^10) -> verify_contribution twice pass; prove on the result verifies")
    log("  wall s (each tool as a user runs it): " + " | ".join(f"{k} {v:.3f}" for k, v in wall.items())
        + f"; .params {os.path.getsize(params[3])} bytes")
    log(f"  new's .params blake2b {hashlib.blake2b(_read(params[1])).hexdigest()[:16]}, the radix file's "
        f"{hashlib.blake2b(_read(os.path.join(radix, f'phase1radix2m{exp}'))).hexdigest()[:16]}")
    for name in ("new", "contribute", "beacon", "verify_contribution 1->2"):
        log(f"  launches {name}: " + ", ".join(f"{k} {v}" for k, v in launches[name].items() if v))
    for tool, split in parts.items():
        log(f"  {tool} again, every part timed: " + " | ".join(f"{k} {v:.3f}" for k, v in split.items()))
    for what, (msg, secs) in rejected.items():
        log(f"  a copy with a changed {what} is rejected: {msg!r} ({secs:.1f} s)")

    # K1, K9 and S1 on the sets new took
    (x, y, d1, d2), = kept["k1"]
    coeffs, = (a[2] for a in kept["terms"] if a[0].x.dim() == 2)
    k1_ms = cuda_ms(lambda: batch_exp.batch_exp_glv_signed(x, y, d1, d2), 3)
    k1_need, k1_own = _function_muls("g1", coeffs), int(_k1_muls(d1, d2).sum())
    k1_does = _k1_kernel_muls(d1, d2)
    k1_bound, k1_by = card.bound(nbytes(x, y, d1, d2) + 3 * nbytes(x), k1_need)
    k1 = {"n": x.shape[0], "ms": k1_ms, "bound_ms": k1_bound, "bound_by": k1_by, "muls": k1_need,
          "ladder_muls": k1_own, "kernel_muls": k1_does}
    log(f"  K1 on new's G1 terms: N={x.shape[0]}, kernel {k1_ms:.3f} ms, bound {k1_bound:.3f} ms ({k1_by}: {k1_need} "
        f"multiplies; this ladder needs {k1_own}, the kernel does {k1_does}; K1 was held to its plain version in "
        f"phase 2)")
    (x, y, k), = kept["k9"]
    k9 = _k9_case(x, y, k, plain_n=KERNEL_N)
    b, by = card.bound(*k9["work"])
    log(f"  K9 on new's G2 terms: N={k9['n']}, kernel == plain limb for limb on the first {k9['plain_n']}; kernel "
        f"{k9['ms']:.3f} ms, plain {k9['plain_ms']:.3f} ms ({k9['plain_n']} points), bound {b:.3f} ms ({by}: "
        f"{k9['work'][1]} multiplies; this ladder needs {k9['ladder_muls']}, the kernel does "
        f"{k9['kernel_muls']})")
    per = {}
    for jac, seg_ids, nseg in kept["s1"]:
        group = "g1" if jac.x.dim() == 2 else "g2"
        c = _s1_case(group, jac, seg_ids, nseg, plain_n=PLAIN_SCAN_N)
        b, by = card.bound(*c["work"])
        per[group] = {"ms": c["ms"], "plain_ms": c["plain_ms"], "plain_n": c["plain_n"], "n": c["n"],
                      "segments": nseg, "segments_checked": c["segments_checked"], "launches": c["launches"],
                      "bound_ms": b, "bound_by": by, "muls": c["work"][1], "kernel_muls": c["kernel_muls"],
                      "tiles_ms": c["tiles_ms"]}
        log(f"  S1 on new's {group} set: N={c['n']} terms over {nseg} segments ({c['launches']} launches), kernel == "
            f"plain in canonical affine on the {c['segments_checked']} segments of the first {c['plain_n']} terms; "
            f"kernel {c['ms']:.3f} ms, plain {c['plain_ms']:.3f} ms ({c['plain_n']} terms), bound {b:.3f} ms ({by}: "
            f"{c['work'][1]} multiplies, {c['work'][0]} bytes; the kernel does {c['kernel_muls']}); by tile: "
            + ", ".join(f"{k} {v:.4f}" for k, v in c["tiles_ms"].items()) + " ms")
    del kept
    for r in records:
        if r["name"] == "batch_exp_g2_windowed":
            r["launches"] = launches["new"]["batch_exp_g2_windowed"]
            r["new_shape"] = {"n": k9["n"], "ms": k9["ms"], "bound_ms": card.bound(*k9["work"])[0],
                              "plain_ms": k9["plain_ms"], "plain_n": k9["plain_n"], "muls": k9["work"][1],
                              "ladder_muls": k9["ladder_muls"],
                              "kernel_muls": k9["kernel_muls"]}
        elif r["name"] == "batch_exp_glv_signed":
            r["new_shape"] = k1
        elif r["name"] == "segment_sums":
            r["launches"] = launches["new"]["segment_sums"]
            r["new_shape"] = per
        if r["name"] in ("batch_exp_glv_signed", "bucket_accumulate", "bucket_reduce", "combine_windows",
                         "batch_exp_g2_windowed", "segment_sums"):
            r["ceremony_launches"] = {k: launches[k][r["name"]] for k in ("new", "contribute",
                                                                          "verify_contribution 1->2")}
    return {what: msg for what, (msg, _) in rejected.items()}


def _ceremony_parts(workdir: str, circuit_json: str, radix: str, params: list[str], tool_log: str) -> dict:
    """`new` and `verify_contribution` once more each, every part timed
    (host clock; the device parts up to the end of their device work). The
    parts do not overlap: `new`'s circuit parse (from_json) runs after its
    JSON parse; `verify_contribution`'s second `new` calls none of the
    checks timed beside it."""
    import torch
    from phase2_bn254_tpu_torch.cli import phase2 as cli2
    from phase2_bn254_tpu_torch.ops import segsum
    from phase2_bn254_tpu_torch.ops.backend import TorchBackend
    from phase2_bn254_tpu_torch.phase2 import circom, mpc

    out = {}
    runs = {"new": (lambda: cli2.new(circuit_json, os.path.join(workdir, "circom_parts.params"), radix, DEVICE),
                    (("JSON parse", circom.json, "load", False), ("circuit from JSON", circom.CircomCircuit,
                                                                  "from_json", False),
                     ("synthesis", circom.CircomCircuit, "synthesize", False), ("radix decode", mpc, "_read_radix", True),
                     ("term arrays", mpc, "_qap_terms", False), ("K1 / K9 + S1", segsum, "segmented_msm", True),
                     ("params encode (for cs_hash, for the file)", mpc.DeviceParameters, "write", False))),
            "verify_contribution": (lambda: cli2.verify(circuit_json, params[1], params[2], radix, DEVICE),
                                    (("params read", cli2, "_load_mpc", True), ("new", mpc.MPCParameters, "new", True),
                                     ("merge_pairs MSMs", TorchBackend, "merge_pairs", True),
                                     ("query comparisons", mpc, "_check_invariants", True),
                                     ("host pairings", mpc, "same_ratio", False)))}
    for tool, (run, parts) in runs.items():
        timers = _Timers()
        for key, owner, attr, sync in parts:
            timers.wall_of(key, owner, attr, sync)
        try:
            with open(tool_log, "a") as f, contextlib.redirect_stdout(f):
                t0 = time.time()
                run()
                torch.cuda.synchronize()
                total = time.time() - t0
        finally:
            timers.restore()
        split = dict(timers.wall)
        out[tool] = {"total": total, **split, "other": total - sum(split.values())}
    return out


def _fixture_ceremony_bytes(radix: str, device: str) -> bytes:
    """scripts/fixtures' circuit: `new` on the radix file in `radix`, then
    `contribute` with the fixed ChaCha seed, on `device`; the .params bytes."""
    from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
    from phase2_bn254_tpu_torch.ops.backend import TorchBackend
    from phase2_bn254_tpu_torch.phase2.circom import CircomCircuit
    from phase2_bn254_tpu_torch.phase2.mpc import MPCParameters

    circuit = CircomCircuit.from_json_file(os.path.join(REPO, "scripts", "fixtures", "circuit.json"))
    be = TorchBackend(device)
    mp = MPCParameters.new(circuit, False, lambda e: os.path.join(radix, f"phase1radix2m{e}"), be)
    mp.contribute(ChaChaRng.from_digest_be(SEED), be)
    return mp.write()


def phase_fixture_ceremony(workdir: str) -> None:
    """Phase 13's last check: scripts/fixtures' circuit, `new` and
    `contribute` with a fixed ChaCha seed on the card and with the plain
    versions on the CPU give the same bytes (a radix file from the port's
    kernels). It runs after every timed phase: the CPU half takes minutes."""
    from phase2_bn254_tpu_torch.phase2.circom import CircomCircuit

    circuit = CircomCircuit.from_json_file(os.path.join(REPO, "scripts", "fixtures", "circuit.json"))
    exp = (circuit.num_constraints + circuit.num_inputs - 1).bit_length()  # new adds one per input
    radix = os.path.join(workdir, "fixture_radix")
    os.makedirs(radix, exist_ok=True)
    write_radix(radix, exp, seed=9)
    t0 = time.time()
    card = _fixture_ceremony_bytes(radix, DEVICE)
    t_card = time.time() - t0
    t0 = time.time()
    cpu = _fixture_ceremony_bytes(radix, "cpu")
    t_cpu = time.time() - t0
    if card != cpu:
        raise AssertionError("fixture ceremony: the card's new + contribute differ from the plain versions' on the CPU")
    log(f"phase 13 fixture ceremony ({circuit.num_constraints} constraints, domain 2^{exp}): new + contribute on the "
        f"card == plain versions on the CPU byte for byte ({len(cpu)} bytes, blake2b "
        f"{hashlib.blake2b(cpu).hexdigest()[:16]}); card {t_card:.1f} s, CPU {t_cpu:.1f} s")


# ---------------------------------------------------------------------------
# phases 14 and 15: the other ladder configurations
# ---------------------------------------------------------------------------

PLAIN_LADDER_N = 1 << 14  # the prefix of phase 14's lanes the plain K7, K8, K10 are held to
# phase 15's contributions: phase 5's size (21), held to phase 5's response
# hash; a smaller size holds them to the default ladders' response of that
# size, made in the phase (the cut to make if the smoke outgrows its 1,200 s)
CONFIG_SIZE = 21
LADDER_VARIABLES = ("PHASE2_TPU_NO_GLV", "PHASE2_TPU_NO_GLS", "PHASE2_TPU_NO_SIGNED5")


def _k7_muls(d1, d2, negs, group: str = "g1"):
    """Multiplies (N,) k P takes on these unsigned GLV windows by K7's
    ladder (K7-BLS's with group "bls_g1"), as far as this data needs it:
    the multiples up to each point's largest digit by a doubling and mixed
    adds (with their beta x where d2 has a nonzero digit), 4 doublings per
    window after the first nonzero one, one add per nonzero digit after the
    first; the signs cost none."""
    ops = OP_MULS[group]
    nz1, nz2 = d1 != 0, d2 != 0
    top = d1.amax(0).maximum(d2.amax(0))
    adds = (nz1.sum(0) + nz2.sum(0) - 1).clamp(min=0)
    return (_table_muls(ops, top, mixed=True) + top * nz2.any(0) * _fq_product(group)
            + _ladder_doublings(nz1 | nz2, 4) * ops["dbl"] + adds * ops["add"])


def _whole_table_muls(ops: dict, top):
    """Multiplies (N,) of K7's and K10's tables: T[2..15] whole by a
    doubling and 13 mixed adds where a digit above 1 occurs, none else."""
    return (top >= 2) * (ops["dbl"] + 13 * ops["madd"])


def _k7_kernel_muls(d1, d2, negs, group: str = "g1") -> int:
    """Multiplies K7 (csrc/batch_exp_glv.cu; K7-BLS with group "bls_g1")
    does on these digits: the table (`_whole_table_muls`), beta x of each
    distinct nonzero digit of d2, 4 doublings per window after each point's
    first nonzero one, one add per nonzero digit after the first (an add
    into infinity, and one of T[0] into infinity, costs none; an add of T[0]
    into a finite point is not made)."""
    ops = OP_MULS[group]
    nz1, nz2 = d1 != 0, d2 != 0
    top = d1.amax(0).maximum(d2.amax(0))
    beta = sum((d2 == j).any(0).long() for j in range(1, 16)) * _fq_product(group)
    adds = (nz1.sum(0) + nz2.sum(0) - 1).clamp(min=0)
    return int((_whole_table_muls(ops, top) + beta + _ladder_doublings(nz1 | nz2, 4) * ops["dbl"]
                + adds * ops["add"]).sum())


def _k8_kernel_muls(scalars) -> int:
    return _windowed_kernel_muls("g1", scalars)


def _k10_muls(digits, negs):
    """Multiplies (N,) k Q takes on these unsigned GLS windows (4, W, N) by
    K10's ladder, as far as this data needs it: the multiples up to each
    point's largest digit by a doubling and mixed adds, psi, psi^2, psi^3
    (`_psi_muls`) of each nonzero digit of parts 1, 2, 3, 4 doublings per
    window after the first nonzero one, one add per nonzero digit after the
    first."""
    ops = OP_MULS["g2"]
    nz = digits != 0
    adds = (nz.sum((0, 1)) - 1).clamp(min=0)
    return (_table_muls(ops, digits.amax((0, 1)), mixed=True) + _psi_muls(nz)
            + _ladder_doublings(nz.any(0), 4) * ops["dbl"] + adds * ops["add"])


def _k10_kernel_muls(digits, negs) -> int:
    """Multiplies K10 (csrc/batch_exp_gls.cu) does: the table
    (`_whole_table_muls`); psi, psi^2, psi^3 of each nonzero digit of parts
    1, 2, 3 and of the zero digits it gathers while the accumulator is at
    infinity (those of the point's first window before its first nonzero
    row; all three rows of the last window for a point without one); 4
    doublings per window after each point's first nonzero one; one add per
    nonzero digit after the first."""
    import torch

    ops = OP_MULS["g2"]
    _, nw, n = digits.shape
    nz = digits != 0
    live = nz.any(0)
    first = torch.where(live.any(0), live.int().argmax(0), nw - 1)
    at_first = nz[:, first, torch.arange(n, device=digits.device)]  # (4, N)
    lead = torch.where(at_first.any(0), at_first.int().argmax(0), 4)  # rows before the first nonzero one
    rows = torch.arange(4, device=digits.device)[:, None]
    adds = (nz.sum((0, 1)) - 1).clamp(min=0)
    return int((_whole_table_muls(ops, digits.amax((0, 1))) + _psi_muls(nz) + _psi_muls((rows < lead)[:, None])
                + _ladder_doublings(live, 4) * ops["dbl"] + adds * ops["add"]).sum())


# wrapper name -> (tag, group, the module whose `decompose` splits its scalars
# (None: it takes them whole), its ladder's multiplies, its kernel's, source,
# the TPU kernel it replaces)
LADDER_CASES = {
    "batch_exp_glv": ("K7", "g1", "glv", _k7_muls, _k7_kernel_muls,
                      "phase2_bn254_tpu_torch/csrc/batch_exp_glv.cu", "phase2_bn254_tpu/ops/pallas_exp.py:571"),
    "batch_exp_g1_windowed": ("K8", "g1", None, lambda k: _windowed_muls("g1", k), _k8_kernel_muls,
                              "phase2_bn254_tpu_torch/csrc/batch_exp_g1_windowed.cu",
                              "phase2_bn254_tpu/ops/pallas_exp.py:358"),
    "batch_exp_gls": ("K10", "g2", "gls", _k10_muls, _k10_kernel_muls,
                      "phase2_bn254_tpu_torch/csrc/batch_exp_gls.cu", "phase2_bn254_tpu/ops/pallas_exp.py:933"),
}


def _ladder_case(name: str, x, y, k, plain_n: int, reps: int, cases=None) -> dict:
    """One of K7, K8, K10 (LADDER_CASES; or of `cases`, which have its form:
    BLS_LADDERS) on points x, y and canonical scalars k: the kernel against
    its plain version on the first plain_n lanes (a lane's split is its
    own), limb for limb; time per call; the work."""
    from phase2_bn254_tpu_torch.bls12_381 import device as bls
    from phase2_bn254_tpu_torch.ops import batch_exp, gls, glv

    tag, group, split, muls, kernel_muls, _, _ = (cases or LADDER_CASES)[name]
    split = {"glv": glv.decompose, "gls": gls.decompose, "bls_glv": bls.decompose_glv_t,
             "bls_glv_signed": bls.decompose_glv_signed_t}.get(split, lambda k: (k,))
    kernel, plain = getattr(batch_exp, name), getattr(batch_exp, name + "_plain")
    n, pn = x.shape[0], min(plain_n, x.shape[0])
    inputs = split(k)
    got = kernel(x, y, *inputs)
    want, plain_ms = once_ms(lambda: plain(x[:pn], y[:pn], *split(k[:pn])))
    err = max_limb_err([t[:pn] for t in got], want)
    if err:
        raise AssertionError(f"{tag} {name}: kernel and plain version differ on the first {pn} lanes "
                             f"(max abs limb error {err})")
    out = {"tag": tag, "group": group, "n": n, "plain_n": pn, "err": err, "plain_ms": plain_ms,
           "ms": cuda_ms(lambda: kernel(x, y, *inputs), reps),
           "work": (nbytes(x, y, *inputs, *got), _function_muls(group, k)),
           "ladder_muls": int(muls(*inputs).sum()), "kernel_muls": kernel_muls(*inputs)}
    if group == "g2":
        out["three_fq"] = _three_fq(_function_muls, group, k)
    return out


def _ladder_log(c: dict, bound_ms: float, bound_by: str) -> str:
    need, n = c["work"][1], c["n"]
    return (f"kernel == plain limb for limb on the first {c['plain_n']} lanes; kernel {c['ms']:.3f} ms/call, plain "
            f"{c['plain_ms']:.3f} ms ({c['plain_n']} lanes), bound {bound_ms:.3f} ms ({bound_by}: {need / n:.0f} "
            f"multiplies/point; this ladder needs {c['ladder_muls'] / n:.0f}, the kernel does "
            f"{c['kernel_muls'] / n:.0f})")


def phase_ladder_kernels(card: Card, records: list[dict], n: int = KERNEL_N) -> None:
    """Phase 14: K7, K8 and K10 against their plain versions on the card."""
    import torch
    from phase2_bn254_tpu_torch import convert

    dev = torch.device(DEVICE)
    rng = random.Random(14)
    for name, (tag, group, _, _, _, source, replaces) in LADDER_CASES.items():
        pts, _ = _tiled_points(group, n, dev, rng)
        k = convert.ints_to_limbs(_edge_scalars(n, rng), dev)
        c = _ladder_case(name, pts.x, pts.y, k, PLAIN_LADDER_N, 5)
        rec = record(card, name, source, replaces, c["err"], c["ms"], c["plain_ms"], c["work"],
                     shape=f"N={n} {group.upper()} points, edge and random scalars", plain_n=c["plain_n"],
                     muls=c["work"][1], ladder_muls=c["ladder_muls"],
                     kernel_muls=c["kernel_muls"],
                     **(_three_fq_fields(card, c["work"][0], c["three_fq"]) if "three_fq" in c else {}))
        log(f"phase 14 {tag} ({name}): N={n}, edge scalars first: " + _ladder_log(c, rec["bound_ms"], rec["bound_by"]))
        records.append(rec)
    for line in _ptxas_of(("batch_exp_glv_kernel", "batch_exp_g1_windowed_kernel", "batch_exp_gls_kernel")):
        log(f"  ptxas: {line}")


@contextlib.contextmanager
def _ladder_env(names):
    """The ladder variables (PHASE2_TPU_NO_*) named set to 1, the others
    unset, for the duration."""
    saved = {v: os.environ.pop(v, None) for v in LADDER_VARIABLES}
    os.environ.update({f"PHASE2_TPU_NO_{v}": "1" for v in names})
    try:
        yield
    finally:
        for v, value in saved.items():
            os.environ.pop(v, None)
            if value is not None:
                os.environ[v] = value


def phase_configurations(card: Card, workdir: str, records: list[dict], response_hash: bytes,
                         size: int = CONFIG_SIZE, batch: int = SMOKE_BATCH, exp: int = CEREMONY_EXP) -> None:
    """Phase 15: a contribution (phase 5's at SMOKE_SIZE, whose hash is
    response_hash; at a smaller size the default ladders' response of that
    size, made here first) and phase 13's `new` under the JAX package's
    other ladder switches, through the CLI functions, and K7 against its
    plain version on the set `new` took."""
    import torch
    from phase2_bn254_tpu_torch.ceremony.params import CeremonyParams
    from phase2_bn254_tpu_torch.cli import phase1
    from phase2_bn254_tpu_torch.cli import phase2 as cli2
    from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
    from phase2_bn254_tpu_torch.crypto.hashing import calculate_hash
    from phase2_bn254_tpu_torch.ops import batch_exp, segsum

    params = CeremonyParams(size, batch)
    if size != SMOKE_SIZE:
        with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
            response_hash = calculate_hash(_torch_response(workdir, size, batch))
    configs = {"NO_SIGNED5": (("SIGNED5",), "batch_exp_glv", "batch_exp_gls"),
               "NO_GLV + NO_GLS": (("GLV", "GLS"), "batch_exp_g1_windowed", "batch_exp_g2_windowed")}
    launches = {}
    for label, (names, g1, g2) in configs.items():
        response = os.path.join(workdir, f"response_{size}_config")
        _zero_counts()
        timers = _Timers()
        for name in batch_exp.LAUNCHES:
            timers.device_of(name, batch_exp, name)
        try:
            with _ladder_env(names):
                t0 = time.time()
                got = phase1.compute_constrained(_challenge(workdir, size, batch), response, size, batch,
                                                 ChaChaRng.from_digest_be(SEED), DEVICE)
                torch.cuda.synchronize()
                wall = time.time() - t0
        finally:
            timers.restore()
        os.remove(response)
        launches[label] = dict(batch_exp.LAUNCHES)
        want = _chunk_launches(params, g1, g2)
        if launches[label] != want:
            raise AssertionError(f"PHASE2_TPU_{label}: kernel launches {launches[label]}, want {want}")
        if got != response_hash:
            raise AssertionError(f"PHASE2_TPU_{label}: response hash {got.hex()[:16]} differs from the default "
                                 f"ladders' {response_hash.hex()[:16]}")
        device = {name: timers.device_s(name) for name in (g1, g2)}
        log(f"phase 15 PHASE2_TPU_{label}: size {size} batch {batch} response == the default ladders' (blake2b "
            f"{got.hex()[:16]}); {g1} launches {want[g1]}, {g2} launches {want[g2]}, the default ladders none; "
            f"wall {wall:.3f} s, ladder kernels {sum(device.values()):.3f} s device (CUDA events): "
            + ", ".join(f"{k} {1e3 * v / want[k]:.3f} ms a launch" for k, v in device.items()))
        for r in records:
            if r["name"] in (g1, g2):
                r.setdefault("launches_by_path", {})[f"compute_constrained size {size}, PHASE2_TPU_{label}"] = \
                    want[r["name"]]
                r["contribute_wall_s"] = wall
                r["contribute_ms_per_launch"] = 1e3 * device[r["name"]] / want[r["name"]]

    circuit_json = os.path.join(workdir, f"circuit_{exp}.json")
    out = os.path.join(workdir, "circom1_no_signed5.params")
    _zero_counts()
    timers, kept = _Timers(), {}
    timers.args_of("k7", batch_exp, "batch_exp_glv", kept)  # the wrappers add no time of their own
    timers.args_of("terms", segsum, "term_products", kept)  # the G1 terms' scalars
    try:
        with _ladder_env(("SIGNED5",)), open(os.path.join(workdir, "ceremony_tools.log"), "a") as f, \
                contextlib.redirect_stdout(f):
            t0 = time.time()
            cli2.main_new([circuit_json, out, os.path.join(workdir, "radix"), "--device", DEVICE])
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        timers.restore()
    got = dict(batch_exp.LAUNCHES)
    if not (got["batch_exp_glv"] == 1 and got["batch_exp_glv_signed"] == 0 and got["batch_exp_g2_windowed"] == 1):
        raise AssertionError(f"new under PHASE2_TPU_NO_SIGNED5: want one K7 and one K9 launch and no K1, got {got}")
    if _read(out) != _read(os.path.join(workdir, "circom1.params")):
        raise AssertionError("new under PHASE2_TPU_NO_SIGNED5 differs from phase 13's .params")
    log(f"phase 15 new at 2^{exp} constraints under PHASE2_TPU_NO_SIGNED5: .params == phase 13's "
        f"({os.path.getsize(out)} bytes); K7 launches 1, K1 0, K9 1; wall {wall:.3f} s")
    (x, y, *_), = kept["k7"]
    coeffs, = (a[2] for a in kept["terms"] if a[0].x.dim() == 2)
    del kept
    c = _ladder_case("batch_exp_glv", x, y, coeffs, PLAIN_SCAN_N, 3)
    b, by = card.bound(*c["work"])
    log(f"  K7 on new's G1 terms: N={c['n']}, " + _ladder_log(c, b, by))
    for r in records:
        if r["name"] == "batch_exp_glv":
            r["launches_by_path"][f"new 2^{exp}, PHASE2_TPU_NO_SIGNED5"] = got["batch_exp_glv"]
            r["new_wall_s"] = wall
            r["new_shape"] = {"n": c["n"], "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                              "plain_n": c["plain_n"], "bound_ms": b, "bound_by": by, "muls": c["work"][1],
                              "ladder_muls": c["ladder_muls"],
                              "kernel_muls": c["kernel_muls"]}
        if r["name"] in ("batch_exp_glv", "batch_exp_gls", "batch_exp_g1_windowed"):
            r["launches"] = sum(r["launches_by_path"].values())


# ---------------------------------------------------------------------------
# phase 16: the BLS12-381 engine
# ---------------------------------------------------------------------------

BLS_N = 1 << 16  # points of each group through phase 16's kernels and slice (KERNEL_N)
PLAIN_BLS_N = 1 << 12  # the prefix of phase 16's lanes the plain ladders are held to
BLS_SAMPLE = 64  # lanes of the slice held to the host chain, spread over the batch
# the ladders at BLS12-381 width, in LADDER_CASES' form: wrapper name ->
# (tag, group ("bls_g1", "bls_g2"), its split (`_ladder_case`; None: the
# scalars whole), its ladder's multiplies, its kernel's, source, the TPU
# kernel the JAX package runs at this width)
BLS_LADDERS = {
    "batch_exp_bls_g1_windowed": ("K8-BLS", "bls_g1", None, lambda k: _windowed_muls("bls_g1", k),
                                  lambda k: _windowed_kernel_muls("bls_g1", k),
                                  "phase2_bn254_tpu_torch/csrc/batch_exp_g1_windowed.cu",
                                  "phase2_bn254_tpu/ops/pallas_exp.py:358"),
    "batch_exp_bls_glv": ("K7-BLS", "bls_g1", "bls_glv", lambda *d: _k7_muls(*d, "bls_g1"),
                          lambda *d: _k7_kernel_muls(*d, "bls_g1"), "phase2_bn254_tpu_torch/csrc/batch_exp_glv.cu",
                          "phase2_bn254_tpu/ops/pallas_exp.py:571"),
    "batch_exp_bls_glv_signed": ("K1-BLS", "bls_g1", "bls_glv_signed", lambda *d: _k1_muls(*d, "bls_g1"),
                                 lambda *d: _k1_kernel_muls(*d, "bls_g1"),
                                 "phase2_bn254_tpu_torch/csrc/batch_exp_g1.cu",
                                 "phase2_bn254_tpu/ops/pallas_exp.py:728"),
    "batch_exp_bls_g2_windowed": ("K9-BLS", "bls_g2", None, lambda k: _windowed_muls("bls_g2", k),
                                  lambda k: _windowed_kernel_muls("bls_g2", k),
                                  "phase2_bn254_tpu_torch/csrc/batch_exp_g2_windowed.cu",
                                  "phase2_bn254_tpu/ops/pallas_exp.py:449"),
}


def _bls_edge_scalars(n: int, rng: random.Random) -> list[int]:
    """The windowed ladder's edges over BLS12-381's r, the GLV split's
    (LAMBDA, r - LAMBDA, the basis' long entries: the Barrett rounding's
    turns), then uniform scalars."""
    from phase2_bn254_tpu_torch.bls12_381 import glv
    from phase2_bn254_tpu_torch.bls12_381.field import R_MOD

    edge = [0, 1, 2, 15, 16, (R_MOD - 1) // 2, (R_MOD + 1) // 2, R_MOD - 2, R_MOD - 1, R_MOD - 16, 1 << 64,
            1 << 253, 1 << 254, (1 << 254) + 1, 16 ** 63 + 15, glv.LAMBDA, R_MOD - glv.LAMBDA, glv._B1, glv._A2,
            (1 << 128) - 1]
    return edge + [rng.randrange(R_MOD) for _ in range(n - len(edge))]


def _bls_points(group: str, n: int, rng: random.Random, distinct: int = 64):
    """n points, `distinct` random multiples m_j G tiled; an AffineBatch on
    the card."""
    import torch
    from phase2_bn254_tpu_torch.bls12_381 import curve as hc
    from phase2_bn254_tpu_torch.bls12_381 import device as D
    from phase2_bn254_tpu_torch.bls12_381.field import R_MOD

    gen = hc.G1_GEN if group == "g1" else hc.G2_GEN
    base = D.points_to_batch([gen.mul(rng.randrange(1, R_MOD)) for _ in range(distinct)], group, DEVICE)
    reps = -(-n // distinct)
    return type(base)(*(t.repeat((reps,) + (1,) * (t.dim() - 1))[:n].contiguous() for t in base))


def _bls_field() -> None:
    """BLS12-381's Fq / Fq2 field code (csrc/fieldops.cu: the 12-limb PTX)
    against field/fp.py / fq2.py on FIELD_N pairs, the edge operands first."""
    from phase2_bn254_tpu_torch.ops import fieldops

    rng = random.Random(16)
    for field in ("bls_fq", "bls_fq2"):
        pairs = fieldops.edge_pairs_fq2(rng, field) if fieldops.is_fq2(field) else fieldops.edge_pairs(field, rng)
        edge = len(pairs)
        pairs += [(fieldops.random_element(field, rng), fieldops.random_element(field, rng))
                  for _ in range(FIELD_N - edge)]
        a, b = (fieldops.to_limbs([pair[k] for pair in pairs], field, DEVICE) for k in (0, 1))
        got = fieldops.field_ops(a, b, field)
        err = max_limb_err(got, fieldops.field_ops_plain(a, b, field))
        if err:
            raise AssertionError(f"field code {field}: the kernel and its plain version differ (max abs limb error "
                                 f"{err})")
        ms = cuda_ms(lambda: fieldops.field_ops(a, b, field), 5)
        log(f"phase 16 field {field}: {FIELD_N} pairs ({edge} edge pairs first): a b, a^2, a + b, a - b == "
            f"field/{'fq2' if fieldops.is_fq2(field) else 'fp'}.py limb for limb; {ms:.4f} ms a launch")


def _bls_raw(group: str, rng: random.Random) -> bytes:
    """Compressed zcash encodings of BLS_N distinct points: 64 host multiples
    of G tiled, times random scalars on the card (K8-BLS / K9-BLS, before
    any counted run), encoded."""
    from phase2_bn254_tpu_torch.bls12_381 import codecs_device as C
    from phase2_bn254_tpu_torch.bls12_381 import device as D

    base = _bls_points(group, BLS_N, rng)
    spread = D.scalars_to_canon([rng.randrange(1, 1 << 64) for _ in range(BLS_N)], DEVICE)
    return C.encode_batch(D.mul_batch(base, spread, group), group, True)


def _bls_non_residue(group: str, rng: random.Random):
    """An x (int, or Fq2) of the group's field with no point on the curve."""
    from phase2_bn254_tpu_torch.bls12_381 import curve as hc
    from phase2_bn254_tpu_torch.bls12_381.field import Fq2, Q

    while True:
        x = rng.randrange(Q) if group == "g1" else Fq2(rng.randrange(Q), rng.randrange(Q))
        if hc.get_point_from_x(x, False, group) is None:
            return x


def _bls_d1_case(card: Card, group: str, raw: bytes, rng: random.Random) -> dict:
    """D1-BLS against its plain version (`_g1_decompress` / `_g2_decompress`)
    on the same x: those of raw's BLS_N encodings, the first NONRESIDUES
    replaced by x values without a point; limbs and valid flags equal, the
    flags false exactly there; time per call, plain time, work and bound."""
    import numpy as np
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.bls12_381 import codecs_device as C

    size = 48 if group == "g1" else 96
    b = np.frombuffer(raw, dtype=np.uint8).reshape(BLS_N, size).copy()
    greatest = torch.tensor((b[:, 0] & 0x20) != 0, device=DEVICE)
    b[:, 0] &= 0x1F
    cols = [C.be_bytes_to_digits(np.ascontiguousarray(b[:, j : j + 48])).astype(np.int64) for j in range(0, size, 48)]
    x = torch.from_numpy(cols[0] if group == "g1" else np.stack([cols[1], cols[0]], axis=1)).to(DEVICE)
    bad = [_bls_non_residue(group, rng) for _ in range(NONRESIDUES)]
    if group == "g1":
        x[:NONRESIDUES] = convert.ints_to_limbs(bad, DEVICE, C.NL)
    else:
        for c, part in enumerate(("c0", "c1")):
            x[:NONRESIDUES, c] = convert.ints_to_limbs([getattr(v, part) for v in bad], DEVICE, C.NL)
    x = x.contiguous()
    got, valid = C.decompress(x, greatest, group)
    (want, want_valid), plain_ms = once_ms(lambda: C.decompress_plain(x, greatest, group))
    err = max_limb_err(got[:2], want[:2])
    if err or not torch.equal(valid, want_valid):
        raise AssertionError(f"D1-BLS {group}: kernel and plain version differ (max abs limb error {err})")
    if not torch.equal(valid, torch.arange(BLS_N, device=DEVICE) >= NONRESIDUES):
        raise AssertionError(f"D1-BLS {group}: the valid flags differ from the x values' residuosity")
    return {"ms": cuda_ms(lambda: C.decompress(x, greatest, group), 3), "plain_ms": plain_ms, "err": err,
            "work": (nbytes(x, greatest, *got[:2], valid), _d1_muls("bls_" + group, BLS_N))}


def _bls_tampered(group: str, raw: bytes, lane: int, case: str) -> bytes:
    """raw (compressed encodings) with the encoding of `lane` changed as
    `case` says."""
    from phase2_bn254_tpu_torch.bls12_381.field import Q

    size = 48 if group == "g1" else 96
    t = bytearray(raw[lane * size : (lane + 1) * size])
    if case == "flag":
        t[0] &= 0x7F
    elif case == "infinity":
        t[0] |= 0x40
    elif case == "coordinate":
        t[:48] = Q.to_bytes(48, "big")
        t[0] |= 0x80
    else:  # a non-residue x
        x = _bls_non_residue(group, random.Random(f"tamper {group}"))
        t[:] = x.to_bytes(48, "big") if group == "g1" else x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big")
        t[0] |= 0x80
    return raw[: lane * size] + bytes(t) + raw[(lane + 1) * size :]


BLS_TAMPERS = {"flag": "compressed bit not set", "infinity": "point at infinity", "coordinate": "not below field",
               "non_residue": "off curve or non-residue"}


def _bls_slice(group: str, raw: bytes, rng: random.Random) -> dict:
    """The slice as a user drives it at BLS_N compressed points:
    decode_batch (D1-BLS), then each of the group's ladders as
    bls12_381/device.py offers them (G1: K8-BLS `ladder`, K7-BLS
    `glv_ladder`, K1-BLS `glv_signed_ladder`; G2: K9-BLS `ladder`), each
    normalized and encoded, every part timed (wall, synchronized); the
    kernels' launches counted from zero around it; every ladder's bytes
    equal, and those of BLS_SAMPLE lanes the host chain's; the tampered
    encodings rejected."""
    import torch
    from phase2_bn254_tpu_torch.bls12_381 import codecs_device as C
    from phase2_bn254_tpu_torch.bls12_381 import curve as hc
    from phase2_bn254_tpu_torch.bls12_381 import device as D
    from phase2_bn254_tpu_torch.bls12_381.field import R_MOD
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.ops import batch_exp

    entry = {"batch_exp_bls_glv": D.glv_ladder, "batch_exp_bls_glv_signed": D.glv_signed_ladder}
    ladders = {tag: (name, entry.get(name, lambda b, s: D.ladder(b, s, group)))
               for name, (tag, key, *_) in BLS_LADDERS.items() if key == "bls_" + group}
    vals = [rng.randrange(1, R_MOD) for _ in range(BLS_N)]
    k = D.scalars_to_canon(vals, DEVICE)
    torch.cuda.synchronize()
    _zero_counts()
    parts, t_all = {}, time.time()

    def timed(part, fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        parts[part] = time.time() - t0
        return out

    batch = timed("decode", lambda: C.decode_batch(raw, group, BLS_N, True, device=DEVICE))
    outs = {}
    for tag, (_, fn) in ladders.items():
        jac = timed(f"{tag} ladder", lambda: fn(batch, k))
        aff = timed(f"{tag} normalize", lambda: G.jac_normalize(D.field_ops(group), jac))
        outs[tag] = timed(f"{tag} encode", lambda: C.encode_batch(aff, group, True))
    wall = time.time() - t_all
    launches = {name: batch_exp.LAUNCHES[name] for name, _ in ladders.values()}
    decodes = C.LAUNCHES["decompress_bls"]
    if set(launches.values()) != {1} or sum(batch_exp.LAUNCHES.values()) != len(ladders) or decodes != 1:
        raise AssertionError(f"{group}: the slice launched {dict(batch_exp.LAUNCHES)} and {decodes} D1-BLS, want "
                             f"one of each of {list(launches)} and one D1-BLS")
    if len(set(outs.values())) != 1:
        raise AssertionError(f"{group}: the ladders {list(outs)} wrote different bytes")
    out = next(iter(outs.values()))
    size = 48 if group == "g1" else 96
    decode = hc.g1_from_compressed if group == "g1" else hc.g2_from_compressed
    encode = hc.g1_to_compressed if group == "g1" else hc.g2_to_compressed
    lanes = [i * (BLS_N // BLS_SAMPLE) + rng.randrange(BLS_N // BLS_SAMPLE) for i in range(BLS_SAMPLE)]
    t0 = time.time()
    for i in lanes:
        want = encode(decode(raw[i * size : (i + 1) * size], check=False).mul(vals[i]))
        if out[i * size : (i + 1) * size] != want:
            raise AssertionError(f"{group}: slice lane {i} differs from the host chain")
    host_s = time.time() - t0
    m = min(256, BLS_N)  # the tampered batches: the first m encodings, one changed
    for case, message in BLS_TAMPERS.items():
        try:
            C.decode_batch(_bls_tampered(group, raw[: m * size], m // 2, case), group, m, True, device=DEVICE)
        except ValueError as e:
            if message not in str(e):
                raise AssertionError(f"{group}: tampered ({case}) rejected with {e!r}, want {message!r}") from e
        else:
            raise AssertionError(f"{group}: a tampered ({case}) encoding decoded")
    # each ladder's slice: the decode and its own ladder, normalize, encode
    walls = {name: parts["decode"] + sum(v for p, v in parts.items() if p.startswith(tag + " "))
             for tag, (name, _) in ladders.items()}
    return {"launches": launches, "decodes": decodes, "wall": wall, "walls": walls, "parts": parts,
            "host_s": host_s, "bytes": len(raw), "ladders": list(ladders)}


def phase_bls(card: Card, records: list[dict]) -> None:
    """Phase 16: the BLS12-381 engine: its field code; K8-BLS, K7-BLS,
    K1-BLS, K9-BLS and D1-BLS against their plain versions; and the slice
    (decode, each ladder, normalize, encode) at BLS_N compressed points of
    each group against the host chain."""
    from phase2_bn254_tpu_torch.bls12_381 import device as D

    t0 = time.time()
    _bls_field()
    rng = random.Random(1616)
    cases = {}
    for name, (_, key, *_) in BLS_LADDERS.items():
        pts = _bls_points(key[4:], BLS_N, rng)
        k = D.scalars_to_canon(_bls_edge_scalars(BLS_N, rng), DEVICE)
        cases[name] = _ladder_case(name, pts.x, pts.y, k, PLAIN_BLS_N, 3, BLS_LADDERS)
    d1, slices = {}, {}
    for group in ("g1", "g2"):
        raw = _bls_raw(group, rng)
        d1[group] = _bls_d1_case(card, group, raw, rng)
        sl = slices[group] = _bls_slice(group, raw, rng)
        log(f"phase 16 slice {group.upper()}: {BLS_N} compressed points ({sl['bytes']} bytes) -> decode (D1-BLS, "
            f"{sl['decodes']} launch) -> " + " / ".join(sl["ladders"]) + " -> normalize -> encode; launches "
            f"{sl['launches']}; the ladders' bytes equal; wall {sl['wall']:.3f} s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sl["parts"].items())
            + "; each ladder's slice (decode + ladder + normalize + encode): "
            + ", ".join(f"{t} {v:.3f} s" for t, v in sl["walls"].items())
            + f"; {BLS_SAMPLE} lanes == the host chain ({sl['host_s']:.1f} s on the host); tampered encodings "
            f"rejected: {', '.join(BLS_TAMPERS)}")
    for name, c in cases.items():
        tag, key, _, _, _, source, replaces = BLS_LADDERS[name]
        sl = slices[key[4:]]
        rec = record(card, name, source, replaces, c["err"], c["ms"], c["plain_ms"], c["work"],
                     shape=f"N={BLS_N} BLS12-381 {key[4:].upper()} points, edge and random scalars",
                     plain_n=c["plain_n"], muls=c["work"][1], ladder_muls=c["ladder_muls"],
                     kernel_muls=c["kernel_muls"], slice_wall_s=sl["walls"][name], slice_parts_s=sl["parts"])
        rec["launches"] = sl["launches"][name]
        rec["launches_by_path"] = {f"the BLS12-381 slice, {BLS_N} compressed {key[4:].upper()} points":
                                   sl["launches"][name]}
        records.append(rec)
        log(f"phase 16 {tag} ({name}): N={BLS_N}, edge scalars first: "
            + _ladder_log(c, rec["bound_ms"], rec["bound_by"]))
    per = {}
    for group in ("g1", "g2"):
        bound_ms, bound_by = card.bound(*d1[group]["work"])
        per[group] = {"ms": d1[group]["ms"], "plain_ms": d1[group]["plain_ms"], "max_abs_err": d1[group]["err"],
                      "bound_ms": bound_ms, "bound_by": bound_by, "muls": d1[group]["work"][1]}
        log(f"phase 16 D1-BLS {group}: N={BLS_N} (the slice's x, {NONRESIDUES} replaced by x without a point, "
            f"their flags): kernel == plain limb for limb and flag; flags false exactly there; kernel "
            f"{d1[group]['ms']:.3f} ms, plain {d1[group]['plain_ms']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
            f"{d1[group]['work'][1] / BLS_N:.0f} multiplies/point)")
    rec = record(card, "decompress_bls", "phase2_bn254_tpu_torch/csrc/decompress.cu",
                 "phase2_bn254_tpu/bls12_381/codecs_device.py:87, :132 (XLA glue, not a Pallas kernel)",
                 max(p["max_abs_err"] for p in per.values()), per["g1"]["ms"], per["g1"]["plain_ms"],
                 d1["g1"]["work"], g2=per["g2"], muls=per["g1"]["muls"],
                 shape=f"N={BLS_N} compressed BLS12-381 points; g2 beside")
    rec["launches_by_path"] = {f"the BLS12-381 slice, {BLS_N} compressed {g.upper()} points": slices[g]["decodes"]
                               for g in ("g1", "g2")}
    rec["launches"] = sum(rec["launches_by_path"].values())
    records.append(rec)
    for line in _ptxas_of(("batch_exp_bls_g1_windowed_kernel", "batch_exp_bls_g2_windowed_kernel",
                           "batch_exp_bls_glv_kernel", "batch_exp_bls_glv_signed_kernel", "decompress_bls_")):
        log(f"  ptxas: {line}")
    log(f"phase 16: {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the signed-digit MSM (PHASE2_TPU_MSM_SIGNED) and the fold
# ---------------------------------------------------------------------------

SIGNED_VARIABLE = "PHASE2_TPU_MSM_SIGNED"
SIGNED_SWEEP = tuple(range(10, 17))  # the windows phase 17 times the signed MSM at (the rule stays JAX's)
SIGNED_WRAPPERS = ("bucket_accumulate_signed", "bucket_reduce_signed")  # their LAUNCHES keys


@contextlib.contextmanager
def _signed_env():
    """PHASE2_TPU_MSM_SIGNED=1 for the duration (TorchBackend reads it when
    it is made)."""
    saved = os.environ.get(SIGNED_VARIABLE)
    os.environ[SIGNED_VARIABLE] = "1"
    try:
        yield
    finally:
        os.environ.pop(SIGNED_VARIABLE)
        if saved is not None:
            os.environ[SIGNED_VARIABLE] = saved


def _k5_plain_batched(group: str, cases: list[dict]) -> None:
    """K5's plain version once over the sets of several _msm_case results
    (one window size; the plain chain's time hardly grows with the sets),
    each case's kernel result against its sets' limb for limb: k5_err, and
    k5_plain_ms the one call's."""
    import torch
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.ops import msm as M

    parts = list(zip(*(case.pop("k5_inputs") for case in cases)))
    sums, buckets = (G.JacobianBatch(*(torch.cat(t) for t in zip(*batches))) for batches in parts[:2])
    hot = M.Hot(*(torch.cat(t) for t in zip(*parts[2])))
    want, ms = once_ms(lambda: M.combine_windows_plain(sums, cases[0]["c"], buckets, hot))
    row = 0
    for case, res in zip(cases, parts[3]):
        rows = res.x.shape[0]
        case["k5_err"] = max_limb_err(res, G.JacobianBatch(*(t[row : row + rows] for t in want)))
        case["k5_plain_ms"] = ms
        row += rows
        if case["k5_err"]:
            raise AssertionError(f"K5 {group}: kernel and plain version differ (max abs limb error "
                                 f"{case['k5_err']})")


def _ones_mix(n: int, rng: random.Random) -> list[int]:
    """A witness-like mix: a quarter ones, a quarter zeros (phase 10's
    circuit's booleanity bits), the rest uniform, shuffled."""
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    ks = [1] * (n // 4) + [0] * (n // 4) + [rng.randrange(R_MOD) for _ in range(n - 2 * (n // 4))]
    rng.shuffle(ks)
    return ks


def _window_sweep(sets) -> dict:
    """ms per call (CUDA events) of msm_sets on sets and of its parts (the
    prep: prep_set and hot_buckets of every set; K3 of every set; K4; K5)
    in the signed mode at each window of SIGNED_SWEEP, and unsigned at
    pick_window's."""
    import torch
    from phase2_bn254_tpu_torch.ops import msm as M

    out = {}
    n = max(k.shape[0] for _, k, _ in sets)
    for c, signed in [(c, True) for c in SIGNED_SWEEP] + [(M.pick_window(n), False)]:
        preps = [M.prep_set(p, k, s, c, signed) for p, k, s in sets]
        k3_args = [(p.x, p.y, p.inf, torch.tensor(s, device=p.x.device), *pr[:5], pr.splits)
                   for (p, _, s), pr in zip(sets, preps)]
        buckets, hot = M.accumulate_sets(sets, c, signed)
        sums = M.bucket_reduce(buckets, signed, hot.lane)
        out[f"{'signed' if signed else 'unsigned'} c={c}"] = {
            "msm_sets": cuda_ms(lambda: M.msm_sets(sets, c, signed=signed), 3),
            "prep": cuda_ms(lambda: [M.hot_buckets(M.prep_set(p, k, s, c, signed), k.shape[0]) for p, k, s in sets],
                            3),
            "K3": cuda_ms(lambda: [M.bucket_accumulate(*a) for a in k3_args], 3),
            "K4": cuda_ms(lambda: M.bucket_reduce(buckets, signed, hot.lane), 3),
            "K5": cuda_ms(lambda: M.combine_windows(sums, c, buckets, hot), 3)}
        del preps, k3_args, buckets, hot, sums
    return out


def _signed_run(name: str, fn, runs: dict, keep: dict | None = None) -> None:
    """fn() under PHASE2_TPU_MSM_SIGNED with the MSM launches and K5's
    count of its fold (msm.fold_counts) from zero, and the K3-K5 device
    time; into runs[name]: wall s, launches, folds, device s. keep:
    msm_sets' arguments of the run."""
    import torch
    from phase2_bn254_tpu_torch.ops import msm as M

    for k in M.LAUNCHES:
        M.LAUNCHES[k] = 0
    M.reset_fold_counts()
    timers = _Timers()
    for w in MSM_WRAPPERS:
        timers.device_of("msm", M, w)
    if keep is not None:
        timers.args_of("msm_sets", M, "msm_sets", keep)
    try:
        with _signed_env():
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        timers.restore()
    launches, folds = dict(M.LAUNCHES), M.fold_counts()
    if launches["bucket_accumulate"] or launches["bucket_reduce"] or not launches["bucket_accumulate_signed"] \
            or launches["bucket_reduce_signed"] != launches["combine_windows"]:
        raise AssertionError(f"{name} under {SIGNED_VARIABLE}=1: launches {launches}, want the signed K3 and K4 "
                             f"only, one K4 a K5")
    runs[name] = {"wall_s": wall, "launches": launches, "folds": folds, "device_s": timers.device_s("msm")}


def _expect_rejection(fn, want: str) -> str:
    try:
        fn()
    except ValueError as e:
        if want not in str(e):
            raise
        return str(e)
    raise AssertionError(f"accepted where {want!r} was expected")


def phase_signed(card: Card, workdir: str, records: list[dict], new_challenge_hash: bytes, proof_hash: str,
                 rejections: dict, size: int = SMOKE_SIZE, batch: int = SMOKE_BATCH, exp: int = PROVE_EXP) -> None:
    """Phase 17: the MSMs under PHASE2_TPU_MSM_SIGNED=1. K3, K4, K5 in the
    signed mode against their plain versions at 2^16 (c from
    pick_window_signed), G1 and G2, uniform, all-equal and ones-mix scalars
    (the fold on the last two); the signed MSM at each window of
    SIGNED_SWEEP; then through the CLI functions: the size-21 verification
    (== phase 8's new challenge), phase 7's tampered response (rejected),
    `prove` at 2^exp (the seeded proof == phase 10's; then K3, K4 and K5 on
    its own sets, c = 16 and 14, against their plain versions) and
    `verify_contribution` on phase 13's files (phase 13's decisions)."""
    import filecmp

    from phase2_bn254_tpu_torch.cli import phase1
    from phase2_bn254_tpu_torch.cli import phase2 as cli2
    from phase2_bn254_tpu_torch.crypto.hashing import calculate_hash
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    t_phase = time.time()
    rng, n = random.Random(1717), KERNEL_N
    mixes = {"uniform": lambda: _edge_scalars(n, rng), "all-equal": lambda: [rng.randrange(R_MOD)] * n,
             "ones mix": lambda: _ones_mix(n, rng)}
    cases = {}
    for group in ("g1", "g2"):
        for label, make in mixes.items():
            case = cases[group, label] = _msm_case(group, n, make(), rng, signed=True, plain_k5=False)
            if bool(case["fold_sets"]) != (label != "uniform"):
                raise AssertionError(f"signed {group} {label}: the gate folds {case['fold_sets']} of 2 sets")
        _k5_plain_batched(group, [cases[group, label] for label in mixes])
    c = cases["g1", "uniform"]["c"]
    log(f"phase 17 signed MSM kernels: N={n} (+1 points, 2 sets), c={c} (pick_window_signed), B = {1 << (c - 1)} "
        f"buckets: K3 (signed) == plain limb for limb, K4 (signed) == plain after normalizing, K5 == plain limb "
        f"for limb, with the fold table of the default path; results == refimpl; G1 and G2")
    for (group, label), case in cases.items():
        bounds = {key: card.bound(*case[f"{key}_work"]) for key in ("k3", "k4", "k5")}
        log(f"  {group} {label} scalars (the gate folds {case['fold_sets']} of 2 sets; K5's plain version one call "
            f"over the three mixes' 6 sets): "
            + "; ".join(f"{what} {case[f'{key}_ms']:.3f} ms (plain {case[f'{key}_plain_ms']:.3f}, bound "
                        f"{bounds[key][0]:.5f} {bounds[key][1]}: {case[f'{key}_work'][1]} multiplies"
                        + (f", the kernel does {case[f'{key}_kernel_muls']}" if f"{key}_kernel_muls" in case else "")
                        + ")" for key, what in (("k3", "K3"), ("k4", "K4"), ("k5", "K5")))
            + f"; K5 chain {case['k5_chain']['warp_levels']} levels")
    log(f"  launches of one call: {_msm_geometry(n, c, 2, signed=True)}")
    for line in _ptxas_of(("bucket_accumulate", "bucket_reduce", "combine_windows")):
        log(f"  ptxas: {line}")
    u = cases["g1", "uniform"]
    sweep = {"power_pairs 2^16 G1": _window_sweep([(G.AffineBatch(*u["args"][:3]), u["scalars"], (0, 1))])}
    del u, cases["g1", "uniform"]["args"]

    runs = {}
    challenge, response = _challenge(workdir, size, batch), os.path.join(workdir, f"response_{size}")
    new_challenge = os.path.join(workdir, f"new_challenge_{size}_signed")
    timers = _verify_timers("prep_windows_signed")
    try:
        _signed_run("verify", lambda: runs.setdefault("verify_hash", phase1.verify_transform_constrained(
            challenge, response, new_challenge, size, batch, DEVICE)), runs)
    finally:
        timers.restore()
    if runs["verify_hash"] != new_challenge_hash or runs["verify_hash"] != calculate_hash(new_challenge):
        raise AssertionError("the signed verification's new challenge hash differs from phase 8's")
    if not filecmp.cmp(new_challenge, os.path.join(workdir, f"new_challenge_{size}"), shallow=False):
        raise AssertionError("the signed verification's new challenge differs from phase 8's, byte for byte")
    os.remove(new_challenge)
    small = 10  # phase 7's size-10 response with one wrong point
    _signed_run("tampered", lambda: runs.setdefault("tampered_msg", _expect_rejection(
        lambda: phase1.verify_transform_constrained(_challenge(workdir, small, 256),
                                                    os.path.join(workdir, f"response_{small}_tampered"),
                                                    os.path.join(workdir, f"new_{small}_signed"), small, 256,
                                                    DEVICE), "INVALID CONTRIBUTION")), runs)

    argv = [os.path.join(workdir, f"circuit_{exp}.json"), os.path.join(workdir, f"witness_{exp}.json"),
            os.path.join(workdir, f"circuit_{exp}.params"), os.path.join(workdir, "proof_signed.json"),
            os.path.join(workdir, "public_signed.json"), "--device", DEVICE]
    kept = {}
    _signed_run("prove", lambda: runs.setdefault("proof_hash", _seeded_proof_hash(argv)), runs, kept)
    if runs["proof_hash"] != proof_hash:
        raise AssertionError(f"the signed seeded proof's blake2b {runs['proof_hash']} differs from phase 10's "
                             f"{proof_hash}")
    if not runs["prove"]["folds"]["launches"]:
        raise AssertionError("prove under the signed mode took no fold (its G1 sets hold the witness' ones)")
    g1_sets = next(a[0] for a in kept["msm_sets"] if a[0][0][0].x.dim() == 2)
    sweep[f"prove's G1 sets {[k.shape[0] for _, k, _ in g1_sets]}"] = _window_sweep(g1_sets)
    prove_shape = _prover_msm_kernels(card, kept["msm_sets"], signed=True)
    del kept, g1_sets

    circuit_json, radix = os.path.join(workdir, f"circuit_{exp}.json"), os.path.join(workdir, "radix")
    params = [os.path.join(workdir, f"circom{i}.params") for i in range(4)]
    tool_log = os.path.join(workdir, "ceremony_tools.log")
    with open(tool_log, "a") as out, contextlib.redirect_stdout(out):
        _signed_run("verify_contribution 1->2", lambda: cli2.main_verify_contribution(
            [circuit_json, params[1], params[2], radix, "--device", DEVICE]), runs)
        _signed_run("verify_contribution, changed l", lambda: runs.setdefault("l_msg", _expect_rejection(
            lambda: cli2.verify(circuit_json, params[2], os.path.join(workdir, "circom3_l.params"), radix, DEVICE),
            rejections["l"])), runs)

    paths = ("verify", "tampered", "prove", "verify_contribution 1->2", "verify_contribution, changed l")
    log(f"phase 17 under {SIGNED_VARIABLE}=1: verify_transform_constrained size {size} batch {batch} passes, its "
        f"new challenge == phase 8's byte for byte; phase 7's size-{small} response with a wrong point is rejected "
        f"({runs['tampered_msg']!r}); prove at 2^{exp} with seeded r and s verifies, its proof's blake2b "
        f"{runs['proof_hash']} == phase 10's; verify_contribution 1->2 passes and the copy with a changed l is "
        f"rejected ({runs['l_msg']!r}), as in phase 13")
    for name in paths:
        r = runs[name]
        log(f"  {name}: wall {r['wall_s']:.3f} s, K3-K5 device {r['device_s']:.3f} s; launches "
            + ", ".join(f"{k} {v}" for k, v in r["launches"].items() if v)
            + f"; K5 taking the fold {r['folds']['launches']} (in {r['folds']['sets']} sets)")
    log(f"  verify by part, wall s: {_verify_wall(timers, runs['verify']['wall_s'])}")
    for shape, configs in sweep.items():
        log(f"  window sweep, {shape}: ms per call of msm_sets (prep | K3 | K4 | K5 apart): "
            + "; ".join(f"{k} {v['msm_sets']:.3f} ({v['prep']:.3f} | {v['K3']:.3f} | {v['K4']:.3f} | {v['K5']:.3f})"
                        for k, v in configs.items()))

    by_path = {name: {k: runs[name]["launches"][k] for k in SIGNED_WRAPPERS} for name in paths}
    fold_by_path = {name: runs[name]["folds"]["launches"] for name in paths}
    source = "phase2_bn254_tpu_torch/csrc/msm.cu"
    of_prove = {"k3": "bucket_accumulate", "k4": "bucket_reduce", "k5": "combine_windows"}
    for name, key, replaces, fold_label in (
            ("bucket_accumulate_signed", "k3", "phase2_bn254_tpu/ops/pallas_msm.py:198 (_wave_kernel's signed "
             "branch :178-186)", "uniform"),
            ("bucket_reduce_signed", "k4", "phase2_bn254_tpu/ops/pallas_msm.py:328 (the signed weight mask "
             ":713-719)", "uniform"),
            ("combine_windows_fold", "k5", "phase2_bn254_tpu/ops/pallas_msm.py:591 (_combine_kernel's exclude "
             "mode :523-531, :564-575)", "ones mix")):
        per = {}
        for group in ("g1", "g2"):
            for label in mixes:
                case = cases[group, label]
                bound_ms, bound_by = card.bound(*case[f"{key}_work"])
                per[f"{group} {label}"] = {"ms": case[f"{key}_ms"], "plain_ms": case[f"{key}_plain_ms"],
                                           "max_abs_err": case[f"{key}_err"], "bound_ms": bound_ms,
                                           "bound_by": bound_by, "muls": case[f"{key}_work"][1],
                                           "kernel_muls": case.get(f"{key}_kernel_muls"),
                                           "fold_sets": case["fold_sets"]}
                if key == "k5":
                    per[f"{group} {label}"]["chain"] = case["k5_chain"]
        main = cases["g1", fold_label]
        rec = record(card, name, source, replaces, max(p["max_abs_err"] for p in per.values()), main[f"{key}_ms"],
                     main[f"{key}_plain_ms"], main[f"{key}_work"], cases=per,
                     shape=f"N={n}, c={c} signed, 2 sets, G1 {fold_label} scalars; every case beside")
        rec["prove_shape"] = prove_shape[of_prove[key]]
        if key == "k5":
            rec["launches_by_path"] = fold_by_path
            rec["window_sweep_ms"] = sweep
        else:
            rec["launches_by_path"] = {p: v[name] for p, v in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        if not rec["launches"]:
            raise AssertionError(f"{name}: no launch on phase 17's paths")
        records.append(rec)
    log(f"phase 17: {time.time() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 18: prepare_phase2, reduce_powers, verify_transcript
# ---------------------------------------------------------------------------

PREPARE_DEGREES = (0, 1, 2, 10, 18, 21)  # the radix files held to write_radix's from phase 5's secrets
GROUP_NTT_N = 1 << 16  # N1's pairs and N2's points in the kernel cases
GROUP_NTT_LOG2C = 12  # N1's case: rows of 2^12 points, stage 12 (each pair its own twiddle of the row's 2^11)
# the points the plain versions are held to, in one call each: N1's first
# two rows (2^12 pairs) and N2's first 2^13 points; row 0 holds the
# generator (z = 1), the edge scalars and infinities, row 1 random Jacobian
# points (z != 1)
PLAIN_GROUP_NTT_N = 2 << GROUP_NTT_LOG2C


def _jac_ladder_muls(group: str, scalars, whole_table: bool = False):
    """Multiplies (N,) of k B for Jacobian bases B by N1 / N2's own ladder
    (csrc/group_ntt.cu jac_ladder) on these scalars, kept beside the bound
    (which counts `_function_muls`, the fewest of the port's ladders): k above (r - 1)/2 as (r - k)(-B), the multiples
    by general adds up to each lane's largest 4-bit digit (2B through the
    add's doubling branch; with whole_table all of T[2..15] where a digit
    above 1 occurs, as the kernel builds them), 4 doublings per window after
    the first nonzero one, one add per nonzero window after the first."""
    import torch
    from phase2_bn254_tpu_torch.ops import batch_exp

    ops = OP_MULS[group]
    win = batch_exp.scalar_windows_msb(batch_exp.half_recode(scalars)[0])
    nz = win != 0
    top = win.amax(0)
    if whole_table:
        top = torch.where(top >= 2, torch.full_like(top, 15), top)
    return _table_muls(ops, top) + _ladder_doublings(nz, 4) * ops["dbl"] + (nz.sum(0) - 1).clamp(min=0) * ops["add"]


def _group_ntt_points(group: str, n: int, dev, rng: random.Random):
    """n Jacobian points for N1 and N2: sums P_i + P_(i+1) of tiled random
    multiples of the generator (z != 1), the first row (2^GROUP_NTT_LOG2C)
    the generator itself (z = 1), and every 1009th from 7 on at infinity."""
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.refimpl import curve as rc

    f = FQ if group == "g1" else FQ2
    pts, _ = _tiled_points(group, n + 1, dev, rng)
    jac = G.jac_add(f, *(G.affine_to_jac(f, G.AffineBatch(*(t[a : a + n] for t in pts))) for a in (0, 1)))
    gen = G.affine_to_jac(f, convert.points_to_affine([rc.G1_GEN if group == "g1" else rc.G2_GEN], group, dev))
    zero = G.jac_zero(f, (1,), dev)
    for c, g, z in zip(jac, gen, zero):
        c[: 1 << GROUP_NTT_LOG2C] = g
        c[7::1009] = z
    return jac


def _same_affine(group: str, got, want) -> bool:
    import torch
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2

    f = FQ if group == "g1" else FQ2
    return all(torch.equal(a, b) for a, b in zip(G.jac_normalize(f, got), G.jac_normalize(f, want)))


def _group_ntt_case(group: str, rng: random.Random) -> dict:
    """N1 over rows of 2^GROUP_NTT_LOG2C points, stage GROUP_NTT_LOG2C
    (GROUP_NTT_N pairs), the inverse domain's twiddles with w^1 and w^2
    replaced by 0 and r - 1 (w^0 = 1: row 0's equal points double into a +
    t and cancel in a - t), and N2 on GROUP_NTT_N points with the edge
    scalars first: each against its plain version, limb for limb and in
    canonical affine, on the first PLAIN_GROUP_NTT_N points (the generator,
    z = 1, then random points, z != 1); time per call; the work (the
    bound's: `_function_muls`; the ladder's and the kernel's beside it)."""
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.ops import ntt
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    dev, log2c, n = torch.device(DEVICE), GROUP_NTT_LOG2C, GROUP_NTT_N
    out = {}
    pts = _group_ntt_points(group, 2 * n, dev, rng)
    tw = ntt.Domain(log2c).twiddles_canonical(True, dev).clone()
    tw[1:3] = convert.ints_to_limbs([0, R_MOD - 1], dev)

    def copy(jac, k=None):
        return G.JacobianBatch(*(c[:k].clone() for c in jac))

    pn = PLAIN_GROUP_NTT_N

    def held(name: str, got, want) -> int:
        err = max_limb_err(got, want)
        if err or not _same_affine(group, G.JacobianBatch(*got), want):
            raise AssertionError(f"{name} {group}: kernel and plain version differ on the first {pn} points (max "
                                 f"abs limb error {err})")
        return err

    # the plain version on the first two rows: a batch of two rows, with the
    # same twiddles
    got = ntt.group_ntt_stage(copy(pts), tw, log2c, log2c)
    want, plain_ms = once_ms(lambda: ntt.group_ntt_stage_plain(copy(pts, pn), tw, log2c, log2c))
    err = held("N1", [t[:pn] for t in got], want)
    scratch = copy(pts)
    ms = cuda_ms(lambda: ntt.group_ntt_stage(scratch, tw, log2c, log2c), 3)
    pair_tw = tw.repeat(n >> (log2c - 1), 1)
    adds = 2 * n * OP_MULS[group]["add"]
    out["group_ntt_stage"] = {"err": err, "ms": ms, "plain_ms": plain_ms, "plain_n": pn // 2, "n": n,
                              "work": (2 * nbytes(*pts) + nbytes(tw), _function_muls(group, pair_tw) + adds),
                              "ladder_muls": int(_jac_ladder_muls(group, pair_tw).sum()) + adds,
                              "kernel_muls": int(_jac_ladder_muls(group, pair_tw, True).sum()) + adds}
    del got, want, scratch

    pts = G.JacobianBatch(*(c[:n].contiguous() for c in pts))
    k = convert.ints_to_limbs(_edge_scalars(n, rng), dev)
    got = ntt.jac_scalar_mul(copy(pts), k)
    want, plain_ms = once_ms(lambda: ntt.jac_scalar_mul_plain(copy(pts, pn), k[:pn]))
    err = held("N2", [t[:pn] for t in got], want)
    scratch = copy(pts)
    ms = cuda_ms(lambda: ntt.jac_scalar_mul(scratch, k), 3)
    out["jac_scalar_mul"] = {"err": err, "ms": ms, "plain_ms": plain_ms, "plain_n": pn, "n": n,
                             "work": (2 * nbytes(*pts) + nbytes(k), _function_muls(group, k)),
                             "ladder_muls": int(_jac_ladder_muls(group, k).sum()),
                             "kernel_muls": int(_jac_ladder_muls(group, k, True).sum())}
    return out


def _prepare_launches(size: int) -> dict:
    """N1 and N2 launches of a size-`size` prepare run in-core: per degree m
    >= 1 one N1 a stage and one N2 for the G1 batch (three vectors) and for
    G2."""
    return {"group_ntt_stage": size * (size + 1), "jac_scalar_mul": 2 * size}


# the vectors of a degree's two iNTT calls, and the bytes of a Jacobian point
PREPARE_VECTORS = {"g1": 3, "g2": 1}
JAC_BYTES = {"g1": 3 * 16 * 8, "g2": 3 * 2 * 16 * 8}


def _prepare_bound(card: Card, size: int) -> dict:
    """The bound (s, as every kernel's: per launch the larger of its bytes
    and its multiplies over the card's rates, summed) of the N1 and N2
    launches of a size-`size` prepare run in-core. Stage s of every degree
    m >= s takes the twiddles w_(2^s)^-j, j < 2^(s-1) (Domain(s)'s), each
    2^(m-s) times a vector; k B as `_function_muls` counts it, two general
    adds a pair; N2 multiplies the 2^m points of each vector by 1/2^m; each
    launch reads and writes its points once."""
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.ops import ntt

    dev = torch.device(DEVICE)
    out = {"group_ntt_stage": 0.0, "jac_scalar_mul": 0.0}
    for group, v in PREPARE_VECTORS.items():
        add = 2 * OP_MULS[group]["add"]
        stage = [_function_muls(group, ntt.Domain(s).twiddles_canonical(True, dev))
                 for s in range(1, size + 1)]
        for m in range(1, size + 1):
            moved = 2 * (v << m) * JAC_BYTES[group]
            for s in range(1, m + 1):
                muls = v * ((stage[s - 1] << (m - s)) + (1 << (m - 1)) * add)
                out["group_ntt_stage"] += card.bound(moved + (16 * 8 << (s - 1)), muls)[0] / 1e3
            minv = convert.ints_to_limbs([ntt.Domain(m).minv], dev)
            out["jac_scalar_mul"] += card.bound(moved, (v << m) * _function_muls(group, minv))[0] / 1e3
    return out


def _prepare_parts(timers, total: float) -> str:
    """The parts of a timed prepare: the group iNTT calls hold the
    normalization and the encoding of the Lagrange vectors; the H bases'
    encoding is apart."""
    w = timers.wall
    kernels = timers.device_s("n1") + timers.device_s("n2")
    encode_h = w["encode"] - w["encode_lagrange"]
    other = total - w["decode"] - w["intt_g1"] - w["intt_g2"] - w["h_bases"] - encode_h
    return (f"decode {w['decode']:.3f} | group iNTT G1 {w['intt_g1']:.3f} | G2 {w['intt_g2']:.3f} (of the two: "
            f"normalize {w['normalize']:.3f}, encode {w['encode_lagrange']:.3f}, N1 + N2 device {kernels:.3f} (CUDA "
            f"events)) | H bases (add, normalize) {w['h_bases']:.3f}, their encode {encode_h:.3f} | other (file "
            f"writes, headers) {other:.3f}")


def phase_prepare(card: Card, workdir: str, records: list[dict], size: int = SMOKE_SIZE,
                  batch: int = SMOKE_BATCH, pair: tuple[int, int] = (10, 256)) -> None:
    """Phase 18: N1 and N2 against their plain versions; prepare_phase2 on
    phase 5's response through the CLI function, as a user runs it and then
    timed by part; its files against write_radix's from phase 5's secrets;
    `new` from them; reduce_powers of phase 8's new challenge;
    verify_transcript on phase 7's size-10 pair."""
    import torch
    from phase2_bn254_tpu_torch.ceremony import prepare, streaming
    from phase2_bn254_tpu_torch.ceremony.keypair import keypair
    from phase2_bn254_tpu_torch.ceremony.params import HASH_SIZE, CeremonyParams
    from phase2_bn254_tpu_torch.cli import phase1, transcript
    from phase2_bn254_tpu_torch.cli import phase2 as cli2
    from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
    from phase2_bn254_tpu_torch.crypto.hashing import calculate_hash, reduced_hash
    from phase2_bn254_tpu_torch.curve import codecs
    from phase2_bn254_tpu_torch.ops import decompress, ntt
    from phase2_bn254_tpu_torch.ops.backend import TorchBackend

    t_phase = time.time()
    rng = random.Random(18)
    cases = {group: _group_ntt_case(group, rng) for group in ("g1", "g2")}
    for name in ("group_ntt_stage", "jac_scalar_mul"):
        for group, c in ((g, cases[g][name]) for g in ("g1", "g2")):
            b, by = card.bound(*c["work"])
            c["bound_ms"], c["bound_by"] = b, by
            log(f"phase 18 {'N1' if name == 'group_ntt_stage' else 'N2'} ({name}) {group}: {c['n']} "
                f"{'pairs' if name == 'group_ntt_stage' else 'points'}, edge scalars and equal points first: kernel == "
                f"plain limb for limb and in canonical affine on the first {c['plain_n']} (the first "
                f"{1 << GROUP_NTT_LOG2C} points the generator, the next random, z != 1); kernel {c['ms']:.3f} ms/call, plain {c['plain_ms']:.3f} ms "
                f"({c['plain_n']}), bound {b:.3f} ms ({by}: {c['work'][1]} multiplies, the fewest of the port's "
                f"ladders, {c['work'][0]} bytes; this ladder needs {c['ladder_muls']}, the kernel does "
                f"{c['kernel_muls']})")
    for line in _ptxas_of(("group_ntt_stage_kernel", "jac_scalar_mul_kernel")):
        log(f"  ptxas: {line}")

    response = os.path.join(workdir, f"response_{size}")  # phase 5's
    prepared = os.path.join(workdir, "prepared")
    os.makedirs(prepared, exist_ok=True)
    argv = [response, str(size), str(batch), "--out-dir", prepared, "--device", DEVICE]
    tool_log = os.path.join(workdir, "prepare_tools.log")
    _zero_counts()
    with open(tool_log, "a") as out, contextlib.redirect_stdout(out):
        t0 = time.time()
        phase1.main_prepare_phase2(argv)
        torch.cuda.synchronize()
        total = time.time() - t0
    launches = {k: ntt.LAUNCHES[k] for k in ("group_ntt_stage", "jac_scalar_mul")}
    if launches != _prepare_launches(size):
        raise AssertionError(f"prepare_phase2: N1 / N2 launches {launches}, want {_prepare_launches(size)} (in-core)")
    nbytes_out = sum(os.path.getsize(os.path.join(prepared, f"phase1radix2m{m}")) for m in range(size + 1))
    log(f"phase 18 prepare_phase2 size {size} batch {batch} (as a user runs it): {total:.3f} s wall; N1 launches "
        f"{launches['group_ntt_stage']}, N2 {launches['jac_scalar_mul']}, D1 {decompress.LAUNCHES['decompress']}; "
        f"{size + 1} files, {nbytes_out} bytes")

    # again, every part timed (the same files written over)
    timers = _Timers()
    timers.wall_of("decode", prepare, "_read_region_host")
    timers.wall_of("normalize", streaming, "normalize", sync=True, sync_start=True)
    timers.wall_of("h_bases", TorchBackend, "sub_batches", sync=True)
    timers.wall_of("encode", codecs, "encode_batch")
    timers.device_of("n1", ntt, "group_ntt_stage")
    timers.device_of("n2", ntt, "jac_scalar_mul")
    intt = streaming.group_intt_streamed
    timers.wall.update(intt_g1=0.0, intt_g2=0.0, encode_lagrange=0.0)

    def timed_intt(srcs, exp, device, rows_per_block=None):
        t, encode = time.time(), timers.wall["encode"]
        try:
            return intt(srcs, exp, device, rows_per_block)
        finally:
            torch.cuda.synchronize()
            timers.wall[f"intt_{srcs[0].group}"] += time.time() - t
            timers.wall["encode_lagrange"] += timers.wall["encode"] - encode

    streaming.group_intt_streamed = timed_intt
    torch.cuda.reset_peak_memory_stats()
    try:
        with open(tool_log, "a") as out, contextlib.redirect_stdout(out):
            t0 = time.time()
            phase1.main_prepare_phase2(argv)
            torch.cuda.synchronize()
            total_parts = time.time() - t0
    finally:
        streaming.group_intt_streamed = intt
        timers.restore()
    log(f"  by part ({total_parts:.3f} s wall, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB): " + _prepare_parts(timers, total_parts))
    bound = _prepare_bound(card, size)
    for name, key in (("group_ntt_stage", "n1"), ("jac_scalar_mul", "n2")):
        n_launch = launches[name]
        log(f"  {name}: {timers.device_s(key):.3f} s device over {n_launch} launches "
            f"({1e3 * timers.device_s(key) / n_launch:.3f} ms a launch), bound {bound[name]:.3f} s")
        cases["g1"][name]["prepare_device_s"] = timers.device_s(key)
        cases["g1"][name]["prepare_bound_s"] = bound[name]

    # the files against write_radix's from phase 5's secrets
    challenge = _challenge(workdir, size, batch)
    _, key = keypair(ChaChaRng.from_digest_be(SEED), calculate_hash(challenge))
    refs = os.path.join(workdir, "radix_phase5")
    os.makedirs(refs, exist_ok=True)
    t0 = time.time()
    for m in PREPARE_DEGREES:
        write_radix(refs, m, secrets=(key.tau, key.alpha, key.beta))
        ref, got = os.path.join(refs, f"phase1radix2m{m}"), os.path.join(prepared, f"phase1radix2m{m}")
        if _read(ref) != _read(got):
            raise AssertionError(f"prepare_phase2: phase1radix2m{m} differs from write_radix's from phase 5's secrets")
        os.remove(ref)
    log(f"  phase1radix2m{{{', '.join(map(str, PREPARE_DEGREES))}}} == write_radix's from phase 5's tau, alpha, beta "
        f"({time.time() - t0:.1f} s); radix m={size} blake2b "
        f"{hashlib.blake2b(_read(os.path.join(prepared, f'phase1radix2m{size}'))).hexdigest()[:16]}")

    # phase-2 `new` from the prepared directory (phase 10's circuit)
    circuit_json = os.path.join(workdir, f"circuit_{CEREMONY_EXP}.json")
    params = os.path.join(workdir, "prepared.params")
    with open(tool_log, "a") as out, contextlib.redirect_stdout(out):
        t0 = time.time()
        cli2.main_new([circuit_json, params, prepared, "--device", DEVICE])
        torch.cuda.synchronize()
        t_new = time.time() - t0
    log(f"  new at 2^{CEREMONY_EXP} constraints from the prepared directory: {t_new:.3f} s, .params blake2b "
        f"{hashlib.blake2b(_read(params)).hexdigest()[:16]} ({os.path.getsize(params)} bytes)")
    shutil.rmtree(prepared)
    os.remove(params)

    # reduce_powers of phase 8's new challenge, 21 -> 18
    small = CEREMONY_EXP
    new_challenge = os.path.join(workdir, f"new_challenge_{size}")
    reduced = os.path.join(workdir, f"reduced_{small}")
    with open(tool_log, "a") as out, contextlib.redirect_stdout(out):
        t0 = time.time()
        phase1.main_reduce_powers([new_challenge, reduced, str(size), str(small), str(batch), "--device", DEVICE])
        t_reduce = time.time() - t0
    orig, red = CeremonyParams(size, batch), CeremonyParams(small, batch)
    with open(reduced, "rb") as f:
        if f.read(HASH_SIZE) != reduced_hash(size, small):
            raise AssertionError("reduce_powers: the header is not reduced_hash(21, 18)")
    with open(new_challenge, "rb") as fo, open(reduced, "rb") as fr:
        for kind in ("tau_g1", "tau_g2", "alpha_g1", "beta_g1", "beta_g2"):
            n = red.element_count(kind) * red.element_size(kind, False)
            fo.seek(orig.position(kind, 0, False))
            fr.seek(red.position(kind, 0, False))
            if fo.read(n) != fr.read(n):
                raise AssertionError(f"reduce_powers: {kind} is not the prefix of the original's")
    if os.path.getsize(reduced) != red.accumulator_size:
        raise AssertionError("reduce_powers: wrong size")
    log(f"  reduce_powers {size} -> {small} of phase 8's new challenge: {t_reduce:.3f} s; header == "
        f"reduced_hash({size}, {small}), every region the original's prefix; blake2b "
        f"{calculate_hash(reduced).hex()[:16]}")
    os.remove(reduced)

    # verify_transcript on phase 7's size-10 pair
    psize, pbatch = pair
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t0 = time.time()
        transcript.main_verify_transcript([_challenge(workdir, psize, pbatch), os.path.join(workdir, f"response_{psize}"),
                                           "--size", str(psize), "--batch", str(pbatch), "--device", DEVICE])
        t_transcript = time.time() - t0
    if "Transcript OK" not in buf.getvalue():
        raise AssertionError(f"verify_transcript did not pass phase 7's size-{psize} pair")
    log(f"  verify_transcript on phase 7's size-{psize} pair: Transcript OK ({t_transcript:.3f} s)")

    replaces = {"group_ntt_stage": "phase2_bn254_tpu/ops/ntt.py:133 _group_stage, :224 _jac_scalar_mul (XLA "
                                   "glue, not Pallas)",
                "jac_scalar_mul": "phase2_bn254_tpu/ops/ntt.py:224 _jac_scalar_mul, :176 the iNTT's 1/N (XLA glue, "
                                  "not Pallas)"}
    for name, source in (("group_ntt_stage", "N1"), ("jac_scalar_mul", "N2")):
        g1, g2 = cases["g1"][name], cases["g2"][name]
        rec = record(card, name, "phase2_bn254_tpu_torch/csrc/group_ntt.cu", replaces[name],
                     max(g1["err"], g2["err"]), g1["ms"], g1["plain_ms"], g1["work"],
                     shape=f"{source}: {g1['n']} {'pairs' if name == 'group_ntt_stage' else 'points'} G1; g2 beside",
                     plain_n=g1["plain_n"], muls=g1["work"][1], ladder_muls=g1["ladder_muls"],
                     kernel_muls=g1["kernel_muls"], prepare_device_s=g1["prepare_device_s"],
                     prepare_bound_s=g1["prepare_bound_s"], prepare_wall_s=total,
                     g2={k: g2[k] for k in ("ms", "plain_ms", "plain_n", "bound_ms", "bound_by", "ladder_muls",
                                            "kernel_muls")} | {"muls": g2["work"][1]})
        rec["launches"] = launches[name]
        rec["ptxas"] = _ptxas_of((f"{name}_kernel",))
        records.append(rec)
    log(f"phase 18: {time.time() - t_phase:.1f} s")


# ---------------------------------------------------------------------------

def run_phases(card: Card, workdir: str, records: list[dict]) -> None:
    """Phases 3-18 (phases 1 and 2 run before the working directory exists)."""
    phase_golden(workdir)
    phase_parity(workdir)
    response_hash = phase_contribute(workdir, records)
    phase_msm_kernels(card, records)
    phase_verify_small(workdir)
    new_challenge_hash = phase_verify(workdir, records)
    phase_ntt(card, records)
    proof_hash = phase_prove(card, workdir, records)
    phase_fixture_proof(workdir)
    phase_segsum_kernels(card, records)
    rejections = phase_ceremony(card, workdir, records)
    phase_ladder_kernels(card, records)
    phase_configurations(card, workdir, records, response_hash)
    phase_bls(card, records)
    phase_signed(card, workdir, records, new_challenge_hash, proof_hash, rejections)
    phase_prepare(card, workdir, records)
    phase_fixture_ceremony(workdir)


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import phase2_bn254_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1
    found = os.path.dirname(os.path.dirname(os.path.realpath(phase2_bn254_tpu_torch.__file__)))
    if found != os.path.realpath(REPO):
        print(f"chip_smoke: the port is not beside this script (found it in {found})", file=sys.stderr)
        return 1
    card = Card()
    log(f"card: {card.line}; {torch.cuda.device_count()} CUDA device(s) visible, this smoke drives device 0; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build(card)
    phase_field()
    records = phase_kernels(card)
    with tempfile.TemporaryDirectory() as workdir:
        run_phases(card, workdir, records)
    loaded = sorted(m for m in ("jax", "phase2_bn254_tpu") if m in sys.modules)
    if loaded:
        print(f"chip_smoke: {', '.join(loaded)} was loaded", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": records}))
    print(card.line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
