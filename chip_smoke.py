#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `phase2_bn254_tpu_torch` through its own entry points and fails (exit
code 1, no result line) if CUDA is missing, if the package is not beside this
script, or if any phase fails. It imports the port only (its own copy of the
ceremony protocol, `cli.phase1`, `ceremony`, `crypto`, and of the exact
reference `refimpl`), and fails if jax or the JAX package got loaded. The
phases:

1. the card's name, power limit and SM clock; build the kernels (csrc/,
   nvcc, sm_90a);
2. K1 and K2 against their plain PyTorch versions on the card, at the
   contribute chunk shape (2^16 points) with the edge scalars in the first
   lanes: exact equality after normalizing; time per call and bound;
3. the golden size-4 / batch-16 response, byte for byte;
4. a size-10 / batch-256 response byte-identical to the exact host backend;
5. new_constrained + compute_constrained at size 21, batch 2^16 (the
   reference ceremony's design depth): hash chain, spot checks of every
   element kind against refimpl, K1 / K2 launch counts, wall time by phase,
   and a torch.profiler breakdown of one chunk of each group;
6. K3, K4, K5 (the Pippenger MSM) and D1 (decompression) against their plain
   versions on the card at the verify chunk shape (2^16 points, c = 9), G1
   and G2, uniform and all-equal scalars; time per call and bound;
7. verify the golden size-4 pair (new challenge == the exact host
   backend's), a size-10 response (passes), and that response with one
   valid but wrong point (rejected);
8. verify_transform_constrained at size 21, batch 2^16, on phase 5's
   response: pass, hash chain, spot checks of the new challenge against
   refimpl decompression, K3-K5 / D1 launch counts, wall time by phase, and
   a torch.profiler breakdown of one chunk's power_pairs.

Each kernel's bound is the larger of two times: the bytes of its inputs and
outputs over the card's memory rate, and its 32-bit integer multiplies over
the card's multiply rate (132 SMs x 64 per SM per clock x the SM clock
nvidia-smi reads); the multiplies are counted from the kernels' code (see
MULS_PER_FQ_PRODUCT, FQ_PRODUCTS) for this run's inputs.

Prints one JSON line of the kernels' results, the card's nvidia-smi line,
and last `{"ok": true, "device": {...}}`. Needs no network; starts no
process that outlives it.
"""

from __future__ import annotations

import hashlib
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
HOT_N = 1 << 9  # all-equal scalars: the plain K3 adds one point per lane per step, so its limb check runs here
NONRESIDUES = 16  # D1 inputs whose x^3 + b has no square root

# Peak rates of the card the bounds are taken against
MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
MULS_PER_SM_PER_CLOCK = 64  # 32-bit integer multiply / multiply-add, compute capability 9.0 (CUDA programming guide)
# 32-bit multiplies of one Fq Montgomery product, csrc/field.cuh `mul` (CIOS
# on 8 x 32-bit limbs): 64 limb products a_j b_i and 64 reduction products
# m p_j of 32 x 32 -> 64 bits (a low and a high half each), and 8 low
# products m = t_0 p'
MULS_PER_FQ_PRODUCT = 2 * (64 + 64) + 8
# Fq products per group operation of csrc/field.cuh (an Fq2 product is 3 Fq
# products, an Fq2 square 2): dbl-2009-l, add-2007-bl, the part of add-2007-bl
# before its P == Q test (then the doubling), madd-2007-bl
FQ_PRODUCTS = {
    "g1": {"dbl": 7, "add": 16, "add_head": 8, "madd": 11},
    "g2": {"dbl": 5 * 2 + 2 * 3, "add": 5 * 2 + 11 * 3, "add_head": 2 * 2 + 6 * 3, "madd": 4 * 2 + 7 * 3},
}


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

    def bound(self, nbytes: int, fq_products: int) -> tuple[float, str]:
        """(least ms, what bounds it) for moving nbytes and doing
        fq_products Montgomery products."""
        t_bytes = nbytes / MEM_BYTES_PER_S
        t_ops = fq_products * MULS_PER_FQ_PRODUCT / self.muls_per_s
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


def _k1_products(d1, d2) -> int:
    """Fq products of K1 (csrc/batch_exp_g1.cu) on these digits: the table
    (16 beta x, 2P through the doubling branch, 3P..16P), 5 doublings per
    window, and one add per nonzero digit after the first (an add into
    infinity or of infinity costs none)."""
    ops = FQ_PRODUCTS["g1"]
    nw, n = d1.shape
    table = 16 + ops["add_head"] + ops["dbl"] + 14 * ops["add"]
    adds = int(((d1 != 0).sum(0) + (d2 != 0).sum(0) - 1).clamp(min=0).sum())
    return n * (table + nw * 5 * ops["dbl"]) + adds * ops["add"]


def _k2_products(digits) -> int:
    """Fq products of K2 (csrc/batch_exp_g2.cu): the table (2Q through the
    doubling branch, 3Q..16Q), per window 5 doublings and psi, psi^2, psi^3
    of the gathered entries (6 + 4 + 6), one add per nonzero digit after the
    first."""
    ops = FQ_PRODUCTS["g2"]
    _, nw, n = digits.shape
    table = ops["add_head"] + ops["dbl"] + 14 * ops["add"]
    adds = int(((digits != 0).sum((0, 1)) - 1).clamp(min=0).sum())
    return n * (table + nw * (5 * ops["dbl"] + 16)) + adds * ops["add"]


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
         lambda k: glv.decompose_signed(k), _k1_products, "phase2_bn254_tpu_torch/csrc/batch_exp_g1.cu",
         "phase2_bn254_tpu/ops/pallas_exp.py:728"),
        ("batch_exp_gls_signed", "g2", FQ2, batch_exp.batch_exp_gls_signed, batch_exp.batch_exp_gls_signed_plain,
         lambda k: (gls.decompose_signed(k),), _k2_products, "phase2_bn254_tpu_torch/csrc/batch_exp_g2.cu",
         "phase2_bn254_tpu/ops/pallas_exp.py:1073"),
    ]
    records = []
    for name, group, f, kernel, plain, split, products, source, replaces in cases:
        pts, _ = _tiled_points(group, n, dev, rng)
        x, y = pts.x, pts.y
        digits = split(convert.ints_to_limbs(_edge_scalars(n, rng), dev))
        got = kernel(x, y, *digits)
        want, plain_ms = once_ms(lambda: plain(x, y, *digits))
        same_jac = all(torch.equal(a, b) for a, b in zip(got, want))
        ga, wa = G.jac_normalize(f, got), G.jac_normalize(f, want)
        err = max_limb_err(ga[:2], wa[:2])
        if err != 0 or not torch.equal(ga.inf, wa.inf):
            raise AssertionError(f"{name}: kernel and plain version differ (max abs limb error {err})")
        ms = cuda_ms(lambda: kernel(x, y, *digits), 5)
        rec = record(card, name, source, replaces, err, ms, plain_ms,
                     (nbytes(x, y, *digits, *got), products(*digits)))
        log(f"phase 2 {name}: N={n} kernel == plain (Jacobian identical: {same_jac}, "
            f"{int(ga.inf.sum())} at infinity); kernel {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call, "
            f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}: {products(*digits) / n:.0f} Fq products/point)")
        records.append(rec)
    return records


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

    def wall_of(self, key: str, owner, attr: str) -> None:
        fn = getattr(owner, attr)
        self.wall.setdefault(key, 0.0)

        def inner(*a, **k):
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                self.wall[key] += time.time() - t0

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


def phase_contribute(workdir: str, records: list[dict], size: int = SMOKE_SIZE, batch: int = SMOKE_BATCH) -> None:
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

    low = len(list(params.chunks("low")))
    high = len(list(params.chunks("high")))
    want = {"batch_exp_glv_signed": 3 * low + high, "batch_exp_gls_signed": low}
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
    log(f"  hash chain ok; {checked} spot checks == refimpl ({t_check:.1f} s)")
    for group in ("g1", "g2"):
        _profile_contribute_chunk(group, batch)


def _profile(fn, kinds) -> str:
    """Run fn under torch.profiler; device time by kind (the first kind
    whose key is in a kernel's name; "copies" for copies and sets, "glue
    kernels" for the rest) and the device's idle share between the first
    and the last device activity."""
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

def _k3_products(group: str, prep, nsets: int) -> int:
    """Fq products of K3: one mixed add per point of a lane's run after its
    first (the first lands on infinity); the inputs hold no point at
    infinity."""
    from phase2_bn254_tpu_torch.ops import msm as M

    _, length = M.lane_runs(prep.starts, prep.counts, prep.groups)
    return nsets * int((length - 1).clamp(min=0).sum()) * FQ_PRODUCTS[group]["madd"]


def _k4_products(group: str, buckets, groups) -> int:
    """Fq products of K4's serial running sum over lanes B-1..1: an add per
    finite bucket after the first, and an add into the total at each weight
    step where the running sum is finite, after the first."""
    import torch
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2

    f = FQ if group == "g1" else FQ2
    finite = ~f.is_zero(buckets.z)[..., 1:]  # (S, nwin, B - 1), lanes 1..B-1
    running = finite.flip(-1).cumsum(-1).flip(-1) > 0
    lane = torch.arange(1, finite.shape[-1] + 1, device=finite.device)
    step = (lane[None, :] % groups[:, None]) == 0
    adds = (finite.sum(-1) - 1).clamp(min=0) + ((running & step).sum(-1) - 1).clamp(min=0)
    return int(adds.sum()) * FQ_PRODUCTS[group]["add"]


def _k5_products(group: str, sums, c: int) -> int:
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2

    f = FQ if group == "g1" else FQ2
    nsets, nwin = sums.z.shape[:2]
    finite = int((~f.is_zero(sums.z)).sum())
    ops = FQ_PRODUCTS[group]
    return nsets * nwin * c * ops["dbl"] + max(finite - nsets, 0) * ops["add"]


def _d1_products(group: str, n: int) -> int:
    """Fq products of D1 per point (csrc/decompress.cu), square-and-multiply
    from the top bit of each public exponent; G2 counts the usual branch
    (alpha != -1)."""
    from phase2_bn254_tpu_torch.refimpl.field import Q

    def pow_cost(e, sqr, mul):
        return (e.bit_length() - 1) * sqr + (bin(e).count("1") - 1) * mul

    if group == "g1":  # to Montgomery, x^3 + b, the root, two from-Montgomery, y^2 == rhs
        per = 1 + 2 + pow_cost((Q + 1) // 4, 1, 1) + 2 + 1
    else:  # to Montgomery, v, a1, alpha, a0, a1 v, (1 + alpha)^((q-1)/2), its product, four from-Montgomery, y^2
        per = (2 + 5 + pow_cost((Q - 3) // 4, 2, 3) + 5 + 3 + 3 + pow_cost((Q - 1) // 2, 2, 3) + 3 + 4 + 2)
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


def _msm_case(group: str, n: int, scalars: list[int], rng: random.Random, plain_k3: bool) -> dict:
    """One power_pairs-shaped MSM (n scalars, n + 1 tiled points, shifts 0
    and 1) through K3, K4, K5 on the card, each against its plain version
    (K3 only when plain_k3), and the results against refimpl."""
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.ops import msm as M

    f = FQ if group == "g1" else FQ2
    dev = torch.device(DEVICE)
    pts, logs = _tiled_points(group, n + 1, dev, rng)
    k = convert.ints_to_limbs(scalars, dev)
    c = M.pick_window(n)
    prep = M.prep_windows(k, c)
    shifts = torch.tensor([0, 1], device=dev)
    args = (pts.x, pts.y, pts.inf, shifts, prep.orders, prep.starts, prep.counts, prep.groups)
    out = {"c": c}

    buckets = M.bucket_accumulate(*args)
    reps = 2 if plain_k3 else 1
    out["k3_ms"] = cuda_ms(lambda: M.bucket_accumulate(*args), reps)
    out["k3_work"] = (nbytes(*args, *buckets), _k3_products(group, prep, 2))
    if plain_k3:
        want, out["k3_plain_ms"] = once_ms(lambda: M.bucket_accumulate_plain(*args))
        out["k3_err"] = max_limb_err(buckets, want)
        if out["k3_err"]:
            raise AssertionError(f"K3 {group}: kernel and plain version differ (max abs limb error {out['k3_err']})")

    sums = M.bucket_reduce(buckets, prep.groups)
    out["k4_ms"] = cuda_ms(lambda: M.bucket_reduce(buckets, prep.groups), 3)
    want, out["k4_plain_ms"] = once_ms(lambda: M.bucket_reduce_plain(buckets, prep.groups))
    flat = [G.JacobianBatch(*(t.reshape(-1, *t.shape[2:]) for t in s)) for s in (sums, want)]
    got_aff, want_aff = (G.jac_normalize(f, s) for s in flat)
    out["k4_err"] = max_limb_err(got_aff, want_aff)
    if out["k4_err"]:
        raise AssertionError(f"K4 {group}: kernel and plain version differ on the affine window sums")
    out["k4_work"] = (nbytes(*buckets, prep.groups, *sums), _k4_products(group, buckets, prep.groups))

    res = M.combine_windows(sums, c)
    out["k5_ms"] = cuda_ms(lambda: M.combine_windows(sums, c), 3)
    want, out["k5_plain_ms"] = once_ms(lambda: M.combine_windows_plain(sums, c))
    out["k5_err"] = max_limb_err(res, want)
    if out["k5_err"]:
        raise AssertionError(f"K5 {group}: kernel and plain version differ (max abs limb error {out['k5_err']})")
    out["k5_work"] = (nbytes(*sums, *res), _k5_products(group, sums, c))

    got = _jac_points(group, res)
    for s in (0, 1):
        if got[s] != _msm_reference(group, logs, scalars, s, n):
            raise AssertionError(f"MSM {group} set {s}: differs from refimpl")
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
    return {"ms": ms, "plain_ms": plain_ms, "err": err,
            "work": (nbytes(x, greatest, *got[:2], valid), _d1_products(group, n))}


def phase_msm_kernels(card: Card, records: list[dict], n: int = KERNEL_N) -> None:
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    rng = random.Random(99)
    res = {}
    for group in ("g1", "g2"):
        uniform = _msm_case(group, n, _edge_scalars(n, rng), rng, plain_k3=True)
        hot_scalar = rng.randrange(R_MOD)
        hot = _msm_case(group, n, [hot_scalar] * n, rng, plain_k3=False)
        hot_small = _msm_case(group, HOT_N, [hot_scalar] * HOT_N, rng, plain_k3=True)
        d1 = _d1_case(group, n, rng)
        res[group] = uniform, hot, hot_small, d1
        c = uniform["c"]
        log(f"phase 6 MSM {group}: N={n} (+1 points, 2 sets), c={c}: K3, K5 == plain limb for limb, K4 == plain "
            f"after normalizing; results == refimpl; uniform scalars: K3 {uniform['k3_ms']:.3f} ms "
            f"(plain {uniform['k3_plain_ms']:.3f}), K4 {uniform['k4_ms']:.3f} ms (plain {uniform['k4_plain_ms']:.3f}), "
            f"K5 {uniform['k5_ms']:.3f} ms (plain {uniform['k5_plain_ms']:.3f})")
        log(f"  all-equal scalars: K3 {hot['k3_ms']:.3f} ms (one lane per window adds all {n} points; limb check "
            f"vs plain at N={HOT_N}: K3 {hot_small['k3_ms']:.3f} ms, plain {hot_small['k3_plain_ms']:.3f} ms), "
            f"K4 {hot['k4_ms']:.3f} ms (plain {hot['k4_plain_ms']:.3f}), K5 {hot['k5_ms']:.3f} ms "
            f"(plain {hot['k5_plain_ms']:.3f}); results == refimpl")
        for key, what in (("k3", "K3"), ("k4", "K4"), ("k5", "K5")):
            for label, case in (("uniform", uniform), ("all-equal", hot)):
                b, by = card.bound(*case[f"{key}_work"])
                log(f"  bound {what} {label}: {b:.3f} ms ({by}; {case[f'{key}_work'][1]} Fq products, "
                    f"{case[f'{key}_work'][0]} bytes)")
        b, by = card.bound(*d1["work"])
        log(f"phase 6 D1 {group}: N={n} ({NONRESIDUES} without a root, flags random): kernel == plain limb for limb "
            f"and mask; mask == host residuosity; 64 points == refimpl; a non-residue through decode_batch raises; "
            f"kernel {d1['ms']:.3f} ms, plain {d1['plain_ms']:.3f} ms, bound {b:.3f} ms ({by})")

    sources = "phase2_bn254_tpu_torch/csrc/msm.cu"
    for name, key, replaces in (("bucket_accumulate", "k3", "phase2_bn254_tpu/ops/pallas_msm.py:198"),
                                ("bucket_reduce", "k4", "phase2_bn254_tpu/ops/pallas_msm.py:328"),
                                ("combine_windows", "k5", "phase2_bn254_tpu/ops/pallas_msm.py:591")):
        per = {}
        for group in ("g1", "g2"):
            uniform = res[group][0]
            bound_ms, bound_by = card.bound(*uniform[f"{key}_work"])
            per[group] = {"ms": uniform[f"{key}_ms"], "plain_ms": uniform[f"{key}_plain_ms"],
                          "max_abs_err": uniform[f"{key}_err"], "bound_ms": bound_ms, "bound_by": bound_by,
                          "all_equal_ms": res[group][1][f"{key}_ms"]}
        g1 = per["g1"]
        records.append(record(card, name, sources, replaces, max(p["max_abs_err"] for p in per.values()), g1["ms"],
                              g1["plain_ms"], res["g1"][0][f"{key}_work"], g2=per["g2"],
                              shape=f"N={n}, c={res['g1'][0]['c']}, 2 sets, uniform scalars; g2 and all-equal beside"))
    per = {}
    for group in ("g1", "g2"):
        d1 = res[group][3]
        bound_ms, bound_by = card.bound(*d1["work"])
        per[group] = {"ms": d1["ms"], "plain_ms": d1["plain_ms"], "max_abs_err": d1["err"], "bound_ms": bound_ms,
                      "bound_by": bound_by}
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


def phase_verify(workdir: str, records: list[dict], size: int = SMOKE_SIZE, batch: int = SMOKE_BATCH) -> None:
    import torch
    from phase2_bn254_tpu_torch.ceremony import accumulator
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

    timers = _Timers()
    for name in ("decode", "power_pairs", "encode"):
        timers.wall_of(name, B.TorchBackend, name)
    timers.wall_of("coefficients", B, "random_scalars")
    timers.wall_of("prep", M, "prep_windows")
    timers.wall_of("ratios", accumulator._RatioAccumulator, "add")
    timers.wall_of("pairings", accumulator.SameRatioBatch, "flush")
    timers.wall_of("hashing", phase1, "calculate_hash")
    for name in M.LAUNCHES:
        timers.device_of("msm", M, name)
        M.LAUNCHES[name] = 0
    timers.device_of("d1", D, "decompress")
    D.LAUNCHES["decompress"] = 0
    pp_calls = [0]
    counted = B.TorchBackend.power_pairs

    def power_pairs(self, ps):
        pp_calls[0] += 1
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
    launches = {**M.LAUNCHES, **D.LAUNCHES}

    low = len(list(params.chunks("low")))
    high = len(list(params.chunks("high")))
    want_pp = 4 * low + high + 1  # every chunk of every kind, and the seam
    if pp_calls[0] != want_pp:
        raise AssertionError(f"{pp_calls[0]} power_pairs calls, want {want_pp}")
    want = {**dict.fromkeys(M.LAUNCHES, want_pp), "decompress": 2 * (4 * low + high)}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want} (K3-K5: one per power_pairs, which runs its "
                             f"two MSMs as two sets; D1: one per compressed chunk decode, verify and decompress)")
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

    w = timers.wall
    top = ("decode", "power_pairs", "ratios", "pairings", "encode", "hashing")
    other = total - sum(w[k] for k in top)
    log(f"phase 8 verify: size {size} batch {batch}: passes; {want_pp} power_pairs ({2 * want_pp} MSMs) -> K3, K4, K5 "
        f"launches {launches['bucket_accumulate']}, {launches['bucket_reduce']}, {launches['combine_windows']}; "
        f"D1 launches {launches['decompress']} (== compressed chunk decodes)")
    log(f"  wall s: total {total:.3f} | decode (codec, D1, valid-mask sync) {w['decode']:.3f} | power_pairs "
        f"{w['power_pairs']:.3f} (of it coefficients {w['coefficients']:.3f}, prep enqueue {w['prep']:.3f}; the rest "
        f"launches and the wait for the two results) | host ratio accumulation {w['ratios']:.3f} | host pairings "
        f"{w['pairings']:.3f} | decompress-encode {w['encode']:.3f} | hashing {w['hashing']:.3f} | other (heads, "
        f"file I/O) {other:.3f}")
    log(f"  device s (CUDA events): K3 + K4 + K5 {timers.device_s('msm'):.3f}, D1 {timers.device_s('d1'):.3f}")
    log(f"  new challenge hash chain ok; {checked} spot checks == refimpl decompression of the response "
        f"({t_check:.1f} s)")
    _profile_power_pairs(response, params)


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
    records = phase_kernels(card)
    with tempfile.TemporaryDirectory() as workdir:
        phase_golden(workdir)
        phase_parity(workdir)
        phase_contribute(workdir, records)
        phase_msm_kernels(card, records)
        phase_verify_small(workdir)
        phase_verify(workdir, records)
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
