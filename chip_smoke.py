#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `phase2_bn254_tpu_torch` through its own entry points and fails (exit
code 1, no result line) if CUDA is missing, if the package is not beside this
script, or if any phase fails. It imports the port and, by their own names,
the JAX package's JAX-free host modules that the port runs and checks against
(the ceremony protocol `cli.phase1`, `ceremony`, `crypto`, and the exact
reference `refimpl`); it never loads jax, and fails if anything did. The
phases:

1. the card's name and power limit; build the kernels (csrc/, nvcc, sm_90a);
2. K1 and K2 against their plain PyTorch versions on the card, at the
   contribute chunk shape (2^16 points) with the edge scalars in the first
   lanes: exact equality after normalizing; time per call of both;
3. the golden size-4 / batch-16 response, byte for byte;
4. a size-10 / batch-256 response byte-identical to the exact host backend;
5. new_constrained + compute_constrained at size 21, batch 2^16 (the
   reference ceremony's design depth): hash chain, spot checks of every
   element kind against refimpl, K1 / K2 launch counts, wall time by phase,
   and a torch.profiler breakdown of one chunk of each group.

Prints one JSON line of the kernels' results, the card's nvidia-smi line,
and last `{"ok": true, "device": {...}}`. Needs no network; starts no
process that outlives it.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = bytes(range(64))
SMOKE_SIZE, SMOKE_BATCH = 21, 1 << 16
KERNEL_N = 1 << 16  # the contribute chunk shape


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from phase2_bn254_tpu_torch.ops import _build

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

def _inputs(group: str, n: int, device, rng: random.Random):
    """n points (256 distinct random multiples of the generator, tiled) and
    n scalars, the edge scalars first."""
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu.refimpl import curve as rc
    from phase2_bn254_tpu.refimpl.field import R_MOD
    from phase2_bn254_tpu.refimpl.glv import LAMBDA

    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    base = convert.points_to_affine([gen.mul(rng.randrange(1, R_MOD)) for _ in range(256)], group, device)
    reps = -(-n // 256)
    x = base.x.repeat((reps,) + (1,) * (base.x.dim() - 1))[:n].contiguous()
    y = base.y.repeat((reps,) + (1,) * (base.y.dim() - 1))[:n].contiguous()
    edge = [1, 2, R_MOD - 1, R_MOD // 2, (R_MOD - 1) // 2, LAMBDA, R_MOD - LAMBDA, (1 << 128) - 1, 1 << 253, 0]
    scalars = edge + [rng.randrange(R_MOD) for _ in range(n - len(edge))]
    return x, y, convert.ints_to_limbs(scalars, device)


def phase_kernels(n: int = KERNEL_N) -> list[dict]:
    import torch
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.ops import batch_exp, gls, glv

    dev = torch.device("cuda")
    rng = random.Random(2024)
    cases = [
        ("batch_exp_glv_signed", "g1", FQ, batch_exp.batch_exp_glv_signed, batch_exp.batch_exp_glv_signed_plain,
         lambda k: glv.decompose_signed(k), "phase2_bn254_tpu_torch/csrc/batch_exp_g1.cu",
         "phase2_bn254_tpu/ops/pallas_exp.py:728"),
        ("batch_exp_gls_signed", "g2", FQ2, batch_exp.batch_exp_gls_signed, batch_exp.batch_exp_gls_signed_plain,
         lambda k: (gls.decompose_signed(k),), "phase2_bn254_tpu_torch/csrc/batch_exp_g2.cu",
         "phase2_bn254_tpu/ops/pallas_exp.py:1073"),
    ]
    records = []
    for name, group, f, kernel, plain, split, source, replaces in cases:
        x, y, k = _inputs(group, n, dev, rng)
        digits = split(k)
        got = kernel(x, y, *digits)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(x, y, *digits)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        same_jac = all(torch.equal(a, b) for a, b in zip(got, want))
        ga, wa = G.jac_normalize(f, got), G.jac_normalize(f, want)
        err = max(int((a - b).abs().max()) for a, b in zip(ga[:2], wa[:2]))
        if err != 0 or not torch.equal(ga.inf, wa.inf):
            raise AssertionError(f"{name}: kernel and plain version differ (max abs limb error {err})")
        ms = cuda_ms(lambda: kernel(x, y, *digits), 5)
        log(f"phase 2 {name}: N={n} kernel == plain (Jacobian identical: {same_jac}, "
            f"{int(ga.inf.sum())} at infinity); kernel {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call")
        records.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
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


def _torch_response(workdir: str, size: int, batch: int) -> bytes:
    """compute_constrained on the card with the fixed ChaCha seed."""
    from phase2_bn254_tpu.crypto.chacha import ChaChaRng
    from phase2_bn254_tpu_torch.cli.phase1 import compute_constrained

    response = os.path.join(workdir, f"response_{size}_torch")
    compute_constrained(_challenge(workdir, size, batch), response, size, batch, ChaChaRng.from_digest_be(SEED), "cuda")
    with open(response, "rb") as f:
        return f.read()


def phase_golden(workdir: str) -> None:
    got = _torch_response(workdir, 4, 16)
    with open(os.path.join(REPO, "tests", "fixtures", "golden_response_s4_b16.bin"), "rb") as f:
        want = f.read()
    if got != want:
        raise AssertionError("size-4 response differs from tests/fixtures/golden_response_s4_b16.bin")
    log(f"phase 3 golden: size 4 batch 16 response == fixture ({len(got)} bytes, "
        f"blake2b {hashlib.blake2b(got).hexdigest()[:16]})")


def phase_parity(workdir: str) -> None:
    from phase2_bn254_tpu.cli.phase1 import contribute
    from phase2_bn254_tpu.crypto.chacha import ChaChaRng
    from phase2_bn254_tpu.refimpl.backend import ExactBackend

    t0 = time.time()
    got = _torch_response(workdir, 10, 256)
    t1 = time.time()
    response = os.path.join(workdir, "response_10_exact")
    contribute(_challenge(workdir, 10, 256), response, 10, 256, ChaChaRng.from_digest_be(SEED), backend=ExactBackend())
    with open(response, "rb") as f:
        want = f.read()
    if got != want:
        raise AssertionError("size-10 response differs from the exact host backend's")
    log(f"phase 4 parity: size 10 batch 256 response == ExactBackend ({len(got)} bytes; "
        f"torch {t1 - t0:.1f} s, exact {time.time() - t1:.1f} s)")


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

class _Timers:
    """Wall time by phase of one contribute: wraps the backend's protocol
    methods and the kernel wrappers (CUDA events)."""

    def __init__(self):
        self.wall = {"decode": 0.0, "pow_mul": 0.0, "encode": 0.0}
        self.events = []

    def wrap_wall(self, key, fn):
        def inner(*a, **k):
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                self.wall[key] += time.time() - t0
        return inner

    def wrap_kernel(self, fn):
        import torch

        def inner(*a, **k):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            self.events.append((s, e))
            return out
        return inner

    def kernel_seconds(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events) / 1000.0


def _spot_check(response: str, params, key, rng: random.Random) -> int:
    """Compare >= 64 indices of every element kind, chunk edges included,
    with G * coeff * tau^i from refimpl."""
    from phase2_bn254_tpu.refimpl import curve as rc
    from phase2_bn254_tpu.refimpl.field import R_MOD

    checked = 0
    b = params.batch_size
    for kind, coeff, lo, hi in (
        ("tau_g1", 1, 0, params.powers_length),
        ("tau_g1", 1, params.powers_length, params.powers_g1_length),
        ("tau_g2", 1, 0, params.powers_length),
        ("alpha_g1", key.alpha, 0, params.powers_length),
        ("beta_g1", key.beta, 0, params.powers_length),
    ):
        edges = {lo, lo + 1, hi - 1}
        for s in range(lo, hi, b):
            edges.update({s, s + b - 1})
        idx = sorted(i for i in edges if lo <= i < hi)
        idx = sorted(set(idx[:48] + idx[-8:] + [rng.randrange(lo, hi) for _ in range(64)]))
        group = "g2" if kind == "tau_g2" else "g1"
        gen = rc.G2_GEN if group == "g2" else rc.G1_GEN
        esize = params.element_size(kind, True)
        with open(response, "rb") as f:
            for i in idx:
                f.seek(params.position(kind, i, True))
                got = rc.point_from_bytes(f.read(esize), group, True, check=False)
                want = gen.mul(coeff * pow(key.tau, i, R_MOD) % R_MOD)
                if got != want:
                    raise AssertionError(f"{kind}[{i}] differs from G * coeff * tau^{i}")
                checked += 1
        if len(idx) < 64:
            raise AssertionError(f"{kind}: only {len(idx)} indices checked")
    return checked


def phase_contribute(workdir: str, records: list[dict], size: int = SMOKE_SIZE, batch: int = SMOKE_BATCH) -> None:
    from phase2_bn254_tpu.ceremony.keypair import keypair
    from phase2_bn254_tpu.ceremony.params import HASH_SIZE, CeremonyParams
    from phase2_bn254_tpu.crypto.chacha import ChaChaRng
    from phase2_bn254_tpu.crypto.hashing import calculate_hash
    from phase2_bn254_tpu_torch.cli.phase1 import compute_constrained
    from phase2_bn254_tpu_torch.ops import batch_exp
    from phase2_bn254_tpu_torch.ops.backend import TorchBackend

    params = CeremonyParams(size, batch)
    response = os.path.join(workdir, f"response_{size}")
    t0 = time.time()
    challenge = _challenge(workdir, size, batch)
    t_new = time.time() - t0

    timers = _Timers()
    methods = {name: getattr(TorchBackend, name) for name in timers.wall}
    kernels = (batch_exp.batch_exp_glv_signed, batch_exp.batch_exp_gls_signed)
    for name, fn in methods.items():
        setattr(TorchBackend, name, timers.wrap_wall(name, fn))
    batch_exp.batch_exp_glv_signed, batch_exp.batch_exp_gls_signed = (timers.wrap_kernel(k) for k in kernels)
    for name in batch_exp.LAUNCHES:
        batch_exp.LAUNCHES[name] = 0
    try:
        t0 = time.time()
        response_hash = compute_constrained(challenge, response, size, batch, ChaChaRng.from_digest_be(SEED), "cuda")
        total = time.time() - t0
    finally:
        for name, fn in methods.items():
            setattr(TorchBackend, name, fn)
        batch_exp.batch_exp_glv_signed, batch_exp.batch_exp_gls_signed = kernels
    launches = dict(batch_exp.LAUNCHES)

    low = len(list(params.chunks("low")))
    high = len(list(params.chunks("high")))
    want = {"batch_exp_glv_signed": 3 * low + high, "batch_exp_gls_signed": low}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want} (one per chunk call)")
    for r in records:
        r["launches"] = launches[r["name"]]

    # contribute hashes the challenge and the response once each; timed again here
    t0 = time.time()
    challenge_hash = calculate_hash(challenge)
    if calculate_hash(response) != response_hash:
        raise AssertionError("the response file's hash differs from the one compute_constrained returned")
    t_hash = time.time() - t0
    with open(response, "rb") as f:
        if f.read(HASH_SIZE) != challenge_hash:
            raise AssertionError("hash chain: the response does not start with the challenge hash")
    if os.path.getsize(response) != params.contribution_size:
        raise AssertionError("response has the wrong size")
    _, key = keypair(ChaChaRng.from_digest_be(SEED), challenge_hash)
    t0 = time.time()
    checked = _spot_check(response, params, key, random.Random(7))
    t_check = time.time() - t0

    kern = timers.kernel_seconds()
    w = timers.wall
    other = total - sum(w.values()) - t_hash
    log(f"phase 5 contribute: size {size} batch {batch}: {params.powers_g1_length} tau_g1 + 2x{params.powers_length} "
        f"alpha/beta_g1 G1 and {params.powers_length} tau_g2 G2 points; K1 launches {launches['batch_exp_glv_signed']}, "
        f"K2 launches {launches['batch_exp_gls_signed']} (== chunk calls)")
    log(f"  wall s: total {total:.3f} | decode {w['decode']:.3f} | pow_mul enqueue (glue: tau powers, split, "
        f"normalize start; ladder launch) {w['pow_mul']:.3f} | encode (wait for the device, normalize finish, codec, "
        f"bytes) {w['encode']:.3f} | hashing (challenge + response, timed again after the run) {t_hash:.3f} | "
        f"other (keypair, file I/O) {other:.3f}")
    log(f"  device s: K1 + K2 kernels {kern:.3f} (CUDA events); new_constrained {t_new:.3f} s")
    log(f"  hash chain ok; {checked} spot checks == refimpl ({t_check:.1f} s)")
    for group in ("g1", "g2"):
        _profile_chunk(group, batch)


def _profile_chunk(group: str, n: int) -> None:
    """Device time of one chunk's pow_mul + encode by kind (the ladder
    kernel, the other kernels of the glue, copies) and the device's idle
    share between the first and the last of them, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from phase2_bn254_tpu.refimpl import curve as rc
    from phase2_bn254_tpu_torch.ops.backend import TorchBackend

    be = TorchBackend("cuda")
    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    ps = be.decode(rc.point_to_bytes(gen, False) * n, group, n, False, False)
    be.encode(be.pow_mul(ps, 5, 0, None), True)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        be.encode(be.pow_mul(ps, 7, 1 << 20, 3), True)
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        raise AssertionError("torch.profiler recorded no device activity")
    sums = {"ladder": 0.0, "glue kernels": 0.0, "copies": 0.0}
    counts = dict.fromkeys(sums, 0)
    for start, end, name in spans:
        kind = "ladder" if "batch_exp" in name else "copies" if "Memcpy" in name or "Memset" in name else "glue kernels"
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
    log(f"  profile {group} chunk of {n}: host wall {wall * 1000:.3f} ms; device {parts}; "
        f"idle {100 * (1 - busy / window):.1f}% of the {window / 1000:.3f} ms device window")


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
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    records = phase_kernels()
    with tempfile.TemporaryDirectory() as workdir:
        phase_golden(workdir)
        phase_parity(workdir)
        phase_contribute(workdir, records)
    if "jax" in sys.modules:
        print("chip_smoke: jax was loaded", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
