#!/usr/bin/env python3
"""Time K6, K8, K9, K1, D1, K3-K5, K7, K10, K7-BLS and the prover's h step
of this checkout and of another one on the same card, and compare three of
their outputs byte for byte.

    python3 scripts/bench_parent.py --parent DIR [--bytes] [--out DIR]
    python3 scripts/bench_parent.py --parent DIR --msm [--out DIR]

DIR is another checkout of the repository (e.g. the parent commit unpacked
with `git archive` into a directory .gitignore lists). Each checkout runs in
processes of its own (both hold a package named phase2_bn254_tpu_torch),
builds its kernels with its own ops/_build.py and makes its inputs with its
own chip_smoke.py helpers from the same seeds. The timing process runs four
times, in the order parent, this, this, parent; each times, with CUDA events
after a warm-up call, each call (`chip_smoke.cuda_ms`: the host's launch
time counts where it is longer than the kernels') and, for K6, also its
device work alone (this checkout's `chip_smoke.device_ms`, for both trees):

* K6: `ntt` forward at exp 18, 20 and 24 and inverse at 18; `coset_ntt` and
  `icoset_ntt` of `divide_by_z_on_coset` (the prover's forms; this
  checkout folds their factors into the passes) at exp 18;
* the prover's h step, `groth16.prover._h_coefficients`, on random a, b, c
  of 2^18 constraints: host clock to the end of its device work, and its
  device launches under torch.profiler;
* K9 at 2^16 uniform scalars, on 262,141 terms of coefficient 1 (`new`'s G2
  terms in chip_smoke phase 13) and on 2^18 terms with the B coefficients
  of scripts/fixtures/circuit.json; K8 at 2^16 uniform scalars;
* K1 at 2^16 points with chip_smoke's edge scalars first (phase 2's case),
  and D1 on 2^16 G1 and 2^16 G2 x coordinates (phase 6's inputs);
* K3, K4 and K5 on one power_pairs-shaped MSM of 2^16 uniform scalars (two
  sets, the unsigned default's window), G1 and G2, as the checkout's
  msm_sets runs them (with its fold table where it has one);
* K7 at 2^16 points with chip_smoke's edge scalars first (phase 14's case)
  and on 1,310,711 terms of coefficient 1 (`new`'s G1 terms in chip_smoke
  phase 15), K10 at 2^16 with the edge scalars first, and K7-BLS at 2^16
  with chip_smoke's BLS12-381 edge scalars first (phase 16's case);
* and reads the ptxas lines (registers, spills, stack) of K6, K8, K9, K1,
  D1, K3-K5, K7, K10 and K7-BLS from the checkout's build log.

With --msm, the timing process times instead the default MSM path end to
end, as the port's callers run it (four processes, in the same order):
`msm.msm_sets` (prep, K3, K4 and K5 with the checkout's fold table) on
one power_pairs-shaped MSM of 2^16 uniform scalars per group, and on sets
of the prover's sizes at 2^18 constraints (G1: 655,353, 262,143 and
262,141 scalars in one call; G2: 262,141) of a witness-like mix, a
quarter zeros, a quarter ones and the rest uniform; and `prove` on
chip_smoke phase 10's circuit as a user runs it (three runs after a warm
one, wall clock to the end of the device work).

With --bytes, one more process per checkout writes chip_smoke's phase 5
response (size 21, batch 2^16), phase 13's radix file and `new`'s .params
(2^18 constraints) and phase 10's proof with r and s from a seeded ChaChaRng
(`prove` as a user runs it otherwise), and prints their blake2b; the run
fails unless the two checkouts agree.

Prints the card's nvidia-smi line, one line per process and a JSON summary
last; writes the log to <out>/bench_parent.log (--out, by default
build/bench_parent). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import importlib.util
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_TERMS = 262_141  # `new`'s G2 terms at 2^18 constraints (chip_smoke phase 13)
NEW_G1_TERMS = 1_310_711  # `new`'s G1 terms at 2^18 constraints (chip_smoke phase 15)


def _device_ms():
    """This checkout's chip_smoke.device_ms, whichever tree the job runs."""
    spec = importlib.util.spec_from_file_location("_this_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms


def _smoke(tree: str):
    sys.path.insert(0, tree)
    import chip_smoke as S

    found = os.path.dirname(os.path.realpath(S.__file__))
    if found != os.path.realpath(tree):
        raise RuntimeError(f"imported chip_smoke from {found}, not {tree}")
    S.DEVICE = "cuda"
    return S


def _h_launches(fn) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def job_times(tree: str) -> dict:
    """The kernels' and the h step's times in this process's checkout."""
    import inspect
    from types import SimpleNamespace

    import torch

    S = _smoke(tree)
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.groth16 import prover
    from phase2_bn254_tpu_torch.ops import _build, batch_exp, decompress, glv, ntt
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    _build.load()
    dev = torch.device("cuda")
    out = {}
    with open(os.path.join(_build.BUILD_DIR, f"ptxas_{_build._source_hash()}.log")) as f:
        kernel = None  # registers and spills of K6, K8, K9, K1, D1, K3-K5, K7, K10, K7-BLS as this checkout builds them
        for line in f:
            if "Compiling entry function" in line:
                kernel = next((k for k in ("lane_dft_kernel", "exp_g1_windowed_kernel", "exp_g2_windowed_kernel",
                                           "batch_exp_glv_signed_kernel", "decompress_g1_kernel",
                                           "decompress_g2_kernel", "bucket_accumulate_kernel",
                                           "bucket_accumulate_tree_kernel", "bucket_accumulate_collect_kernel",
                                           "bucket_reduce_kernel", "combine_windows_kernel",
                                           "batch_exp_glv_kernel", "batch_exp_gls_kernel",
                                           "batch_exp_bls_glv_kernel")
                               if k in line), None)  # (BLS12-381 instances only where named: exp_bls_g1_... not)
            elif kernel and ("registers" in line or "spill" in line):
                out.setdefault(f"ptxas {kernel}", []).append(line.split(":", 1)[-1].strip())
    device_ms = _device_ms()

    def k6(name, fn):
        out[name] = S.cuda_ms(fn, 5)
        out[f"{name} device"] = device_ms(fn, 5)

    gen = torch.Generator().manual_seed(11)  # on the host: chip_smoke._fr_random moves the values
    for exp, inverse in ((18, False), (18, True), (20, False), (24, False)):
        x = S._fr_random(1 << exp, gen)
        k6(f"ntt {exp}{' inverse' if inverse else ''}", lambda: ntt.ntt(exp, x, inverse))
    x = S._fr_random(1 << 18, gen)
    k6("coset_ntt 18", lambda: ntt.coset_ntt(18, x))
    if "divide_by_z" in inspect.signature(ntt.icoset_ntt).parameters:
        k6("icoset_ntt(divide_by_z) 18", lambda: ntt.icoset_ntt(18, x, divide_by_z=True))
    else:
        k6("icoset_ntt(divide_by_z) 18", lambda: ntt.icoset_ntt(18, ntt.divide_by_z_on_coset(18, x)))
    del x

    rng = random.Random(10)
    vals = SimpleNamespace(**{k: [rng.randrange(R_MOD) for _ in range(1 << 18)] for k in "abc"})
    prover._h_coefficients(vals, dev)  # warm
    walls = []
    for _ in range(3):
        t0 = time.time()
        prover._h_coefficients(vals, dev)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    out["h step s"] = min(walls)
    out["h step launches"] = _h_launches(lambda: prover._h_coefficients(vals, dev))

    def ladder(group, n, scalars):
        pts, _ = S._tiled_points(group, n, dev, rng)
        k = convert.ints_to_limbs(scalars, dev)
        fn = batch_exp.batch_exp_g2_windowed if group == "g2" else batch_exp.batch_exp_g1_windowed
        return S.cuda_ms(lambda: fn(pts.x, pts.y, k), 3)

    out["K9 2^16 uniform"] = ladder("g2", 1 << 16, [rng.randrange(R_MOD) for _ in range(1 << 16)])
    out["K9 new's terms (coefficient 1)"] = ladder("g2", NEW_TERMS, [1] * NEW_TERMS)
    with open(os.path.join(tree, "scripts", "fixtures", "circuit.json")) as f:
        mix = {}  # the fixture's B coefficients and their counts, as chip_smoke._fixture_b_mix counts them
        for _, b, _ in json.load(f)["constraints"]:
            for v in b.values():
                mix[int(v) % R_MOD] = mix.get(int(v) % R_MOD, 0) + 1
    mix_rng = random.Random(12)
    out["K9 fixture mix 2^18"] = ladder("g2", 1 << 18, mix_rng.choices(list(mix), weights=list(mix.values()),
                                                                       k=1 << 18))
    out["K8 2^16 uniform"] = ladder("g1", 1 << 16, [rng.randrange(R_MOD) for _ in range(1 << 16)])

    pts, _ = S._tiled_points("g1", 1 << 16, dev, rng)
    digits = glv.decompose_signed(convert.ints_to_limbs(S._edge_scalars(1 << 16, rng), dev))
    out["K1 2^16 edge and uniform"] = S.cuda_ms(lambda: batch_exp.batch_exp_glv_signed(pts.x, pts.y, *digits), 5)
    for group in ("g1", "g2"):
        xs, flags = S._d1_inputs(group, 1 << 16, rng)
        x, greatest = S._x_digits(group, xs, dev), torch.tensor(flags, device=dev)
        out[f"D1 {group} 2^16"] = S.cuda_ms(lambda: decompress.decompress(x, greatest, group), 5)
    for group, kernels in _msm_kernels(S, dev, rng).items():
        for name, fn in kernels.items():
            out[f"{name} {group} 2^16 uniform, 2 sets"] = S.cuda_ms(fn, 5)
    out.update(_glv_gls_times(S, dev, rng))
    return out


def _glv_gls_times(S, dev, rng) -> dict:
    """K7 (2^16 edge and uniform scalars; `new`'s G1 terms, coefficient 1),
    K10 (2^16 edge and uniform) and K7-BLS (2^16, BLS12-381 edge and
    uniform) in the checkout."""
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.bls12_381 import device as D
    from phase2_bn254_tpu_torch.ops import batch_exp, gls, glv

    out, n = {}, 1 << 16
    pts, _ = S._tiled_points("g1", n, dev, rng)
    inputs = glv.decompose(convert.ints_to_limbs(S._edge_scalars(n, rng), dev))
    out["K7 2^16 edge and uniform"] = S.cuda_ms(lambda: batch_exp.batch_exp_glv(pts.x, pts.y, *inputs), 5)
    ones, _ = S._tiled_points("g1", NEW_G1_TERMS, dev, rng)
    unit = glv.decompose(convert.ints_to_limbs([1] * NEW_G1_TERMS, dev))
    out["K7 new's G1 terms (coefficient 1)"] = S.cuda_ms(lambda: batch_exp.batch_exp_glv(ones.x, ones.y, *unit), 5)
    del ones, unit
    qts, _ = S._tiled_points("g2", n, dev, rng)
    digits = gls.decompose(convert.ints_to_limbs(S._edge_scalars(n, rng), dev))
    out["K10 2^16 edge and uniform"] = S.cuda_ms(lambda: batch_exp.batch_exp_gls(qts.x, qts.y, *digits), 5)
    bls = S._bls_points("g1", n, rng)
    split = D.decompose_glv_t(D.scalars_to_canon(S._bls_edge_scalars(n, rng), dev))
    out["K7-BLS 2^16 edge and uniform"] = S.cuda_ms(lambda: batch_exp.batch_exp_bls_glv(bls.x, bls.y, *split), 5)
    return out


def _msm_kernels(S, dev, rng) -> dict:
    """K3, K4, K5 calls on one power_pairs-shaped MSM per group (2^16
    uniform scalars, 2^16 + 1 points, shifts 0 and 1, pick_window's c),
    made as the checkout's msm_sets makes them: with its fold table where
    it has one (hot_buckets), the arguments of the parent's otherwise."""
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.ops import msm as M
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    n, out = 1 << 16, {}
    c = M.pick_window(n)
    shifts = torch.tensor([0, 1], device=dev)
    for group in ("g1", "g2"):
        pts, _ = S._tiled_points(group, n + 1, dev, rng)
        k = convert.ints_to_limbs([rng.randrange(R_MOD) for _ in range(n)], dev)
        if hasattr(M, "hot_buckets"):
            prep = M.prep_set(pts, k, (0, 1), c)
            hot = M.Hot(*(t.expand(2, -1).contiguous() for t in M.hot_buckets(prep, n)))
            extra4, extra5 = (False, hot.lane), (hot,)
        else:
            prep, extra4, extra5 = M.prep_windows(k, c), (), ()
        args = (pts.x, pts.y, pts.inf, shifts, *prep[:5])
        buckets = M.bucket_accumulate(*args)
        sums = M.bucket_reduce(buckets, *extra4)
        with_buckets = (buckets, *extra5) if extra5 else ()
        out[group] = {"K3": lambda a=args: M.bucket_accumulate(*a),
                      "K4": lambda b=buckets, e=extra4: M.bucket_reduce(b, *e),
                      "K5": lambda s=sums, w=with_buckets: M.combine_windows(s, c, *w)}
    return out


def _mix(n: int, rng) -> list[int]:
    """n scalars: a quarter zeros, a quarter ones, the rest uniform, shuffled."""
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    ks = [0] * (n // 4) + [1] * (n // 4) + [rng.randrange(R_MOD) for _ in range(n - 2 * (n // 4))]
    rng.shuffle(ks)
    return ks


def job_msm(tree: str) -> dict:
    """The default MSM path and `prove`, end to end (see --msm)."""
    import contextlib

    import torch

    S = _smoke(tree)
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.cli import phase2 as cli2
    from phase2_bn254_tpu_torch.ops import _build
    from phase2_bn254_tpu_torch.ops import msm as M
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    _build.load()
    dev, rng, out = torch.device("cuda"), random.Random(14), {}
    for group in ("g1", "g2"):
        pts, _ = S._tiled_points(group, (1 << 16) + 1, dev, rng)
        k = convert.ints_to_limbs([rng.randrange(R_MOD) for _ in range(1 << 16)], dev)
        out[f"msm_sets {group} 2^16 uniform, shifts 0 and 1"] = S.cuda_ms(lambda: M.msm_sets([(pts, k, (0, 1))]), 20)
    for group, sizes in (("g1", (655_353, 262_143, 262_141)), ("g2", (262_141,))):
        sets = []
        for n in sizes:
            pts, _ = S._tiled_points(group, n, dev, rng)
            sets.append((pts, convert.ints_to_limbs(_mix(n, rng), dev), (0,)))
        out[f"msm_sets {group} prover sizes {list(sizes)}, witness-like mix"] = S.cuda_ms(lambda: M.msm_sets(sets), 20)
        del sets
    with tempfile.TemporaryDirectory() as work, open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        circuit_json, witness_json = S.write_circuit(work, 18, seed=18)
        params = os.path.join(work, "circuit_18.params")
        S.write_params(circuit_json, params, seed=18, device="cuda")
        argv = [circuit_json, witness_json, params, os.path.join(work, "proof.json"),
                os.path.join(work, "public.json"), "--device", "cuda"]
        walls = []
        for _ in range(4):
            t0 = time.time()
            cli2.main_prove(argv)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
    out["prove 2^18 s (three runs after a warm one)"] = walls[1:]
    return out


def job_bytes(tree: str) -> dict:
    """blake2b of phase 5's response, phase 13's radix file and `new`'s
    .params, and phase 10's proof with seeded r and s."""
    import contextlib
    import hashlib

    import torch

    S = _smoke(tree)
    from phase2_bn254_tpu_torch.cli import phase1
    from phase2_bn254_tpu_torch.cli import phase2 as cli2
    from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng

    def digest(path):
        with open(path, "rb") as f:
            return hashlib.blake2b(f.read()).hexdigest()[:16]

    out = {}
    with tempfile.TemporaryDirectory() as work, open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        response = os.path.join(work, "response")
        phase1.compute_constrained(S._challenge(work, S.SMOKE_SIZE, S.SMOKE_BATCH), response, S.SMOKE_SIZE,
                                   S.SMOKE_BATCH, ChaChaRng.from_digest_be(S.SEED), "cuda")
        out["phase 5 response"] = digest(response)
        circuit_json, witness_json = S.write_circuit(work, 18, seed=18)
        radix = os.path.join(work, "radix")
        os.makedirs(radix)
        S.write_radix(radix, 18, seed=13)
        out["phase 13 radix"] = digest(os.path.join(radix, "phase1radix2m18"))
        params = os.path.join(work, "circom1.params")
        cli2.main_new([circuit_json, params, radix, "--device", "cuda"])
        out["phase 13 new .params"] = digest(params)
        gen_params = os.path.join(work, "circuit_18.params")
        S.write_params(circuit_json, gen_params, seed=18, device="cuda")
        proof = os.path.join(work, "proof.json")
        saved = cli2.participant_rng
        cli2.participant_rng = lambda *a: ChaChaRng.from_digest_be(S.SEED)
        try:
            cli2.main_prove([circuit_json, witness_json, gen_params, proof, os.path.join(work, "public.json"),
                             "--device", "cuda"])
        finally:
            cli2.participant_rng = saved
        torch.cuda.synchronize()
        out["phase 10 proof (seeded r, s)"] = digest(proof)
    return out


def _run(tree: str, job: str, log) -> dict:
    with tempfile.NamedTemporaryFile("r", suffix=".json") as f:
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--job", job, "--tree", tree,
                               "--json", f.name], capture_output=True, text=True, timeout=1800)
        if proc.returncode:
            log(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise RuntimeError(f"{job} in {tree} exited with {proc.returncode}")
        res = json.load(f)
    log(f"{job} {tree} ({time.time() - t0:.1f} s): {json.dumps(res)}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout to compare with")
    ap.add_argument("--bytes", action="store_true", help="also compare the phase 5, 10 and 13 outputs")
    ap.add_argument("--msm", action="store_true", help="time the default MSM path and prove end to end instead")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "bench_parent"))
    ap.add_argument("--job", choices=("times", "msm", "bytes"), help=argparse.SUPPRESS)
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--json", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.job:
        res = {"times": job_times, "msm": job_msm, "bytes": job_bytes}[a.job](os.path.abspath(a.tree))
        with open(a.json, "w") as f:
            json.dump(res, f)
        return 0
    if not a.parent:
        ap.error("--parent DIR is required")
    os.makedirs(a.out, exist_ok=True)
    logf = open(os.path.join(a.out, "bench_parent.log"), "w")

    def log(msg):
        print(msg, flush=True)
        logf.write(msg + "\n")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    trees = {"parent": os.path.abspath(a.parent), "this": REPO}
    runs = {"parent": [], "this": []}
    for name in ("parent", "this", "this", "parent"):
        runs[name].append(_run(trees[name], "msm" if a.msm else "times", log))
    summary = {"card": smi, "times": {}}
    for case in runs["this"][0]:
        summary["times"][case] = {name: [r.get(case) for r in rs] for name, rs in runs.items()}
        if case.startswith("ptxas"):
            continue
        p, t = (sum(v) / len(v) for v in ([x for r in rs for x in (r if isinstance(r, list) else [r])]
                                          for rs in summary["times"][case].values()))
        log(f"{case}: parent {p:.4f}, this {t:.4f}, {100 * (t / p - 1):+.2f}% (runs {summary['times'][case]})")
    ok = True
    if a.bytes:
        got = {name: _run(tree, "bytes", log) for name, tree in trees.items()}
        summary["bytes"] = got
        for k in got["this"]:
            same = got["this"][k] == got["parent"][k]
            ok &= same
            log(f"{k}: this {got['this'][k]}, parent {got['parent'][k]}: {'same' if same else 'DIFFERENT'}")
    log(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
