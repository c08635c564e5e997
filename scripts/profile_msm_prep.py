#!/usr/bin/env python3
"""Device time of the MSM's prep (ops/msm.py), unsigned and signed, by
kernel, on one GPU.

    python3 scripts/profile_msm_prep.py [--n N ...] [--c C ...] [--out DIR]

For each N (default 2^16 and 655,353, the prover's largest G1 set in
chip_smoke phase 10) it makes N canonical scalars from a seed, a quarter
ones, a quarter zeros and the rest uniform (chip_smoke._ones_mix, a
witness-like mix), and runs `prep_set` and `hot_buckets` as msm_sets runs
them, unsigned at pick_window's c and signed at each C (default 12, 13):
the call's time (CUDA events, after a warm-up) and, under torch.profiler,
the device time of each kernel name, summed over the call, the top ten.
Prints the card's nvidia-smi line first and a JSON summary last; writes
its log to DIR/profile_msm_prep.log.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _by_kernel(fn) -> dict:
    """{kernel name: device ms} of one call of fn under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1000.0
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:10])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[1 << 16, 655_353])
    ap.add_argument("--c", type=int, nargs="+", default=[12, 13])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile_msm_prep"))
    a = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as S
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.curve import group as G
    from phase2_bn254_tpu_torch.ops import msm as M

    if not torch.cuda.is_available():
        print("profile_msm_prep: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(a.out, exist_ok=True)
    logf = open(os.path.join(a.out, "profile_msm_prep.log"), "w")

    def log(msg):
        print(msg, flush=True)
        logf.write(msg + "\n")

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60).stdout.strip())
    dev, rng, summary = torch.device("cuda"), random.Random(17), {}
    for n in a.n:
        k = convert.ints_to_limbs(S._ones_mix(n, rng), dev)
        pts = G.AffineBatch(None, None, torch.zeros(n, dtype=torch.bool, device=dev))  # the prep reads inf only
        for c, signed in [(M.pick_window(n), False)] + [(c, True) for c in a.c]:
            def fn():
                return M.hot_buckets(M.prep_set(pts, k, (0,), c, signed), n)

            key = f"N={n} {'signed' if signed else 'unsigned'} c={c}"
            summary[key] = {"ms": S.cuda_ms(fn, 5), "kernels_ms": _by_kernel(fn)}
            log(f"{key}: {summary[key]['ms']:.3f} ms a call; by kernel: "
                + "; ".join(f"{name[:80]} {ms:.3f}" for name, ms in summary[key]["kernels_ms"].items()))
    log(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
