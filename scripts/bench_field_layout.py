#!/usr/bin/env python3
"""Time the kernels' field-code layout against the layouts it was chosen over,
on one GPU.

    python3 scripts/bench_field_layout.py [--parent DIR] [--reps N]

The port builds one layout (`default`): field.cuh's PTX product and square
behind a call of their own, as the group operations are, and K5 as one warp
per set. This script makes the others from a copy of csrc/ under
build/kernels/, changed as text, so that they live nowhere in the port:

* `inline`: the Fq product and square `__forceinline__` into the group
  operations;
* `k5_serial`: K5 with every product of a level in order on each lane
  (`SerialProducts`), i.e. the one-thread chain;
* `parent` (with --parent DIR): the kernels of another checkout of the
  repository (e.g. the parent commit unpacked with `git archive`), built by
  that checkout's own ops/_build.py.

It times K1, K2, K3 and K5 of each build on the same inputs, in turns (each
layout once in order, then in reverse order, `--reps` times), after checking
that every build gives the default build's limbs. Inputs are those of
chip_smoke.py: K1 / K2 at the contribute chunk (2^16 points, edge and random
scalars), K3 / K5 at the verify chunk (2^16 points, two sets, c = 9), G1 and
G2. Prints each build's ptxas registers and spills of these kernels, one line
per time, and a JSON summary last; writes the whole log to
chiprun_out/bench_field_layout.log. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as S  # noqa: E402

# layout -> (file, text, replacement); each text must occur in the file
PATCHES = {
    "inline": [("field.cuh", "static __device__ __noinline__ Fp mul(", "static __device__ __forceinline__ Fp mul("),
               ("field.cuh", "static __device__ __noinline__ Fp sqr(", "static __device__ __forceinline__ Fp sqr(")],
    "k5_serial": [("msm.cu", "s, nwin, c, WarpProducts())", "s, nwin, c, SerialProducts())")],
}
VARIANT_SOURCES = ("batch_exp_g1.cu", "batch_exp_g2.cu", "msm.cu")
ENTRIES = ("p2_batch_exp_glv_signed", "p2_batch_exp_gls_signed", "p2_bucket_accumulate_g1", "p2_bucket_accumulate_g2",
           "p2_bucket_reduce_g1", "p2_bucket_reduce_g2", "p2_combine_windows_g1", "p2_combine_windows_g2")
PTXAS_KEYS = ("batch_exp_glv_signed_kernel", "batch_exp_gls_signed_kernel", "bucket_accumulate_kernel",
              "combine_windows_kernel")
_LOG = []


def log(msg: str) -> None:
    _LOG.append(msg)
    print(msg, flush=True)


def _ptxas(logf: str) -> list[str]:
    """Registers and spills of the kernels of PTXAS_KEYS from a ptxas log."""
    out, keep = [], False
    with open(logf) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                keep = any(k in name for k in PTXAS_KEYS)
                if keep:
                    out.append(name)
            elif keep and ("registers" in line or "spill" in line):
                out.append("    " + line.strip().removeprefix("ptxas info    : "))
    return out


def _build_variant(name: str) -> tuple[str, str]:
    """A copy of csrc/ with PATCHES[name] applied, its VARIANT_SOURCES built
    into one library: (library path, ptxas log path)."""
    from phase2_bn254_tpu_torch.ops import _build

    d = os.path.join(_build.BUILD_DIR, f"variant_{name}_{_build._source_hash()}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    _build.write_headers(d, _build.generated_headers())
    for fname, old, new in PATCHES[name]:
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"{name}: {fname} no longer holds {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    nvcc = _build._nvcc()
    objs = [os.path.join(d, s + ".o") for s in VARIANT_SOURCES]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, os.path.join(d, s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(VARIANT_SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    logf = os.path.join(d, "ptxas.log")
    with open(logf, "w") as f:
        f.write("".join(logs))
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{name}: nvcc failed, see {logf}")
    lib = os.path.join(d, "lib.so")
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", lib, *objs], check=True)
    return lib, logf


def _parent_library(parent: str) -> tuple[str, str]:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from phase2_bn254_tpu_torch.ops import _build; print(_build.build())")
    res = subprocess.run([sys.executable, "-c", code, parent], capture_output=True, text=True, check=True)
    lib = res.stdout.strip().splitlines()[-1]
    return lib, os.path.join(os.path.dirname(lib), os.path.basename(lib).replace("libp2kernels_", "ptxas_")[:-3] + ".log")


def _open(path: str) -> ctypes.CDLL:
    from phase2_bn254_tpu_torch.ops import _build

    lib = ctypes.CDLL(path)
    for name in ENTRIES:
        nptr, nint = _build.ENTRY_POINTS[name]
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _cases():
    """name -> thunk on the card: the inputs are made once."""
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.ops import batch_exp, gls, glv
    from phase2_bn254_tpu_torch.ops import msm as M

    dev = torch.device("cuda")
    rng = random.Random(9)
    n = S.KERNEL_N
    cases = {}
    pts, _ = S._tiled_points("g1", n, dev, rng)
    d1, d2 = glv.decompose_signed(convert.ints_to_limbs(S._edge_scalars(n, rng), dev))
    cases["K1"] = lambda: batch_exp.batch_exp_glv_signed(pts.x, pts.y, d1, d2)
    qts, _ = S._tiled_points("g2", n, dev, rng)
    dg = gls.decompose_signed(convert.ints_to_limbs(S._edge_scalars(n, rng), dev))
    cases["K2"] = lambda: batch_exp.batch_exp_gls_signed(qts.x, qts.y, dg)
    for group in ("g1", "g2"):
        p, _ = S._tiled_points(group, n + 1, dev, rng)
        c = M.pick_window(n)
        prep = M.prep_windows(convert.ints_to_limbs(S._edge_scalars(n, rng), dev), c)
        args = (p.x, p.y, p.inf, torch.tensor([0, 1], device=dev), *prep[:5])
        sums = M.bucket_reduce(M.bucket_accumulate(*args))
        cases[f"K3 {group}"] = (lambda a=args: M.bucket_accumulate(*a))
        cases[f"K5 {group}"] = (lambda s=sums, c=c: M.combine_windows(s, c))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout of the repository whose kernels to time beside these")
    ap.add_argument("--reps", type=int, default=2, help="rounds of turns (each layout twice a round)")
    args = ap.parse_args()
    import torch
    from phase2_bn254_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("bench_field_layout: needs a CUDA device", file=sys.stderr)
        return 1
    log(f"card: {S._smi('name,power.limit')}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    default = _build.build()
    builds = {"default": (default, os.path.join(_build.BUILD_DIR, f"ptxas_{_build._source_hash()}.log"))}
    builds.update({name: _build_variant(name) for name in PATCHES})
    if args.parent:
        builds["parent"] = _parent_library(os.path.abspath(args.parent))
    libs = {name: _open(lib) for name, (lib, _) in builds.items()}
    for name, (lib, logf) in builds.items():
        log(f"{name}: {os.path.relpath(lib, REPO) if lib.startswith(REPO) else lib}")
        for line in _ptxas(logf):
            log(f"  ptxas: {line}")

    _build._lib = libs["default"]
    cases = _cases()
    want = {k: [t.clone() for t in fn()] for k, fn in cases.items()}
    for name, lib in libs.items():
        _build._lib = lib
        for k, fn in cases.items():
            if not all(torch.equal(a, b) for a, b in zip(fn(), want[k])):
                raise AssertionError(f"{name}: {k} differs from the default build's limbs")
    log("every build gives the default build's limbs on every case")

    order = list(libs)
    times = {name: {k: [] for k in cases} for name in libs}
    for _ in range(args.reps):
        for name in order + order[::-1]:
            _build._lib = libs[name]
            for k, fn in cases.items():
                ms = S.cuda_ms(fn, 3 if k in ("K1", "K2") else 5)
                times[name][k].append(ms)
                log(f"{name} {k}: {ms:.4f} ms")
    _build._lib = None
    summary = {name: {k: min(v) for k, v in per.items()} for name, per in times.items()}
    for k in cases:
        log(f"{k}: " + ", ".join(f"{name} {summary[name][k]:.4f}" for name in libs) + " ms (least of "
            f"{2 * args.reps} calls of each)")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "bench_field_layout.log"), "w") as f:
        f.write("\n".join(_LOG) + "\n")
    print(json.dumps({"card": S._smi("name,power.limit"), "ms": summary, "all_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
