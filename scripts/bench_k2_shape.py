#!/usr/bin/env python3
"""Time K2's launch shape against the shapes it was chosen over, and count
the instructions the card runs for K2, on one GPU.

    python3 scripts/bench_k2_shape.py [--parent DIR] [--reps N] [--sass] [--out DIR]

The port builds K2 (csrc/batch_exp_g2.cu) in one launch shape: kThreads
threads a block and `__launch_bounds__(kThreads)`. This script makes the
others from a copy of csrc/ under build/kernels/, changed as text, so that
they live nowhere in the port (SHAPES: 64 and 128 threads a block, and
launch bounds that ask for more blocks per SM, which cap the registers),
builds each alone into a library of its own, checks that each gives the
port's limbs on K2's inputs in chip_smoke.py (2^16 points, edge and random
scalars), and times them in turns (each shape once in order, then in
reverse order, `--reps` times). With --parent DIR it times the K2 of
another checkout too (e.g. the parent commit unpacked with `git archive`),
built by that checkout's own ops/_build.py.

With --sass it dumps the SASS of the port's library (and of --parent's)
with `cuobjdump -sass`, cuts K2's kernel at its call targets (nvcc puts
the __noinline__ functions it calls into the kernel's own section) and
counts, for each role (`k2_sass`: the kernel's own code, the doubling, the
add, the Fq and Fq2 products and the Fq2 square): its instructions, its
integer multiplies (IMAD forms other than moves), its IMAD moves, its
local (LDL, STL) and generic (LD, ST) memory accesses and its calls; and
estimates the instructions of one window of the ladder (5 doublings, 4
adds, psi, psi^2, psi^3), each function counted once per call
(straight-line: the add's P == Q doubling and its early returns not
taken).

Prints each build's ptxas registers and spills, one line per time, and a
JSON summary last; writes the log to <out>/bench_k2_shape.log and the SASS
of K2's kernel to <out>/k2_sass_<build>.txt (--out, by default
build/bench_k2_shape). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import re
import shutil
import subprocess
import sys
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as S  # noqa: E402

SOURCE = "batch_exp_g2.cu"
ENTRY = "p2_batch_exp_gls_signed"
# shape -> [(text, replacement)] in batch_exp_g2.cu; each text must occur there
SHAPES = {
    "t64": [("constexpr int kThreads = 256;", "constexpr int kThreads = 64;")],
    "t128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "t128_min3": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
                  ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")],
    "t64_min5": [("constexpr int kThreads = 256;", "constexpr int kThreads = 64;"),
                 ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 5)")],
}
_LOG = []


def log(msg: str) -> None:
    _LOG.append(msg)
    print(msg, flush=True)


def _ptxas(logf: str) -> list[str]:
    out, keep = [], False
    with open(logf) as f:
        for line in f:
            if "Compiling entry function" in line:
                keep = "batch_exp_gls_signed_kernel" in line
            elif keep and ("registers" in line or "spill" in line):
                out.append(line.strip().removeprefix("ptxas info    : "))
    return out


def _build_shapes() -> dict:
    """shape -> (library, ptxas log): each a copy of csrc/ with SHAPES[shape]
    applied, batch_exp_g2.cu built alone; nvcc started for all together."""
    from phase2_bn254_tpu_torch.ops import _build

    jobs = {}
    for name, patches in SHAPES.items():
        d = os.path.join(_build.BUILD_DIR, f"k2_{name}_{_build._source_hash()}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        _build.write_headers(d, _build.generated_headers())
        path = os.path.join(d, SOURCE)
        with open(path) as f:
            text = f.read()
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: {SOURCE} no longer holds {old!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(d, "lib.so")
        jobs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, path],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        logf = os.path.join(os.path.dirname(lib), "ptxas.log")
        with open(logf, "w") as f:
            f.write(proc.communicate()[0])
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed, see {logf}")
        out[name] = (lib, logf)
    return out


def _parent_library(parent: str) -> tuple[str, str]:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from phase2_bn254_tpu_torch.ops import _build; print(_build.build())")
    res = subprocess.run([sys.executable, "-c", code, parent], capture_output=True, text=True, check=True)
    lib = res.stdout.strip().splitlines()[-1]
    return lib, os.path.join(os.path.dirname(lib), os.path.basename(lib).replace("libp2kernels_", "ptxas_")[:-3] + ".log")


def _k2_of(path: str):
    """The K2 entry of a library, its argument types set."""
    from phase2_bn254_tpu_torch.ops import _build

    fn = getattr(ctypes.CDLL(path), ENTRY)
    nptr, nint = _build.ENTRY_POINTS[ENTRY]
    fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# SASS
# ---------------------------------------------------------------------------

def sass_functions(lib: str) -> dict:
    """mangled name -> [instruction lines] of every function in the
    library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    return parse_sass(text)


def parse_sass(text: str) -> dict:
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            funcs[cur].append(line.strip())
    return funcs


def _parse(line: str):
    """(address, opcode, text) of one SASS instruction line."""
    m = re.match(r"/\*([0-9a-f]+)\*/\s*(.*?)\s*;", line)
    if not m:
        return None
    body = re.sub(r"^@!?U?P[T0-9]\s+", "", m.group(2))
    return int(m.group(1), 16), body.split()[0], body


MOVES = ("IMAD.MOV", "IMAD.IADD", "IMAD.SHL")  # IMAD forms that multiply nothing


def _counts(body: list) -> dict:
    ops = Counter(op for _, op, _ in body if op != "NOP")
    return {"instructions": sum(ops.values()),
            "imad": sum(v for k, v in ops.items() if k.startswith("IMAD") and not k.startswith(MOVES)),
            "imad_moves": sum(v for k, v in ops.items() if k.startswith(MOVES)),
            "local": sum(v for k, v in ops.items() if k.startswith(("LDL", "STL"))),
            "generic": sum(v for k, v in ops.items() if k.startswith(("LD.", "ST."))),
            "top": ops.most_common(8)}


def subroutines(lines: list[str]) -> dict:
    """The kernel's SASS cut at its call targets (nvcc places the
    __noinline__ functions it calls after the kernel's own code, in the
    kernel's section): start address -> counts and calls {target: times}."""
    body = [x for x in map(_parse, lines) if x]
    calls = [(a, int(t.split()[1], 16)) for a, op, t in body if op.startswith("CALL.REL")]
    starts = sorted({0, *(t for _, t in calls)})
    subs = {}
    for i, lo in enumerate(starts):
        hi = starts[i + 1] if i + 1 < len(starts) else float("inf")
        sub = [x for x in body if lo <= x[0] < hi]
        subs[lo] = {**_counts(sub), "calls": Counter(t for a, t in calls if lo <= a < hi)}
    return subs


def k2_sass(lib: str, out_txt: str) -> dict:
    """K2's kernel and the functions it calls, by role: the kernel's own
    code, jac_double, jac_add, the leaf products (the Fq2 product and square
    where they are routines of their own, the Fq product). A role is found
    by its calls: jac_double calls only leaves, jac_add calls jac_double
    and the most leaves, the square is the leaf jac_double calls 5 times.
    Then inclusive counts (a leaf once per call; a group operation's call
    of the doubling, its P == Q branch, not counted) and one window's
    estimate: 5 doublings, 4 adds and psi's products (2 + 2 Fq2, 4 Fq; an
    Fq2 product without a routine of its own as three Fq products, the
    Karatsuba adds around them not counted)."""
    funcs = sass_functions(lib)
    kernel = [k for k in funcs if "batch_exp_gls_signed_kernel" in k]
    if not kernel:
        raise RuntimeError(f"{lib}: no batch_exp_gls_signed_kernel in its SASS")
    lines = funcs[kernel[0]]
    with open(out_txt, "w") as f:
        f.write(f"Function : {kernel[0]}\n" + "\n".join(lines) + "\n")
    subs = subroutines(lines)
    leaves = {a for a, c in subs.items() if a and not c["calls"]}
    inner = {a for a, c in subs.items() if a and c["calls"]}
    dbl = [a for a in inner if set(subs[a]["calls"]) <= leaves]
    add = sorted((a for a in inner if set(subs[a]["calls"]) & set(dbl)),
                 key=lambda a: -sum(n for t, n in subs[a]["calls"].items() if t in leaves))
    if len(dbl) != 1 or not add:
        raise RuntimeError(f"{lib}: cannot tell the group operations apart ({len(dbl)} doublings)")
    dbl = dbl[0]
    roles = {"kernel": 0, "jac_double": dbl, "jac_add": add[0]}
    by_calls = sorted(subs[dbl]["calls"].items(), key=lambda kv: -kv[1])
    if len(by_calls) == 2:  # the fused Fq2 routines: 5 squares, 2 products
        roles["sqr_fq2"], roles["mul_fq2"] = by_calls[0][0], by_calls[1][0]
        fq = [a for a in leaves if a not in (by_calls[0][0], by_calls[1][0])]
    else:  # every Fq2 operation is Fq products
        fq = [by_calls[0][0]]
    if fq:
        roles["mul_fq"] = max(fq, key=lambda a: sum(subs[k]["calls"][a] for k in subs))

    def inclusive(a: int) -> dict:
        c = subs[a]
        out = {"instructions": c["instructions"], "imad": c["imad"]}
        for t, n in c["calls"].items():
            if t in leaves:
                for k in out:
                    out[k] += n * subs[t][k]
        return out

    report = {}
    for role, a in roles.items():
        c = subs[a]
        report[role] = {"address": hex(a), **{k: c[k] for k in ("instructions", "imad", "imad_moves", "local",
                                                                 "generic", "top")},
                        "calls": sum(c["calls"].values()), "inclusive": inclusive(a)}
    mul2 = (report["mul_fq2"]["inclusive"] if "mul_fq2" in report
            else {k: 3 * v for k, v in report["mul_fq"]["inclusive"].items()})
    report["window_estimate"] = {k: 5 * report["jac_double"]["inclusive"][k] + 4 * report["jac_add"]["inclusive"][k]
                                 + 4 * mul2[k] + 4 * report["mul_fq"]["inclusive"][k] for k in mul2}
    return report


# ---------------------------------------------------------------------------

def _inputs():
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.ops import gls

    dev = torch.device("cuda")
    rng = random.Random(2024)
    pts, _ = S._tiled_points("g2", S.KERNEL_N, dev, rng)
    digits = gls.decompose_signed(convert.ints_to_limbs(S._edge_scalars(S.KERNEL_N, rng), dev))
    return pts.x, pts.y, digits


def _call(fn, x, y, digits):
    import torch

    n, w = x.shape[0], digits.shape[1]
    out = [torch.empty_like(x) for _ in range(3)]
    err = fn(*(t.data_ptr() for t in (x, y, digits, *out)), n, w, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{ENTRY}: CUDA error {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout of the repository whose K2 to time beside these")
    ap.add_argument("--reps", type=int, default=2, help="rounds of turns (each shape twice a round)")
    ap.add_argument("--sass", action="store_true", help="count K2's SASS instructions (cuobjdump)")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "bench_k2_shape"),
                    help="directory for the log and the SASS text")
    args = ap.parse_args()
    import torch
    from phase2_bn254_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("bench_k2_shape: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    log(f"card: {S._smi('name,power.limit')}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    builds = {"default": (_build.build(), os.path.join(_build.BUILD_DIR, f"ptxas_{_build._source_hash()}.log"))}
    builds.update(_build_shapes())
    if args.parent:
        builds["parent"] = _parent_library(os.path.abspath(args.parent))
    fns = {name: _k2_of(lib) for name, (lib, _) in builds.items()}
    for name, (lib, logf) in builds.items():
        log(f"{name}: " + "; ".join(_ptxas(logf)))

    sass = {}
    if args.sass:
        for name in ("default", "parent"):
            if name in builds:
                sass[name] = k2_sass(builds[name][0], os.path.join(args.out, f"k2_sass_{name}.txt"))
                for role, c in sass[name].items():
                    log(f"sass {name} {role}: {json.dumps(c)}")

    x, y, digits = _inputs()
    want = _call(fns["default"], x, y, digits)
    for name, fn in fns.items():
        if not all(torch.equal(a, b) for a, b in zip(_call(fn, x, y, digits), want)):
            raise AssertionError(f"{name}: K2 differs from the port's limbs")
    log("every build gives the port's K2 limbs")
    order = list(fns)
    times = {name: [] for name in fns}
    for _ in range(args.reps):
        for name in order + order[::-1]:
            ms = S.cuda_ms(lambda fn=fns[name]: _call(fn, x, y, digits), 3)
            times[name].append(ms)
            log(f"{name} K2: {ms:.4f} ms")
    summary = {name: min(v) for name, v in times.items()}
    log("K2 (least of " + f"{2 * args.reps} calls of each): " + ", ".join(f"{k} {v:.4f}" for k, v in summary.items())
        + " ms")
    with open(os.path.join(args.out, "bench_k2_shape.log"), "w") as f:
        f.write("\n".join(_LOG) + "\n")
    print(json.dumps({"card": S._smi("name,power.limit"), "ms": summary, "all_ms": times, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
