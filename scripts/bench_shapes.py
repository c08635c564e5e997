#!/usr/bin/env python3
"""Time kernels' launch shapes and code forms against the ones they were
chosen over, on one GPU.

    python3 scripts/bench_shapes.py [--only GROUP ...] [--rounds N] [--sass] [--out DIR]

Each shape is a copy of csrc/ under build/kernels/ with a few lines changed
as text (GROUPS; in the group's first source or in a header), so that it
lives nowhere in the port. A group's sources are built into a library of
their own per shape (every nvcc of every group and shape started together).
The script then puts each library in the place of the port's
(`ops/_build._lib`) and calls the port's own wrappers, so every shape runs
on the wrappers' inputs and arguments. The groups:

* K6 (`ntt`, forward): exp 20 and 24 (two passes of 2^10 / 2^12) and 26
  (three of 2^9, 2^9, 2^8); shapes: the port's (at most 512 threads, a
  block at least 2^9 elements), at most 256 threads, blocks of at least
  2^10 and of at least 2^11 elements, radix-2 phases (one stage between
  barriers, two elements a thread) in place of radix-4, and `loads8`;
* K9: 2^16 G2 points with uniform scalars and 262,141 with scalar 1 (the
  G2 terms of chip_smoke phase 13's `new`); 128 (the port's), 64 and 256
  threads a block; and forms of csrc/ladders.cuh's ladder (LADDER_FORMS,
  each a whole function put in the port's place): this change's first
  form (`first`: the scalar in registers, T[1] in registers, the table by
  a doubling and mixed adds only up to the largest digit) and it with the
  scalar read at a window index known only at run time (`windows_local`,
  in local memory), without the recoding of k > (r - 1)/2 (`no_recode`),
  and with T[2..15] built whole where a digit above 1 occurs by general
  adds (`add_full`) or mixed adds (`madd_full`); the parent's ladder
  (`parent_ladder`: the table of 15 general adds, 64 windows, an add of
  T[d] every window, the digits read from the scalar in device memory) and
  it with every feature of the port but the table's (`pl_fast`); the
  port's shape with either table (`v2_add`, `v2_madd`: the port takes the
  first over Fq, the second over Fq2); and `loads8`;
* K8: 2^16 G1 points with uniform scalars; the port's 128 threads with
  launch bounds asking 4 blocks an SM (at most 128 registers), 64, 128 and
  256 threads without, and bounds asking 3 (`bounds3`); K9's forms; the
  first form with its table by general adds (`add_table`), every thread
  through all 64 windows from infinity (`all_windows`), the table built to
  T[15] whatever the digits (`full_table`), and T[0] = infinity added
  every window (`uncond_add`); and the parent's ladder with one of the
  port's features each (`pl_regs`: the scalar in registers, read by
  selects; `pl_recode`: that and the recoding; `pl_skip0`: no add of T[0];
  `pl_madd`: the table by a doubling and mixed adds; `pl_start`: the start
  at the first nonzero window);
* K8-BLS and K9-BLS (the windowed ladders over BLS12-381's 12-limb Fq and
  Fq2): 2^16 points with uniform scalars mod BLS r; 128 threads a block (the
  port's), 64 and 256, and for K8-BLS launch bounds asking 2 and 3 blocks
  of 128 an SM (`bounds2`, `bounds3`);
* K2 (csrc/batch_exp_g2.cu, the signed GLS ladder) on chip_smoke's inputs
  (2^16 points, edge and random scalars): 256 threads (the port's), 64 and
  128, and launch bounds asking 3 blocks of 128 or 5 of 64 an SM;
* K7 and K7-BLS (csrc/batch_exp_glv.cu, the unsigned GLV ladder) on
  chip_smoke's inputs (2^16 points, edge and random scalars; K7 also on
  1,310,711 terms of coefficient 1, `new`'s G1 terms): K7 64 threads (the
  port's), 128 and 256, K7-BLS 128 (the port's), 64 and 256; the table by
  general adds (`general_table`) in place of a doubling and mixed adds; the
  digit scan unrolled (`unroll4`, `unroll11`); K7 with launch bounds asking
  6, 7, 8 or 10 blocks of 64 an SM (at most 168 / 144 / 128 / 102
  registers: `bounds6` ... `bounds10`; `bounds8_unroll11` with the scan
  unrolled) or 3 or 4 of 128 (`t128_bounds3`, `t128_bounds4`);
* K10 (csrc/batch_exp_gls.cu, the unsigned GLS ladder) on chip_smoke's
  inputs: 128 threads (the port's), 64 and 256; the digit scan unrolled
  (`unroll4`, `unroll17`);
* field (csrc/field.cuh's layout, in K1, K2, K3 and K5 at the contribute
  and verify chunk: 2^16 points, c = 9, two sets, G1 and G2): the port's;
  `inline`, the Fq product and square `__forceinline__` into the group
  operations; `k5_serial`, K5 with every product of a level in order on each
  lane; and `loads8`.

`loads8` is field.cuh's load_limbs / store_limbs with one 8-byte access a
digit, as before the 16-byte accesses. Every shape's output must equal the
port's: limb for limb, or for K8 and K9 (whose forms may reach the same
points through other Jacobian limbs) as canonical affine points. Each
round times the shapes in order and then in reverse (CUDA events,
`chip_smoke.cuda_ms`). With --sass the SASS of the port's K2 is counted
by role (`k2_sass`; needs cuobjdump). Prints each build's ptxas registers
and spills, one line per time and a JSON summary last, and writes the log
to <out>/bench_shapes.log (--out, by default build/bench_shapes). Needs a
CUDA device and nvcc.
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

NTT_BLOCK = "while (e < 9 && (1 << (e - log2c)) < rows) ++e;"
LOADS8 = [("field.cuh", "#if defined(__CUDA_ARCH__)\n  const longlong2* q", "#if 0\n  const longlong2* q"),
          ("field.cuh", "#if defined(__CUDA_ARCH__)\n  longlong2* q", "#if 0\n  longlong2* q")]
LADDER_FN = re.compile(r"template <class F, class S = Bn254Scalars>\n__device__ void windowed_ladder_point\(.*?\n}\n",
                       re.S)
# the parent's ladder: the table of 15 general adds, 64 windows, an add of T[d] every window, the digits read
# from the scalar in device memory
PARENT_LADDER = """template <class F>
__device__ void windowed_ladder_point(const int64_t* x, const int64_t* y, const int64_t* k, int64_t* ox,
                                      int64_t* oy, int64_t* oz, int64_t i) {
  const int64_t* s = k + 16 * i;
  Jac<F> table[16];
  table[0] = jac_infinity<F>();
  load_el(x + kDigits<F> * i, table[1].x);
  load_el(y + kDigits<F> * i, table[1].y);
  table[1].z = table[0].y;
  for (int j = 2; j < 16; ++j) table[j] = jac_add(table[j - 1], table[1]);
  Jac<F> acc = jac_infinity<F>();
  for (int w = 63; w >= 0; --w) {
    for (int t = 0; t < 4; ++t) acc = jac_double(acc);
    int d = (int)((s[w >> 2] >> (4 * (w & 3))) & 0xF);
    acc = jac_add(acc, table[d]);
  }
  store_jac(ox, oy, oz, i, acc);
}
"""
# this change's first form: the scalar in registers (read by selects), T[1] in registers, the table by a doubling
# and mixed adds only up to the largest digit
FIRST_LADDER = """template <class F>
__device__ void windowed_ladder_point(const int64_t* x, const int64_t* y, const int64_t* k, int64_t* ox,
                                      int64_t* oy, int64_t* oz, int64_t i) {
  // the scalar in registers (every index below is a constant once unrolled)
  uint32_t s[8];
  {
    const Fr k8 = load_limbs<Fr>(k + 16 * i);
#pragma unroll
    for (int l = 0; l < 8; ++l) s[l] = k8.v[l];
  }
  F px, py;
  load_el(x + kDigits<F> * i, px);
  load_el(y + kDigits<F> * i, py);
  int64_t borrow = 0;  // (r - 1)/2 - k < 0: k above (r - 1)/2
#pragma unroll
  for (int l = 0; l < 8; ++l) borrow = ((int64_t)FR_HALF[l] - (int64_t)s[l] + borrow) >> 32;
  if (borrow < 0) {
    int64_t b = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int64_t t = (int64_t)FR_P[l] - (int64_t)s[l] + b;
      s[l] = (uint32_t)t;
      b = t >> 32;
    }
    py = neg(py);
  }
  int first = 0, d0 = 0, top = 0;  // the first nonzero window (0 if none is), its digit, the largest digit
#pragma unroll
  for (int w = 0; w < 64; ++w) {
    const int dw = (int)((s[w >> 3] >> (4 * (w & 7))) & 0xF);
    if (dw != 0) first = w, d0 = dw;
    if (dw > top) top = dw;
  }

  const Jac<F> p1 = {px, py, jac_infinity<F>().y};  // z = one
  Jac<F> table[16];  // j P for 1 <= j <= top, in local memory, where the ladder reads them
  if (first > 0) table[1] = p1;
  if (top >= 2) table[2] = jac_double(p1);
  for (int j = 3; j <= top; ++j) table[j] = jac_madd(table[j - 1], px, py);

  Jac<F> acc = d0 == 1 ? p1 : d0 == 0 ? jac_infinity<F>() : table[d0];
  for (int w = first - 1; w >= 0; --w) {  // window w holds bits 4w .. 4w + 3
    for (int t = 0; t < 4; ++t) acc = jac_double(acc);
    uint32_t word = s[0];  // s[w >> 3] by selects: an index known only here would put s in local memory
#pragma unroll
    for (int l = 1; l < 8; ++l) word = (w >> 3) == l ? s[l] : word;
    const int dw = (int)((word >> (4 * (w & 7))) & 0xF);
    if (dw != 0) acc = jac_add(acc, table[dw]);
  }
  store_jac(ox, oy, oz, i, acc);
}
"""
# the port's features in the parent's shape: the scalar (recoded) and the table in local memory, T[1] loaded in
# place, a scan loop for the first window and the largest digit, T[2..15] whole where a digit above 1 occurs, by
# general adds (`v2_add`) or by a doubling and mixed adds (`v2_madd`); the port takes the first over Fq and the
# second over Fq2
V2_LADDER = """template <class F>
__device__ void windowed_ladder_point(const int64_t* x, const int64_t* y, const int64_t* k, int64_t* ox,
                                      int64_t* oy, int64_t* oz, int64_t i) {
  Fr s = load_limbs<Fr>(k + 16 * i);
  Jac<F> table[16];
  load_el(x + kDigits<F> * i, table[1].x);
  load_el(y + kDigits<F> * i, table[1].y);
  table[1].z = jac_infinity<F>().y;
  int64_t b = 0;
#pragma unroll
  for (int l = 0; l < 8; ++l) b = ((int64_t)FR_HALF[l] - (int64_t)s.v[l] + b) >> 32;
  if (b < 0) {
    int64_t c = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int64_t t = (int64_t)FR_P[l] - (int64_t)s.v[l] + c;
      s.v[l] = (uint32_t)t;
      c = t >> 32;
    }
    table[1].y = neg(table[1].y);
  }
  int first = 0, top = 0;
  for (int w = 0; w < 64; ++w) {
    const int d = (int)((s.v[w >> 3] >> (4 * (w & 7))) & 0xF);
    if (d != 0) first = w;
    top = d > top ? d : top;
  }
  if (top >= 2) {
TABLE
  }
  const int d0 = (int)((s.v[first >> 3] >> (4 * (first & 7))) & 0xF);
  Jac<F> acc = d0 == 0 ? jac_infinity<F>() : table[d0];
  for (int w = first - 1; w >= 0; --w) {
    for (int t = 0; t < 4; ++t) acc = jac_double(acc);
    const int d = (int)((s.v[w >> 3] >> (4 * (w & 7))) & 0xF);
    if (d != 0) acc = jac_add(acc, table[d]);
  }
  store_jac(ox, oy, oz, i, acc);
}
"""
V2_TABLES = {
    "v2_add": "    for (int j = 2; j < 16; ++j) table[j] = jac_add(table[j - 1], table[1]);",
    "v2_madd": "    table[2] = jac_double(table[1]);\n"
               "    for (int j = 3; j < 16; ++j) table[j] = jac_madd(table[j - 1], table[1].x, table[1].y);",
}


def _form(base: str, patches: list = ()) -> list:
    """A patch putting `base`, changed as text by `patches`, in the place of
    the port's ladder in csrc/ladders.cuh. The forms read BN254's r (FR_HALF,
    FR_P) whatever their scalar field S: K8-BLS / K9-BLS built from them are
    not run (the K8 and K9 groups time the BN254 kernels)."""
    for old, new in patches:
        if old not in base:
            raise RuntimeError(f"the ladder form does not hold {old!r}")
        base = base.replace(old, new)
    return [("ladders.cuh", LADDER_FN, base.replace("template <class F>\n", "template <class F, class S = Bn254Scalars>\n", 1))]


# the parent's ladder with one of the port's features each: the scalar in registers, read by selects; that and
# the recoding of k > (r - 1)/2; no add of T[0]; the table by a doubling and mixed adds; the start at the first
# nonzero window; all these but the table's
_REGS = [("  const int64_t* s = k + 16 * i;\n", "  Fr s8 = load_limbs<Fr>(k + 16 * i);\n"),
         ("    int d = (int)((s[w >> 2] >> (4 * (w & 3))) & 0xF);",
          "    uint32_t word = s8.v[0];\n#pragma unroll\n"
          "    for (int l = 1; l < 8; ++l) word = (w >> 3) == l ? s8.v[l] : word;\n"
          "    int d = (int)((word >> (4 * (w & 7))) & 0xF);")]
_RECODE = [("  Fr s8 = load_limbs<Fr>(k + 16 * i);\n",
            "  Fr s8 = load_limbs<Fr>(k + 16 * i);\n  int64_t b = 0;\n#pragma unroll\n"
            "  for (int l = 0; l < 8; ++l) b = ((int64_t)FR_HALF[l] - (int64_t)s8.v[l] + b) >> 32;\n"
            "  const bool flip = b < 0;\n  b = 0;\n#pragma unroll\n  for (int l = 0; l < 8 && flip; ++l) {\n"
            "    const int64_t t = (int64_t)FR_P[l] - (int64_t)s8.v[l] + b;\n    s8.v[l] = (uint32_t)t;\n"
            "    b = t >> 32;\n  }\n"),
           ("  table[1].z = table[0].y;\n", "  table[1].z = table[0].y;\n  if (flip) table[1].y = neg(table[1].y);\n")]
_SKIP0 = [("    acc = jac_add(acc, table[d]);", "    if (d != 0) acc = jac_add(acc, table[d]);")]
_START = [("  Jac<F> acc = jac_infinity<F>();\n  for (int w = 63; w >= 0; --w) {",
           "  int first = 63;\n"
           "  while (first > 0 && ((s[first >> 2] >> (4 * (first & 3))) & 0xF) == 0) --first;\n"
           "  Jac<F> acc = table[(s[first >> 2] >> (4 * (first & 3))) & 0xF];\n"
           "  for (int w = first - 1; w >= 0; --w) {")]
PARENT_PLUS = {
    "pl_regs": _REGS,
    "pl_recode": _REGS + _RECODE,
    "pl_skip0": _SKIP0,
    "pl_madd": [("  for (int j = 2; j < 16; ++j) table[j] = jac_add(table[j - 1], table[1]);",
                 "  table[2] = jac_double(table[1]);\n"
                 "  for (int j = 3; j < 16; ++j) table[j] = jac_madd(table[j - 1], table[1].x, table[1].y);")],
    "pl_start": _START,
    "pl_fast": _REGS + _RECODE + _SKIP0 + [(old.replace("s[first >> 2]", "s8.v[first >> 3]")
                                             .replace("(first & 3)", "(first & 7)"),
                                             new.replace("s[first >> 2]", "s8.v[first >> 3]")
                                             .replace("(first & 3)", "(first & 7)")) for old, new in _START],
}
# the first form changed: the scalar read at a window index known only at run time (local memory); no
# recoding; T[2..15] whole where a digit above 1 occurs, by general adds or by a doubling and mixed adds
FIRST_FORMS = {
    "windows_local": [("    uint32_t word = s[0];", "    const uint32_t word = s[w >> 3];\n"),
                      ("#pragma unroll\n    for (int l = 1; l < 8; ++l) word = (w >> 3) == l ? s[l] : word;\n", "")],
    "no_recode": [("if (borrow < 0) {", "if (false) {")],
    "add_full": [("  if (top >= 2) table[2] = jac_double(p1);\n"
                  "  for (int j = 3; j <= top; ++j) table[j] = jac_madd(table[j - 1], px, py);",
                  "  if (top >= 2) {\n    table[1] = p1;\n"
                  "    for (int j = 2; j < 16; ++j) table[j] = jac_add(table[j - 1], p1);\n  }")],
    "madd_full": [("  for (int j = 3; j <= top; ++j) table[j] = jac_madd(table[j - 1], px, py);",
                   "  if (top >= 2)\n    for (int j = 3; j < 16; ++j) table[j] = jac_madd(table[j - 1], px, py);")],
}
# K8 only: the first form's table by general adds, every thread through all 64 windows from infinity, the table
# built to T[15] whatever the digits, T[0] = infinity added every window
FIRST_FORMS_K8 = {
    "add_table": [("table[j] = jac_madd(table[j - 1], px, py);", "table[j] = jac_add(table[j - 1], p1);")],
    "all_windows": [("Jac<F> acc = d0 == 1 ? p1 : d0 == 0 ? jac_infinity<F>() : table[d0];\n"
                     "  for (int w = first - 1; w >= 0; --w) {",
                     "Jac<F> acc = jac_infinity<F>();\n  table[1] = p1;\n  for (int w = 63; w >= 0; --w) {"),
                    ("if (dw != 0) acc = jac_add(acc, table[dw]);",
                     "acc = jac_add(acc, dw == 0 ? jac_infinity<F>() : table[dw]);")],
    "full_table": [("for (int j = 3; j <= top; ++j)", "for (int j = 3; j < 16; ++j)")],
    "uncond_add": [("if (dw != 0) acc = jac_add(acc, table[dw]);", "acc = jac_add(acc, table[dw]);"),
                   ("if (first > 0) table[1] = p1;", "table[0] = jac_infinity<F>();\n  table[1] = p1;")],
}
LADDER_FORMS = {
    "first": _form(FIRST_LADDER),
    **{name: _form(FIRST_LADDER, p) for name, p in FIRST_FORMS.items()},
    "parent_ladder": _form(PARENT_LADDER),
    "pl_fast": _form(PARENT_LADDER, PARENT_PLUS["pl_fast"]),
    **{name: _form(V2_LADDER, [("TABLE", table)]) for name, table in V2_TABLES.items()},
    "loads8": LOADS8,
}
K2_SHAPES = {
    "t64": [("constexpr int kThreads = 256;", "constexpr int kThreads = 64;")],
    "t128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "t128_min3": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
                  ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")],
    "t64_min5": [("constexpr int kThreads = 256;", "constexpr int kThreads = 64;"),
                 ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 5)")],
}
# K7 / K7-BLS (csrc/batch_exp_glv.cu): the table by general adds in place of a doubling and mixed adds
GLV_GENERAL_TABLE = [("    table[2] = jac_double(table[1]);\n"
                      "    for (int k = 3; k < 16; ++k) table[k] = jac_madd(table[k - 1], px, py);",
                      "    for (int k = 2; k < 16; ++k) table[k] = jac_add(table[k - 1], table[1]);  // k = 2 doubles")]
# K7 / K10: the digit scan (the first window, the largest digit) unrolled
GLV_SCAN = "  for (int w = nw - 1; w >= 0; --w) {\n    const int da"
GLS_SCAN = "  for (int w = nw - 1; w >= 0; --w) {\n    int any = 0;"
# group -> (sources, kernels whose ptxas lines to keep, {shape: patches}, compare); the first shape is the
# port's. A patch is (text, replacement) in the first source or (file, text or pattern, replacement).
GROUPS = {
    "K6": (("ntt.cu",), ("lane_dft_kernel",), {
        "port": [],
        "t256": [("constexpr int kMaxThreads = 512;", "constexpr int kMaxThreads = 256;")],
        "e1024": [(NTT_BLOCK, NTT_BLOCK.replace("e < 9", "e < 10"))],
        "radix2": [("const int st = 2 * ph + 1;", "const int st = ph + 1;"),
                   ("const bool r4 = st < L;", "const bool r4 = false;"),
                   ("const int last = (L - 1) / 2;", "const int last = L - 1;"),
                   ("return 1 << (block_log - (2 * ph + 1 < log2c ? 2 : 1));", "return 1 << (block_log - 1);"),
                   ("const int phases = (a.log2c + 1) / 2;", "const int phases = a.log2c;")],
        "e2048": [(NTT_BLOCK, NTT_BLOCK.replace("e < 9", "e < 11"))],
        "loads8": LOADS8,
    }, "limbs"),
    "K9": (("batch_exp_g2_windowed.cu",), ("exp_g2_windowed_kernel",), {
        "port": [],
        **{f"t{t}": [("constexpr int kThreads = 128;", f"constexpr int kThreads = {t};")] for t in (64, 256)},
        **LADDER_FORMS,
    }, "points"),
    "K8": (("batch_exp_g1_windowed.cu",), ("exp_g1_windowed_kernel",), {
        "port": [],
        **{f"t{t}": [("constexpr int kThreads = 128;", f"constexpr int kThreads = {t};"),
                     ("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads)")] for t in (64, 256)},
        "t128": [("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads)")],
        "bounds3": [("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 3)")],
        **LADDER_FORMS,
        **{name: _form(FIRST_LADDER, p) for name, p in FIRST_FORMS_K8.items()},
        **{name: _form(PARENT_LADDER, p) for name, p in PARENT_PLUS.items() if name != "pl_fast"},
    }, "points"),
    "K8-BLS": (("batch_exp_g1_windowed.cu",), ("bls_g1_windowed_kernel",), {
        "port": [],
        **{f"t{t}": [("constexpr int kBlsThreads = 128;", f"constexpr int kBlsThreads = {t};")] for t in (64, 256)},
        **{f"bounds{b}": [("__launch_bounds__(kBlsThreads)", f"__launch_bounds__(kBlsThreads, {b})")] for b in (2, 3)},
    }, "points"),
    "K9-BLS": (("batch_exp_g2_windowed.cu",), ("bls_g2_windowed_kernel",), {
        "port": [],
        **{f"t{t}": [("constexpr int kBlsThreads = 128;", f"constexpr int kBlsThreads = {t};")] for t in (64, 256)},
    }, "points"),
    "K2": (("batch_exp_g2.cu",), ("gls_signed_kernel",), {"port": [], **K2_SHAPES}, "limbs"),
    "K7": (("batch_exp_glv.cu",), ("batch_exp_glv_kernel",), {
        "port": [],
        **{f"t{t}": [("constexpr int kThreads = 64;", f"constexpr int kThreads = {t};")] for t in (128, 256)},
        "general_table": GLV_GENERAL_TABLE,
        **{f"unroll{u}": [(GLV_SCAN, f"#pragma unroll {u}\n" + GLV_SCAN)] for u in (4, 11)},
        **{f"bounds{b}": [("__launch_bounds__(kThreads)", f"__launch_bounds__(kThreads, {b})")] for b in (6, 7, 8, 10)},
        "bounds8_unroll11": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 8)"),
                             (GLV_SCAN, "#pragma unroll 11\n" + GLV_SCAN)],
        **{f"t128_bounds{b}": [("constexpr int kThreads = 64;", "constexpr int kThreads = 128;"),
                               ("__launch_bounds__(kThreads)", f"__launch_bounds__(kThreads, {b})")] for b in (3, 4)},
    }, "limbs"),
    "K7-BLS": (("batch_exp_glv.cu",), ("batch_exp_bls_glv_kernel",), {
        "port": [],
        **{f"t{t}": [("constexpr int kBlsThreads = 128;", f"constexpr int kBlsThreads = {t};")] for t in (64, 256)},
        "general_table": GLV_GENERAL_TABLE,
        "unroll4": [(GLV_SCAN, "#pragma unroll 4\n" + GLV_SCAN)],
    }, "limbs"),
    "K10": (("batch_exp_gls.cu",), ("batch_exp_gls_kernel",), {
        "port": [],
        **{f"t{t}": [("constexpr int kThreads = 128;", f"constexpr int kThreads = {t};")] for t in (64, 256)},
        **{f"unroll{u}": [(GLS_SCAN, f"#pragma unroll {u}\n" + GLS_SCAN)] for u in (4, 17)},
    }, "limbs"),
    "field": (("batch_exp_g1.cu", "batch_exp_g2.cu", "msm.cu"),
              ("glv_signed_kernel", "gls_signed_kernel", "bucket_accumulate_kernel", "combine_windows_kernel"), {
        "port": [],
        "inline": [("field.cuh", f"static __device__ __noinline__ Fp {op}(",
                    f"static __device__ __forceinline__ Fp {op}(")
                   for op in ("mul", "sqr")],
        "k5_serial": [("msm.cu", "s, nwin, c, WarpProducts(), bx", "s, nwin, c, SerialProducts(), bx")],
        "loads8": LOADS8,
    }, "limbs"),
}
_LOG = []


def log(msg: str) -> None:
    _LOG.append(msg)
    print(msg, flush=True)


def _patched_copy(group: str, shape: str, sources: tuple, patches: list) -> str:
    from phase2_bn254_tpu_torch.ops import _build

    d = os.path.join(_build.BUILD_DIR, f"shape_{group}_{shape}_{_build._source_hash()}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    _build.write_headers(d, _build.generated_headers())
    for patch in patches:
        name, old, new = patch if len(patch) == 3 else (sources[0], *patch)
        with open(os.path.join(d, name)) as f:
            text = f.read()
        if isinstance(old, re.Pattern):
            text, n = old.subn(lambda _: new, text, count=1)
        else:
            n = text.count(old)
            text = text.replace(old, new)
        if not n:
            raise RuntimeError(f"{group} {shape}: {name} no longer holds {getattr(old, 'pattern', old)!r}")
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    return d


def _ptxas(text: str, kernels: tuple) -> list[str]:
    """Registers and spills of the named kernels from nvcc's -Xptxas -v output."""
    out, keep = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            keep = next((k for k in kernels if k in line), None)
        elif keep and ("registers" in line or "spill" in line):
            out.append(f"{keep}: " + line.strip().removeprefix("ptxas info    : "))
    return out


def _build_all(groups: list[str]) -> dict:
    """(group, shape) -> (library, ptxas lines): one nvcc -c per source, all
    started together, then a link per library."""
    from phase2_bn254_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    jobs = {}
    for group in groups:
        sources, _, shapes, _ = GROUPS[group]
        for shape, patches in shapes.items():
            d = _patched_copy(group, shape, sources, patches)
            jobs[group, shape] = (d, [(os.path.join(d, s + ".o"), subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-c", "-o", os.path.join(d, s + ".o"), os.path.join(d, s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for s in sources])
    out = {}
    for (group, shape), (d, procs) in jobs.items():
        text = "".join(p.communicate()[0] for _, p in procs)
        if any(p.returncode for _, p in procs):
            raise RuntimeError(f"{group} {shape}: nvcc failed:\n{text[-3000:]}")
        lib = os.path.join(d, "lib.so")
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", lib, *(o for o, _ in procs)], check=True)
        out[group, shape] = (lib, _ptxas(text, GROUPS[group][1]))
    return out


def _library(path: str):
    """A shape's library with the argument types of the entry points it has."""
    from phase2_bn254_tpu_torch.ops import _build

    lib = ctypes.CDLL(path)
    for entry, (nptr, nint) in _build.ENTRY_POINTS.items():
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _parts(out) -> tuple:
    """A kernel's output as a tuple of tensors (a Jacobian batch is one)."""
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _same(got, want, compare: str, f) -> bool:
    import torch
    from phase2_bn254_tpu_torch.curve import group as G

    if compare == "points":
        got, want = (G.jac_normalize(f, G.JacobianBatch(*o)) for o in (got, want))
    return all(torch.equal(g, w) for g, w in zip(_parts(got), _parts(want)))


def _cases(groups: list[str]) -> dict:
    """group -> {case: (the call, its reps, its field for a points compare)} on the card."""
    import torch
    from phase2_bn254_tpu_torch import convert
    from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
    from phase2_bn254_tpu_torch.ops import batch_exp, gls, glv, ntt
    from phase2_bn254_tpu_torch.ops import msm as M
    from phase2_bn254_tpu_torch.refimpl.field import R_MOD

    dev = torch.device("cuda")
    rng = random.Random(21)
    gen = torch.Generator().manual_seed(21)
    cases = {}
    if "K6" in groups:
        cases["K6"] = {}
        for exp in (20, 24, 26):
            x = S._fr_random(1 << exp, gen)
            cases["K6"][f"ntt {exp}"] = ((lambda x=x, exp=exp: ntt.ntt(exp, x, False)), 5 if exp < 26 else 2, None)
    uniform = convert.ints_to_limbs([rng.randrange(R_MOD) for _ in range(1 << 16)], dev)
    if "K9" in groups:
        g2, _ = S._tiled_points("g2", 1 << 16, dev, rng)
        ones, _ = S._tiled_points("g2", 262_141, dev, rng)
        k1 = convert.ints_to_limbs([1] * 262_141, dev)
        cases["K9"] = {"2^16 uniform": (lambda: batch_exp.batch_exp_g2_windowed(g2.x, g2.y, uniform), 3, FQ2),
                       "new's terms": (lambda: batch_exp.batch_exp_g2_windowed(ones.x, ones.y, k1), 5, FQ2)}
    if "K8" in groups:
        g1, _ = S._tiled_points("g1", 1 << 16, dev, rng)
        cases["K8"] = {"2^16 uniform": (lambda: batch_exp.batch_exp_g1_windowed(g1.x, g1.y, uniform), 3, FQ)}
    for group, name in (("K8-BLS", "g1"), ("K9-BLS", "g2")):
        if group in groups:
            from phase2_bn254_tpu_torch.bls12_381 import device as D
            from phase2_bn254_tpu_torch.bls12_381.field import R_MOD as BLS_R

            pts = S._bls_points(name, 1 << 16, rng)
            k = D.scalars_to_canon([rng.randrange(BLS_R) for _ in range(1 << 16)], dev)
            kernel = getattr(batch_exp, f"batch_exp_bls_{name}_windowed")
            cases[group] = {"2^16 uniform": ((lambda p=pts, k=k, kernel=kernel: kernel(p.x, p.y, k)), 3,
                                             D.field_ops(name))}
    if "K7" in groups:
        g1, _ = S._tiled_points("g1", S.KERNEL_N, dev, rng)
        split = glv.decompose(convert.ints_to_limbs(S._edge_scalars(S.KERNEL_N, rng), dev))
        ones, _ = S._tiled_points("g1", 1_310_711, dev, rng)
        unit = glv.decompose(convert.ints_to_limbs([1] * 1_310_711, dev))
        cases["K7"] = {"2^16 edge and uniform": (lambda: batch_exp.batch_exp_glv(g1.x, g1.y, *split), 5, None),
                       "new's terms (coefficient 1)": (lambda: batch_exp.batch_exp_glv(ones.x, ones.y, *unit), 5,
                                                       None)}
    if "K7-BLS" in groups:
        from phase2_bn254_tpu_torch.bls12_381 import device as D

        bls = S._bls_points("g1", S.KERNEL_N, rng)
        bsplit = D.decompose_glv_t(D.scalars_to_canon(S._bls_edge_scalars(S.KERNEL_N, rng), dev))
        cases["K7-BLS"] = {"2^16 edge and uniform": (lambda: batch_exp.batch_exp_bls_glv(bls.x, bls.y, *bsplit), 3,
                                                     None)}
    if "K10" in groups:
        g2, _ = S._tiled_points("g2", S.KERNEL_N, dev, rng)
        gsplit = gls.decompose(convert.ints_to_limbs(S._edge_scalars(S.KERNEL_N, rng), dev))
        cases["K10"] = {"2^16 edge and uniform": (lambda: batch_exp.batch_exp_gls(g2.x, g2.y, *gsplit), 3, None)}
    if "K2" in groups or "field" in groups:
        n = S.KERNEL_N
        pts, _ = S._tiled_points("g1", n, dev, rng)
        d1, d2 = glv.decompose_signed(convert.ints_to_limbs(S._edge_scalars(n, rng), dev))
        qts, _ = S._tiled_points("g2", n, dev, rng)
        dg = gls.decompose_signed(convert.ints_to_limbs(S._edge_scalars(n, rng), dev))
        k2 = {"K2": (lambda: batch_exp.batch_exp_gls_signed(qts.x, qts.y, dg), 3, None)}
        if "K2" in groups:
            cases["K2"] = k2
        if "field" in groups:
            cases["field"] = {"K1": (lambda: batch_exp.batch_exp_glv_signed(pts.x, pts.y, d1, d2), 3, None), **k2}
            for group in ("g1", "g2"):
                p, _ = S._tiled_points(group, n + 1, dev, rng)
                c = M.pick_window(n)
                prep = M.prep_windows(convert.ints_to_limbs(S._edge_scalars(n, rng), dev), c)
                args = (p.x, p.y, p.inf, torch.tensor([0, 1], device=dev), *prep[:5])
                sums = M.bucket_reduce(M.bucket_accumulate(*args))
                cases["field"][f"K3 {group}"] = ((lambda a=args: M.bucket_accumulate(*a)), 5, None)
                cases["field"][f"K5 {group}"] = ((lambda s=sums, c=c: M.combine_windows(s, c)), 5, None)
    return cases


# ---------------------------------------------------------------------------
# SASS of K2 (--sass)
# ---------------------------------------------------------------------------

def parse_sass(text: str) -> dict:
    """mangled name -> [instruction lines] of every function in cuobjdump
    -sass output."""
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
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    funcs = parse_sass(subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout)
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

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=list(GROUPS), help="the groups to time (default: all)")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of turns (each shape twice a round)")
    ap.add_argument("--sass", action="store_true", help="count the port's K2 SASS instructions (cuobjdump)")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "bench_shapes"))
    a = ap.parse_args()
    import torch
    from phase2_bn254_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("bench_shapes: needs a CUDA device", file=sys.stderr)
        return 1
    groups = a.only or list(GROUPS)
    if a.sass and "K2" not in groups:
        groups.append("K2")
    os.makedirs(a.out, exist_ok=True)
    S.DEVICE = "cuda"
    log(f"card: {S._smi('name,power.limit')}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    built = _build_all(groups)
    for (group, shape), (_, lines) in built.items():
        log(f"{group} {shape}: " + "; ".join(lines))
    sass = {}
    if a.sass:
        sass = k2_sass(built["K2", "port"][0], os.path.join(a.out, "k2_sass_port.txt"))
        for role, c in sass.items():
            log(f"sass K2 {role}: {json.dumps(c)}")
    cases = _cases(groups)
    times = {}
    for group in groups:
        shapes, compare = GROUPS[group][2], GROUPS[group][3]
        libs = {shape: _library(built[group, shape][0]) for shape in shapes}
        _build._lib = libs["port"]
        want = {case: [t.clone() for t in _parts(fn())] for case, (fn, _, _) in cases[group].items()}
        for shape, lib in libs.items():
            _build._lib = lib
            for case, (fn, _, f) in cases[group].items():
                if not _same(fn(), want[case], compare, f):
                    raise AssertionError(f"{group} {shape} {case}: differs from the port's shape ({compare})")
        del want
        log(f"{group}: every shape gives the port's output ({compare})")
        order = list(shapes)
        for _ in range(a.rounds):
            for shape in order + order[::-1]:
                _build._lib = libs[shape]
                for case, (fn, reps, _) in cases[group].items():
                    ms = S.cuda_ms(fn, reps)
                    times.setdefault(group, {}).setdefault(case, {}).setdefault(shape, []).append(ms)
                    log(f"{group} {case} {shape}: {ms:.4f} ms")
    _build._lib = None
    least = {g: {c: {s: min(v) for s, v in by.items()} for c, by in per.items()} for g, per in times.items()}
    for group, by_case in least.items():
        for case, by_shape in by_case.items():
            log(f"{group} {case} (least of {2 * a.rounds}): " + ", ".join(f"{s} {v:.4f}" for s, v in by_shape.items()))
    log(json.dumps({"card": S._smi("name,power.limit"), "times": times, "least": least, "sass": sass}))
    with open(os.path.join(a.out, "bench_shapes.log"), "w") as f:
        f.write("\n".join(_LOG) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
