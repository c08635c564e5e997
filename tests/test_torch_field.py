"""The port's field layer against the JAX package's, limb for limb.

`phase2_bn254_tpu_torch.field.fp` / `fq2` on the CPU against
`phase2_bn254_tpu.field.fp` / `fq2` (XLA:CPU), on the same inputs made from
a seeded numpy generator. Tolerance: exact integer equality of every limb
(the Montgomery values are the same integers in both packages).

The kernels' own field code has two paths, both held against `field/fp.py`
here on `ops.fieldops.edge_pairs` and random pairs: the inline PTX of
field_ptx.cuh (`ops._ptx.field_ptx_header()`), parsed and executed instruction by instruction with its
carry flag, and the C++ CIOS that g++ builds from csrc/fieldops.cu (the
card compares the PTX itself: tests/test_torch_field_gpu.py). Both paths
also at BLS12-381 width ("bls_fq", "bls_fq2": 12 x 32-bit limbs, R =
2^384).
"""

import ctypes
import os
import random
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase2_bn254_tpu.field import fp as jfp
from phase2_bn254_tpu.field.fq2 import Fq2Ops as JFq2Ops
from phase2_bn254_tpu.refimpl.field import Q, R_MOD, Fq2
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.field import fp
from phase2_bn254_tpu_torch.field.fq2 import FQ2
from phase2_bn254_tpu_torch.ops import _build, _ptx, fieldops

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

N = 24
CTXS = {"fq": (fp.FQ_CTX, jfp.FpContext(Q, "fq")), "fr": (fp.FR_CTX, jfp.FpContext(R_MOD, "fr"))}


def _elements(seed: int, p: int, n: int = N) -> list[int]:
    """Reduced Montgomery-form values: random, plus 0, 1, p - 1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n - 3, -(-p.bit_length() // 32)), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]
    return vals + [0, 1, p - 1]


def _pair(vals):
    """The same values as a torch tensor and a JAX array."""
    t = convert.ints_to_limbs(vals, "cpu")
    return t, jnp.asarray(t.numpy().astype(np.uint32))


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("field", ["fq", "fr"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_ops_match_jax(field, op):
    ctx, jctx = CTXS[field]
    a, ja = _pair(_elements(1, ctx.p))
    b, jb = _pair(_elements(2, ctx.p)[::-1])
    assert _same(getattr(fp, op)(ctx, a, b), getattr(jfp, op)(jctx, ja, jb))


@pytest.mark.parametrize("field", ["fq", "fr"])
def test_unary_ops_match_jax(field):
    ctx, jctx = CTXS[field]
    a, ja = _pair(_elements(3, ctx.p))
    b, jb = _pair(_elements(4, ctx.p))
    assert _same(fp.neg(ctx, a), jfp.neg(jctx, ja))
    assert _same(fp.to_mont(ctx, a), jfp.to_mont(jctx, ja))
    assert _same(fp.from_mont(ctx, a), jfp.from_mont(jctx, ja))
    assert np.array_equal(fp.gt(a, b).numpy(), np.asarray(jfp.gt(ja, jb)))
    assert np.array_equal(fp.eq(a, a.flip(0)).numpy(), np.asarray(jfp.eq(ja, ja[::-1])))
    assert np.array_equal(fp.is_zero(a).numpy(), np.asarray(jfp.is_zero(ja)))


def test_batch_inv_with_zeros_matches_jax():
    ctx, jctx = CTXS["fq"]
    vals = _elements(5, Q, 16)
    vals[3] = vals[9] = 0
    a, ja = _pair(vals)
    got = fp.batch_inv(ctx, a)
    assert _same(got, jax.jit(jfp.batch_inv, static_argnums=0)(jctx, ja))
    for v, inv in zip(vals, convert.limbs_to_ints(got)):
        assert inv == 0 if v == 0 else v * inv * ctx.rinv % Q == ctx.r  # Montgomery product is one


def test_fq2_ops_match_jax():
    jf = JFq2Ops(CTXS["fq"][1])
    a = torch.stack([convert.ints_to_limbs(_elements(6, Q), "cpu"), convert.ints_to_limbs(_elements(7, Q), "cpu")], 1)
    b = torch.stack([convert.ints_to_limbs(_elements(8, Q), "cpu"), convert.ints_to_limbs(_elements(9, Q), "cpu")], 1)
    ja, jb = jnp.asarray(a.numpy().astype(np.uint32)), jnp.asarray(b.numpy().astype(np.uint32))
    assert _same(FQ2.mul(a, b), jf.mul(ja, jb))
    assert _same(FQ2.sqr(a), jf.sqr(ja))
    assert _same(FQ2.add(a, b), jf.add(ja, jb))
    assert _same(FQ2.sub(a, b), jf.sub(ja, jb))
    assert _same(FQ2.neg(a), jf.neg(ja))
    assert _same(FQ2.conjugate(a), jf.conjugate(ja))
    ctx = fp.FQ_CTX
    inv = FQ2.batch_inv(a[:8])
    for i in range(8):
        x = Fq2(*(ctx.from_mont_int(v) for v in convert.limbs_to_ints(a[i])))
        y = Fq2(*(ctx.from_mont_int(v) for v in convert.limbs_to_ints(inv[i])))
        assert x * y == Fq2(1, 0)


def test_convert_round_trips():
    vals = _elements(10, Q)
    assert convert.limbs_to_ints(convert.ints_to_limbs(vals, "cpu")) == vals
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 16, size=(5, 2, 16), dtype=np.uint32)
    y = rng.integers(0, 1 << 16, size=(5, 2, 16), dtype=np.uint32)
    inf = np.array([False, True, False, False, True])
    batch = convert.affine_from_numpy(x, y, inf, "cpu")
    assert batch.x.dtype == torch.int64 and batch.x.shape == (5, 2, 16)
    bx, by, binf = convert.affine_to_numpy(batch)
    assert bx.dtype == np.uint32 and np.array_equal(bx, x) and np.array_equal(by, y)
    assert np.array_equal(binf, inf)


# ---------------------------------------------------------------------------
# the kernels' field code (csrc/): the PTX the card runs, executed here
# instruction by instruction, and the C++ path a host compiler builds
# ---------------------------------------------------------------------------

_M32 = (1 << 32) - 1
_PTX_FN = re.compile(r"__device__ __forceinline__ void (\w+)\(([^)]*)\) \{\n(.*?)\n\}", re.S)


def _parse_ptx(text: str) -> dict:
    """field_ptx.cuh's text -> {name: function}; a function holds its inputs
    ((variable, array, index)), its zeroed variables, its asm statements
    ((instructions, "+r" operands, "r" operands)) and its outputs."""
    fns = {}
    for name, _, body in _PTX_FN.findall(text):
        fn = {"inputs": [], "zeros": [], "blocks": [], "outputs": []}
        lines = iter(body.split("\n"))
        for line in lines:
            line = line.strip()
            if line.startswith("const uint32_t "):
                fn["inputs"] += [(v, a, int(k)) for v, a, k in re.findall(r"(\w+) = (\w+)\[(\d+)\]", line)]
            elif line.startswith("uint32_t "):
                fn["zeros"] += re.findall(r"(\w+) = 0", line)
            elif line == "asm volatile(":
                text_parts, constraints = [], []
                for line in lines:
                    line = line.strip()
                    if line.startswith('"'):
                        text_parts.append(line[1:-1].replace("\\n\\t", ""))
                    else:
                        constraints.append(line)
                        if line.endswith(");"):
                            break
                outs = re.findall(r'"\+r"\((\w+)\)', constraints[0])
                ins = re.findall(r'"r"\((\w+)\)', constraints[1])
                instrs = []
                for part in text_parts:
                    part = part.strip().rstrip(";")
                    if part in ("{", "}") or part.startswith(".reg"):
                        continue
                    op, args = part.split(" ", 1)
                    instrs.append((op, [a.strip() for a in args.split(",")]))
                fn["blocks"].append((instrs, outs, ins))
            elif line.startswith("r[0]"):
                fn["outputs"] = [v for _, v in sorted(re.findall(r"r\[(\d+)\] = (\w+);", line), key=lambda t: int(t[0]))]
        fns[name] = fn
    return fns


def _compile_ptx(fn: dict):
    """One parsed function -> a Python function of its input arrays that
    runs its instructions in order on 32-bit limbs, with the carry flag.
    The carry flag is undefined at the start of every asm statement (the
    compiler keeps it across none): an instruction that reads it must
    follow one that set it in the same statement, and no instruction may
    write an input operand (both checked here, once, for every path of the
    straight-line code); a chain's last add without .cc must lose no carry
    (checked at run time)."""
    env = {}  # variable -> Python name

    def name(v):
        return env.setdefault(v, f"v{len(env)}")

    lines = ["def run(arrays):"]
    lines += [f"    {name(v)} = arrays[{a!r}][{k}]" for v, a, k in fn["inputs"]]
    lines += [f"    {name(v)} = 0" for v in fn["zeros"]]
    for b, (instrs, outs, ins) in enumerate(fn["blocks"]):
        operands, has_cf = outs + ins, False

        def val(tok):
            if tok.startswith("%"):
                return name(operands[int(tok[1:])])
            if re.fullmatch(r"-?(0x[0-9a-fA-F]+|\d+)", tok):
                return str(int(tok, 0))
            return f"l{b}_{tok}"

        for op, (dst, *src) in instrs:
            base, *mods = op.split(".")
            x = [val(t) for t in src]
            if base in ("madc", "addc", "subc"):
                assert has_cf, f"{op} reads a carry its statement never set"
            if base in ("mad", "madc"):
                prod = f"({x[0]} * {x[1]})"
                v = f"{f'({prod} & {_M32})' if 'lo' in mods else f'({prod} >> 32)'} + {x[2]}" + (" + cf" if base == "madc" else "")
            elif base in ("add", "addc"):
                v = f"{x[0]} + {x[1]}" + (" + cf" if base == "addc" else "")
            elif base in ("sub", "subc"):
                v = f"{x[0]} - {x[1]}" + (" - cf" if base == "subc" else "")
            elif base == "mul":
                v = f"({x[0]} * {x[1]}) & {_M32}"
            elif base == "and":
                v = f"{x[0]} & {x[1]}"
            elif base == "setp":
                v = f"int({x[0]} != {x[1]})"
            elif base == "selp":
                v = f"({x[0]} if {x[2]} else {x[1]})"
            else:
                raise AssertionError(f"no model of {op}")
            lines.append(f"    t = {v}")
            if "cc" in mods:
                lines.append("    cf = int(t < 0)" if base in ("sub", "subc") else "    cf = t >> 32")
                has_cf = True
            elif base in ("mad", "madc", "add", "addc"):
                lines.append(f"    assert t >> 32 == 0, {op + ' into ' + dst + ' lost a carry'!r}")
            if dst.startswith("%"):
                assert int(dst[1:]) < len(outs), f"{op} writes the input operand {dst}"
            lines.append(f"    {val(dst)} = t & {_M32}")
    lines.append(f"    return [{', '.join(name(v) for v in fn['outputs'])}]")
    scope = {}
    exec(compile("\n".join(lines), f"<ptx {len(lines)} lines>", "exec"), scope)
    return scope["run"]


def _run_ptx(fn: dict, **arrays) -> list[int]:
    """Execute one parsed function on 32-bit limbs (`_compile_ptx`, compiled
    once per function)."""
    if "run" not in fn:
        fn["run"] = _compile_ptx(fn)
    return fn["run"](arrays)


def _words(v: int, n: int = 8) -> list[int]:
    return [(v >> (32 * k)) & _M32 for k in range(n)]


def _field_cases(field: str, seed: int, n_random: int = 40):
    """fieldops.edge_pairs (Fq2: edge_pairs_fq2) plus random pairs: (values
    a, values b)."""
    p = fieldops.CTXS[field].p
    rng = random.Random(seed)
    if fieldops.is_fq2(field):
        pairs = fieldops.edge_pairs_fq2(rng, field)
        pairs += [(fieldops.random_element(field, rng), fieldops.random_element(field, rng)) for _ in range(n_random)]
        return [x for x, _ in pairs], [y for _, y in pairs]
    pairs = fieldops.edge_pairs(field, rng)
    a = [x for x, _ in pairs] + _elements(seed, p, n_random)
    b = [y for _, y in pairs] + _elements(seed + 1, p, n_random)
    return a, b


def test_build_writes_the_field_ptx_header(tmp_path):
    """field_ptx.cuh has one source, ops/_ptx.py: the build writes it onto
    nvcc's include path and keys the library by its text."""
    gen = _build.generated_headers()
    assert gen == {"field_ptx.cuh": _ptx.field_ptx_header()}
    assert not os.path.exists(os.path.join(_build.CSRC, "field_ptx.cuh"))
    _build.write_headers(str(tmp_path), gen)
    assert (tmp_path / "field_ptx.cuh").read_text() == gen["field_ptx.cuh"]
    assert _build._source_hash(gen) != _build._source_hash({"field_ptx.cuh": gen["field_ptx.cuh"] + "\n"})


@pytest.mark.parametrize("field", ["fq", "fr", "bls_fq"])
def test_field_ptx_matches_fp(field):
    """Every instruction of field_ptx.cuh's product, square, sum and
    difference, run on Python integers, against field/fp.py limb for limb
    on the edge operands and random pairs (bls_fq: the 12-limb routines)."""
    fns = _parse_ptx(_ptx.field_ptx_header())
    a, b = _field_cases(field, 7)
    want = [convert.limbs_to_ints(t) for t in fieldops.field_ops_plain(*(fieldops.to_limbs(v, field, "cpu") for v in (a, b)), field)]
    got = [[], [], [], []]
    n = _ptx.LIMBS[field]
    for x, y in zip(a, b):
        wx, wy = _words(x, n), _words(y, n)
        res = (_run_ptx(fns[f"ptx_mul_{field}"], a=wx, b=wy), _run_ptx(fns[f"ptx_sqr_{field}"], a=wx),
               _run_ptx(fns[f"ptx_add_{field}"], a=wx, b=wy), _run_ptx(fns[f"ptx_sub_{field}"], a=wx, b=wy))
        for out, words in zip(got, res):
            out.append(sum(w << (32 * k) for k, w in enumerate(words)))
    p, rinv = fieldops.CTXS[field].p, fieldops.CTXS[field].rinv
    assert got == want
    assert want[0] == [x * y * rinv % p for x, y in zip(a, b)]
    assert want[1] == [x * x * rinv % p for x in a]


def _fq2_ptx_matches_fq2(field: str) -> None:
    fns = _parse_ptx(_ptx.field_ptx_header())
    a, b = _field_cases(field, 11)
    ta, tb = (fieldops.to_limbs(v, field, "cpu") for v in (a, b))
    f, ctx = fieldops.FQ2_OPS[field], fieldops.CTXS[field]
    prod, sq = f.mul(ta, tb), f.sqr(ta)
    p, rinv, n, name = ctx.p, ctx.rinv, ctx.nlimbs // 2, _ptx.FQ2_NAMES[field.removesuffix("2")]
    for i, ((a0, a1), (b0, b1)) in enumerate(zip(a, b)):
        got_mul = _run_ptx(fns[f"ptx_mul_{name}"], a=_words(a0, n) + _words(a1, n), b=_words(b0, n) + _words(b1, n))
        got_sqr = _run_ptx(fns[f"ptx_sqr_{name}"], a=_words(a0, n) + _words(a1, n))
        for got, want in ((got_mul, prod[i]), (got_sqr, sq[i])):
            assert torch.equal(fieldops.to_limbs([(_int(got[:n]), _int(got[n:]))], field, "cpu")[0], want), i
        assert (_int(got_mul[:n]), _int(got_mul[n:])) == ((a0 * b0 - a1 * b1) * rinv % p, (a0 * b1 + a1 * b0) * rinv % p)
        assert (_int(got_sqr[:n]), _int(got_sqr[n:])) == ((a0 * a0 - a1 * a1) * rinv % p, 2 * a0 * a1 * rinv % p)
    assert {0, p - 1} <= set(convert.limbs_to_ints(prod.reshape(-1, ctx.nlimbs)))  # products land on 0 and p - 1
    assert 0 in convert.limbs_to_ints(sq[:, 0])  # and squares' c0 on 0


def test_fq2_ptx_matches_fq2():
    """Every instruction of field_ptx.cuh's fused Fq2 product and square
    (Karatsuba with lazy reduction), run on Python integers, against
    field/fq2.py limb for limb and against the integers, on
    fieldops.edge_pairs_fq2 (components 0, 1, p - 1; a0 + a1 >= p; a0 b0 <
    a1 b1; results on 0 and p - 1) and random pairs."""
    _fq2_ptx_matches_fq2("fq2")


def test_bls_fq2_ptx_matches_fq2():
    """The same for BLS12-381's Fq2 routines (ptx_mul_bls_fq2,
    ptx_sqr_bls_fq2: 12-limb products, their 24-word sums and differences
    cut into statements of 8 words) against field/fq2.py's BLS_FQ2."""
    _fq2_ptx_matches_fq2("bls_fq2")


def _int(words: list[int]) -> int:
    return sum(w << (32 * k) for k, w in enumerate(words))


_FIELD_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "fieldops.cu"
extern "C" void host_field_ops(const int64_t* a, const int64_t* b, int64_t* prod, int64_t* sq, int64_t* sum,
                               int64_t* diff, int n, int field) {
  for (int64_t i = 0; i < n; ++i) field_ops_pair(a, b, prod, sq, sum, diff, i, field);
}
"""


@pytest.mark.parametrize("field", ["fq", "fr", "fq2", "bls_fq", "bls_fq2"])
def test_field_host_path_matches_fp(field, tmp_path):
    """csrc/fieldops.cu compiled by g++ (the C++ CIOS of field.cuh; for Fq2
    the fused product and square's C++ counterpart; BLS12-381's on 12
    limbs) against field/fp.py (field/fq2.py) limb for limb on the same
    operands."""
    (tmp_path / "shim.cpp").write_text(_FIELD_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
                    str(tmp_path / "shim.cpp"), "-o", str(tmp_path / "shim.so")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(tmp_path / "shim.so"))
    a, b = (fieldops.to_limbs(v, field, "cpu") for v in _field_cases(field, 9))
    out = [torch.empty_like(a) for _ in range(4)]
    lib.host_field_ops(*(ctypes.c_void_p(t.data_ptr()) for t in (a, b, *out)), ctypes.c_int(a.shape[0]),
                       ctypes.c_int(fieldops.FIELDS[field]))
    assert all(torch.equal(g, w) for g, w in zip(out, fieldops.field_ops_plain(a, b, field)))
