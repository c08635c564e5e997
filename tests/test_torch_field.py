"""The port's field layer against the JAX package's, limb for limb.

`phase2_bn254_tpu_torch.field.fp` / `fq2` on the CPU against
`phase2_bn254_tpu.field.fp` / `fq2` (XLA:CPU), on the same inputs made from
a seeded numpy generator. Tolerance: exact integer equality of every limb
(the Montgomery values are the same integers in both packages).

The kernels' own field code has two paths, both held against `field/fp.py`
here on `ops.fieldops.edge_pairs` and random pairs: the inline PTX of
field_ptx.cuh (`ops._ptx.field_ptx_header()`), parsed and executed instruction by instruction with its
carry flag, and the C++ CIOS that g++ builds from csrc/fieldops.cu (the
card compares the PTX itself: tests/test_torch_field_gpu.py).
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
    words = rng.integers(0, 1 << 32, size=(n - 3, 8), dtype=np.uint64)
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


def _run_ptx(fn: dict, **arrays) -> list[int]:
    """Execute one parsed function on 32-bit limbs. The carry flag is
    undefined at the start of every asm statement (the compiler keeps it
    across none); a chain's last add without .cc must lose no carry."""
    env = {v: arrays[a][k] for v, a, k in fn["inputs"]}
    env.update({v: 0 for v in fn["zeros"]})
    for instrs, outs, ins in fn["blocks"]:
        operands, local, cf = outs + ins, {}, None

        def val(tok):
            if tok.startswith("%"):
                return env[operands[int(tok[1:])]]
            return local[tok] if tok in local else int(tok, 0)

        for op, (dst, *src) in instrs:
            base, *mods = op.split(".")
            s = [val(t) for t in src]
            if base in ("madc", "addc", "subc"):
                assert cf is not None, f"{op} reads a carry its statement never set"
            if base in ("mad", "madc"):
                prod = s[0] * s[1]
                v = (prod & _M32 if "lo" in mods else prod >> 32) + s[2] + (cf if base == "madc" else 0)
            elif base in ("add", "addc"):
                v = s[0] + s[1] + (cf if base == "addc" else 0)
            elif base in ("sub", "subc"):
                v = s[0] - s[1] - (cf if base == "subc" else 0)
            elif base == "mul":
                v = (s[0] * s[1]) & _M32
            elif base == "and":
                v = s[0] & s[1]
            elif base == "setp":
                v = int(s[0] != s[1])
            elif base == "selp":
                v = s[0] if s[2] else s[1]
            else:
                raise AssertionError(f"no model of {op}")
            if "cc" in mods:
                cf = int(v < 0) if base in ("sub", "subc") else v >> 32
            elif base in ("mad", "madc", "add", "addc"):
                assert v >> 32 == 0, f"{op} into {dst} lost a carry"
            if dst.startswith("%"):
                k = int(dst[1:])
                assert k < len(outs), f"{op} writes the input operand {dst}"
                env[operands[k]] = v & _M32
            else:
                local[dst] = v & _M32
    return [env[v] for v in fn["outputs"]]


def _words(v: int) -> list[int]:
    return [(v >> (32 * k)) & _M32 for k in range(8)]


def _field_cases(field: str, seed: int, n_random: int = 40):
    """fieldops.edge_pairs (Fq2: edge_pairs_fq2) plus random pairs: (values
    a, values b)."""
    p = fieldops.CTXS[field].p
    rng = random.Random(seed)
    if field == "fq2":
        pairs = fieldops.edge_pairs_fq2(rng)
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


@pytest.mark.parametrize("field", ["fq", "fr"])
def test_field_ptx_matches_fp(field):
    """Every instruction of field_ptx.cuh's product, square, sum and
    difference, run on Python integers, against field/fp.py limb for limb
    on the edge operands and random pairs."""
    fns = _parse_ptx(_ptx.field_ptx_header())
    a, b = _field_cases(field, 7)
    want = [convert.limbs_to_ints(t) for t in fieldops.field_ops_plain(*(convert.ints_to_limbs(v, "cpu") for v in (a, b)), field)]
    got = [[], [], [], []]
    for x, y in zip(a, b):
        wx, wy = _words(x), _words(y)
        res = (_run_ptx(fns[f"ptx_mul_{field}"], a=wx, b=wy), _run_ptx(fns[f"ptx_sqr_{field}"], a=wx),
               _run_ptx(fns[f"ptx_add_{field}"], a=wx, b=wy), _run_ptx(fns[f"ptx_sub_{field}"], a=wx, b=wy))
        for out, words in zip(got, res):
            out.append(sum(w << (32 * k) for k, w in enumerate(words)))
    p, rinv = fieldops.CTXS[field].p, pow(1 << 256, -1, fieldops.CTXS[field].p)
    assert got == want
    assert want[0] == [x * y * rinv % p for x, y in zip(a, b)]
    assert want[1] == [x * x * rinv % p for x in a]


def test_fq2_ptx_matches_fq2():
    """Every instruction of field_ptx.cuh's fused Fq2 product and square
    (Karatsuba with lazy reduction), run on Python integers, against
    field/fq2.py limb for limb and against the integers, on
    fieldops.edge_pairs_fq2 (components 0, 1, p - 1; a0 + a1 >= p; a0 b0 <
    a1 b1; results on 0 and p - 1) and random pairs."""
    fns = _parse_ptx(_ptx.field_ptx_header())
    a, b = _field_cases("fq2", 11)
    ta, tb = (fieldops.to_limbs(v, "fq2", "cpu") for v in (a, b))
    prod, sq = FQ2.mul(ta, tb), FQ2.sqr(ta)
    p, rinv = Q, pow(1 << 256, -1, Q)
    for i, ((a0, a1), (b0, b1)) in enumerate(zip(a, b)):
        got_mul = _run_ptx(fns["ptx_mul_fq2"], a=_words(a0) + _words(a1), b=_words(b0) + _words(b1))
        got_sqr = _run_ptx(fns["ptx_sqr_fq2"], a=_words(a0) + _words(a1))
        for got, want in ((got_mul, prod[i]), (got_sqr, sq[i])):
            assert torch.equal(fieldops.to_limbs([(_int(got[:8]), _int(got[8:]))], "fq2", "cpu")[0], want), i
        assert (_int(got_mul[:8]), _int(got_mul[8:])) == ((a0 * b0 - a1 * b1) * rinv % p, (a0 * b1 + a1 * b0) * rinv % p)
        assert (_int(got_sqr[:8]), _int(got_sqr[8:])) == ((a0 * a0 - a1 * a1) * rinv % p, 2 * a0 * a1 * rinv % p)
    assert {0, p - 1} <= set(convert.limbs_to_ints(prod.reshape(-1, 16)))  # products land on 0 and p - 1
    assert 0 in convert.limbs_to_ints(sq[:, 0])  # and squares' c0 on 0


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


@pytest.mark.parametrize("field", ["fq", "fr", "fq2"])
def test_field_host_path_matches_fp(field, tmp_path):
    """csrc/fieldops.cu compiled by g++ (the C++ CIOS of field.cuh; for Fq2
    the fused product and square's C++ counterpart) against field/fp.py
    (field/fq2.py) limb for limb on the same operands."""
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
