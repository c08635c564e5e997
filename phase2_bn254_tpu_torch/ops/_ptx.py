"""The text of field_ptx.cuh: the Fq, Fq2 and Fr arithmetic of the kernels
on the card, as inline PTX carry chains on n x 32-bit limbs: n = 8 for
BN254's Fq and Fr (R = 2^256), n = 12 for BLS12-381's Fq (R = 2^384). It is
not kept in csrc/: `_build.build()` writes it into the build directory, on
nvcc's include path, and keys the library by its text.

Generated rather than written by hand so that every instruction the card
runs is also run on the CPU: tests/test_torch_field.py parses the header's
text and executes its instructions (carry flag included) on Python
integers against `field/fp.py`.

Per modulus p (q of Fq, r of Fr, q of BLS Fq: `MODULI`), four functions on
little-endian limbs, each value in [0, p):

* `ptx_mul_<f>`: a b 2^(-32 n) mod p by CIOS. Row i adds a b_i to the
  running sum and then m p with m = t_i (-p^-1) mod 2^32, each as two carry
  chains over the even and the odd limbs (lo and hi halves of one limb
  product land on neighbouring words, so the chains of a row do not
  overlap). The rows write into a (2n + 1)-word window t that moves up a
  word per row, so no word is ever copied; the result is t[n..2n-1] < 2p.
* `ptx_sqr_<f>`: a^2 2^(-32 n) mod p with the n (n - 1) / 2 cross products
  a_i a_j (i < j) computed once and doubled, then the n squares a_i^2 (36
  limb products where the multiply takes 64, at n = 8). The low half of the
  square is Montgomery-reduced (n rows of m p) and the high half added
  after: (lo + M p) / 2^(32 n) <= p and hi < p / 4, so the sum is < 2p.
* `ptx_add_<f>`, `ptx_sub_<f>`: a + b and a - b mod p.

and for Fq2 = Fq[u] / (u^2 + 1), each operand 2n limbs (c0 then c1):

* `ptx_mul_fq2` (`ptx_mul_bls_fq2`): Karatsuba with lazy reduction. a0 b0,
  a1 b1 and (a0 + a1)(b0 + b1) are three n x n-limb products into 2n
  words, none reduced (a0 + a1 < 2p < 2^(32 n) needs no reduction either);
  then c0 = a0 b0 - a1 b1 + p^2 and c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1,
  both in [0, 2 p^2), below p 2^(32 n) (2p < 2^(32 n): BN254 q < 2^254, BLS
  q < 2^381); then one Montgomery reduction of each (the low half by n rows
  of m p into fresh words, the high half added after: (lo + M p) / 2^(32 n)
  <= p and hi < p, so the sum is < 2p). 3 x 128 + 2 x 136 = 656 32-bit
  multiplies at n = 8 (three CIOS products take 792), 3 x 288 + 2 x 300 =
  1,464 at n = 12.
* `ptx_sqr_fq2` (`ptx_sqr_bls_fq2`): c0 = (a0 + a1)(a0 - a1 + p) < 4 p^2
  (below p 2^(32 n) as 4p < 2^(32 n)) and c1 = 2 a0 a1, two unreduced
  products and two reductions: 2 x 128 + 2 x 136 = 528 at n = 8, 1,176 at
  n = 12.

Each result goes through one conditional subtraction (or addition) of p,
so every value stays fully reduced. Each carry chain lies inside one
`asm volatile` statement: the compiler promises nothing about the carry
flag between statements. No statement takes more than 30 operands (the
limit of GCC's inline asm, which the front ends follow): a chain longer
than that is cut into statements of at most 8 words, the carry between
them passed in the word `lk` and put back into the flag at the next
statement's start. The modulus and -p^-1 are immediates. The BN254
functions' text is the same as before the limb count became a parameter.
"""

from __future__ import annotations

from ..bls12_381.field import Q as BLS_Q
from ..refimpl.field import Q, R_MOD

MODULI = {"fq": Q, "fr": R_MOD, "bls_fq": BLS_Q}
LIMBS = {"fq": 8, "fr": 8, "bls_fq": 12}  # 32-bit limbs of each field
FQ2_NAMES = {"fq": "fq2", "bls_fq": "bls_fq2"}  # the Fq2 routines over each base field
SEGMENT = 8  # words of one statement of a long add / subtract chain


def _limbs(v: int, n: int = 8) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


class _Fn:
    """One generated function: its C signature, the C variables it declares,
    a list of asm statements (each a list of (op, dst, srcs) and its
    block-local registers), and its outputs."""

    def __init__(self, name: str, args: list[str]):
        self.name, self.args = name, args
        self.inputs: list[tuple[str, str]] = []  # (variable, "a[k]")
        self.zeros: list[str] = []
        self.blocks: list[tuple[list[tuple], list[tuple[str, str]]]] = []
        self.outputs: list[tuple[int, str]] = []

    def block(self, regs=()) -> list[tuple]:
        ins: list[tuple] = []
        self.blocks.append((ins, list(regs)))
        return ins


def _chain(ins: list, rows: list[tuple], first_cc: bool = False) -> None:
    """One carry chain of limb products (x, y, word_lo, word_hi): word_lo +=
    lo(x y), word_hi += hi(x y), carries in order; the chain's carry is left
    in the flag after its last instruction (.cc)."""
    for k, (x, y, lo, hi) in enumerate(rows):
        ins.append(("madc.lo.cc.u32" if k or first_cc else "mad.lo.cc.u32", lo, (x, y, lo)))
        ins.append(("madc.hi.cc.u32", hi, (x, y, hi)))


def _propagate(ins: list, words: list[str]) -> None:
    """Add the carry flag into words[0], then the carries on up to the last
    word, which takes no carry out."""
    for w in words[:-1]:
        ins.append(("addc.cc.u32", w, (w, 0)))
    ins.append(("addc.u32", words[-1], (words[-1], 0)))


def _reduce_row(ins: list, t: list[str], p: list[int], pinv: int) -> None:
    """t[0..n] += m p with m = t[0] pinv mod 2^32, n = len(p) (t[0] becomes
    0; t[n] takes the even chain's carry and the odd chain's top)."""
    n = len(p)
    ins.append(("mul.lo.u32", "p2m", (t[0], pinv)))
    _chain(ins, [("p2m", p[j], t[j], t[j + 1]) for j in range(0, n, 2)])
    ins.append(("addc.u32", t[n], (t[n], 0)))
    _chain(ins, [("p2m", p[j], t[j], t[j + 1]) for j in range(1, n, 2)])
    ins[-1] = ("madc.hi.u32", t[n], ins[-1][2])


def _final_subtract(fn: _Fn, x: list[str], p: list[int]) -> None:
    """out = x - p if x >= p else x, for x < 2p; the result back into x."""
    n = len(p)
    ins = fn.block([("u32", f"p2z{k}") for k in range(n)] + [("u32", "p2bw"), ("pred", "p2lt")])
    ins.append(("sub.cc.u32", "p2z0", (x[0], p[0])))
    for k in range(1, n):
        ins.append(("subc.cc.u32", f"p2z{k}", (x[k], p[k])))
    ins.append(("subc.u32", "p2bw", (0, 0)))  # all ones where x < p
    ins.append(("setp.ne.u32", "p2lt", ("p2bw", 0)))
    for k in range(n):
        ins.append(("selp.b32", x[k], (x[k], f"p2z{k}", "p2lt")))


def _binary_fn(name: str, n: int) -> _Fn:
    fn = _Fn(name, ["uint32_t* r", "const uint32_t* a", "const uint32_t* b"])
    fn.inputs = [(f"a{k}", f"a[{k}]") for k in range(n)] + [(f"b{k}", f"b[{k}]") for k in range(n)]
    return fn


def _mul(f: str, p: list[int], pinv: int) -> _Fn:
    n = len(p)
    fn = _binary_fn(f"ptx_mul_{f}", n)
    fn.zeros = [f"t{k}" for k in range(2 * n + 1)]
    for i in range(n):
        t = [f"t{i + k}" for k in range(n + 1)]
        ins = fn.block([("u32", "p2m")])
        _chain(ins, [(f"a{j}", f"b{i}", t[j], t[j + 1]) for j in range(0, n, 2)])
        ins.append(("addc.u32", t[n], (t[n], 0)))
        _chain(ins, [(f"a{j}", f"b{i}", t[j], t[j + 1]) for j in range(1, n, 2)])
        ins[-1] = ("madc.hi.u32", t[n], ins[-1][2])
        _reduce_row(ins, t, p, pinv)
    res = [f"t{n + k}" for k in range(n)]
    _final_subtract(fn, res, p)
    fn.outputs = list(enumerate(res))
    return fn


def _sqr(f: str, p: list[int], pinv: int) -> _Fn:
    n = len(p)
    fn = _Fn(f"ptx_sqr_{f}", ["uint32_t* r", "const uint32_t* a"])
    fn.inputs = [(f"a{k}", f"a[{k}]") for k in range(n)]
    w = [f"w{k}" for k in range(2 * n)]  # the square, 2n words
    u = [f"u{k}" for k in range(n, 2 * n + 1)]  # the reduction's words above w[n - 1]
    fn.zeros = w + u + (["lk"] if n > SEGMENT else [])
    # cross products: row i adds a_i (a_(i+1) .. a_(n-1)) at word 2i + 1;
    # after row i the sum is < 2^(32 (i + n + 1) + 1), so its carries stop
    # at w[i + n + 1]
    for i in range(n - 1):
        ins = fn.block()
        o, ys = 2 * i + 1, list(range(i + 1, n))
        for parity in (0, 1):
            js = [j for j in range(parity, len(ys), 2)]
            if not js:
                continue
            _chain(ins, [(f"a{i}", f"a{ys[j]}", w[o + j], w[o + j + 1]) for j in js])
            _propagate(ins, w[o + js[-1] + 2 : i + n + 2])
    ins = fn.block()  # double (w[0] is 0); 2 cross < a^2 < 2^(64 n - 4)
    ins.append(("add.cc.u32", w[1], (w[1], w[1])))
    for k in range(2, 2 * n - 1):
        ins.append(("addc.cc.u32", w[k], (w[k], w[k])))
    ins.append(("addc.u32", w[2 * n - 1], (w[2 * n - 1], w[2 * n - 1])))
    # the squares a_i^2 at word 2i; past SEGMENT limbs in two statements, the
    # carry between them in lk
    rows = [(f"a{i}", f"a{i}", w[2 * i], w[2 * i + 1]) for i in range(n)]
    ins = fn.block()
    if n > SEGMENT:
        _chain(ins, rows[: n // 2])
        ins.append(("addc.u32", "lk", (0, 0)))
        ins = fn.block([("u32", "p2k")])
        ins.append(("add.cc.u32", "p2k", ("lk", 0xFFFFFFFF)))
        _chain(ins, rows[n // 2 :], first_cc=True)
    else:
        _chain(ins, rows)
    ins[-1] = ("madc.hi.u32", w[2 * n - 1], ins[-1][2])
    # reduce the low half: t = w[0..n-1] then u[n..2n], row i on t[i .. i + n]
    t = w[:n] + u
    for i in range(n):
        _reduce_row(fn.block([("u32", "p2m")]), t[i : i + n + 1], p, pinv)
    ins = fn.block()  # + the high half: (lo + M p) / 2^(32 n) <= p, hi < p / 4
    ins.append(("add.cc.u32", u[0], (u[0], w[n])))
    for k in range(1, n - 1):
        ins.append(("addc.cc.u32", u[k], (u[k], w[n + k])))
    ins.append(("addc.u32", u[n - 1], (u[n - 1], w[2 * n - 1])))
    res = u[:n]
    _final_subtract(fn, res, p)
    fn.outputs = list(enumerate(res))
    return fn


def _add(f: str, p: list[int]) -> _Fn:
    n = len(p)
    fn = _binary_fn(f"ptx_add_{f}", n)
    s = _words("s", n)
    fn.zeros = s + (["lk"] if n > SEGMENT else [])
    _wide_chain(fn, "add", s, _words("b", n), lhs=_words("a", n))  # a + b < 2p < 2^(32 n): no carry out
    _final_subtract(fn, s, p)
    fn.outputs = list(enumerate(s))
    return fn


def _sub(f: str, p: list[int]) -> _Fn:
    n = len(p)
    fn = _binary_fn(f"ptx_sub_{f}", n)
    d = _words("d", n)
    if n > SEGMENT:
        # a - b in statements of SEGMENT words, its borrow (all ones where a
        # < b) into bw; then + (p & bw), the carry out of the last word dropped
        q = _words("q", n)
        fn.zeros = d + q + ["lk", "bw"]
        _wide_chain(fn, "sub", d, _words("b", n), lhs=_words("a", n), carry="bw")
        ins = fn.block()
        for k in range(n):
            ins.append(("and.b32", q[k], ("bw", p[k])))
        _wide_chain(fn, "add", d, q, carry="drop")
        fn.outputs = list(enumerate(d))
        return fn
    fn.zeros = d
    ins = fn.block([("u32", "p2bw")] + [("u32", f"p2q{k}") for k in range(n)])
    ins.append(("sub.cc.u32", d[0], ("a0", "b0")))
    for k in range(1, n):
        ins.append(("subc.cc.u32", d[k], (f"a{k}", f"b{k}")))
    ins.append(("subc.u32", "p2bw", (0, 0)))  # all ones where a < b
    for k in range(n):
        ins.append(("and.b32", f"p2q{k}", ("p2bw", p[k])))
    # + p where a < b, mod 2^256: the carry out of the last word is dropped
    ins.append(("add.cc.u32", d[0], (d[0], "p2q0")))
    for k in range(1, n):
        ins.append(("addc.cc.u32", d[k], (d[k], f"p2q{k}")))
    fn.outputs = list(enumerate(d))
    return fn


def _wide_product(fn: _Fn, x: list[str], y: list[str], w: list[str]) -> None:
    """w[0..2n-1] = x y for n-word x, y (w zeroed): row i adds x y_i at
    word i, an even and an odd chain as in `_mul`; after row i the sum is
    below 2^(32 (i + n + 1)), so word i + n takes the row's last carry."""
    n = len(x)
    for i in range(n):
        ins = fn.block()
        _chain(ins, [(x[j], y[i], w[i + j], w[i + j + 1]) for j in range(0, n, 2)])
        ins.append(("addc.u32", w[i + n], (w[i + n], 0)))
        _chain(ins, [(x[j], y[i], w[i + j], w[i + j + 1]) for j in range(1, n, 2)])
        ins[-1] = ("madc.hi.u32", w[i + n], ins[-1][2])


def _wide_chain(fn: _Fn, op: str, dst: list[str], src: list, lhs: list | None = None,
                carry: str | None = None) -> None:
    """dst = lhs op src word by word with carries ("add" or "sub"; lhs is
    dst unless given). src words may be immediates. With carry None the
    result must fit (no carry or borrow out); "drop" drops it (mod 2^(32
    len)); any other name is a word that takes it (add: 0 or 1, sub: all
    ones or 0). A chain longer than SEGMENT words is cut into asm statements
    of SEGMENT (fewer operands each), the carry between them passed in the
    word `lk` (0 or 1) and put back into the flag at the next statement's
    start."""
    lhs = dst if lhs is None else lhs
    for half in range(0, len(dst), SEGMENT):
        d, s, a = dst[half : half + SEGMENT], src[half : half + SEGMENT], lhs[half : half + SEGMENT]
        ins = fn.block([("u32", "p2k")] if half else [])
        if half:  # the flag from lk: 1 + 0xffffffff carries, 0 - 1 borrows
            ins.append(("add.cc.u32" if op == "add" else "sub.cc.u32", "p2k",
                        ("lk", 0xFFFFFFFF) if op == "add" else (0, "lk")))
        ins.append((f"{op}c.cc.u32" if half else f"{op}.cc.u32", d[0], (a[0], s[0])))
        for k in range(1, len(d) - 1):
            ins.append((f"{op}c.cc.u32", d[k], (a[k], s[k])))
        if half + SEGMENT < len(dst):
            ins.append((f"{op}c.cc.u32", d[-1], (a[-1], s[-1])))
            ins.append((f"{op}c.u32", "lk", (0, 0)))  # the carry (the borrow: 0 - 0 - 1 = all ones)
            if op == "sub":
                ins.append(("and.b32", "lk", ("lk", 1)))
        elif carry is None:
            ins.append((f"{op}c.u32", d[-1], (a[-1], s[-1])))
        else:
            ins.append((f"{op}c.cc.u32", d[-1], (a[-1], s[-1])))
            if carry != "drop":
                ins.append((f"{op}c.u32", carry, (0, 0)))


def _wide_reduce(fn: _Fn, w: list[str], u: list[str], p: list[int], pinv: int) -> list[str]:
    """w (2n words, below p 2^(32 n)) 2^(-32 n) mod p, fully reduced, into
    u (n zeroed words): the low half by n rows of m p into u (row i on words
    i .. i + n of w[0..n-1] + u), the high half added after, as in `_sqr`."""
    n = len(p)
    t = w[:n] + u
    for i in range(n):
        _reduce_row(fn.block([("u32", "p2m")]), t[i : i + n + 1], p, pinv)
    _wide_chain(fn, "add", u, w[n:])
    _final_subtract(fn, u, p)
    return u


def _fq2_fn(name: str, n: int, binary: bool) -> _Fn:
    args = ["uint32_t* r", "const uint32_t* a"] + (["const uint32_t* b"] if binary else [])
    fn = _Fn(name, args)
    fn.inputs = [(f"a{k}", f"a[{k}]") for k in range(2 * n)]
    if binary:
        fn.inputs += [(f"b{k}", f"b[{k}]") for k in range(2 * n)]
    return fn


def _words(prefix: str, n: int) -> list[str]:
    return [f"{prefix}{k}" for k in range(n)]


def _mul_fq2(p: list[int], pinv: int, modulus: int, name: str = "fq2") -> _Fn:
    n = len(p)
    fn = _fq2_fn(f"ptx_mul_{name}", n, True)
    a0, a1, b0, b1 = _words("a", n), _words("a", 2 * n)[n:], _words("b", n), _words("b", 2 * n)[n:]
    sa, sb = _words("sa", n), _words("sb", n)  # a0 + a1, b0 + b1 < 2p < 2^(32 n)
    x, y, z = _words("x", 2 * n), _words("y", 2 * n), _words("z", 2 * n)  # a0 b0, a1 b1, (a0 + a1)(b0 + b1)
    u, v = _words("u", n), _words("v", n)
    fn.zeros = sa + sb + x + y + z + u + v + ["lk"]
    for s, lo, hi in ((sa, a0, a1), (sb, b0, b1)):
        _wide_chain(fn, "add", s, hi, lhs=lo)
    _wide_product(fn, a0, b0, x)
    _wide_product(fn, a1, b1, y)
    _wide_product(fn, sa, sb, z)
    _wide_chain(fn, "sub", z, x)  # c1 = z - x - y = a0 b1 + a1 b0 >= 0
    _wide_chain(fn, "sub", z, y)
    p2 = modulus * modulus
    _wide_chain(fn, "add", x, [(p2 >> (32 * k)) & 0xFFFFFFFF for k in range(2 * n)])  # c0 = x + p^2 - y > 0
    _wide_chain(fn, "sub", x, y)
    c0 = _wide_reduce(fn, x, u, p, pinv)
    c1 = _wide_reduce(fn, z, v, p, pinv)
    fn.outputs = list(enumerate(c0 + c1))
    return fn


def _sqr_fq2(p: list[int], pinv: int, name: str = "fq2") -> _Fn:
    n = len(p)
    fn = _fq2_fn(f"ptx_sqr_{name}", n, False)
    a0, a1 = _words("a", n), _words("a", 2 * n)[n:]
    sa, da = _words("sa", n), _words("da", n)  # a0 + a1, a0 - a1 + p, both < 2p < 2^(32 n)
    x, y = _words("x", 2 * n), _words("y", 2 * n)  # (a0 + a1)(a0 - a1 + p) < 4 p^2, a0 a1
    u, v = _words("u", n), _words("v", n)
    fn.zeros = sa + da + x + y + u + v + ["lk"]
    _wide_chain(fn, "add", sa, a1, lhs=a0)
    _wide_chain(fn, "add", da, p, lhs=a0)
    _wide_chain(fn, "sub", da, a1)
    _wide_product(fn, sa, da, x)
    _wide_product(fn, a0, a1, y)
    _wide_chain(fn, "add", y, y)  # 2 a0 a1 < 2 p^2
    c0 = _wide_reduce(fn, x, u, p, pinv)
    c1 = _wide_reduce(fn, y, v, p, pinv)
    fn.outputs = list(enumerate(c0 + c1))
    return fn


def _render(fn: _Fn) -> str:
    lines = [f"__device__ __forceinline__ void {fn.name}({', '.join(fn.args)}) {{"]
    if fn.inputs:
        lines.append("  const uint32_t " + ", ".join(f"{v} = {e}" for v, e in fn.inputs) + ";")
    lines.append("  uint32_t " + ", ".join(f"{v} = 0" for v in fn.zeros) + ";")
    for ins, regs in fn.blocks:
        local = {name for _, name in regs}
        written, order = [], []
        for _, dst, srcs in ins:
            for v in (*srcs, dst):
                if isinstance(v, str) and v not in local and v not in order:
                    order.append(v)
            if dst not in local and dst not in written:
                written.append(dst)
        outs = [v for v in order if v in written]
        operands = outs + [v for v in order if v not in written]
        num = {v: f"%{k}" for k, v in enumerate(operands)}

        def arg(v):
            return f"0x{v:08x}" if isinstance(v, int) else num.get(v, v)

        body = ['"{\\n\\t"']
        for kind, name in regs:
            body.append(f'".reg .{kind} {name};\\n\\t"')
        for op, dst, srcs in ins:
            body.append(f'"{op} {", ".join(arg(v) for v in (dst, *srcs))};\\n\\t"')
        body.append('"}"')
        lines.append("  asm volatile(")
        lines.extend("      " + b for b in body)
        lines.append("      : " + ", ".join(f'"+r"({v})' for v in outs))
        lines.append("      : " + ", ".join(f'"r"({v})' for v in operands[len(outs):]) + ");")
    lines.append("  " + " ".join(f"r[{k}] = {v};" for k, v in fn.outputs))
    lines.append("}")
    return "\n".join(lines)


def field_ptx_header() -> str:
    """The text of field_ptx.cuh."""
    parts = [
        "// BN254 Fq, Fq2 and Fr arithmetic as inline PTX carry chains on 8 little-endian",
        "// 32-bit limbs (16 for Fq2: c0 then c1), Montgomery form (R = 2^256), and",
        "// BLS12-381 Fq and Fq2 (the _bls_ functions) on 12 limbs (24 for Fq2, R = 2^384);",
        "// every value in [0, p).",
        "// Written by ops/_ptx.py field_ptx_header(); tests/test_torch_field.py runs",
        "// its instructions on the CPU. Device code only (field.cuh includes it",
        "// under __CUDA_ARCH__).",
        "#pragma once",
        "",
        "#include <cstdint>",
    ]
    for f, modulus in MODULI.items():
        p = _limbs(modulus, LIMBS[f])
        pinv = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        for fn in (_mul(f, p, pinv), _sqr(f, p, pinv), _add(f, p), _sub(f, p)):
            parts += ["", _render(fn)]
        if f in FQ2_NAMES:
            for fn in (_mul_fq2(p, pinv, modulus, FQ2_NAMES[f]), _sqr_fq2(p, pinv, FQ2_NAMES[f])):
                parts += ["", _render(fn)]
    return "\n".join(parts) + "\n"
