"""Build and load the CUDA kernels of `csrc/` (Hopper, sm_90a).

The sources are compiled at first use with `nvcc`, one process per source
started together, and linked into one shared library with a plain C
interface, loaded through ctypes. The library is keyed by a hash of the
sources and kept under `build/kernels/` at the repository root (listed in
.gitignore), so a fresh checkout builds everything on its first kernel call.
Nothing here runs at import time. `on_card`, `check` and `launch` are the
boundary every kernel wrapper goes through.

`csrc/constants.cuh` holds the field constants as 32-bit limbs; it is the
output of `constants_header()`, which derives them from the `refimpl` and
`bls12_381.field` integers, and the tests check the two agree. `field_ptx.cuh`, the field's
PTX, is not kept in csrc/: `build()` writes it from `ops/_ptx.py` into the
build directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("batch_exp_g1.cu", "batch_exp_g2.cu", "batch_exp_g2_windowed.cu", "batch_exp_g1_windowed.cu",
           "batch_exp_glv.cu", "batch_exp_gls.cu", "msm.cu", "decompress.cu", "ntt.cu", "segsum.cu", "fieldops.cu",
           "group_ntt.cu")
HEADERS = ("field.cuh", "constants.cuh", "ladders.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the C entry points: name -> (pointer arguments, int arguments); each also
# takes the stream last and returns cudaGetLastError()
ENTRY_POINTS = {
    "p2_batch_exp_glv_signed": (7, 2),
    "p2_batch_exp_gls_signed": (6, 2),
    "p2_batch_exp_g2_windowed": (6, 1),
    "p2_batch_exp_g1_windowed": (6, 1),
    "p2_batch_exp_glv": (8, 2),
    "p2_batch_exp_gls": (7, 2),
    **{f"p2_bucket_accumulate_{g}": (16, 7) for g in ("g1", "g2")},
    **{f"p2_bucket_reduce_{g}": (7, 5) for g in ("g1", "g2")},
    **{f"p2_combine_windows_{g}": (12, 4) for g in ("g1", "g2")},
    **{f"p2_decompress_{g}": (5, 1) for g in ("g1", "g2")},
    "p2_lane_dft": (9, 14),
    **{f"p2_segment_sums_{g}": (11, 3) for g in ("g1", "g2")},
    "p2_field_ops": (6, 2),
    "p2_batch_exp_bls_g1_windowed": (6, 1),
    "p2_batch_exp_bls_g2_windowed": (6, 1),
    "p2_batch_exp_bls_glv": (8, 2),
    "p2_batch_exp_bls_glv_signed": (7, 2),
    **{f"p2_decompress_bls_{g}": (5, 1) for g in ("g1", "g2")},
    **{f"p2_group_ntt_stage_{g}": (4, 3) for g in ("g1", "g2")},
    **{f"p2_jac_scalar_mul_{g}": (4, 2) for g in ("g1", "g2")},
}

_lock = threading.Lock()
_lib = None


def constants_header() -> str:
    """The text of csrc/constants.cuh, from the refimpl integers (BN254) and
    the port's bls12_381.field (BLS12-381)."""
    from ..bls12_381 import field as bls
    from ..bls12_381 import glv as bls_glv
    from ..refimpl.field import B_G2, Q, R_MOD
    from ..refimpl.gls import G2C1, G2C2
    from ..refimpl.glv import BETA

    r = 1 << 256

    def mont(v: int, p: int = Q) -> int:
        return v * r % p

    def bls_mont(v: int) -> int:
        return (v << 384) % bls.Q

    n1 = (G2C1 * G2C1.conjugate()).c0
    n2 = (G2C2 * G2C2.conjugate()).c0
    c31, c32 = G2C1 * n1, G2C2 * n2
    arrays = [
        ("FQ_P", Q, "the modulus q"),
        ("FQ_ONE", mont(1), "R mod q (Montgomery one)"),
        ("GLV_BETA", mont(BETA), "beta, phi(x, y) = (beta x, y) on G1"),
        ("GLS_C1_C0", mont(G2C1.c0), "C1 = xi^((q-1)/3), psi's x factor"),
        ("GLS_C1_C1", mont(G2C1.c1), ""),
        ("GLS_C2_C0", mont(G2C2.c0), "C2 = xi^((q-1)/2), psi's y factor"),
        ("GLS_C2_C1", mont(G2C2.c1), ""),
        ("GLS_N1", mont(n1), "N1 = C1 conj(C1), in Fq: psi^2's x factor"),
        ("GLS_N2", mont(n2), "N2 = C2 conj(C2), in Fq: psi^2's y factor"),
        ("GLS_C31_C0", mont(c31.c0), "C31 = N1 C1, psi^3's x factor"),
        ("GLS_C31_C1", mont(c31.c1), ""),
        ("GLS_C32_C0", mont(c32.c0), "C32 = N2 C2, psi^3's y factor"),
        ("GLS_C32_C1", mont(c32.c1), ""),
        ("B_G1", mont(3), "b = 3 of G1: y^2 = x^3 + b"),
        ("B_G2_C0", mont(B_G2.c0), "b = 3 / (9 + u) of G2"),
        ("B_G2_C1", mont(B_G2.c1), ""),
        ("FQ_NEG_ONE", mont(Q - 1), "-1"),
        ("FQ_R2", r * r % Q, "R^2 mod q as an integer (to Montgomery form: multiply by it)"),
        ("EXP_SQRT_G1", (Q + 1) // 4, "exponent (q + 1) / 4, an integer: the G1 square root"),
        ("EXP_G2_A1", (Q - 3) // 4, "exponent (q - 3) / 4: a1 of the G2 square root"),
        ("EXP_G2_B", (Q - 1) // 2, "exponent (q - 1) / 2: the G2 square root's (1 + alpha) power"),
        ("FR_P", R_MOD, "the scalar field's modulus r"),
        ("FR_ONE", mont(1, R_MOD), "R mod r (Montgomery one of Fr)"),
        ("FR_HALF", (R_MOD - 1) // 2, "(r - 1) / 2 as an integer: the windowed ladders take k above it as (r - k)(-P)"),
        ("FQ_P2", Q * Q, "q^2 as an integer, 16 limbs: the offset of the Fq2 product's c0 (host path)"),
        ("BLS_FQ_P", bls.Q, "BLS12-381: the modulus q, 12 limbs"),
        ("BLS_FQ_ONE", (1 << 384) % bls.Q, "2^384 mod q (Montgomery one, R = 2^384)"),
        ("BLS_FQ_P2", bls.Q * bls.Q, "q^2 as an integer, 24 limbs: the offset of the Fq2 product's c0 (host path)"),
        ("BLS_FR_P", bls.R_MOD, "the scalar field's modulus r, 8 limbs"),
        ("BLS_FR_HALF", (bls.R_MOD - 1) // 2, "(r - 1) / 2 as an integer: the windowed ladders take k above it as "
                                               "(r - k)(-P)"),
        ("BLS_GLV_BETA", bls_mont(bls_glv.BETA), "beta, phi(x, y) = (beta x, y) on G1 (bls12_381/glv.py)"),
        ("BLS_B_G1", bls_mont(bls.B_G1), "b = 4 of G1"),
        ("BLS_B_G2_C0", bls_mont(bls.B_G2.c0), "b = 4 (1 + u) of G2"),
        ("BLS_B_G2_C1", bls_mont(bls.B_G2.c1), ""),
        ("BLS_FQ_NEG_ONE", bls_mont(bls.Q - 1), "-1"),
        ("BLS_FQ_R2", (1 << 768) % bls.Q, "R^2 mod q as an integer (to Montgomery form: multiply by it)"),
        ("BLS_EXP_SQRT_G1", (bls.Q + 1) // 4, "exponent (q + 1) / 4, an integer: the G1 square root"),
        ("BLS_EXP_G2_A1", (bls.Q - 3) // 4, "exponent (q - 3) / 4: a1 of the G2 square root"),
        ("BLS_EXP_G2_B", (bls.Q - 1) // 2, "exponent (q - 1) / 2: the G2 square root's (1 + alpha) power"),
    ]
    # BLS12-381's Fq values and exponents on 12 words (24 for q^2), whatever
    # their bit length
    widths = {name: 24 if name == "BLS_FQ_P2" else 12 for name, _, _ in arrays
              if name.startswith("BLS_") and not name.startswith("BLS_FR_")}
    lines = [
        "// BN254 constants as 8 little-endian 32-bit limbs (FQ_P2 16), Montgomery form",
        "// (R = 2^256) except FQ_P, FR_P, FR_HALF, FQ_R2, FQ_P2 and the EXP_ exponents; the",
        "// BLS12-381 ones (BLS_) on 12 limbs for Fq and its exponents (24 for q^2), 8 for Fr,",
        "// R = 2^384, with the same exceptions. Written by",
        "// ops/_build.py constants_header() from the refimpl and bls12_381.field / glv integers;",
        "// tests/test_torch_batch_exp.py checks it.",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        f"static constexpr uint32_t FQ_PINV = 0x{(-pow(Q, -1, 1 << 32)) % (1 << 32):08x}u;  // -q^-1 mod 2^32",
        f"static constexpr uint32_t FR_PINV = 0x{(-pow(R_MOD, -1, 1 << 32)) % (1 << 32):08x}u;  // -r^-1 mod 2^32",
        f"static constexpr uint32_t BLS_FQ_PINV = 0x{(-pow(bls.Q, -1, 1 << 32)) % (1 << 32):08x}u;  "
        "// BLS12-381: -q^-1 mod 2^32",
    ]
    for name, v, doc in arrays:
        n = widths.get(name, max(8, -(-v.bit_length() // 32)))
        limbs = ", ".join(f"0x{(v >> (32 * k)) & 0xFFFFFFFF:08x}u" for k in range(n))
        if doc:
            lines.append(f"// {doc}")
        lines.append(f"static __constant__ uint32_t {name}[{n}] = {{{limbs}}};")
    return "\n".join(lines) + "\n"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _source_hash(generated: dict | None = None) -> str:
    """The library's key: csrc/, the generated headers (made anew when not
    given) and the flags."""
    if generated is None:
        generated = generated_headers()
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    for name, text in sorted(generated.items()):
        h.update(name.encode() + b"\0" + text.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def generated_headers() -> dict:
    """The headers that are written at build time, not kept in csrc/:
    name -> text (field_ptx.cuh, the field's PTX, from ops/_ptx.py)."""
    from . import _ptx

    return {"field_ptx.cuh": _ptx.field_ptx_header()}


def write_headers(directory: str, generated: dict) -> None:
    """Write the generated headers into `directory` (the include path that
    nvcc gets beside csrc/), each file atomically."""
    os.makedirs(directory, exist_ok=True)
    for name, text in generated.items():
        path = os.path.join(directory, name)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)


def build() -> str:
    """Compile csrc/ into build/kernels/libp2kernels_<hash>.so (once per
    source hash): one nvcc per source, all started together, then one link.
    The generated headers go into build/kernels/include_<hash>/, on nvcc's
    include path. Returns the library path. The compiler's -Xptxas -v report
    (registers, spills) is kept beside it as ptxas_<hash>.log."""
    generated = generated_headers()
    tag = _source_hash(generated)
    out = os.path.join(BUILD_DIR, f"libp2kernels_{tag}.so")
    if os.path.exists(out):
        return out
    include = os.path.join(BUILD_DIR, f"include_{tag}")
    write_headers(include, generated)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [os.path.join(BUILD_DIR, f"{s}.{tag}.{pid}.o") for s in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, f"-I{include}", "-c", "-o", o, os.path.join(CSRC, s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    with open(os.path.join(BUILD_DIR, f"ptxas_{tag}.log"), "w") as f:
        f.write("".join(logs))
    for s, p, log in zip(SOURCES, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{log[-4000:]}")
    tmp = f"{out}.{pid}.tmp"
    res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
    for o in objs:
        os.remove(o)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for name, (nptr, nint) in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = [vp] * nptr + [ci] * nint + [vp]
                fn.restype = ci
            _lib = lib
        return _lib


def on_card(wrapper: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (take
    the plain version); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{wrapper}: no kernel for device {t.device}")
    return True


def check(wrapper: str, name: str, t: torch.Tensor, shape: tuple, device: torch.device,
          dtype: torch.dtype = torch.int64) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on
    `device`, 16-byte aligned where it has rows (2-D or more): the kernels
    move a row's int64 digits two at a time and its packed words four."""
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device or not t.is_contiguous()
            or (t.dim() >= 2 and t.data_ptr() % 16)):
        raise ValueError(f"{wrapper}: {name}: want contiguous {dtype} {tuple(shape)} on {device}, rows 16-byte "
                         f"aligned, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device} at {t.data_ptr():#x}")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry` with args (tensors pass their data
    pointers) on the device's current stream; raise on a launch error."""
    lib = load()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
