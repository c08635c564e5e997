"""Build and load the CUDA kernels of `csrc/` (Hopper, sm_90a).

The sources are compiled at first use with `nvcc` into one shared library
with a plain C interface, loaded through ctypes. The library is keyed by a
hash of the sources and kept under `build/kernels/` at the repository root
(listed in .gitignore), so a fresh checkout builds everything on its first
kernel call. Nothing here runs at import time.

`csrc/constants.cuh` holds the field constants as 32-bit limbs; it is the
output of `constants_header()`, which derives them from the `refimpl`
integers, and the tests check the two agree.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("batch_exp_g1.cu", "batch_exp_g2.cu")
HEADERS = ("field.cuh", "constants.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def constants_header() -> str:
    """The text of csrc/constants.cuh, from the refimpl integers."""
    from phase2_bn254_tpu.refimpl.field import Q
    from phase2_bn254_tpu.refimpl.glv import BETA
    from phase2_bn254_tpu.refimpl.gls import G2C1, G2C2

    r = 1 << 256

    def mont(v: int) -> int:
        return v * r % Q

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
    ]
    lines = [
        "// BN254 constants as 8 little-endian 32-bit limbs, Montgomery form",
        "// (R = 2^256) except FQ_P. Written by ops/_build.py constants_header()",
        "// from the refimpl integers; tests/test_torch_batch_exp.py checks it.",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        f"static constexpr uint32_t FQ_PINV = 0x{(-pow(Q, -1, 1 << 32)) % (1 << 32):08x}u;  // -q^-1 mod 2^32",
    ]
    for name, v, doc in arrays:
        limbs = ", ".join(f"0x{(v >> (32 * k)) & 0xFFFFFFFF:08x}u" for k in range(8))
        if doc:
            lines.append(f"// {doc}")
        lines.append(f"static __constant__ uint32_t {name}[8] = {{{limbs}}};")
    return "\n".join(lines) + "\n"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/ into build/kernels/libp2kernels_<hash>.so (once per
    source hash); returns the library path. The compiler's -Xptxas -v report
    (registers, spills) is kept beside it as ptxas_<hash>.log."""
    tag = _source_hash()
    out = os.path.join(BUILD_DIR, f"libp2kernels_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[os.path.join(CSRC, s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, f"ptxas_{tag}.log"), "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.p2_batch_exp_glv_signed.argtypes = [vp] * 7 + [ci, ci, vp]
            lib.p2_batch_exp_glv_signed.restype = ci
            lib.p2_batch_exp_gls_signed.argtypes = [vp] * 6 + [ci, ci, vp]
            lib.p2_batch_exp_gls_signed.restype = ci
            _lib = lib
        return _lib
