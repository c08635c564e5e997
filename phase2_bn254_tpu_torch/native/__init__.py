"""Native (C++) host codec: file bytes <-> 16-bit limb digit planes.

The reference implementation's host runtime is entirely native Rust; here
the codec is C++ compiled with g++ at first use from `codec.cpp` into
`build/native/` at the repository root (listed in .gitignore), and loaded
via ctypes. The port's codecs (`curve/codecs.py`) need it: they raise when
it is unavailable (`PHASE2_TPU_NO_NATIVE=1` forces that).

The port's own copy of `phase2_bn254_tpu/native/__init__.py`, building into
the port's own directory instead of `~/.cache/phase2_bn254_tpu`; file:line
citations of `.rs` files are to the upstream Rust repository.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _cache_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> str | None:
    src = os.path.join(_HERE, "codec.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"libp2codec_{tag}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    for extra in (["-march=native", "-fopenmp"], ["-fopenmp"], []):
        try:
            subprocess.run(
                base[:-2] + extra + base[-2:],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, out)
            return out
        except (OSError, subprocess.SubprocessError):
            continue
    return None


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("PHASE2_TPU_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.p2_decode_digits.restype = ctypes.c_int
        lib.p2_decode_digits.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, u8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u32p, u8p, u8p, i64p,
        ]
        lib.p2_encode_digits.restype = None
        lib.p2_encode_digits.argtypes = [
            u32p, ctypes.c_int64, ctypes.c_int, i32p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, u8p, u8p,
        ]
        lib.p2_be_to_digits.restype = None
        lib.p2_be_to_digits.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, u32p]
        lib.p2_digits_to_be.restype = None
        lib.p2_digits_to_be.argtypes = [u32p, ctypes.c_int64, ctypes.c_int, u8p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


_DECODE_ERRORS = {
    1: "point at infinity in stream",
    2: "compression flag set on uncompressed point",
    3: "coordinate not below field modulus",
}


def decode_digits(
    raw: bytes | np.ndarray,
    n: int,
    ncoords: int,
    nw: int,
    qbytes: bytes,
    *,
    check_lt_q: bool = True,
    reject_inf: bool = True,
    reject_greatest: bool = False,
):
    """Raw element bytes -> (digits (n, ncoords, nw) uint32 in FILE coordinate
    order, greatest (n,) bool, inf (n,) bool-or-None).  Raises ValueError with
    the reference's rejection semantics.  Returns None if the native library
    is unavailable (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    assert buf.size == n * ncoords * 2 * nw
    q = np.frombuffer(qbytes, dtype=np.uint8)
    assert q.size == 2 * nw
    digits = np.empty((n, ncoords, nw), dtype=np.uint32)
    greatest = np.empty(n, dtype=np.uint8)
    inf = None if reject_inf else np.empty(n, dtype=np.uint8)
    bad = ctypes.c_int64(-1)
    ret = lib.p2_decode_digits(
        _u8(np.ascontiguousarray(buf)), n, ncoords, nw, _u8(np.ascontiguousarray(q)),
        int(check_lt_q), int(reject_inf), int(reject_greatest),
        _u32(digits), _u8(greatest),
        _u8(inf) if inf is not None else ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(bad),
    )
    if ret:
        raise ValueError(f"{_DECODE_ERRORS[ret]} (element {bad.value})")
    return digits, greatest.astype(bool), (None if inf is None else inf.astype(bool))


def encode_digits(
    packed: np.ndarray,
    coord_cols: list[int],
    nw: int,
    *,
    greatest_col: int = -1,
    inf_mask: np.ndarray | None = None,
):
    """Packed uint32 rows -> element bytes; None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, stride = packed.shape
    cols = np.asarray(coord_cols, dtype=np.int32)
    out = np.empty((n, len(coord_cols) * 2 * nw), dtype=np.uint8)
    im = None
    if inf_mask is not None:
        im = np.ascontiguousarray(inf_mask, dtype=np.uint8)
    lib.p2_encode_digits(
        _u32(packed), n, stride,
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(coord_cols), nw,
        greatest_col,
        _u8(im) if im is not None else ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8)),
        _u8(out),
    )
    return out


def be_bytes_to_digits(arr: np.ndarray, nw: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    n = arr.shape[0]
    out = np.empty((n, nw), dtype=np.uint32)
    lib.p2_be_to_digits(_u8(arr), n, nw, _u32(out))
    return out


def digits_to_be_bytes(d: np.ndarray, nw: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    d = np.ascontiguousarray(d, dtype=np.uint32)
    n = d.shape[0]
    out = np.empty((n, 2 * nw), dtype=np.uint8)
    lib.p2_digits_to_be(_u32(d), n, nw, _u8(out))
    return out
