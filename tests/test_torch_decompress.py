"""Point decompression D1 (ops/decompress.py, csrc/decompress.cu) on the CPU.

* `codecs.decode_batch(compressed=True)` (the plain D1 on CPU tensors)
  against `refimpl.point_from_bytes` on compressed G1 and G2 bytes of
  points and of their negations (both "greatest" flags), and against the
  JAX package's `codecs.decode_batch` on the same bytes (canonical limbs);
* an x whose x^3 + b has no square root: `decode_batch` raises, and the
  plain D1's valid mask is false exactly there;
* the kernel's per-point code (csrc/decompress.cu), compiled for the host
  with g++, against the plain D1, valid and invalid x alike (the kernel
  itself runs only on a GPU: the `gpu` test).

Tolerance: exact (points, limbs, masks, bytes).
"""

import ctypes
import os
import random
import subprocess

import numpy as np
import pytest
import torch

from phase2_bn254_tpu.curve import codecs as jcodecs
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.curve import codecs
from phase2_bn254_tpu_torch.field import fp
from phase2_bn254_tpu_torch.ops import _build
from phase2_bn254_tpu_torch.ops import decompress as D
from phase2_bn254_tpu_torch.refimpl import curve as rc
from phase2_bn254_tpu_torch.refimpl.field import B_G2, Fq2, Q, R_MOD, legendre

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GEN = {"g1": rc.G1_GEN, "g2": rc.G2_GEN}


def _points(group, n, seed):
    """n // 2 random points and their negations: both flags occur."""
    rng = random.Random(seed)
    pts = [GEN[group].mul(rng.randrange(1, R_MOD)) for _ in range(n // 2)]
    return pts + [p.neg() for p in pts]


def _nonresidue_xs(group, k, seed):
    rng = random.Random(seed)
    out = []
    while len(out) < k:
        if group == "g1":
            x = rng.randrange(Q)
            if legendre((x * x * x + 3) % Q, Q) == -1:
                out.append(x)
        else:
            x = Fq2(rng.randrange(Q), rng.randrange(Q))
            if legendre((x * x * x + B_G2).norm(), Q) == -1:
                out.append(x)
    return out


def _compressed_x(group, x) -> bytes:
    """File bytes of a compressed x with clear flags (G2: c1 || c0)."""
    return x.to_bytes(32, "big") if group == "g1" else x.c1.to_bytes(32, "big") + x.c0.to_bytes(32, "big")


def _x_digits(group, xs):
    if group == "g1":
        return convert.ints_to_limbs(xs, "cpu")
    return torch.stack([convert.ints_to_limbs([x.c0 for x in xs], "cpu"),
                        convert.ints_to_limbs([x.c1 for x in xs], "cpu")], dim=1).contiguous()


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_decode_compressed_matches_refimpl_and_jax(group):
    pts = _points(group, 12, 3)
    raw = b"".join(rc.point_to_bytes(p, True) for p in pts)
    batch = codecs.decode_batch(raw, group, len(pts), True, False, "cpu")
    assert convert.affine_to_points(batch, group) == [rc.point_from_bytes(rc.point_to_bytes(p, True), group, True)
                                                      for p in pts] == pts
    jbatch = jcodecs.decode_batch(raw, group, len(pts), True, False)
    for ours, theirs in ((batch.x, jbatch.x), (batch.y, jbatch.y)):
        want = torch.from_numpy(np.asarray(theirs).astype(np.int64))
        assert torch.equal(fp.from_mont(fp.FQ_CTX, ours), fp.from_mont(fp.FQ_CTX, want))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_nonresidue_raises(group):
    good = _points(group, 2, 5)[0]
    bad = _nonresidue_xs(group, 1, 6)[0]
    raw = rc.point_to_bytes(good, True) + _compressed_x(group, bad)
    with pytest.raises(ValueError, match="non-QR"):
        codecs.decode_batch(raw, group, 2, True, False, "cpu")
    xs = [good.x, bad]
    _, valid = D.decompress_plain(_x_digits(group, xs), torch.tensor([False, True]), group)
    assert valid.tolist() == [True, False]


_HOST_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "decompress.cu"
extern "C" void host_decompress(int g2, const int64_t* x, const bool* greatest, int64_t* ox, int64_t* oy,
                                bool* valid, int n) {
  for (int64_t i = 0; i < n; ++i) {
    if (g2) decompress_g2_point(x, greatest, ox, oy, valid, i);
    else decompress_g1_point(x, greatest, ox, oy, valid, i);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("decompress_shim")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(d / "shim.so")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(d / "shim.so"))


def _inputs(group, seed):
    """Points of both flags, then x values without a root; random flags."""
    xs = [p.x for p in _points(group, 6, seed)] + _nonresidue_xs(group, 3, seed + 1)
    rng = random.Random(seed + 2)
    return _x_digits(group, xs), torch.tensor([rng.random() < 0.5 for _ in xs])


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_cuda_source_on_host_matches_plain(group, host_lib):
    """csrc/decompress.cu's per-point functions compiled by g++ (CUDA
    qualifiers defined away), run on the CPU: limbs and mask."""
    x, greatest = _inputs(group, 21)
    want, want_valid = D.decompress_plain(x, greatest, group)
    ox, oy, valid = torch.empty_like(x), torch.empty_like(x), torch.empty_like(greatest)
    host_lib.host_decompress(int(group == "g2"), *(ctypes.c_void_p(t.data_ptr()) for t in (x, greatest, ox, oy, valid)),
                             x.shape[0])
    assert torch.equal(ox, want.x) and torch.equal(oy, want.y) and torch.equal(valid, want_valid)
    assert valid.tolist() == [True] * 6 + [False] * 3


def test_wrapper_takes_no_other_device():
    x = torch.zeros((2, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        D.decompress(x, torch.zeros(2, dtype=torch.bool, device="meta"), "g1")


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_kernel_matches_plain_on_gpu(group):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, greatest = _inputs(group, 31)
    want, want_valid = D.decompress_plain(x, greatest, group)
    before = D.LAUNCHES["decompress"]
    got, valid = D.decompress(x.cuda(), greatest.cuda(), group)
    assert D.LAUNCHES["decompress"] == before + 1
    assert torch.equal(got.x.cpu(), want.x) and torch.equal(got.y.cpu(), want.y)
    assert torch.equal(valid.cpu(), want_valid)
