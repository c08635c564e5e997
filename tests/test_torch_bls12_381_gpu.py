"""The BLS12-381 engine's kernels on a card (`gpu`; they skip without one):
K8-BLS and K9-BLS against their plain versions on the same CUDA tensors,
limb for limb, on the edge scalars of the recoding; the slice (zcash bytes
-> decode -> ladder -> normalize -> encode) on the card against the port's
host layer. The CPU half is tests/test_torch_bls12_381.py.

The file imports nothing of JAX, so it runs on a machine with a card and
without JAX, where tests/conftest.py cannot load:

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_bls12_381_gpu.py

Tolerance: exact equality of every limb and byte.
"""

import random

import pytest
import torch

from phase2_bn254_tpu_torch.bls12_381 import codecs_device as C
from phase2_bn254_tpu_torch.bls12_381 import curve as hc
from phase2_bn254_tpu_torch.bls12_381 import device as D
from phase2_bn254_tpu_torch.bls12_381.field import R_MOD as R
from phase2_bn254_tpu_torch.ops import batch_exp

SCALARS = [0, 1, 2, (R - 1) // 2, (R + 1) // 2, R - 1, 16 ** 40, 16 ** 63 + 15]
KERNELS = {"g1": "batch_exp_bls_g1_windowed", "g2": "batch_exp_bls_g2_windowed"}
GENS = {"g1": hc.G1_GEN, "g2": hc.G2_GEN}

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _case(group: str, n: int):
    rng = random.Random(f"bls gpu {group}")
    pts = [GENS[group].mul(rng.randrange(1, R)) for _ in range(16)]
    vals = SCALARS + [rng.randrange(R) for _ in range(n - len(SCALARS))]
    batch = D.points_to_batch([pts[i % len(pts)] for i in range(n)], group, "cuda")
    return batch, D.scalars_to_canon(vals, "cuda"), vals


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bls_kernel_matches_plain_on_gpu(card, group):
    batch, k, _ = _case(group, 256)
    name = KERNELS[group]
    before = batch_exp.LAUNCHES[name]
    got = getattr(batch_exp, name)(batch.x, batch.y, k)
    assert batch_exp.LAUNCHES[name] == before + 1
    want = getattr(batch_exp, name + "_plain")(batch.x, batch.y, k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bls_slice_matches_host_on_gpu(card, group):
    """Compressed bytes of 32 points through decode_batch, the kernel,
    normalize and encode_batch on the card, against the host chain."""
    rng = random.Random(f"bls slice gpu {group}")
    pts = [GENS[group].mul(rng.randrange(1, R)) for _ in range(32)]
    vals = [rng.randrange(1, R) for _ in pts]
    enc = hc.g1_to_compressed if group == "g1" else hc.g2_to_compressed
    raw = b"".join(enc(p) for p in pts)
    batch = C.decode_batch(raw, group, len(pts), True, device="cuda")
    out = C.encode_batch(D.mul_batch(batch, D.scalars_to_canon(vals, "cuda"), group), group, True)
    assert out == b"".join(enc(p.mul(k)) for p, k in zip(pts, vals))
