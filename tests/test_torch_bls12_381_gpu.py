"""The BLS12-381 engine's kernels on a card (`gpu`; they skip without one):
K8-BLS and K9-BLS against their plain versions on the same CUDA tensors,
limb for limb, on the edge scalars of the recoding; K7-BLS and K1-BLS
against theirs on the GLV split's edge scalars; D1-BLS against its plain
version (limbs and valid flags, x values without a point among them); the
slice (zcash bytes -> decode -> ladder -> normalize -> encode) on the card
against the port's host layer, through each G1 ladder. The CPU half is
tests/test_torch_bls12_381.py and tests/test_torch_bls12_381_glv.py.

The file imports nothing of JAX, so it runs on a machine with a card and
without JAX, where tests/conftest.py cannot load:

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_bls12_381_gpu.py

Tolerance: exact equality of every limb and byte.
"""

import random

import pytest
import torch

from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.bls12_381 import codecs_device as C
from phase2_bn254_tpu_torch.bls12_381 import curve as hc
from phase2_bn254_tpu_torch.bls12_381 import device as D
from phase2_bn254_tpu_torch.bls12_381 import glv
from phase2_bn254_tpu_torch.bls12_381.field import Fq2, Q
from phase2_bn254_tpu_torch.bls12_381.field import R_MOD as R
from phase2_bn254_tpu_torch.curve import group as G
from phase2_bn254_tpu_torch.ops import batch_exp

SCALARS = [0, 1, 2, (R - 1) // 2, (R + 1) // 2, R - 1, 16 ** 40, 16 ** 63 + 15]
GLV_SCALARS = SCALARS + [glv.LAMBDA, R - glv.LAMBDA, glv._B1, glv._A2, (1 << 128) - 1]
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


@pytest.mark.parametrize("name,split", [("batch_exp_bls_glv", D.decompose_glv_t),
                                        ("batch_exp_bls_glv_signed", D.decompose_glv_signed_t)])
def test_bls_glv_kernel_matches_plain_on_gpu(card, name, split):
    """K7-BLS / K1-BLS on 256 points, the GLV split's edge scalars first,
    limb for limb with the plain version on the same CUDA tensors."""
    rng = random.Random(f"bls glv gpu {name}")
    batch, _, _ = _case("g1", 256)
    k = D.scalars_to_canon(GLV_SCALARS + [rng.randrange(R) for _ in range(256 - len(GLV_SCALARS))], "cuda")
    digits = split(k)
    before = batch_exp.LAUNCHES[name]
    got = getattr(batch_exp, name)(batch.x, batch.y, *digits)
    assert batch_exp.LAUNCHES[name] == before + 1
    want = getattr(batch_exp, name + "_plain")(batch.x, batch.y, *digits)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bls_decompress_matches_plain_on_gpu(card, group):
    """D1-BLS on the x of 64 points and 8 x values without a point: limbs
    and valid flags equal the plain version's on the same CUDA tensors."""
    rng = random.Random(f"bls d1 gpu {group}")
    gen = GENS[group]
    xs = [gen.mul(rng.randrange(1, R)).x for _ in range(64)]
    while len(xs) < 72:
        x = rng.randrange(Q) if group == "g1" else Fq2(rng.randrange(Q), rng.randrange(Q))
        if hc.get_point_from_x(x, False, group) is None:
            xs.append(x)
    if group == "g1":
        dig = convert.ints_to_limbs(xs, "cuda", C.NL)
    else:
        dig = torch.stack([convert.ints_to_limbs([x.c0 for x in xs], "cuda", C.NL),
                           convert.ints_to_limbs([x.c1 for x in xs], "cuda", C.NL)], dim=1).contiguous()
    greatest = torch.tensor([rng.random() < 0.5 for _ in xs], device="cuda")
    before = C.LAUNCHES["decompress_bls"]
    got, valid = C.decompress(dig, greatest, group)
    assert C.LAUNCHES["decompress_bls"] == before + 1
    want, want_valid = C.decompress_plain(dig, greatest, group)
    assert torch.equal(got.x, want.x) and torch.equal(got.y, want.y) and torch.equal(valid, want_valid)
    assert valid.tolist() == [True] * 64 + [False] * 8


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bls_slice_matches_host_on_gpu(card, group):
    """Compressed bytes of 32 points through decode_batch, the kernel,
    normalize and encode_batch on the card, against the host chain."""
    rng = random.Random(f"bls slice gpu {group}")
    pts = [GENS[group].mul(rng.randrange(1, R)) for _ in range(32)]
    vals = [rng.randrange(1, R) for _ in pts]
    enc = hc.g1_to_compressed if group == "g1" else hc.g2_to_compressed
    raw = b"".join(enc(p) for p in pts)
    before = C.LAUNCHES["decompress_bls"]
    batch = C.decode_batch(raw, group, len(pts), True, device="cuda")
    assert C.LAUNCHES["decompress_bls"] == before + 1
    k = D.scalars_to_canon(vals, "cuda")
    want = b"".join(enc(p.mul(v)) for p, v in zip(pts, vals))
    assert C.encode_batch(D.mul_batch(batch, k, group), group, True) == want
    if group == "g1":
        for ladder in (D.glv_ladder, D.glv_signed_ladder):
            assert C.encode_batch(G.jac_normalize(D.FQ_OPS, ladder(batch, k)), group, True) == want
