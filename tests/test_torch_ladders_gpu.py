"""The ceremony's ladder configurations on a card (`gpu`; they skip without
one): K7, K8 and K10 against their plain versions on the same CUDA tensors
(K7 also on terms like `new`'s, mostly 1 and r - 1),
a size-10 / batch-256 response under each configuration equal to the
default's, and scripts/fixtures' `new` under PHASE2_TPU_NO_SIGNED5 equal to
the default's. Through the plain ladders on one thread of an Intel Xeon a
size-10 contribution took 152 s and that `new` 224 s, too slow for the CPU
tier, so they run where the kernels do.

The file imports nothing of JAX (tests/test_torch_ladders.py, which does,
takes its constants from here), so it also runs on a machine with a card and
without JAX, where tests/conftest.py cannot load:

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_ladders_gpu.py

Tolerance: exact equality of every limb and byte.
"""

import os
import random

import numpy as np
import pytest
import torch

from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.cli import phase1, phase2
from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
from phase2_bn254_tpu_torch.ops import batch_exp, gls, glv
from phase2_bn254_tpu_torch.phase2.circom import CircomCircuit
from phase2_bn254_tpu_torch.refimpl import curve as rc
from phase2_bn254_tpu_torch.refimpl.field import R_MOD
from phase2_bn254_tpu_torch.refimpl.glv import LAMBDA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = bytes(range(64))
# r // 2 rounds half way in the Babai step: the device splits (JAX and port)
# and the host recodes pick different, equally valid digits there
TIE = R_MOD // 2
EDGE = [1, 2, R_MOD - 1, TIE, LAMBDA, R_MOD - LAMBDA, (1 << 128) - 1, 1 << 253, (1 << 252) + 1, 0]
VARIABLES = ("PHASE2_TPU_NO_GLV", "PHASE2_TPU_NO_GLS", "PHASE2_TPU_NO_SIGNED5")
CONFIGS = {
    "no_signed5": {"PHASE2_TPU_NO_SIGNED5": "1"},
    "no_glv_no_gls": {"PHASE2_TPU_NO_GLV": "1", "PHASE2_TPU_NO_GLS": "1"},
}
WRAPPERS = ("batch_exp_glv_signed", "batch_exp_gls_signed", "batch_exp_glv", "batch_exp_g1_windowed",
            "batch_exp_gls", "batch_exp_g2_windowed")
# the ladders each configuration's contribution must take
USES = {"no_signed5": {"batch_exp_glv", "batch_exp_gls"},
        "no_glv_no_gls": {"batch_exp_g1_windowed", "batch_exp_g2_windowed"}}
LADDERS = {  # name -> (group, wrapper, the split its inputs take)
    "k7": ("g1", batch_exp.batch_exp_glv, glv.decompose),
    "k8": ("g1", batch_exp.batch_exp_g1_windowed, lambda k: (k,)),
    "k10": ("g2", batch_exp.batch_exp_gls, gls.decompose),
}

pytestmark = [pytest.mark.gpu, pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")]


def _scalars(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % R_MOD for row in words]


def ladder_inputs(name: str, device) -> tuple:
    """One ladder's case on `device`: (points, scalars (EDGE and two random),
    affine points, the ladder's inputs)."""
    group, _, split = LADDERS[name]
    rng = random.Random(f"ladder {name}")
    vals = EDGE + _scalars(6, 2)
    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    pts = [gen.mul(rng.randrange(1, R_MOD)) for _ in vals]
    return pts, vals, convert.points_to_affine(pts, group, device), split(convert.ints_to_limbs(vals, device))


def set_config(monkeypatch, config: str) -> None:
    """The ladder variables of `config` set, the others unset ("default":
    none set)."""
    for v in VARIABLES:
        monkeypatch.delenv(v, raising=False)
    for v, value in CONFIGS.get(config, {}).items():
        monkeypatch.setenv(v, value)


def new_terms_inputs(device, n: int = 4096) -> tuple:
    """K7 on terms like `new`'s G1 QAP terms: n scalars, 45% 1, 45% r - 1
    and 10% uniform, shuffled, on 32 random points tiled (affine points, the
    split). Lanes of one warp then start at different windows, and most
    build no table."""
    rng = random.Random("new terms")
    vals = [1 if u < 0.45 else R_MOD - 1 if u < 0.9 else rng.randrange(R_MOD)
            for u in (rng.random() for _ in range(n))]
    pts = [rc.G1_GEN.mul(rng.randrange(1, R_MOD)) for _ in range(32)]
    aff = convert.points_to_affine([pts[i % 32] for i in range(n)], "g1", device)
    return aff, glv.decompose(convert.ints_to_limbs(vals, device))


@pytest.mark.parametrize("name", sorted(LADDERS) + ["k7_new_terms"])
def test_kernel_matches_plain_on_gpu(name):
    if name == "k7_new_terms":
        aff, inputs = new_terms_inputs("cuda")
        name = "k7"
    else:
        _, _, aff, inputs = ladder_inputs(name, "cuda")
    wrapper = LADDERS[name][1]
    plain = getattr(batch_exp, wrapper.__name__ + "_plain")
    before = batch_exp.LAUNCHES[wrapper.__name__]
    got = wrapper(aff.x, aff.y, *inputs)
    assert batch_exp.LAUNCHES[wrapper.__name__] == before + 1
    want = plain(aff.x, aff.y, *inputs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_size10_response_under_each_configuration_on_gpu(tmp_path, monkeypatch):
    challenge = str(tmp_path / "challenge")
    phase1.new_constrained(challenge, 10, 256)
    out = {}
    for config in ("default", *CONFIGS):
        set_config(monkeypatch, config)
        before = dict(batch_exp.LAUNCHES)
        response = str(tmp_path / f"response_{config}")
        phase1.compute_constrained(challenge, response, 10, 256, ChaChaRng.from_digest_be(SEED), "cuda")
        if config in USES:
            assert {w for w in WRAPPERS if batch_exp.LAUNCHES[w] > before[w]} == USES[config]
        with open(response, "rb") as f:
            out[config] = f.read()
    assert out["no_signed5"] == out["default"] == out["no_glv_no_gls"]


def test_fixture_new_under_no_signed5_on_gpu(tmp_path, monkeypatch):
    """scripts/fixtures' circuit (507 constraints): `new` under
    PHASE2_TPU_NO_SIGNED5 gives the default's bytes, on radix files of
    random points (32 distinct per vector, tiled)."""
    circuit = os.path.join(REPO, "scripts", "fixtures", "circuit.json")
    c = CircomCircuit.from_json_file(circuit)
    exp = (c.num_constraints + c.num_inputs - 1).bit_length()
    m, rng = 1 << exp, random.Random(3)

    def vector(gen, count, distinct=32):
        pts = [gen.mul(rng.randrange(1, R_MOD)) for _ in range(distinct)]
        return b"".join(rc.point_to_bytes(pts[i % distinct], False) for i in range(count))

    with open(tmp_path / f"phase1radix2m{exp}", "wb") as f:
        f.write(vector(rc.G1_GEN, 2, 2) + vector(rc.G2_GEN, 1, 1))
        for gen, count in ((rc.G1_GEN, m), (rc.G2_GEN, m), (rc.G1_GEN, m), (rc.G1_GEN, m), (rc.G1_GEN, m - 1)):
            f.write(vector(gen, count))
    out = {}
    for config in ("default", "no_signed5"):
        set_config(monkeypatch, config)
        before = dict(batch_exp.LAUNCHES)
        phase2.new(circuit, str(tmp_path / f"{config}.params"), str(tmp_path), "cuda")
        launched = {w for w in WRAPPERS if batch_exp.LAUNCHES[w] > before[w]}
        assert launched == {"batch_exp_glv" if config == "no_signed5" else "batch_exp_glv_signed",
                            "batch_exp_g2_windowed"}
        with open(tmp_path / f"{config}.params", "rb") as f:
            out[config] = f.read()
    assert out["no_signed5"] == out["default"]
