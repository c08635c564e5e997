"""The port's contribute slice end to end, on the CPU (plain versions).

`phase1.contribute(..., backend=TorchBackend("cpu"))` at size 4, batch 16
with the fixed ChaCha seed must give the golden response
(tests/fixtures/golden_response_s4_b16.bin, as tests/test_golden_ceremony.py
pins for the exact backend), in this process and, through the port's own
entry points (`cli.phase1.new_constrained` / `compute_constrained`), in
fresh processes: one where `jax` cannot be imported, and one where it can
but the port must leave it unloaded. Tolerance: byte-identical files.
"""

import os
import subprocess
import sys

import pytest
import torch

from phase2_bn254_tpu.cli.phase1 import contribute, new_challenge
from phase2_bn254_tpu.crypto.chacha import ChaChaRng
from phase2_bn254_tpu_torch.cli import phase1 as torch_phase1
from phase2_bn254_tpu_torch.ops.backend import TorchBackend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden_response_s4_b16.bin")

_CONTRIBUTE = r"""
import sys
challenge, response, block_jax = sys.argv[1], sys.argv[2], sys.argv[3] == "block"
if block_jax:
    sys.modules["jax"] = None  # any import of jax now raises ImportError
from phase2_bn254_tpu_torch.cli.phase1 import compute_constrained, new_constrained
from phase2_bn254_tpu.crypto.chacha import ChaChaRng
new_constrained(challenge, 4, 16)
compute_constrained(challenge, response, 4, 16, ChaChaRng.from_digest_be(bytes(range(64))), device="cpu")
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m] is not None]
assert not loaded, loaded
"""


def _contribute_in_subprocess(tmp_path, block_jax: bool) -> None:
    challenge, response = str(tmp_path / "challenge"), str(tmp_path / "response")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PHASE2_TPU_NO_CACHE", None)  # set by tests/conftest.py; the port must not need it
    res = subprocess.run(
        [sys.executable, "-c", _CONTRIBUTE, challenge, response, "block" if block_jax else "installed"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    with open(response, "rb") as got, open(GOLDEN, "rb") as want:
        assert got.read() == want.read()


def test_golden_response_cpu(tmp_path):
    challenge, response = str(tmp_path / "challenge"), str(tmp_path / "response")
    new_challenge(challenge, 4, 16)
    contribute(challenge, response, 4, 16, ChaChaRng.from_digest_be(bytes(range(64))), backend=TorchBackend("cpu"))
    with open(response, "rb") as got, open(GOLDEN, "rb") as want:
        assert got.read() == want.read()


def test_golden_response_without_jax(tmp_path):
    """The port and the protocol it reuses run where JAX is not installed."""
    _contribute_in_subprocess(tmp_path, block_jax=True)


def test_port_leaves_jax_unloaded(tmp_path):
    """Where JAX is installed, importing the port and contributing loads no
    jax: the JAX package's __init__ imports jax for its compile cache, and the
    port imports that package with the cache switched off."""
    _contribute_in_subprocess(tmp_path, block_jax=False)


@pytest.mark.gpu
def test_golden_response_on_a_card_that_is_not_current(tmp_path):
    """pow_mul's copy of the product total to the host, and the event that
    encode waits on, run on the backend's card while another card is the
    current device."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    challenge, response = str(tmp_path / "challenge"), str(tmp_path / "response")
    new_challenge(challenge, 4, 16)
    with torch.cuda.device(0):
        contribute(challenge, response, 4, 16, ChaChaRng.from_digest_be(bytes(range(64))),
                   backend=TorchBackend("cuda:1"))
    with open(response, "rb") as got, open(GOLDEN, "rb") as want:
        assert got.read() == want.read()


def test_cuda_device_never_falls_back(tmp_path):
    """The CLI's default device is cuda; without a GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_phase1.main_compute([str(tmp_path / "c"), str(tmp_path / "r"), "4", "16", "--entropy", "x"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TorchBackend("cpu").power_pairs(None)
