"""The port's contribute slice end to end, on the CPU (plain versions).

`phase1.contribute(..., backend=TorchBackend("cpu"))` at size 4, batch 16
with the fixed ChaCha seed must give the golden response
(tests/fixtures/golden_response_s4_b16.bin, as tests/test_golden_ceremony.py
pins for the exact backend), in this process and, through the port's own
entry points (`cli.phase1.new_constrained` / `compute_constrained`, then
`verify_transform_constrained`), in fresh processes: one where neither `jax`
nor `phase2_bn254_tpu` can be imported, and one where both can but the port
must leave them unloaded (both processes also import the port's BLS12-381
engine). Tolerance: byte-identical files.
"""

import hashlib
import os
import subprocess
import sys

import pytest
import torch

from phase2_bn254_tpu.cli.phase1 import contribute, new_challenge
from phase2_bn254_tpu.crypto.chacha import ChaChaRng
from phase2_bn254_tpu_torch.cli import phase1 as torch_phase1
from phase2_bn254_tpu_torch.ops.backend import TorchBackend

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden_response_s4_b16.bin")
# Blake2b of the new challenge that verifying the golden response writes, as
# the JAX package's verify_transform with its ExactBackend writes it
# (tests/test_torch_verify.py compares the bytes)
GOLDEN_NEXT_BLAKE2B = (
    "c1affaeb7b3124b5efa445d1ca8dbabc3b2e3f30e9789c87f57db955ca514892"
    "b35f675c1829236417db6bc7340a8dab27f3c3899906881d1ffe6fe1b6866c78"
)

_CONTRIBUTE = r"""
import sys
challenge, response, block = sys.argv[1], sys.argv[2], sys.argv[3] == "block"
if block:
    sys.modules["jax"] = None  # any import of either now raises ImportError
    sys.modules["phase2_bn254_tpu"] = None
from phase2_bn254_tpu_torch.cli.phase1 import compute_constrained, new_constrained, verify_transform_constrained
from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
new_constrained(challenge, 4, 16)
compute_constrained(challenge, response, 4, 16, ChaChaRng.from_digest_be(bytes(range(64))), device="cpu")
if block:
    verify_transform_constrained(challenge, response, challenge + ".next", 4, 16, device="cpu")
from phase2_bn254_tpu_torch.bls12_381 import codecs_device, device  # the BLS12-381 engine too
assert device.FQ_OPS.ctx.nlimbs == 24
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "phase2_bn254_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
"""


def _contribute_in_subprocess(tmp_path, block: bool) -> None:
    challenge, response = str(tmp_path / "challenge"), str(tmp_path / "response")
    # one torch thread: the subprocess may share the cores with other workers
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("PHASE2_TPU_NO_CACHE", None)  # set by tests/conftest.py; the port must not need it
    res = subprocess.run(
        [sys.executable, "-c", _CONTRIBUTE, challenge, response, "block" if block else "installed"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    with open(response, "rb") as got, open(GOLDEN, "rb") as want:
        assert got.read() == want.read()
    if block:
        with open(challenge + ".next", "rb") as got:
            assert hashlib.blake2b(got.read()).hexdigest() == GOLDEN_NEXT_BLAKE2B


def test_golden_response_cpu(tmp_path):
    challenge, response = str(tmp_path / "challenge"), str(tmp_path / "response")
    new_challenge(challenge, 4, 16)
    contribute(challenge, response, 4, 16, ChaChaRng.from_digest_be(bytes(range(64))), backend=TorchBackend("cpu"))
    with open(response, "rb") as got, open(GOLDEN, "rb") as want:
        assert got.read() == want.read()


def test_golden_response_without_jax(tmp_path):
    """The port, with its own copy of the protocol, contributes and verifies
    where neither JAX nor the JAX package can be imported."""
    _contribute_in_subprocess(tmp_path, block=True)


def test_port_leaves_jax_unloaded(tmp_path):
    """Where JAX and the JAX package are installed, importing the port and
    contributing loads neither."""
    _contribute_in_subprocess(tmp_path, block=False)


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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_phase1.main_verify([str(tmp_path / "c"), str(tmp_path / "r"), str(tmp_path / "n"), "4", "16"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_phase1.main_prepare_phase2([str(tmp_path / "r"), "4", "16"])
