"""The port's verify slice end to end on the CPU (plain versions of K3, K4,
K5 and D1), on the golden size-4 / batch-16 challenge and response
(tests/fixtures/):

* `verify_transform(..., backend=TorchBackend("cpu"))` passes and writes a
  new challenge byte-identical to the one the JAX package's
  `verify_transform` writes with its `ExactBackend`;
* a response with one byte of a tau_g1 point flipped (the hash header
  intact) is rejected while its chunk is decompressed (`ValueError`, as
  tests/test_ceremony_phase1.py expects of the JAX package);
* a response with one tau_g1 point replaced by another valid point (the
  hash header intact) is rejected by the power-pair ratio check alone.

Tolerance: byte-identical files.
"""

import os
import shutil

import pytest
import torch

from phase2_bn254_tpu.cli.phase1 import verify_transform as jax_verify_transform
from phase2_bn254_tpu.refimpl.backend import ExactBackend as JaxExactBackend
from phase2_bn254_tpu_torch.ceremony.params import HASH_SIZE, CeremonyParams
from phase2_bn254_tpu_torch.cli.phase1 import verify_transform
from phase2_bn254_tpu_torch.crypto.hashing import calculate_hash
from phase2_bn254_tpu_torch.ops.backend import TorchBackend
from phase2_bn254_tpu_torch.refimpl import curve as rc

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CHALLENGE = os.path.join(FIXTURES, "golden_challenge_s4_b16.bin")
RESPONSE = os.path.join(FIXTURES, "golden_response_s4_b16.bin")
SIZE, BATCH = 4, 16
PARAMS = CeremonyParams(SIZE, BATCH)
INDEX = 5  # a tau_g1 point of the first chunk, not one of the heads (0, 1) checked on the host


@pytest.fixture(scope="module")
def verified(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("verify") / "new_challenge")
    digest = verify_transform(CHALLENGE, RESPONSE, out, SIZE, BATCH, backend=TorchBackend("cpu"))
    return out, digest


def test_golden_verify_passes(verified):
    out, digest = verified
    assert digest == calculate_hash(out)
    with open(out, "rb") as f:
        assert f.read(HASH_SIZE) == calculate_hash(RESPONSE)
    assert os.path.getsize(out) == PARAMS.accumulator_size


def test_new_challenge_matches_jax_exact_backend(verified, tmp_path):
    want = str(tmp_path / "new_challenge_exact")
    jax_verify_transform(CHALLENGE, RESPONSE, want, SIZE, BATCH, backend=JaxExactBackend())
    with open(verified[0], "rb") as got, open(want, "rb") as ref:
        assert got.read() == ref.read()


def _tampered(tmp_path, edit) -> str:
    path = str(tmp_path / "response")
    shutil.copyfile(RESPONSE, path)
    pos = PARAMS.position("tau_g1", INDEX, True)
    with open(path, "r+b") as f:
        f.seek(pos)
        raw = f.read(32)
        f.seek(pos)
        f.write(edit(raw))
    return path


def _flip_to_nonresidue(raw: bytes) -> bytes:
    """raw with the first bit flip of its x (below the flag bits) that keeps
    x < q and leaves x^3 + 3 without a square root."""
    for byte in range(31, 0, -1):
        for bit in range(8):
            b = bytearray(raw)
            b[byte] ^= 1 << bit
            x = int.from_bytes(bytes([b[0] & 0x3F]) + bytes(b[1:]), "big")
            if x < rc.Q and rc.get_point_from_x(x, True, "g1") is None:
                return bytes(b)
    raise AssertionError("no flip found")


def test_flipped_byte_rejected_by_decompression(tmp_path):
    response = _tampered(tmp_path, _flip_to_nonresidue)
    with pytest.raises(ValueError, match="non-QR"):
        verify_transform(CHALLENGE, response, str(tmp_path / "out"), SIZE, BATCH, backend=TorchBackend("cpu"))


def test_valid_wrong_point_rejected_by_ratio_check(tmp_path):
    response = _tampered(tmp_path, lambda raw: rc.point_to_bytes(rc.G1_GEN.mul(12345), True))
    with pytest.raises(ValueError, match="INVALID CONTRIBUTION"):
        verify_transform(CHALLENGE, response, str(tmp_path / "out"), SIZE, BATCH, backend=TorchBackend("cpu"))
