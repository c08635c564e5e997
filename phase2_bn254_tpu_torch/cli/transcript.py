"""Full ceremony-transcript verifier (counterpart of
`phase2_bn254_tpu/cli/transcript.py`, powersoftau/examples/verify.rs:260-460
in the upstream Rust repository).

Replays a whole phase-1 ceremony (the initial challenge, then response_1 ..
response_n): the Blake2b hash chain and every transformation
(`ceremony.accumulator.verify_transformation`: D1 and the power-pair MSMs
K3-K5 on the backend's device), the running challenge rebuilt by
decompressing each verified response (`accumulator.decompress`). The point
math runs on `TorchBackend(device)`; `--device` defaults to `cuda`, which
raises without a GPU.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from ..ceremony import accumulator
from ..ceremony.keypair import PublicKey
from ..ceremony.params import HASH_SIZE, CeremonyParams
from ..crypto.hashing import calculate_hash, pretty_hash
from ..ops.backend import TorchBackend


def verify_transcript(challenge_path: str, response_paths: list[str], size: int, batch: int,
                      backend=None) -> list[bytes]:
    """Returns the per-round response hashes. Raises ValueError on the
    first failure, naming its round. backend: by default
    `TorchBackend("cuda")`."""
    backend = backend or TorchBackend("cuda")
    params = CeremonyParams(size, batch)

    current_challenge = challenge_path
    cleanup = []
    hashes = []
    try:
        for round_no, response in enumerate(response_paths, 1):
            challenge_hash = calculate_hash(current_challenge)
            with open(response, "rb") as f:
                claimed = f.read(HASH_SIZE)
            if claimed != challenge_hash:
                raise ValueError(f"round {round_no}: hash chain failure")
            with open(response, "rb") as f:
                f.seek(params.pubkey_position(output_is_compressed=True))
                pubkey = PublicKey.deserialize(f.read(params.public_key_size))
            with open(current_challenge, "rb") as fin, open(response, "rb") as fout:
                ok = accumulator.verify_transformation(
                    fin, fout, pubkey, challenge_hash, params, backend,
                    input_compressed=False, output_compressed=True,
                    check_input=False, check_output=True,
                )
            if not ok:
                raise ValueError(f"round {round_no}: invalid transformation")
            response_hash = calculate_hash(response)
            hashes.append(response_hash)
            # decompress into the next running challenge
            nxt = tempfile.NamedTemporaryFile(delete=False)
            nxt.close()
            cleanup.append(nxt.name)
            with open(response, "rb") as fin, open(nxt.name, "wb") as fnew:
                fnew.truncate(params.accumulator_size)
                fnew.seek(0)
                fnew.write(response_hash)
                accumulator.decompress(fin, fnew, params, backend, check_input=False)
            current_challenge = nxt.name
            print(f"round {round_no} verified; response hash:")
            print(pretty_hash(response_hash))
    finally:
        for f in cleanup:
            try:
                os.unlink(f)
            except OSError:
                pass
    return hashes


def main_verify_transcript(argv=None):
    ap = argparse.ArgumentParser(prog="verify_transcript")
    ap.add_argument("challenge_file")
    ap.add_argument("responses", nargs="+")
    ap.add_argument("--size", type=int, required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; never falls back to the CPU)")
    a = ap.parse_args(argv)
    verify_transcript(a.challenge_file, a.responses, a.size, a.batch, TorchBackend(a.device))
    print("Transcript OK")
