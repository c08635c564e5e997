"""Phase-1 ceremony tools of the port (counterpart of
`phase2_bn254_tpu/cli/phase1.py`, whose protocol functions `:72-82`,
`:116-126` and `:153-271` this module carries, without the JAX package's
multihost, sharded and default-backend code, and its `prepare_phase2` and
`reduce_powers` entry points `:333-365`, on `ceremony/prepare.py`).

The ceremony "API" is files on disk: challenge/response with a 64-byte
Blake2b hash-chain header (the reference's powersoftau binaries). The point
math runs on `TorchBackend(device)` with the ladders that the JAX
package's PHASE2_TPU_NO_GLV / NO_GLS / NO_SIGNED5 variables select
(`ops.backend.Ladders.from_env`); the argv entry points take the JAX CLI's
arguments plus `--device` (default `cuda`, which raises without a GPU:
nothing falls back to the CPU).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

from ..ceremony import accumulator, prepare
from ..ceremony.keypair import PublicKey, keypair
from ..ceremony.params import HASH_SIZE, CeremonyParams
from ..crypto.chacha import ChaChaRng
from ..crypto.hashing import calculate_hash, pretty_hash
from ..ops.backend import TorchBackend, check_device


def participant_rng(entropy: str, system_entropy: bytes | None = None) -> ChaChaRng:
    """compute_constrained.rs:41-80: Blake2b(1024 OsRng bytes || user text),
    first 32 digest bytes as 8 BE u32 seed words."""
    if system_entropy is None:
        system_entropy = os.urandom(1024)
    assert len(system_entropy) == 1024
    h = hashlib.blake2b()
    h.update(system_entropy)
    h.update(entropy.encode())
    return ChaChaRng.from_digest_be(h.digest())


def beacon_rng(beacon_hash_hex: str, iterations_exp: int, progress: bool = True) -> ChaChaRng:
    """beacon_constrained.rs:51-97: 2^n iterated SHA-256 over the beacon."""
    cur = bytes.fromhex(beacon_hash_hex)
    assert len(cur) == 32
    n = iterations_exp
    for i in range(1 << n):
        if progress and n >= 10 and i % (1 << (n - 10)) == 0:
            print(f"{i}: {cur.hex()}")
        cur = hashlib.sha256(cur).digest()
    print(f"Final result of beacon: {cur.hex()}")
    return ChaChaRng.from_digest_be(cur)


def new_challenge(challenge_path: str, size: int, batch: int) -> bytes:
    """new_constrained.rs:14-103; returns the Blake2b hash of the file."""
    params = CeremonyParams(size, batch)
    with open(challenge_path, "wb") as f:
        f.truncate(params.accumulator_size)
        f.seek(0)
        f.write(hashlib.blake2b(b"").digest())
        accumulator.generate_initial(f, params, compressed=False)
    return calculate_hash(challenge_path)


def contribute(challenge_path: str, response_path: str, size: int, batch: int, rng: ChaChaRng,
               backend=None) -> bytes:
    """compute_constrained.rs:18-237: uncompressed challenge in, compressed
    response (accumulator + public key) out, the point math on `backend`
    (default `TorchBackend("cuda")`). Returns the response hash."""
    params = CeremonyParams(size, batch)
    backend = backend or TorchBackend("cuda")
    if os.path.getsize(challenge_path) != params.accumulator_size:
        raise ValueError("challenge file has wrong size")

    challenge_hash = calculate_hash(challenge_path)
    print("`challenge` file contains decompressed points and has a hash:")
    print(pretty_hash(challenge_hash))

    pubkey, privkey = keypair(rng, challenge_hash)

    with open(challenge_path, "rb") as fin, open(response_path, "wb") as fout:
        fout.truncate(params.contribution_size)
        fout.seek(0)
        fout.write(challenge_hash)
        accumulator.transform(fin, fout, params, privkey, backend, input_compressed=False, output_compressed=True,
                              check_input=False)
        fout.seek(params.pubkey_position(output_is_compressed=True))
        fout.write(pubkey.serialize())

    response_hash = calculate_hash(response_path)
    print("Your contribution has been written; response hash:")
    print(pretty_hash(response_hash))
    return response_hash


def verify_transform(challenge_path: str, response_path: str, new_challenge_path: str, size: int, batch: int,
                     backend=None) -> bytes:
    """verify_transform_constrained.rs:18-255: check the response against
    its challenge (hash chain, proofs of knowledge, power-pair ratios), then
    write the new challenge, the response uncompressed. The point math runs
    on `backend` (default `TorchBackend("cuda")`). Raises ValueError on an
    invalid contribution; returns the new challenge's hash."""
    params = CeremonyParams(size, batch)
    backend = backend or TorchBackend("cuda")
    if os.path.getsize(challenge_path) != params.accumulator_size:
        raise ValueError("challenge file has wrong size")
    if os.path.getsize(response_path) != params.contribution_size:
        raise ValueError("response file has wrong size")

    challenge_hash = calculate_hash(challenge_path)
    with open(response_path, "rb") as f:
        response_claimed_hash = f.read(HASH_SIZE)
    if response_claimed_hash != challenge_hash:
        raise ValueError("hash chain failure: response is not based on this challenge")

    response_hash = calculate_hash(response_path)

    with open(response_path, "rb") as f:
        f.seek(params.pubkey_position(output_is_compressed=True))
        pubkey = PublicKey.deserialize(f.read(params.public_key_size))

    with open(challenge_path, "rb") as fin, open(response_path, "rb") as fout:
        ok = accumulator.verify_transformation(fin, fout, pubkey, challenge_hash, params, backend,
                                               input_compressed=False, output_compressed=True,
                                               check_input=False, check_output=True)
    if not ok:
        raise ValueError("INVALID CONTRIBUTION")
    print("Verification succeeded! Writing new challenge file...")

    with open(response_path, "rb") as fin, open(new_challenge_path, "wb") as fnew:
        fnew.truncate(params.accumulator_size)
        fnew.seek(0)
        fnew.write(response_hash)
        accumulator.decompress(fin, fnew, params, backend, check_input=False)

    new_hash = calculate_hash(new_challenge_path)
    print("New challenge hash:")
    print(pretty_hash(new_hash))
    return new_hash


# ---------------------------------------------------------------------------
# the tools, by function and by argv
# ---------------------------------------------------------------------------

def new_constrained(challenge_file: str, circuit_power: int, batch_size: int) -> bytes:
    """Write the empty challenge (host work only); returns its hash."""
    return new_challenge(challenge_file, circuit_power, batch_size)


def compute_constrained(challenge_file: str, response_file: str, circuit_power: int, batch_size: int, rng,
                        device="cuda") -> bytes:
    """One contribution with the participant's ChaCha `rng`, its point math
    on `device`; returns the response hash."""
    return contribute(challenge_file, response_file, circuit_power, batch_size, rng, TorchBackend(device))


def beacon_constrained(challenge_file: str, response_file: str, circuit_power: int, batch_size: int,
                       beacon_hash: str, num_iterations_exp: int, device="cuda") -> bytes:
    """A contribution whose randomness is the beacon's; returns the
    response hash."""
    backend = TorchBackend(device)  # before the beacon's iterations
    rng = beacon_rng(beacon_hash, num_iterations_exp)
    return contribute(challenge_file, response_file, circuit_power, batch_size, rng, backend)


def verify_transform_constrained(challenge_file: str, response_file: str, new_challenge_file: str,
                                 circuit_power: int, batch_size: int, device="cuda") -> bytes:
    """Verify a response and write the next challenge, the point math on
    `device`; returns the new challenge's hash."""
    return verify_transform(challenge_file, response_file, new_challenge_file, circuit_power, batch_size,
                            TorchBackend(device))


def _parser(prog: str, *files: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog)
    for name in files:
        ap.add_argument(name)
    ap.add_argument("circuit_power", type=int)
    ap.add_argument("batch_size", type=int)
    return ap


def _device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; never falls back to the CPU)")


def main_new(argv=None):
    ap = _parser("new_constrained", "challenge_file")
    _device_arg(ap)  # the empty challenge is host work; checked for a uniform interface
    a = ap.parse_args(argv)
    check_device(a.device)
    h = new_constrained(a.challenge_file, a.circuit_power, a.batch_size)
    print("Empty contribution is formed with a hash:")
    print(pretty_hash(h))


def main_compute(argv=None):
    ap = _parser("compute_constrained", "challenge_file", "response_file")
    ap.add_argument("--entropy", default=None, help="skip the interactive prompt")
    _device_arg(ap)
    a = ap.parse_args(argv)
    check_device(a.device)  # before the entropy prompt
    entropy = a.entropy
    if entropy is None:
        print("Type some random text and press [ENTER] to provide additional entropy...")
        entropy = sys.stdin.readline()
    compute_constrained(a.challenge_file, a.response_file, a.circuit_power, a.batch_size, participant_rng(entropy),
                        a.device)


def main_beacon(argv=None):
    ap = _parser("beacon_constrained", "challenge_file", "response_file")
    ap.add_argument("beacon_hash", help="32-byte hex beacon value")
    ap.add_argument("num_iterations_exp", type=int)
    _device_arg(ap)
    a = ap.parse_args(argv)
    beacon_constrained(a.challenge_file, a.response_file, a.circuit_power, a.batch_size, a.beacon_hash,
                       a.num_iterations_exp, a.device)


def main_verify(argv=None):
    ap = _parser("verify_transform_constrained", "challenge_file", "response_file", "new_challenge_file")
    _device_arg(ap)
    a = ap.parse_args(argv)
    verify_transform_constrained(a.challenge_file, a.response_file, a.new_challenge_file, a.circuit_power,
                                 a.batch_size, a.device)


def main_prepare_phase2(argv=None):
    ap = argparse.ArgumentParser(prog="prepare_phase2")
    ap.add_argument("response_file")
    ap.add_argument("circuit_power", type=int)
    ap.add_argument("batch_size", type=int)
    ap.add_argument("--out-dir", default=".")
    _device_arg(ap)
    a = ap.parse_args(argv)
    prepare.prepare_phase2(a.response_file, a.circuit_power, a.batch_size, TorchBackend(a.device), out_dir=a.out_dir)


def main_reduce_powers(argv=None):
    ap = argparse.ArgumentParser(prog="reduce_powers")
    ap.add_argument("challenge_file")
    ap.add_argument("reduced_challenge_file")
    ap.add_argument("original_circuit_power", type=int)
    ap.add_argument("reduced_circuit_power", type=int)
    ap.add_argument("batch_size", type=int)
    _device_arg(ap)  # byte copying on the host; checked for a uniform interface
    a = ap.parse_args(argv)
    check_device(a.device)
    prepare.reduce_powers(a.challenge_file, a.reduced_challenge_file, a.original_circuit_power,
                          a.reduced_circuit_power, a.batch_size)
