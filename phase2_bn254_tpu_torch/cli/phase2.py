"""The port's phase-2 `prove` tool (counterpart of
`phase2_bn254_tpu/cli/phase2.py` `main_prove`, the reference's phase2
`prove` binary).

`prove` reads the circuit and witness (circom JSON) and a .params file,
makes a Groth16 proof on `TorchBackend(device)` with r, s drawn from the
system's randomness, checks it with the verifying key (host pairings) and
writes proof.json and public.json in snarkjs' format. It keeps the JAX
CLI's semantics: the parameters are read as `filter_params` leaves them (no
points at infinity in h, a, b_g1, b_g2; `VerifyingKey.read` rejects one in
ic), here through `ParametersSource` and the device codec, so no host Point
is made per query base.
"""

from __future__ import annotations

import argparse
import json

from ..groth16.containers import Proof
from ..groth16.prover import create_random_proof
from ..groth16.source import ParametersSource
from ..groth16.verifier import prepare_verifying_key, verify_proof
from ..ops.backend import TorchBackend
from ..phase2.circom import CircomCircuit, proof_to_json, witness_from_json_file
from .phase1 import _device_arg, participant_rng


def prove(circuit_json: str, witness_json: str, params_path: str, proof_json: str, public_json: str,
          device="cuda") -> Proof:
    """prove.rs: the proof of the witness, verified, written as JSON."""
    backend = TorchBackend(device)
    circuit = CircomCircuit.from_json_file(circuit_json).with_witness(witness_from_json_file(witness_json))
    with open(params_path, "rb") as f:
        params = ParametersSource(f)
        # create_rng in the reference is OsRng-seeded ChaCha via Blake2b
        rng = participant_rng("", None)
        print("Proving...")
        proof = create_random_proof(circuit, params, rng, backend)
    print("Verifying proof")
    publics = circuit.get_public_inputs()
    if not verify_proof(prepare_verifying_key(params.vk), proof, publics):
        raise ValueError("the proof does not verify")
    with open(proof_json, "w") as f:
        f.write(proof_to_json(proof))
    with open(public_json, "w") as f:
        f.write(json.dumps([str(x) for x in publics]))
    print("Done!")
    return proof


def main_prove(argv=None):
    ap = argparse.ArgumentParser(prog="phase2-prove")
    ap.add_argument("circuit_json")
    ap.add_argument("witness_json")
    ap.add_argument("params")
    ap.add_argument("proof_json")
    ap.add_argument("public_json")
    _device_arg(ap)
    a = ap.parse_args(argv)
    prove(a.circuit_json, a.witness_json, a.params, a.proof_json, a.public_json, a.device)
