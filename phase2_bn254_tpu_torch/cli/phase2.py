"""The port's phase-2 tools (counterpart of `phase2_bn254_tpu/cli/phase2.py`,
the reference's phase2 binaries), with the JAX CLI's positional arguments:

* the ceremony, on `TorchBackend(device)` with the ladders the environment
  selects (`ops.backend.Ladders.from_env`): `new` (the QAP evaluation on the
  device, where the JAX `main_new` runs it on the host: the same bytes),
  `contribute`, `beacon` and `verify_contribution` (`phase2/mpc.py`);
* `prove`: reads the circuit and witness (circom JSON) and a .params file,
  makes a Groth16 proof with r, s drawn from the system's randomness,
  checks it with the verifying key (host pairings) and writes proof.json
  and public.json in snarkjs' format. The parameters are read as
  `filter_params` leaves them (no points at infinity in h, a, b_g1, b_g2;
  `VerifyingKey.read` rejects one in ic), through `ParametersSource` and
  the device codec, so no host Point is made per query base;
* host-only, no kernel: `export_keys`, `generate_verifier`, `copy_json`,
  `snarkjs_verify`.

Every device tool takes `--device` (default cuda, which raises without a
GPU; nothing falls back to the CPU).
"""

from __future__ import annotations

import argparse
import json

from ..groth16.containers import Parameters, Proof
from ..groth16.prover import create_random_proof
from ..groth16.source import ParametersSource
from ..groth16.verifier import prepare_verifying_key, verify_proof
from ..ops.backend import TorchBackend
from ..phase2.circom import (
    CircomCircuit,
    proof_to_json,
    proving_key_json,
    snarkjs_verify,
    verification_key_json,
    witness_from_json_file,
)
from ..phase2.mpc import MPCParameters, contains_contribution, verify_contribution
from ..phase2.solidity import create_verifier_sol_file
from .phase1 import _device_arg, beacon_rng, participant_rng


def _radix_path_for(directory: str):
    return lambda exp: f"{directory}/phase1radix2m{exp}"


def _load_mpc(path: str, backend: TorchBackend) -> MPCParameters:
    with open(path, "rb") as f:
        return MPCParameters.read(f.read(), disallow_points_at_infinity=False, checked=True, backend=backend)


def load_params_file(path: str) -> Parameters:
    """circom_circuit.rs load_params: the bellman Parameters of a .params
    file as host Points (the host-only export tools)."""
    with open(path, "rb") as f:
        return Parameters.read(f)


def new(circuit_json: str, out_params: str, radix_directory: str, device="cuda") -> MPCParameters:
    print(f"Creating initial parameters for {circuit_json}...")
    backend = TorchBackend(device)
    circuit = CircomCircuit.from_json_file(circuit_json)
    params = MPCParameters.new(circuit, False, _radix_path_for(radix_directory), backend)
    with open(out_params, "wb") as f:
        f.write(params.write())
    print(f"Wrote initial parameters to {out_params}.")
    return params


def contribute(in_params: str, out_params: str, rng, device="cuda") -> bytes:
    """One contribution with `rng` (participant_rng or beacon_rng); returns
    its hash."""
    backend = TorchBackend(device)
    params = _load_mpc(in_params, backend)
    print(f"Contributing to {in_params}...")
    h = params.contribute(rng, backend)
    print(f"Contribution hash: 0x{h.hex()}")
    with open(out_params, "wb") as f:
        f.write(params.write())
    print(f"Wrote parameters to {out_params}.")
    return h


def verify(circuit_json: str, old_params: str, new_params: str, radix_directory: str, device="cuda") -> bytes:
    """verify_contribution: the last contribution of new_params against
    old_params, then the whole transcript against the circuit; returns the
    contribution's hash."""
    backend = TorchBackend(device)
    old = _load_mpc(old_params, backend)
    new_ = _load_mpc(new_params, backend)
    print(f"Checking contribution {new_params}...")
    contribution = verify_contribution(old, new_, backend)
    circuit = CircomCircuit.from_json_file(circuit_json)
    result = new_.verify(circuit, False, _radix_path_for(radix_directory), backend)
    if not contains_contribution(result, contribution):
        raise ValueError("the contribution is not in the verified transcript")
    print(f"Contribution {new_params} verified.")
    return contribution


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


def main_new(argv=None):
    ap = argparse.ArgumentParser(prog="phase2-new")
    ap.add_argument("circuit_json")
    ap.add_argument("out_params")
    ap.add_argument("radix_directory")
    _device_arg(ap)
    a = ap.parse_args(argv)
    new(a.circuit_json, a.out_params, a.radix_directory, a.device)


def main_contribute(argv=None):
    ap = argparse.ArgumentParser(prog="phase2-contribute")
    ap.add_argument("in_params")
    ap.add_argument("out_params")
    ap.add_argument("entropy")
    ap.add_argument("-v", "--progress-interval", type=int, default=0)
    _device_arg(ap)
    a = ap.parse_args(argv)
    contribute(a.in_params, a.out_params, participant_rng(a.entropy), a.device)


def main_beacon(argv=None):
    ap = argparse.ArgumentParser(prog="phase2-beacon")
    ap.add_argument("in_params")
    ap.add_argument("beacon_hash")
    ap.add_argument("num_iterations_exp", type=int)
    ap.add_argument("out_params")
    _device_arg(ap)
    a = ap.parse_args(argv)
    if not 10 <= a.num_iterations_exp <= 63:
        raise SystemExit("in_num_iterations_exp should be in [10, 63] range")
    TorchBackend(a.device)  # raises before the 2^n hash iterations if the device is missing
    contribute(a.in_params, a.out_params, beacon_rng(a.beacon_hash, a.num_iterations_exp), a.device)


def main_verify_contribution(argv=None):
    ap = argparse.ArgumentParser(prog="phase2-verify-contribution")
    ap.add_argument("circuit_json")
    ap.add_argument("old_params")
    ap.add_argument("new_params")
    ap.add_argument("radix_directory")
    _device_arg(ap)
    a = ap.parse_args(argv)
    verify(a.circuit_json, a.old_params, a.new_params, a.radix_directory, a.device)


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


def main_export_keys(argv=None):
    ap = argparse.ArgumentParser(prog="phase2-export-keys")
    ap.add_argument("in_params")
    ap.add_argument("out_vk_json")
    ap.add_argument("out_pk_json")
    a = ap.parse_args(argv)
    print(f"Exporting {a.in_params}...")
    params = load_params_file(a.in_params)
    with open(a.out_pk_json, "w") as f:
        f.write(proving_key_json(params))
    with open(a.out_vk_json, "w") as f:
        f.write(verification_key_json(params))
    print(f"Created {a.out_pk_json} and {a.out_vk_json}.")


def main_copy_json(argv=None):
    """Merge key/values of in.json over reference.json (copy_json.rs:7-26)."""
    ap = argparse.ArgumentParser(prog="phase2-copy-json")
    ap.add_argument("reference_json")
    ap.add_argument("in_json")
    ap.add_argument("out_json")
    a = ap.parse_args(argv)
    with open(a.reference_json) as f:
        ref = json.load(f)
    with open(a.in_json) as f:
        src = json.load(f)
    ref.update(src)
    with open(a.out_json, "w") as f:
        f.write(json.dumps(ref))
    print("Done")


def main_generate_verifier(argv=None):
    ap = argparse.ArgumentParser(prog="phase2-generate-verifier")
    ap.add_argument("in_params")
    ap.add_argument("out_sol")
    a = ap.parse_args(argv)
    with open(a.in_params, "rb") as f:
        create_verifier_sol_file(ParametersSource(f), a.out_sol)  # reads the verifying key only
    print(f"Created {a.out_sol}")


def main_snarkjs_verify(argv=None):
    """`npx snarkjs verify --vk vk.json --proof proof.json` analog
    (phase2/test.sh:44) - consumes only the exported JSON files."""
    ap = argparse.ArgumentParser(prog="phase2-snarkjs-verify")
    ap.add_argument("vk_json")
    ap.add_argument("proof_json")
    ap.add_argument("public_json")
    a = ap.parse_args(argv)
    with open(a.vk_json) as f:
        vk = f.read()
    with open(a.proof_json) as f:
        proof = f.read()
    with open(a.public_json) as f:
        public = f.read()
    if snarkjs_verify(vk, proof, public):
        print("OK")
        return 0
    print("INVALID")
    raise SystemExit(1)
