"""The port's Groth16 prover path on the CPU (plain versions of K3-K6) against
the JAX package's.

* the port's generator (`generate_parameters_bytes`, K1 / K2 plain) gives
  the JAX generator's `Parameters.write()` bytes on the same toxic waste
  (XORDemo, bellman's tests/mod.rs);
* the port's `create_proof` and the JAX `create_proof(backend=None)`, with
  the same r and s and the same parameters, give equal `Proof.write()` bytes:
  XORDemo through a `Parameters` (host Points), MiMC (bellman tests/mimc.rs,
  3 rounds) through a `ParametersSource`; the proof
  verifies and a wrong public input is rejected;
* the bases the prover takes from a `ParametersSource` equal those from the
  `Parameters` read from the same bytes;
* `prove` through the port's CLI, in a subprocess where neither jax nor the
  JAX package can be imported, on an unfiltered .params built as the JAX
  CLI's `new` builds one (ExactBackend radix files, as
  tests/test_golden_phase2.py, with should_filter_points_at_infinity=False):
  with the same ChaCha seed for r and s, proof.json and public.json equal
  the JAX package's `filter_params` + `create_random_proof`;
* `MPCParameters.read(...).write()` gives back the bytes of the JAX
  package's .params files, and of the port's own `new` (equal to the JAX
  package's); the phase-2 ceremony itself is tests/test_torch_phase2.py's.

Tolerance: exact (bytes, JSON text, points).
"""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

from phase2_bn254_tpu.ceremony.prepare import prepare_phase2
from phase2_bn254_tpu.cli.phase1 import contribute as p1_contribute
from phase2_bn254_tpu.cli.phase1 import new_challenge, participant_rng
from phase2_bn254_tpu.crypto.chacha import ChaChaRng
from phase2_bn254_tpu.groth16 import cs as jcs
from phase2_bn254_tpu.groth16 import generator as jgenerator
from phase2_bn254_tpu.groth16 import prover as jprover
from phase2_bn254_tpu.groth16.containers import Parameters as JParameters
from phase2_bn254_tpu.phase2 import circom as jcircom
from phase2_bn254_tpu.phase2.mpc import MPCParameters as JMPCParameters
from phase2_bn254_tpu.refimpl import curve as jrc
from phase2_bn254_tpu.refimpl.backend import ExactBackend
from phase2_bn254_tpu_torch.groth16 import cs, generator, prover
from phase2_bn254_tpu_torch.groth16.containers import Parameters
from phase2_bn254_tpu_torch.groth16.source import ParametersSource
from phase2_bn254_tpu_torch.groth16.verifier import prepare_verifying_key, verify_proof
from phase2_bn254_tpu_torch.ops.backend import TorchBackend
from phase2_bn254_tpu_torch.phase2.circom import CircomCircuit
from phase2_bn254_tpu_torch.phase2.mpc import MPCParameters
from phase2_bn254_tpu_torch.refimpl import curve as rc
from phase2_bn254_tpu_torch.refimpl.field import R_MOD

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, S = 0x1234567890ABCDEF, 0xFEDCBA0987654321  # the blinding of every compared proof
TOXIC = (48577, 22580, 53332, 5481, 3673)  # alpha, beta, gamma, delta, tau of XORDemo (bellman tests)


def _xordemo(m):
    """bellman/src/groth16/tests/mod.rs XORDemo, c = a XOR b, over the
    constraint-system module `m` (the JAX package's or the port's)."""
    one, lc = m.Variable("input", 0), m.LinearCombination

    class XORDemo:
        def __init__(self, a=None, b=None):
            self.a, self.b = a, b

        def synthesize(self, cs_):
            a_var = cs_.alloc(None, (lambda: int(self.a)) if self.a is not None else None)
            cs_.enforce(None, lc() + (1, one) - a_var, lc() + a_var, lc())
            b_var = cs_.alloc(None, (lambda: int(self.b)) if self.b is not None else None)
            cs_.enforce(None, lc() + (1, one) - b_var, lc() + b_var, lc())
            c_val = None if self.a is None else int(self.a) ^ int(self.b)
            c_var = cs_.alloc_input(None, (lambda: c_val) if c_val is not None else None)
            cs_.enforce(None, lc() + a_var + a_var, lc() + b_var, lc() + a_var + b_var - c_var)

    return XORDemo


def _mimc(m, rounds=3):
    """bellman/tests/mimc.rs, as tests/test_groth16_generator.py has it, with
    `rounds` rounds: two constraints a round and two input constraints, so
    3 rounds fill a domain of 2^3, XORDemo's (the JAX prover's compiles are
    shared)."""
    one, lc = m.Variable("input", 0), m.LinearCombination

    class MiMC:
        def __init__(self, constants, xl=None, xr=None):
            self.constants, self.xl, self.xr = constants, xl, xr

        def image(self):
            xl, xr = self.xl, self.xr
            for c in self.constants:
                xl, xr = (xr + pow((xl + c) % R_MOD, 3, R_MOD)) % R_MOD, xl
            return xl

        def synthesize(self, cs_):
            xl_val, xr_val = self.xl, self.xr
            xl = cs_.alloc(None, (lambda: xl_val) if xl_val is not None else None)
            xr = cs_.alloc(None, (lambda: xr_val) if xr_val is not None else None)
            for i, c in enumerate(self.constants):
                t_val = None if xl_val is None else (xl_val + c) % R_MOD
                tmp_val = None if t_val is None else t_val * t_val % R_MOD
                tmp = cs_.alloc(None, (lambda v=tmp_val: v) if tmp_val is not None else None)
                cs_.enforce(None, lc() + xl + (c, one), lc() + xl + (c, one), lc() + tmp)
                new_val = None if tmp_val is None else (xr_val + tmp_val * t_val) % R_MOD
                alloc = cs_.alloc_input if i == rounds - 1 else cs_.alloc
                new_xl = alloc(None, (lambda v=new_val: v) if new_val is not None else None)
                cs_.enforce(None, lc() + tmp, lc() + xl + (c, one), lc() + new_xl - xr)
                xl_val, xr_val = new_val, xl_val
                xl, xr = new_xl, xl

    return MiMC


@pytest.fixture(scope="module")
def xordemo_params():
    """(JAX generator bytes, port generator bytes) of XORDemo."""
    want = jgenerator.generate_parameters(_xordemo(jcs)(), jrc.G1_GEN, jrc.G2_GEN, *TOXIC).write()
    got = generator.generate_parameters_bytes(_xordemo(cs)(), rc.G1_GEN, rc.G2_GEN, *TOXIC, "cpu")
    return want, got


@pytest.fixture(scope="module")
def mimc_params():
    constants = [random.Random(5).randrange(R_MOD) for _ in range(3)]
    params = jgenerator.generate_random_parameters(_mimc(jcs)(constants), ChaChaRng.from_digest_be(bytes(range(32))))
    return constants, params.write()


def test_generator_matches_jax(xordemo_params):
    want, got = xordemo_params
    assert got == want
    params = Parameters.read(got)
    assert len(params.h) == 7 and len(params.l) == 2 and len(params.vk.ic) == 2


def _check_proof(proof, vk, publics):
    pvk = prepare_verifying_key(vk)
    assert verify_proof(pvk, proof, publics)
    assert not verify_proof(pvk, proof, [(publics[0] + 1) % R_MOD] + publics[1:])


def test_xordemo_proof_matches_jax(xordemo_params):
    data, _ = xordemo_params
    want = jprover.create_proof(jprover.prepare_prover(_xordemo(jcs)(True, False)), JParameters.read(data), R, S,
                                backend=None)
    params = Parameters.read(data)
    proof = prover.create_proof(prover.prepare_prover(_xordemo(cs)(True, False)), params, R, S, TorchBackend("cpu"))
    assert proof.write() == want.write()
    _check_proof(proof, params.vk, [1])


def test_mimc_proof_from_source_matches_jax(mimc_params):
    constants, data = mimc_params
    rng = random.Random(6)
    xl, xr = rng.randrange(R_MOD), rng.randrange(R_MOD)
    want = jprover.create_proof(jprover.prepare_prover(_mimc(jcs)(constants, xl, xr)), JParameters.read(data), R, S,
                                backend=None)
    src = ParametersSource(data)
    circuit = _mimc(cs)(constants, xl, xr)
    proof = prover.create_proof(prover.prepare_prover(circuit), src, R, S, TorchBackend("cpu"))
    assert proof.write() == want.write()
    _check_proof(proof, src.vk, [circuit.image()])


def test_source_bases_equal_list_bases(mimc_params):
    _, data = mimc_params
    params = Parameters.read(data)
    from_list = prover._Bases(params, TorchBackend("cpu"))
    from_source = prover._Bases(ParametersSource(data), TorchBackend("cpu"))
    for name in ("h", "l", "a", "b_g1", "b_g2"):
        n = len(getattr(params, name))
        got, want = from_source.prefix(name, n), from_list.prefix(name, n)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
    with pytest.raises(ValueError, match="not enough bases"):
        from_source.prefix("h", len(params.h) + 1)


# a circuit for the size-3 ceremony (domain 2^3, as XORDemo's and MiMC's):
# w3 * w4 = w5, w5 * w2 = w1 (w1 the output, w2 a public input); its
# unfiltered .params holds points at infinity in a (w4) and b_g1
CIRCUIT_JSON = {"constraints": [[{"3": "1"}, {"4": "1"}, {"5": "1"}], [{"5": "1"}, {"2": "1"}, {"1": "1"}]],
                "nPubInputs": 1, "nOutputs": 1, "nVars": 6}
WITNESS = ["1", "30", "5", "2", "3", "6"]
SEED = bytes(range(100, 164))

_PROVE = r"""
import sys
sys.modules["jax"] = None  # any import of either now raises ImportError
sys.modules["phase2_bn254_tpu"] = None
from phase2_bn254_tpu_torch.__main__ import main
from phase2_bn254_tpu_torch.cli import phase2
from phase2_bn254_tpu_torch.crypto.chacha import ChaChaRng
seed = bytes.fromhex(sys.argv[1])
phase2.participant_rng = lambda *a: ChaChaRng.from_digest_be(seed)  # r, s of the compared proof
assert main(["prove", *sys.argv[2:], "--device", "cpu"]) == 0
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "phase2_bn254_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
"""


@pytest.fixture(scope="module")
def unfiltered_params(tmp_path_factory):
    """circuit.json, witness.json and an unfiltered .params, as the JAX CLI's
    `new` writes it, from a size-3 phase-1 ceremony on the exact backend."""
    d = tmp_path_factory.mktemp("size3")
    new_challenge(str(d / "c1"), 3, 4)
    p1_contribute(str(d / "c1"), str(d / "r1"), 3, 4, participant_rng("unfiltered", system_entropy=bytes(1024)),
                  backend=ExactBackend())
    prepare_phase2(str(d / "r1"), 3, 4, ExactBackend(), out_dir=str(d))
    circuit = jcircom.CircomCircuit.from_json(CIRCUIT_JSON)
    mp = JMPCParameters.new(circuit, False, lambda exp: str(d / f"phase1radix2m{exp}"))
    (d / "circom.params").write_bytes(mp.write())
    (d / "circuit.json").write_text(json.dumps(CIRCUIT_JSON))
    (d / "witness.json").write_text(json.dumps(WITNESS))
    return d


def test_mpc_params_round_trip(unfiltered_params):
    cpu = TorchBackend("cpu")
    for path in (unfiltered_params / "circom.params", os.path.join(REPO, "tests", "fixtures", "golden_params_s3.bin")):
        with open(path, "rb") as f:
            data = f.read()
        assert MPCParameters.read(data, backend=cpu).write() == data
    params = MPCParameters.read((unfiltered_params / "circom.params").read_bytes(), backend=cpu).params
    assert bool(params.a.inf.any()) and bool(params.b_g1.inf.any())
    # the port's own new: its bytes read back and written again unchanged
    d = unfiltered_params
    ours = MPCParameters.new(CircomCircuit.from_json(CIRCUIT_JSON), False, lambda exp: str(d / f"phase1radix2m{exp}"), cpu)
    data = ours.write()
    assert data == (d / "circom.params").read_bytes()
    back = MPCParameters.read(data, backend=cpu)
    assert back == ours and back.write() == data


def test_prove_cli_without_jax_matches_jax(unfiltered_params):
    d = unfiltered_params
    files = [str(d / n) for n in ("circuit.json", "witness.json", "circom.params", "proof.json", "public.json")]
    # one torch thread: the subprocess may share the cores with other workers
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("PHASE2_TPU_NO_CACHE", None)  # set by tests/conftest.py; the port must not need it
    res = subprocess.run([sys.executable, "-c", _PROVE, SEED.hex(), *files], cwd=str(d), env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]

    with open(d / "circom.params", "rb") as f:
        params = jcircom.filter_params(JMPCParameters.read(f.read(), disallow_points_at_infinity=False).params)
    circuit = jcircom.CircomCircuit.from_json(CIRCUIT_JSON).with_witness(jcircom.witness_from_json(WITNESS))
    want = jprover.create_random_proof(circuit, params, ChaChaRng.from_digest_be(SEED), backend=None)
    assert (d / "proof.json").read_text() == jcircom.proof_to_json(want)
    assert json.loads((d / "public.json").read_text()) == ["30", "5"]


def test_cuda_device_never_falls_back(unfiltered_params):
    """The prove tool's default device is cuda; without a GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from phase2_bn254_tpu_torch.cli import phase2

    d = unfiltered_params
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        phase2.main_prove([str(d / n) for n in ("circuit.json", "witness.json", "circom.params", "p", "q")])
