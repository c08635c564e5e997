"""Circom circuit import and snarkjs-format JSON / Solidity exporters.

Mirrors phase2/src/circom_circuit.rs and the decimal-string
JSON helpers of phase2/src/utils.rs:124-185. The circuit.json schema is the
circom 0.0.35 output: {"constraints": [[{var: coeff}, ...] x3, ...],
"nPubInputs": n, "nOutputs": n, "nVars": n}.

The port's own copy of `phase2_bn254_tpu/phase2/circom.py` (code unchanged);
file:line citations of `.rs` files are to the upstream Rust repository.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from ..groth16.containers import Parameters, Proof
from ..groth16.cs import LinearCombination, Variable
from ..refimpl import curve as rc
from ..refimpl.field import R_MOD
from ..refimpl.pairing import ate_pairing, fq12_to_tower_coeffs


@dataclass
class CircomCircuit:
    num_inputs: int  # includes the "one" variable
    num_aux: int
    num_constraints: int
    constraints: list[tuple[list[tuple[int, int]], list[tuple[int, int]], list[tuple[int, int]]]]
    witness: Optional[list[int]] = None

    # -- loading ------------------------------------------------------------
    @classmethod
    def from_json(cls, data: dict) -> "CircomCircuit":
        """circom_circuit.rs:332-365."""
        num_inputs = data["nPubInputs"] + data["nOutputs"] + 1
        num_vars = data["nVars"]
        num_aux = num_vars - num_inputs
        constraints = []
        for c in data["constraints"]:
            row = []
            for lc in c[:3]:
                row.append([(int(k), int(v) % R_MOD) for k, v in lc.items()])
            constraints.append(tuple(row))
        return cls(
            num_inputs=num_inputs,
            num_aux=num_aux,
            num_constraints=len(constraints),
            constraints=constraints,
        )

    @classmethod
    def from_json_file(cls, path: str) -> "CircomCircuit":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def with_witness(self, witness: list[int]) -> "CircomCircuit":
        return CircomCircuit(
            self.num_inputs, self.num_aux, self.num_constraints, self.constraints, witness
        )

    def get_public_inputs(self) -> Optional[list[int]]:
        if self.witness is None:
            return None
        return self.witness[1 : self.num_inputs]

    # -- synthesis (circom_circuit.rs:135-182) ------------------------------
    def synthesize(self, cs):
        w = self.witness
        for i in range(1, self.num_inputs):
            cs.alloc_input(None, (lambda i=i: w[i] if w is not None else 1))
        for i in range(self.num_aux):
            cs.alloc(None, (lambda i=i: w[i + self.num_inputs] if w is not None else 1))

        def make_var(index):
            if index < self.num_inputs:
                return Variable("input", index)
            return Variable("aux", index - self.num_inputs)

        def make_lc(terms):
            lc = LinearCombination()
            for index, coeff in terms:
                lc = lc + (coeff, make_var(index))
            return lc

        for a, b, c in self.constraints:
            cs.enforce(None, make_lc(a), make_lc(b), make_lc(c))


def witness_from_json(data) -> list[int]:
    return [int(x) % R_MOD for x in data]


def witness_from_json_file(path: str) -> list[int]:
    with open(path) as f:
        return witness_from_json(json.load(f))


# ---------------------------------------------------------------------------
# snarkjs JSON exporters (decimal strings)
# ---------------------------------------------------------------------------

def p1_to_vec(p: rc.Point) -> list[str]:
    return [str(p.x), str(p.y), "0" if p.is_zero() else "1"]


def p2_to_vec(p: rc.Point) -> list[list[str]]:
    return [
        [str(p.x.c0), str(p.x.c1)],
        [str(p.y.c0), str(p.y.c1)],
        ["0", "0"] if p.is_zero() else ["1", "0"],
    ]


def pairing_to_vec(coeffs: list[int]) -> list[list[list[str]]]:
    """12 canonical ints in tower order -> nested decimal-string array."""
    c = [str(v) for v in coeffs]
    return [
        [[c[0], c[1]], [c[2], c[3]], [c[4], c[5]]],
        [[c[6], c[7]], [c[8], c[9]], [c[10], c[11]]],
    ]


def proof_to_json(proof: Proof) -> str:
    return json.dumps(
        {
            "pi_a": p1_to_vec(proof.a),
            "pi_b": p2_to_vec(proof.b),
            "pi_c": p1_to_vec(proof.c),
            "protocol": "groth",
        }
    )


def proving_key_json(params: Parameters) -> str:
    obj = {
        "a": [p1_to_vec(e) for e in params.a],
        "b1": [p1_to_vec(e) for e in params.b_g1],
        "b2": [p2_to_vec(e) for e in params.b_g2],
        "c": [None] * len(params.vk.ic) + [p1_to_vec(e) for e in params.l],
        "vk_alfa_1": p1_to_vec(params.vk.alpha_g1),
        "vk_beta_1": p1_to_vec(params.vk.beta_g1),
        "vk_delta_1": p1_to_vec(params.vk.delta_g1),
        "vk_beta_2": p2_to_vec(params.vk.beta_g2),
        "vk_delta_2": p2_to_vec(params.vk.delta_g2),
        "h": [p1_to_vec(e) for e in params.h],
    }
    return json.dumps(obj)


def verification_key_json(params: Parameters) -> str:
    ab = ate_pairing(params.vk.alpha_g1, params.vk.beta_g2)
    obj = {
        "ic": [p1_to_vec(e) for e in params.vk.ic],
        "vk_alfa_1": p1_to_vec(params.vk.alpha_g1),
        "vk_beta_2": p2_to_vec(params.vk.beta_g2),
        "vk_gamma_2": p2_to_vec(params.vk.gamma_g2),
        "vk_delta_2": p2_to_vec(params.vk.delta_g2),
        "vk_alfabeta_12": pairing_to_vec(fq12_to_tower_coeffs(ab)),
        "inputs_count": len(params.vk.ic) - 1,
        "protocol": "groth",
    }
    return json.dumps(obj)


def filter_params(params: Parameters) -> Parameters:
    """circom_circuit.rs filter_params: drop points at infinity from
    ic/h/a/b_g1/b_g2 (NOT l)."""
    params.vk.ic = [x for x in params.vk.ic if not x.is_zero()]
    params.h = [x for x in params.h if not x.is_zero()]
    params.a = [x for x in params.a if not x.is_zero()]
    params.b_g1 = [x for x in params.b_g1 if not x.is_zero()]
    params.b_g2 = [x for x in params.b_g2 if not x.is_zero()]
    return params


# ---------------------------------------------------------------------------
# snarkjs-semantics verifier (the `npx snarkjs verify` step of
# phase2/test.sh:44, reimplemented so the external
# cross-check runs without npm: consumes ONLY the exported JSON files,
# including the serialized vk_alfabeta_12, never the in-memory Parameters)
# ---------------------------------------------------------------------------

def _p1_from_vec(v) -> rc.Point:
    if v[2] == "0":
        return rc.point_zero("g1")
    assert v[2] == "1", "non-normalized projective G1 in JSON"
    p = rc.Point(int(v[0]), int(v[1]), False, "g1")
    if not p.is_on_curve():
        raise ValueError("G1 point not on curve")
    return p


def _p2_from_vec(v) -> rc.Point:
    from ..refimpl.field import Fq2

    if v[2] == ["0", "0"]:
        return rc.point_zero("g2")
    assert v[2] == ["1", "0"], "non-normalized projective G2 in JSON"
    p = rc.Point(
        Fq2(int(v[0][0]), int(v[0][1])),
        Fq2(int(v[1][0]), int(v[1][1])),
        False,
        "g2",
    )
    if not p.is_on_curve():
        raise ValueError("G2 point not on curve")
    return p


def _fq12_from_vec(v):
    """Inverse of pairing_to_vec: nested decimal strings -> w-basis Fq12."""
    from ..refimpl.field import FQ2_ZERO, Fq2

    flat = [
        (int(v[i][j][0]), int(v[i][j][1])) for i in range(2) for j in range(3)
    ]
    # tower order c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2 -> w powers
    # 0, 2, 4, 1, 3, 5 (fq12_to_tower_coeffs inverse)
    out = [FQ2_ZERO] * 6
    for k, w_index in enumerate([0, 2, 4, 1, 3, 5]):
        out[w_index] = Fq2(*flat[k])
    return tuple(out)


def snarkjs_verify(vk_json: str, proof_json: str, public_json: str) -> bool:
    """Groth16 verification exactly as snarkjs' legacy `groth` protocol:
    e(pi_a, pi_b) == vk_alfabeta_12 * e(IC(publics), vk_gamma_2)
                     * e(pi_c, vk_delta_2),
    with vk_alfabeta_12 taken from the serialized key (this cross-checks
    the Fq12 tower serialization, not just the points)."""
    from ..refimpl.pairing import FQ12_ONE, fq12_mul, pairing

    vk = json.loads(vk_json)
    proof = json.loads(proof_json)
    publics = [int(x) for x in json.loads(public_json)]

    if vk.get("protocol", "groth") != "groth" or proof.get("protocol") != "groth":
        return False
    if len(publics) != vk["inputs_count"]:
        return False

    ic = [_p1_from_vec(v) for v in vk["ic"]]
    gamma_2 = _p2_from_vec(vk["vk_gamma_2"])
    delta_2 = _p2_from_vec(vk["vk_delta_2"])
    alfabeta_12 = _fq12_from_vec(vk["vk_alfabeta_12"])
    pi_a = _p1_from_vec(proof["pi_a"])
    pi_b = _p2_from_vec(proof["pi_b"])
    pi_c = _p1_from_vec(proof["pi_c"])

    cpub = ic[0]
    for value, base in zip(publics, ic[1:]):
        cpub = cpub.add(base.mul(value % R_MOD))

    lhs = pairing(pi_a, pi_b)
    rhs = fq12_mul(
        fq12_mul(alfabeta_12, pairing(cpub, gamma_2)), pairing(pi_c, delta_2)
    )
    return lhs == rhs
