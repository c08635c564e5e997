"""Solidity verifier generation (circom_circuit.rs:202-241 counterpart).

The port's own copy of `phase2_bn254_tpu/phase2/solidity.py` (code
unchanged), with its template `verifier_template.sol`; file:line citations
of `.rs` files are to the upstream Rust repository.
"""

from __future__ import annotations

import os

from ..groth16.containers import Parameters
from ..refimpl import curve as rc

_TEMPLATE_PATH = os.path.join(os.path.dirname(__file__), "verifier_template.sol")


def _p1_to_str(p: rc.Point) -> str:
    return f"uint256({p.x}), uint256({p.y})"


def _p2_to_str(p: rc.Point) -> str:
    return (
        f"[uint256({p.x.c1}), uint256({p.x.c0})], "
        f"[uint256({p.y.c1}), uint256({p.y.c0})]"
    )


def create_verifier_sol(params: Parameters) -> str:
    with open(_TEMPLATE_PATH) as f:
        template = f.read()
    template = template.replace("<%vk_alfa1%>", _p1_to_str(params.vk.alpha_g1))
    template = template.replace("<%vk_beta2%>", _p2_to_str(params.vk.beta_g2))
    template = template.replace("<%vk_gamma2%>", _p2_to_str(params.vk.gamma_g2))
    template = template.replace("<%vk_delta2%>", _p2_to_str(params.vk.delta_g2))
    template = template.replace("<%vk_ic_length%>", str(len(params.vk.ic)))
    template = template.replace("<%vk_input_length%>", str(len(params.vk.ic) - 1))
    vi = ""
    for i, p in enumerate(params.vk.ic):
        prefix = "" if not vi else "        "
        vi += f"{prefix}vk.IC[{i}] = Pairing.G1Point({_p1_to_str(p)});\n"
    template = template.replace("<%vk_ic_pts%>", vi)
    return template


def create_verifier_sol_file(params: Parameters, filename: str) -> None:
    with open(filename, "w") as f:
        f.write(create_verifier_sol(params))
