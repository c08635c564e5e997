"""Groth16 verifier (host pairings).

Reimplements bellman/src/groth16/verifier.rs:19-67:
e(A, B) == e(alpha, beta) * e(sum x_i IC_i, gamma) * e(C, delta).
Pairing values only feed equality checks here, so any correct pairing works;
we use the reduced optimal ate for consistency with the JSON exports.

The port's own copy of `phase2_bn254_tpu/groth16/verifier.py` (code unchanged);
file:line citations of `.rs` files are to the upstream Rust repository.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..refimpl import curve as rc
from ..refimpl.field import R_MOD
from ..refimpl.pairing import FQ12_ONE, ate_pairing, fq12_mul
from .containers import Proof, VerifyingKey


@dataclass
class PreparedVerifyingKey:
    alpha_g1_beta_g2: tuple
    gamma_g2: rc.Point
    delta_g2: rc.Point
    ic: list[rc.Point]


def prepare_verifying_key(vk: VerifyingKey) -> PreparedVerifyingKey:
    return PreparedVerifyingKey(
        alpha_g1_beta_g2=ate_pairing(vk.alpha_g1, vk.beta_g2),
        gamma_g2=vk.gamma_g2,
        delta_g2=vk.delta_g2,
        ic=list(vk.ic),
    )


def verify_proof(pvk: PreparedVerifyingKey, proof: Proof, public_inputs: list[int]) -> bool:
    if len(public_inputs) + 1 != len(pvk.ic):
        raise ValueError("malformed verifying key or inputs")
    acc = pvk.ic[0]
    for x, ic in zip(public_inputs, pvk.ic[1:]):
        acc = acc.add(ic.mul(x % R_MOD))
    lhs = ate_pairing(proof.a, proof.b)
    rhs = fq12_mul(
        fq12_mul(pvk.alpha_g1_beta_g2, ate_pairing(acc, pvk.gamma_g2)),
        ate_pairing(proof.c, pvk.delta_g2),
    )
    return lhs == rhs
