"""Groth16 parameter generator from explicit toxic waste (counterpart of
`phase2_bn254_tpu/groth16/generator.py`, bellman groth16/generator.rs:
177-510).

Synthesize the circuit into QAP matrices, evaluate the polynomials at tau in
the Lagrange basis (an inverse NTT of the tau powers, K6) and build the CRS
queries. The JAX package multiplies one host point per query entry; here
each group's entries are one batch scalar multiplication of its base on the
device: every G1 query (h, l, a, b_g1) through the GLV split and K1, b_g2
through the GLS split and K2. The verifying key (a few points) stays on the
host. `generate_parameters_bytes` writes the bellman Parameters format
straight from the device batches, byte for byte what the JAX generator's
`Parameters.write()` gives (`containers.Parameters.read` reads it back).
"""

from __future__ import annotations

import struct

import torch

from .. import convert
from ..curve import codecs
from ..curve import group as G
from ..field import fp
from ..field.fq2 import FQ, FQ2
from ..ops import batch_exp, gls, glv, ntt
from ..refimpl import curve as rc
from ..refimpl.field import R_MOD
from .containers import VerifyingKey
from .cs import KeypairAssembly, LinearCombination, SynthesisError, UnconstrainedVariable, Variable

CTX = fp.FR_CTX


def _batch_mul(base: rc.Point, scalars: torch.Tensor) -> bytes:
    """Uncompressed bytes of k_i * base for nonzero canonical scalars k_i,
    int64 (N, 16) on the device (K1 for G1, K2 for G2)."""
    n = scalars.shape[0]
    if n == 0:
        return b""
    group = base.group
    pt = convert.points_to_affine([base], group, scalars.device)
    x, y = (t.expand(n, *t.shape[1:]).contiguous() for t in (pt.x, pt.y))
    if group == "g1":
        jac = batch_exp.batch_exp_glv_signed(x, y, *glv.decompose_signed(scalars))
    else:
        jac = batch_exp.batch_exp_gls_signed(x, y, gls.decompose_signed(scalars))
    return codecs.encode_batch(G.jac_normalize(FQ if group == "g1" else FQ2, jac), group, compressed=False)


def generate_parameters_bytes(circuit, g1: rc.Point, g2: rc.Point, alpha: int, beta: int, gamma: int, delta: int,
                              tau: int, device) -> bytes:
    """The bellman Parameters bytes of the circuit's CRS (generator.rs), the
    queries computed on `device` (a torch device name; the JAX CLI's
    semantics: a, b_g1, b_g2 without the points at infinity)."""
    dev = torch.device(device)
    assembly = KeypairAssembly()
    assembly.alloc_input()
    circuit.synthesize(assembly)
    for i in range(assembly.num_inputs):
        assembly.enforce(
            None,
            LinearCombination([(Variable("input", i), 1)]),
            LinearCombination(),
            LinearCombination(),
        )

    exp = (assembly.num_constraints - 1).bit_length()
    if exp > 28:
        raise SynthesisError("polynomial degree too large")
    m = 1 << exp

    gamma_inv = pow(gamma, -1, R_MOD)
    delta_inv = pow(delta, -1, R_MOD)

    # tau powers; H query: g1^{tau^i * t(tau) / delta}, i < m - 1
    powers = ntt.geometric(tau, exp, dev)  # Montgomery
    coeff = (pow(tau, m, R_MOD) - 1) * delta_inv % R_MOD
    coeff_t = convert.ints_to_limbs([CTX.to_mont_int(coeff)], dev)[0]
    h_scalars = fp.from_mont(CTX, fp.mont_mul(CTX, powers[: m - 1], coeff_t))
    # Lagrange coefficients of the tau powers
    lag = convert.limbs_to_ints(fp.from_mont(CTX, ntt.ntt(exp, powers, True)))

    def eval_at_tau(terms):
        return sum(lag[idx] * c for c, idx in terms) % R_MOD

    def eval_section(at, bt, ct, inv):
        a, b, ext = [], [], []
        for at_i, bt_i, ct_i in zip(at, bt, ct):
            at_v, bt_v, ct_v = eval_at_tau(at_i), eval_at_tau(bt_i), eval_at_tau(ct_i)
            a.append(at_v)
            b.append(bt_v)
            ext.append((at_v * beta + bt_v * alpha + ct_v) * inv % R_MOD)
        return a, b, ext

    a_in, b_in, ic = eval_section(assembly.at_inputs, assembly.bt_inputs, assembly.ct_inputs, gamma_inv)
    a_aux, b_aux, l = eval_section(assembly.at_aux, assembly.bt_aux, assembly.ct_aux, delta_inv)
    if not all(l):  # g1^0 is the point at infinity
        raise UnconstrainedVariable()
    a = [v for v in a_in + a_aux if v]
    b = [v for v in b_in + b_aux if v]

    vk = VerifyingKey(
        alpha_g1=g1.mul(alpha),
        beta_g1=g1.mul(beta),
        beta_g2=g2.mul(beta),
        gamma_g2=g2.mul(gamma),
        delta_g1=g1.mul(delta),
        delta_g2=g2.mul(delta),
        ic=[g1.mul(e) for e in ic],
    )
    g1_scalars = torch.cat([h_scalars, convert.ints_to_limbs(l + a + b, dev)])
    g1_bytes = _batch_mul(g1, g1_scalars)
    out = bytearray(vk.write())
    start = 0
    for count in (m - 1, len(l), len(a), len(b)):  # h, l, a, b_g1
        out += struct.pack(">I", count) + g1_bytes[64 * start : 64 * (start + count)]
        start += count
    out += struct.pack(">I", len(b)) + _batch_mul(g2, convert.ints_to_limbs(b, dev))
    return bytes(out)
