"""Groth16 prover on the device (counterpart of
`phase2_bn254_tpu/groth16/prover.py`, bellman groth16/prover.rs:137-345).

Synthesize the witness assignment, then on `TorchBackend`'s device:

* `_h_coefficients`: a, b, c interpolated and evaluated on the coset (three
  inverse NTTs, three coset NTTs: K6, the coset powers folded into the
  passes), a * b - c, then one inverse coset NTT with the division by the
  vanishing polynomial folded into its last pass; a, b, c and h stay limb
  tensors on the device;
* the query MSMs (K3, K4, K5), launched back to back through
  `TorchBackend.msm_many_async` and then waited for. The JAX package runs
  eight (h, l, a over the inputs and over the aux variables, and the same
  two for b in G1 and in G2); the proof only needs h + l, a, b_g1 and b_g2,
  and the bases of each pair of terms are contiguous in their vectors (or,
  for h and l, concatenated), so the port runs four MSMs over the joined
  scalars, the three in G1 sharing one K4 and one K5 launch;

and combine the results with the r / s blinding on the host.

The query bases come from a `containers.Parameters` (host Points) or from a
`source.ParametersSource`. A source is read as the `prove` tool reads a
.params file after `phase2.circom.filter_params`: each vector is decoded
whole on the device (2^18-element chunks), and the points at infinity of h,
a, b_g1 and b_g2 are dropped, those of l kept (skipped by the MSM); a source
opened with disallow_points_at_infinity raises on any.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..crypto.chacha import ChaChaRng
from ..curve import codecs
from ..curve.group import AffineBatch
from ..field import fp
from ..ops import ntt
from ..ops.backend import PointSet, TorchBackend
from ..refimpl import curve as rc
from ..refimpl.field import R_MOD
from ..refimpl.sampling import rand_fr
from .containers import Proof
from .cs import LinearCombination, ProvingAssignment, SynthesisError, Variable
from .source import ParametersSource

CTX = fp.FR_CTX


def prepare_prover(circuit) -> ProvingAssignment:
    """prover.rs:153-186 (including the x*0=0 input constraints)."""
    prover = ProvingAssignment()
    prover.alloc_input(None, lambda: 1)
    circuit.synthesize(prover)
    for i in range(len(prover.input_assignment)):
        prover.enforce(
            None,
            LinearCombination([(Variable("input", i), 1)]),
            LinearCombination(),
            LinearCombination(),
        )
    return prover


def _h_coefficients(prover: ProvingAssignment, device) -> torch.Tensor:
    """The (a*b - c)/z coset pipeline (prover.rs:216-251): canonical Fr limbs
    of h, int64 (m - 1, 16) on `device`."""
    n = len(prover.a)
    exp = (n - 1).bit_length()
    m = 1 << exp
    if exp > 28:
        raise SynthesisError("polynomial degree too large")

    def mont(vals):
        limbs = convert.ints_to_limbs(vals, device)
        limbs = torch.cat([limbs, torch.zeros((m - len(vals), fp.NLIMBS), dtype=limbs.dtype, device=device)])
        return fp.to_mont(CTX, limbs)

    a, b, c = (ntt.coset_ntt(exp, ntt.ntt(exp, mont(v), True)) for v in (prover.a, prover.b, prover.c))
    ab = fp.sub(CTX, fp.mont_mul(CTX, a, b), c)
    h = ntt.icoset_ntt(exp, ab, divide_by_z=True)  # icoset_ntt(divide_by_z_on_coset(ab)), one ntt call
    return fp.from_mont(CTX, h)[: m - 1]  # truncate last


class _Bases:
    """The query MSMs over one parameter set. Bases are prefixes of a
    Parameters vector (host Points, uploaded) or of a ParametersSource vector
    (decoded once on the device, filtered as the module docstring says)."""

    def __init__(self, params, backend: TorchBackend):
        self.params = params
        self.backend = backend
        self.streaming = isinstance(params, ParametersSource)
        self._vectors: dict[str, AffineBatch] = {}

    def _decoded(self, name: str) -> AffineBatch:
        if name not in self._vectors:
            batch = codecs.decode_vector(self.params, name, self.backend.device)
            if name != "l" and bool(batch.inf.any()):  # filter_params leaves l as it is
                keep = (~batch.inf).nonzero().squeeze(1)
                batch = AffineBatch(*(t[keep] for t in batch))
            self._vectors[name] = batch
        return self._vectors[name]

    def prefix(self, name: str, count: int) -> AffineBatch:
        """vector[:count] (count > 0); raises if the vector is shorter."""
        if not self.streaming:
            vec = getattr(self.params, name)
            if count > len(vec):
                raise ValueError(f"not enough bases in {name}: {count} of {len(vec)}")
            return self.backend.from_points(vec[:count], "g2" if name == "b_g2" else "g1").affine
        batch = self._decoded(name)
        have = batch.inf.shape[0]
        if count > have:
            raise ValueError(f"not enough bases in {name}: {count} of {have}")
        return AffineBatch(*(t[:count] for t in batch))

    def msm_async(self, group: str, queries):
        """Launch one MSM per query of one group, a list of terms (vector
        name, scalars for its prefix) that are joined, all of them sharing
        one K4 and one K5 launch; `wait` takes the handle. An empty query is
        the point at infinity."""
        present, items = [], []
        for terms in queries:
            terms = [(name, k) for name, k in terms if k.shape[0]]
            present.append(bool(terms))
            if terms:
                bases = [self.prefix(name, k.shape[0]) for name, k in terms]
                scalars = torch.cat([k for _, k in terms])
                items.append((PointSet(group, scalars.shape[0], affine=AffineBatch(*map(torch.cat, zip(*bases)))),
                              scalars))
        return group, present, self.backend.msm_many_async(items) if items else None

    def wait(self, handle) -> list[rc.Point]:
        group, present, launched = handle
        results = iter(self.backend.msm_many_wait(launched) if launched else ())
        return [next(results) if p else rc.point_zero(group) for p in present]


def create_proof(prover: ProvingAssignment, params, r: int, s: int, backend: TorchBackend) -> Proof:
    """params: a containers.Parameters OR a source.ParametersSource."""
    vk = params.vk
    if vk.delta_g1.is_zero() or vk.delta_g2.is_zero():
        raise SynthesisError("unexpected identity (CRS subversion)")
    dev = backend.device

    h_scalars = _h_coefficients(prover, dev)
    inputs = convert.ints_to_limbs(prover.input_assignment, dev)
    auxs = convert.ints_to_limbs(prover.aux_assignment, dev)

    def dense(t, density):
        return t[convert.to_device(np.flatnonzero(np.asarray(density, dtype=bool)), dev)]

    a_scalars = torch.cat([inputs, dense(auxs, prover.a_aux_density)])
    b_scalars = torch.cat([dense(inputs, prover.b_input_density), dense(auxs, prover.b_aux_density)])

    q = _Bases(params, backend)
    g1 = q.msm_async("g1", [[("h", h_scalars), ("l", auxs)], [("a", a_scalars)], [("b_g1", b_scalars)]])
    g2 = q.msm_async("g2", [[("b_g2", b_scalars)]])
    h_l, a_answer, b1_answer = q.wait(g1)
    (b2_answer,) = q.wait(g2)
    return combine(vk, r, s, h_l, a_answer, b1_answer, b2_answer)


def combine(vk, r: int, s: int, h_l, a_answer, b1_answer, b2_answer) -> Proof:
    """The proof from the MSM results and the blinding r, s (host)."""
    g_a = vk.delta_g1.mul(r).add(vk.alpha_g1)
    g_b = vk.delta_g2.mul(s).add(vk.beta_g2)
    g_c = vk.delta_g1.mul((r * s) % R_MOD).add(vk.alpha_g1.mul(s)).add(vk.beta_g1.mul(r))

    g_a = g_a.add(a_answer)
    g_c = g_c.add(a_answer.mul(s))
    g_b = g_b.add(b2_answer)
    g_c = g_c.add(b1_answer.mul(r)).add(h_l)
    return Proof(a=g_a, b=g_b, c=g_c)


def create_random_proof(circuit, params, rng: ChaChaRng, backend: TorchBackend) -> Proof:
    """prover.rs:439-455: r, s = Fr::rand(rng).

    params: containers.Parameters or a streaming source.ParametersSource."""
    prover = prepare_prover(circuit)
    r = rand_fr(rng)
    s = rand_fr(rng)
    return create_proof(prover, params, r, s, backend)
