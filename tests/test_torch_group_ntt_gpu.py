"""The group NTT's kernels on a card (`gpu`; they skip without one): N1
`group_ntt_stage` and N2 `jac_scalar_mul` (csrc/group_ntt.cu) against their
plain versions on the same CUDA tensors, and `group_ntt_staged` through the
kernels against the plain versions on the CPU.

The inputs (`stage_case`, `scalar_case`, shared with
tests/test_torch_prepare.py, which runs the kernels' code compiled by g++
on them) are Jacobian points with z != 1, the first lanes all equal to the
generator and a few at infinity, and the edge scalars 0, 1, r - 1, (r -
1)/2 and (r + 1)/2 first: a + w b meets P == Q and P == -Q there. Tolerance:
exact equality of every limb (the kernels take the plain versions' steps)
and of the normalized affine points.

The file imports nothing of JAX, so it also runs on a machine with a card
and without JAX, where tests/conftest.py cannot load:

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_group_ntt_gpu.py
"""

import numpy as np
import pytest
import torch

from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.curve import group as G
from phase2_bn254_tpu_torch.field.fq2 import FQ, FQ2
from phase2_bn254_tpu_torch.ops import ntt
from phase2_bn254_tpu_torch.refimpl import curve as rc
from phase2_bn254_tpu_torch.refimpl.field import R_MOD

EDGE = [0, 1, R_MOD - 1, (R_MOD - 1) // 2, (R_MOD + 1) // 2]
GROUPS = ("g1", "g2")


def _field(group: str):
    return FQ if group == "g1" else FQ2


def _scalars(rng: np.random.Generator, n: int) -> list[int]:
    """n canonical scalars: EDGE first, then uniform in [0, r)."""
    words = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.int64).tolist()
    rand = [sum(w << (63 * i) for i, w in enumerate(ws)) % R_MOD for ws in words]
    return (EDGE + rand)[:n]


def jacobian_points(group: str, n: int, seed: int, equal: int = 8, infinity=(9, 13), distinct: int = 16,
                    device="cpu") -> G.JacobianBatch:
    """n Jacobian points: the first `equal` the generator (z = 1), the
    `infinity` lanes (0, 1, 0), the rest sums P + Q of random multiples of
    the generator (z != 1), `distinct` of them tiled."""
    rng = np.random.default_rng(seed)
    gen = rc.G1_GEN if group == "g1" else rc.G2_GEN
    f = _field(group)
    ks = [int(k) for k in rng.integers(2, 1 << 62, size=2 * distinct)]
    p = convert.points_to_affine([gen.mul(k) for k in ks[:distinct]], group, device)
    q = convert.points_to_affine([gen.mul(k) for k in ks[distinct:]], group, device)
    sums = G.jac_add(f, G.affine_to_jac(f, p), G.affine_to_jac(f, q))
    idx = torch.arange(n, device=device) % distinct
    pts = G.JacobianBatch(*(c[idx].clone() for c in sums))
    one = G.affine_to_jac(f, convert.points_to_affine([gen], group, device))
    zero = G.jac_zero(f, (1,), device)
    for c, g in zip(pts, one):
        c[: min(equal, n)] = g
    for i in infinity:
        if i < n:
            for c, z in zip(pts, zero):
                c[i] = z[0]
    return pts


def stage_case(group: str, rows: int, log2c: int, seed: int, device="cpu"):
    """(points, twiddle table): rows of 2^log2c points and a table of
    2^(log2c - 1) canonical twiddles, EDGE first (stage log2c reads each
    entry once a row)."""
    rng = np.random.default_rng(seed + 1)
    tw = convert.ints_to_limbs(_scalars(rng, 1 << (log2c - 1)), device)
    return jacobian_points(group, rows << log2c, seed, device=device), tw


def scalar_case(group: str, n: int, seed: int, device="cpu"):
    """(points, per-lane scalars), EDGE first."""
    rng = np.random.default_rng(seed + 2)
    return jacobian_points(group, n, seed, device=device), convert.ints_to_limbs(_scalars(rng, n), device)


def _affine(jac: G.JacobianBatch):
    f = FQ if jac.x.dim() == 2 else FQ2
    return [t.cpu() for t in G.jac_normalize(f, jac)]


def _copy(jac: G.JacobianBatch) -> G.JacobianBatch:
    return G.JacobianBatch(*(c.clone() for c in jac))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("group", GROUPS)
def test_group_ntt_stage_matches_plain(cuda, group):
    pts, tw = stage_case(group, 4, 6, seed=5, device=cuda)
    for s in (1, 3, 6):
        before = ntt.LAUNCHES["group_ntt_stage"]
        got = ntt.group_ntt_stage(_copy(pts), tw, 6, s)
        assert ntt.LAUNCHES["group_ntt_stage"] == before + 1
        want = ntt.group_ntt_stage_plain(_copy(pts), tw, 6, s)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), s
        assert all(torch.equal(a, b) for a, b in zip(_affine(got), _affine(want))), s


@pytest.mark.gpu
@pytest.mark.parametrize("group", GROUPS)
def test_jac_scalar_mul_matches_plain(cuda, group):
    pts, k = scalar_case(group, 64, seed=6, device=cuda)
    for scalars in (k, k[3:4]):  # per lane, and one scalar broadcast
        before = ntt.LAUNCHES["jac_scalar_mul"]
        got = ntt.jac_scalar_mul(_copy(pts), scalars)
        assert ntt.LAUNCHES["jac_scalar_mul"] == before + 1
        want = ntt.jac_scalar_mul_plain(_copy(pts), scalars)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(_affine(got), _affine(want)))


@pytest.mark.gpu
@pytest.mark.parametrize("group", GROUPS)
def test_group_ntt_staged_on_the_card_matches_cpu(cuda, group):
    """Two rows of 2^5 points, inverse: the kernels on the card, the plain
    versions on the CPU."""
    pts = jacobian_points(group, 64, seed=7)
    got = ntt.group_ntt_staged(5, G.JacobianBatch(*(c.to(cuda) for c in pts)), inverse=True)
    want = ntt.group_ntt_staged(5, pts, inverse=True)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
