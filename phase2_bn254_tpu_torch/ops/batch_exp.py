"""Batch scalar multiplication for the contribute path (counterpart of
`phase2_bn254_tpu/ops/pallas_exp.py`).

* `tau_powers`: coeff * tau^(start + i), canonical Fr (pallas_exp.py:1161-1176).
* K1 `batch_exp_glv_signed`: the signed GLV double ladder on G1
  (pallas_exp.py:667-767), kernel in csrc/batch_exp_g1.cu.
* K2 `batch_exp_gls_signed`: the signed GLS quad ladder on G2
  (pallas_exp.py:985-1103), kernel in csrc/batch_exp_g2.cu.
* K9 `batch_exp_g2_windowed`: the plain windowed ladder on G2, 64 4-bit
  windows of the canonical scalar and no endomorphism (pallas_exp.py:391-476),
  kernel in csrc/batch_exp_g2_windowed.cu; the phase-2 QAP evaluation's G2
  terms (`ops/segsum.py`).
* K8 `batch_exp_g1_windowed`: the same ladder on G1 (pallas_exp.py:310-388),
  kernel in csrc/batch_exp_g1_windowed.cu.
* K7 `batch_exp_glv`: the unsigned base-16 GLV double ladder on G1, 4-bit
  windows of |k1|, |k2| with a sign flag per lane (pallas_exp.py:503-613),
  kernel in csrc/batch_exp_glv.cu.
* K10 `batch_exp_gls`: the unsigned GLS quad ladder on G2, 4-bit windows of
  |k0..k3| with a sign flag per lane (pallas_exp.py:845-963), kernel in
  csrc/batch_exp_gls.cu.
* K8-BLS `batch_exp_bls_g1_windowed` and K9-BLS `batch_exp_bls_g2_windowed`:
  K8 and K9 at BLS12-381 width (the JAX package runs pallas_exp.py:358 /
  :449 with its 24-limb field constants, bls12_381/device.py:147-177), the
  same template over the 12 x 32-bit field in csrc/batch_exp_g1_windowed.cu
  / batch_exp_g2_windowed.cu; points (N, 24) / (N, 2, 24), scalars (N, 16)
  canonical mod BLS r.
* K7-BLS `batch_exp_bls_glv` and K1-BLS `batch_exp_bls_glv_signed`: K7 and
  K1 at BLS12-381 width (pallas_exp.py:571 / :728 as the JAX package's
  bls12_381/device.py:209 / :238 runs them), the same per-point templates
  over the 12 x 32-bit field in csrc/batch_exp_glv.cu / batch_exp_g1.cu,
  with BLS beta; points (N, 24), digits of `ops.glv` over the BLS plan
  (`bls12_381.device.GLV_PLAN`). The plain versions of K1 / K7 and of their
  BLS instances share one formulation each (`_glv_signed_plain`,
  `_glv_plain`) over the field ops and beta.

`batch_exp_g1` / `batch_exp_g2` pick one of these by name from canonical
scalars, splitting them as the ladder needs (the choice is
`ops.backend.Ladders`, JAX `ops/backend.py:133-172`).

Each kernel has a wrapper, a plain PyTorch version of the same function and
a launch count (`LAUNCHES[<wrapper name>]`, raised by one per kernel launch). The
wrapper takes the plain version for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises.

Inputs are Montgomery affine points, outputs Jacobian points in Montgomery
form, fully reduced: the same function as the TPU kernels'.
"""

from __future__ import annotations

import torch

from ..curve import group as G
from ..field import fp
from ..bls12_381.field import R_MOD as BLS_R
from ..bls12_381.glv import BETA as BLS_BETA
from ..field.fq2 import BLS_FQ, BLS_FQ2, FQ, FQ2
from ..refimpl.field import R_MOD
from ..refimpl.gls import G2C1, G2C2
from ..refimpl.glv import BETA
from . import _build, gls, glv
from .gls import GLS_WINDOWS5
from .glv import BN_PLAN

G1_WINDOWS = BN_PLAN.windows5  # 26
G2_WINDOWS = GLS_WINDOWS5  # 14

# kernel launches by wrapper name; only a launch of the kernel counts
LAUNCHES = {"batch_exp_glv_signed": 0, "batch_exp_gls_signed": 0, "batch_exp_g2_windowed": 0,
            "batch_exp_g1_windowed": 0, "batch_exp_glv": 0, "batch_exp_gls": 0,
            "batch_exp_bls_g1_windowed": 0, "batch_exp_bls_g2_windowed": 0, "batch_exp_bls_glv": 0,
            "batch_exp_bls_glv_signed": 0}
N_WINDOWS = 64  # 4-bit windows of a canonical scalar (K9; BLS r < 2^255 fits them too)


def tau_powers(tau_start: torch.Tensor, tau_pows: torch.Tensor, coeff: torch.Tensor, log2n: int) -> torch.Tensor:
    """coeff * tau^(start + i) for i < 2^log2n, canonical, int64 (2^log2n, 16).

    tau_start, coeff: Montgomery Fr limbs (16,); tau_pows[j]: Montgomery limbs
    of tau^(2^j). Log-doubling: P_2k = [P_k, P_k tau^k]."""
    ctx = fp.FR_CTX
    out = tau_start[None]
    for j in range(log2n):
        out = torch.cat([out, fp.mont_mul(ctx, out, tau_pows[j])])
    return fp.from_mont(ctx, fp.mont_mul(ctx, out, coeff))


def _gather(table: G.JacobianBatch, idx: torch.Tensor) -> G.JacobianBatch:
    """Per-lane table lookup: entry idx[i] of lane i."""
    lanes = torch.arange(idx.shape[0], device=idx.device)
    return G.JacobianBatch(*(c[idx, lanes] for c in table))


def _table(f, x: torch.Tensor, y: torch.Tensor, size: int = 17) -> G.JacobianBatch:
    """T[j] = j P for j < size, stacked on a new leading axis."""
    n = x.shape[0]
    base = G.JacobianBatch(x, y, f.ones((n,), x.device))
    entries = [G.jac_zero(f, (n,), x.device), base]
    for _ in range(2, size):
        entries.append(G.jac_add(f, entries[-1], base))  # step 2 is P + P
    return G.JacobianBatch(*(torch.stack(c) for c in zip(*entries)))


def _first_live_window(*digits: torch.Tensor) -> int:
    """The first window (row) in which any lane has a nonzero digit; the
    number of rows if none has. Before it every lane's accumulator is
    infinity, and a window of doublings and adds of T[0] leaves it so, limbs
    included (the add returns T[0]): the plain ladders start there."""
    live = torch.stack([(d != 0).reshape(d.shape[0], -1).any(1) for d in digits]).any(0)
    return int(live.nonzero()[0]) if bool(live.any()) else live.shape[0]


def _add_neg(f, acc: G.JacobianBatch, e: G.JacobianBatch, neg: torch.Tensor) -> G.JacobianBatch:
    """acc + e, with e's y negated in the lanes where neg is true."""
    return G.jac_add(f, acc, e._replace(y=f.select(neg, f.neg(e.y), e.y)))


# ---------------------------------------------------------------------------
# K1: G1 signed GLV double ladder
# ---------------------------------------------------------------------------

def _glv_signed_plain(f, beta, x, y, d1, d2) -> G.JacobianBatch:
    """Plain K1 over the field ops f (FQ; BLS_FQ for K1-BLS) with beta's
    Montgomery limbs: the table by general adds (the kernel's mixed adds
    give the same limbs: every value is fully reduced); the windows before
    the first nonzero digit of the batch are skipped (`_first_live_window`;
    the kernel starts each lane at its own, with the same limbs)."""
    table = _table(f, x, y)
    beta_x = f.mul(table.x, beta)
    acc = G.jac_zero(f, (x.shape[0],), x.device)
    for w in range(_first_live_window(d1, d2), d1.shape[0]):
        for _ in range(5):
            acc = G.jac_double(f, acc)
        acc = _add_neg(f, acc, _gather(table, d1[w].abs()), d1[w] < 0)
        acc = _add_neg(f, acc, _gather(table._replace(x=beta_x), d2[w].abs()), d2[w] < 0)  # phi
    return acc


def batch_exp_glv_signed_plain(x, y, d1, d2) -> G.JacobianBatch:
    """Plain PyTorch K1. x, y: int64 (N, 16) Montgomery affine; d1, d2: int64
    (W, N) signed base-32 digits, MSB first (`_glv_signed_plain`)."""
    return _glv_signed_plain(FQ, fp.FQ_CTX.const(BETA, x.device), x, y, d1, d2)


def batch_exp_glv_signed(x, y, d1, d2) -> G.JacobianBatch:
    """K1: k_i P_i for G1 points. CPU tensors take the plain version; CUDA
    tensors launch csrc/batch_exp_g1.cu."""
    if not _build.on_card("batch_exp_glv_signed", x):
        return batch_exp_glv_signed_plain(x, y, d1, d2)
    n, w = x.shape[0], d1.shape[0]
    for name, t, shape in (("x", x, (n, 16)), ("y", y, (n, 16)), ("d1", d1, (w, n)), ("d2", d2, (w, n))):
        _build.check("batch_exp_glv_signed", name, t, shape, x.device)
    out = [torch.empty_like(x) for _ in range(3)]
    _build.launch("p2_batch_exp_glv_signed", x.device, x, y, d1, d2, *out, n, w)
    LAUNCHES["batch_exp_glv_signed"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# K2: G2 signed GLS quad ladder
# ---------------------------------------------------------------------------

def _gls_consts(device):
    """psi constants (pallas_exp.py:830-842), Montgomery: C1, C2, N1, N2,
    C31 = N1 C1, C32 = N2 C2."""
    ctx = fp.FQ_CTX
    n1 = (G2C1 * G2C1.conjugate()).c0
    n2 = (G2C2 * G2C2.conjugate()).c0

    def fq2(v):
        return torch.stack([ctx.const(v.c0, device), ctx.const(v.c1, device)])

    return fq2(G2C1), fq2(G2C2), ctx.const(n1, device), ctx.const(n2, device), fq2(G2C1 * n1), fq2(G2C2 * n2)


def _psi_pow(c: int, e: G.JacobianBatch, consts) -> G.JacobianBatch:
    c1, c2, n1, n2, c31, c32 = consts
    if c == 0:
        return e
    if c == 2:
        return G.JacobianBatch(FQ.mul(e.x, n1), FQ.mul(e.y, n2), e.z)
    cx, cy = (c1, c2) if c == 1 else (c31, c32)
    return G.JacobianBatch(
        FQ2.mul(FQ2.conjugate(e.x), cx), FQ2.mul(FQ2.conjugate(e.y), cy), FQ2.conjugate(e.z)
    )


def batch_exp_gls_signed_plain(x, y, digits) -> G.JacobianBatch:
    """Plain PyTorch K2. x, y: int64 (N, 2, 16) Montgomery affine; digits:
    int64 (4, W, N) signed base-32 digits, MSB first."""
    consts = _gls_consts(x.device)
    table = _table(FQ2, x, y)
    acc = G.jac_zero(FQ2, (x.shape[0],), x.device)
    for w in range(digits.shape[1]):
        for _ in range(5):
            acc = G.jac_double(FQ2, acc)
        for c in range(4):
            d = digits[c, w]
            acc = _add_neg(FQ2, acc, _psi_pow(c, _gather(table, d.abs()), consts), d < 0)
    return acc


def batch_exp_gls_signed(x, y, digits) -> G.JacobianBatch:
    """K2: k_i Q_i for G2 points. CPU tensors take the plain version; CUDA
    tensors launch csrc/batch_exp_g2.cu."""
    if not _build.on_card("batch_exp_gls_signed", x):
        return batch_exp_gls_signed_plain(x, y, digits)
    n, w = x.shape[0], digits.shape[1]
    for name, t, shape in (("x", x, (n, 2, 16)), ("y", y, (n, 2, 16)), ("digits", digits, (4, w, n))):
        _build.check("batch_exp_gls_signed", name, t, shape, x.device)
    out = [torch.empty_like(x) for _ in range(3)]
    _build.launch("p2_batch_exp_gls_signed", x.device, x, y, digits, *out, n, w)
    LAUNCHES["batch_exp_gls_signed"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# K9: G2 plain windowed ladder
# ---------------------------------------------------------------------------

def scalar_windows_msb(scalars: torch.Tensor) -> torch.Tensor:
    """Canonical scalars int64 (N, 16) -> int64 (64, N) 4-bit windows, most
    significant first (JAX `pallas_exp.scalar_windows_t_msb`)."""
    return glv.windows4(scalars, N_WINDOWS)


def half_recode(scalars: torch.Tensor, r: int = R_MOD) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical scalars int64 (N, 16) mod r (the scalar field's modulus:
    BN254's by default) -> (k', neg): k' = r - k and neg true where k > (r -
    1)/2, else k' = k (so k P = k' (+-P), k' <= (r - 1)/2)."""
    half = torch.tensor(fp.int_to_limbs((r - 1) // 2), dtype=torch.int64, device=scalars.device)
    neg = fp.gt(scalars, half.expand_as(scalars))
    return fp.select(neg, fp.int_minus(r, scalars), scalars), neg


def _windowed_plain(f, x, y, scalars, r: int = R_MOD) -> G.JacobianBatch:
    """Plain K8 (f = FQ), K9 (f = FQ2) and, with r BLS12-381's, K8-BLS (f =
    BLS_FQ) and K9-BLS (f = BLS_FQ2). x, y: Montgomery affine, finite;
    scalars: int64 (N, 16) canonical mod r. Per lane k > (r - 1)/2 is taken
    as (r - k)(-P) (`half_recode`, as the kernels do); then T[j] = j P for j =
    0..15 and per window (MSB first) 4 doublings and one add of T[d]
    (`jac_add_sparse`: the limbs of `jac_add`, the arithmetic only on the
    lanes where both points are finite); the windows before the first
    nonzero digit of the batch are skipped (`_first_live_window`). The
    kernels' later per-lane start, their table (mixed adds over Fq2) and
    their skipped adds of T[0] leave the same limbs."""
    scalars, neg = half_recode(scalars, r)
    table = _table(f, x, f.select(neg, f.neg(y), y), 16)
    acc = G.jac_zero(f, (x.shape[0],), x.device)
    digits = scalar_windows_msb(scalars)
    for d in digits[_first_live_window(digits) :]:
        for _ in range(4):
            acc = G.jac_double(f, acc)
        acc = G.jac_add_sparse(f, acc, _gather(table, d))
    return acc


def batch_exp_g2_windowed_plain(x, y, scalars) -> G.JacobianBatch:
    """Plain PyTorch K9. x, y: int64 (N, 2, 16); scalars: int64 (N, 16)."""
    return _windowed_plain(FQ2, x, y, scalars)


def batch_exp_g2_windowed(x, y, scalars) -> G.JacobianBatch:
    """K9: k_i Q_i for G2 points and canonical scalars. CPU tensors take the
    plain version; CUDA tensors launch csrc/batch_exp_g2_windowed.cu."""
    if not _build.on_card("batch_exp_g2_windowed", x):
        return batch_exp_g2_windowed_plain(x, y, scalars)
    n = x.shape[0]
    for name, t, shape in (("x", x, (n, 2, 16)), ("y", y, (n, 2, 16)), ("scalars", scalars, (n, 16))):
        _build.check("batch_exp_g2_windowed", name, t, shape, x.device)
    out = [torch.empty_like(x) for _ in range(3)]
    _build.launch("p2_batch_exp_g2_windowed", x.device, x, y, scalars, *out, n)
    LAUNCHES["batch_exp_g2_windowed"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# K8: G1 plain windowed ladder
# ---------------------------------------------------------------------------

def batch_exp_g1_windowed_plain(x, y, scalars) -> G.JacobianBatch:
    """Plain PyTorch K8. x, y: int64 (N, 16) Montgomery affine, finite;
    scalars: int64 (N, 16) canonical."""
    return _windowed_plain(FQ, x, y, scalars)


def batch_exp_g1_windowed(x, y, scalars) -> G.JacobianBatch:
    """K8: k_i P_i for G1 points and canonical scalars. CPU tensors take the
    plain version; CUDA tensors launch csrc/batch_exp_g1_windowed.cu."""
    if not _build.on_card("batch_exp_g1_windowed", x):
        return batch_exp_g1_windowed_plain(x, y, scalars)
    n = x.shape[0]
    for name, t in (("x", x), ("y", y), ("scalars", scalars)):
        _build.check("batch_exp_g1_windowed", name, t, (n, 16), x.device)
    out = [torch.empty_like(x) for _ in range(3)]
    _build.launch("p2_batch_exp_g1_windowed", x.device, x, y, scalars, *out, n)
    LAUNCHES["batch_exp_g1_windowed"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# K8-BLS, K9-BLS: the windowed ladders over BLS12-381's 12 x 32-bit field
# ---------------------------------------------------------------------------

def batch_exp_bls_g1_windowed_plain(x, y, scalars) -> G.JacobianBatch:
    """Plain PyTorch K8-BLS. x, y: int64 (N, 24) Montgomery affine (R =
    2^384), finite; scalars: int64 (N, 16) canonical mod BLS r."""
    return _windowed_plain(BLS_FQ, x, y, scalars, BLS_R)


def batch_exp_bls_g1_windowed(x, y, scalars) -> G.JacobianBatch:
    """K8-BLS: k_i P_i for BLS12-381 G1 points and canonical scalars. CPU
    tensors take the plain version; CUDA tensors launch
    csrc/batch_exp_g1_windowed.cu's BLS instantiation."""
    if not _build.on_card("batch_exp_bls_g1_windowed", x):
        return batch_exp_bls_g1_windowed_plain(x, y, scalars)
    n = x.shape[0]
    for name, t, shape in (("x", x, (n, 24)), ("y", y, (n, 24)), ("scalars", scalars, (n, 16))):
        _build.check("batch_exp_bls_g1_windowed", name, t, shape, x.device)
    out = [torch.empty_like(x) for _ in range(3)]
    _build.launch("p2_batch_exp_bls_g1_windowed", x.device, x, y, scalars, *out, n)
    LAUNCHES["batch_exp_bls_g1_windowed"] += 1
    return G.JacobianBatch(*out)


def batch_exp_bls_g2_windowed_plain(x, y, scalars) -> G.JacobianBatch:
    """Plain PyTorch K9-BLS. x, y: int64 (N, 2, 24) Montgomery affine,
    finite; scalars: int64 (N, 16) canonical mod BLS r."""
    return _windowed_plain(BLS_FQ2, x, y, scalars, BLS_R)


def batch_exp_bls_g2_windowed(x, y, scalars) -> G.JacobianBatch:
    """K9-BLS: k_i Q_i for BLS12-381 G2 points and canonical scalars. CPU
    tensors take the plain version; CUDA tensors launch
    csrc/batch_exp_g2_windowed.cu's BLS instantiation."""
    if not _build.on_card("batch_exp_bls_g2_windowed", x):
        return batch_exp_bls_g2_windowed_plain(x, y, scalars)
    n = x.shape[0]
    for name, t, shape in (("x", x, (n, 2, 24)), ("y", y, (n, 2, 24)), ("scalars", scalars, (n, 16))):
        _build.check("batch_exp_bls_g2_windowed", name, t, shape, x.device)
    out = [torch.empty_like(x) for _ in range(3)]
    _build.launch("p2_batch_exp_bls_g2_windowed", x.device, x, y, scalars, *out, n)
    LAUNCHES["batch_exp_bls_g2_windowed"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# K7-BLS, K1-BLS: the GLV ladders over BLS12-381's 12 x 32-bit field
# ---------------------------------------------------------------------------

def batch_exp_bls_glv_plain(x, y, d1, d2, negs) -> G.JacobianBatch:
    """Plain PyTorch K7-BLS. x, y: int64 (N, 24) Montgomery affine (R =
    2^384); d1, d2: int64 (W, N) 4-bit windows of |k1|, |k2| of
    bls12_381/glv.py's split, MSB first; negs: int64 (2, N)."""
    return _glv_plain(BLS_FQ, fp.BLS_FQ_CTX.const(BLS_BETA, x.device), x, y, d1, d2, negs)


def batch_exp_bls_glv(x, y, d1, d2, negs) -> G.JacobianBatch:
    """K7-BLS: k_i P_i for BLS12-381 G1 points. CPU tensors take the plain
    version; CUDA tensors launch csrc/batch_exp_glv.cu's BLS instantiation."""
    if not _build.on_card("batch_exp_bls_glv", x):
        return batch_exp_bls_glv_plain(x, y, d1, d2, negs)
    n, w = x.shape[0], d1.shape[0]
    for name, t, shape in (("x", x, (n, 24)), ("y", y, (n, 24)), ("d1", d1, (w, n)), ("d2", d2, (w, n)),
                           ("negs", negs, (2, n))):
        _build.check("batch_exp_bls_glv", name, t, shape, x.device)
    out = [torch.empty_like(x) for _ in range(3)]
    _build.launch("p2_batch_exp_bls_glv", x.device, x, y, d1, d2, negs, *out, n, w)
    LAUNCHES["batch_exp_bls_glv"] += 1
    return G.JacobianBatch(*out)


def batch_exp_bls_glv_signed_plain(x, y, d1, d2) -> G.JacobianBatch:
    """Plain PyTorch K1-BLS. x, y: int64 (N, 24) Montgomery affine (R =
    2^384); d1, d2: int64 (W, N) signed base-32 digits of bls12_381/glv.py's
    split, MSB first."""
    return _glv_signed_plain(BLS_FQ, fp.BLS_FQ_CTX.const(BLS_BETA, x.device), x, y, d1, d2)


def batch_exp_bls_glv_signed(x, y, d1, d2) -> G.JacobianBatch:
    """K1-BLS: k_i P_i for BLS12-381 G1 points. CPU tensors take the plain
    version; CUDA tensors launch csrc/batch_exp_g1.cu's BLS instantiation."""
    if not _build.on_card("batch_exp_bls_glv_signed", x):
        return batch_exp_bls_glv_signed_plain(x, y, d1, d2)
    n, w = x.shape[0], d1.shape[0]
    for name, t, shape in (("x", x, (n, 24)), ("y", y, (n, 24)), ("d1", d1, (w, n)), ("d2", d2, (w, n))):
        _build.check("batch_exp_bls_glv_signed", name, t, shape, x.device)
    out = [torch.empty_like(x) for _ in range(3)]
    _build.launch("p2_batch_exp_bls_glv_signed", x.device, x, y, d1, d2, *out, n, w)
    LAUNCHES["batch_exp_bls_glv_signed"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# K7: G1 unsigned GLV double ladder
# ---------------------------------------------------------------------------

def _glv_plain(f, beta, x, y, d1, d2, negs) -> G.JacobianBatch:
    """Plain K7 over the field ops f (FQ; BLS_FQ for K7-BLS) with beta's
    Montgomery limbs: T[j] = j P for j = 0..15; per window 4 doublings, then
    +-T[d1] and +-phi(T[d2]), the sign that of the lane's k_i whatever the
    digit (T[0] negated is still infinity). The windows before the first
    nonzero digit of the batch are skipped (`_first_live_window`; a batch
    without one runs the last window, as each lane without one does in the
    kernel, which starts every lane at its own)."""
    table = _table(f, x, y, 16)
    phi = table._replace(x=f.mul(table.x, beta))
    neg1, neg2 = negs[0] != 0, negs[1] != 0
    acc = G.jac_zero(f, (x.shape[0],), x.device)
    for w in range(min(_first_live_window(d1, d2), d1.shape[0] - 1), d1.shape[0]):
        for _ in range(4):
            acc = G.jac_double(f, acc)
        acc = _add_neg(f, acc, _gather(table, d1[w]), neg1)
        acc = _add_neg(f, acc, _gather(phi, d2[w]), neg2)
    return acc


def batch_exp_glv_plain(x, y, d1, d2, negs) -> G.JacobianBatch:
    """Plain PyTorch K7. x, y: int64 (N, 16) Montgomery affine; d1, d2: int64
    (W, N) 4-bit windows of |k1|, |k2|, MSB first; negs: int64 (2, N), 1
    where k_i < 0 (`_glv_plain`)."""
    return _glv_plain(FQ, fp.FQ_CTX.const(BETA, x.device), x, y, d1, d2, negs)


def batch_exp_glv(x, y, d1, d2, negs) -> G.JacobianBatch:
    """K7: k_i P_i for G1 points. CPU tensors take the plain version; CUDA
    tensors launch csrc/batch_exp_glv.cu."""
    if not _build.on_card("batch_exp_glv", x):
        return batch_exp_glv_plain(x, y, d1, d2, negs)
    n, w = x.shape[0], d1.shape[0]
    for name, t, shape in (("x", x, (n, 16)), ("y", y, (n, 16)), ("d1", d1, (w, n)), ("d2", d2, (w, n)),
                           ("negs", negs, (2, n))):
        _build.check("batch_exp_glv", name, t, shape, x.device)
    out = [torch.empty_like(x) for _ in range(3)]
    _build.launch("p2_batch_exp_glv", x.device, x, y, d1, d2, negs, *out, n, w)
    LAUNCHES["batch_exp_glv"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# K10: G2 unsigned GLS quad ladder
# ---------------------------------------------------------------------------

def batch_exp_gls_plain(x, y, digits, negs) -> G.JacobianBatch:
    """Plain PyTorch K10. x, y: int64 (N, 2, 16) Montgomery affine; digits:
    int64 (4, W, N) 4-bit windows of |k_c|, MSB first; negs: int64 (4, N), 1
    where k_c < 0. T[j] = j Q for j = 0..15; per window 4 doublings, then
    for c = 0..3 psi^c(T[d_c]) with y negated after psi where k_c < 0. The
    windows before the first nonzero digit of the batch are skipped (a batch
    without one runs the last window, as each lane without one does in the
    kernel, which starts every lane at its own)."""
    consts = _gls_consts(x.device)
    table = _table(FQ2, x, y, 16)
    acc = G.jac_zero(FQ2, (x.shape[0],), x.device)
    for w in range(min(_first_live_window(digits.transpose(0, 1)), digits.shape[1] - 1), digits.shape[1]):
        for _ in range(4):
            acc = G.jac_double(FQ2, acc)
        for c in range(4):
            acc = _add_neg(FQ2, acc, _psi_pow(c, _gather(table, digits[c, w]), consts), negs[c] != 0)
    return acc


def batch_exp_gls(x, y, digits, negs) -> G.JacobianBatch:
    """K10: k_i Q_i for G2 points. CPU tensors take the plain version; CUDA
    tensors launch csrc/batch_exp_gls.cu."""
    if not _build.on_card("batch_exp_gls", x):
        return batch_exp_gls_plain(x, y, digits, negs)
    n, w = x.shape[0], digits.shape[1]
    for name, t, shape in (("x", x, (n, 2, 16)), ("y", y, (n, 2, 16)), ("digits", digits, (4, w, n)),
                           ("negs", negs, (4, n))):
        _build.check("batch_exp_gls", name, t, shape, x.device)
    out = [torch.empty_like(x) for _ in range(3)]
    _build.launch("p2_batch_exp_gls", x.device, x, y, digits, negs, *out, n, w)
    LAUNCHES["batch_exp_gls"] += 1
    return G.JacobianBatch(*out)


# ---------------------------------------------------------------------------
# the ladders by name
# ---------------------------------------------------------------------------

def batch_exp_g1(ladder: str, x, y, scalars) -> G.JacobianBatch:
    """k_i P_i for G1 points and canonical scalars (N, 16) by the named
    ladder: "glv_signed" (K1), "glv" (K7) or "windowed" (K8)."""
    if ladder == "glv_signed":
        return batch_exp_glv_signed(x, y, *glv.decompose_signed(scalars))
    if ladder == "glv":
        return batch_exp_glv(x, y, *glv.decompose(scalars))
    if ladder == "windowed":
        return batch_exp_g1_windowed(x, y, scalars)
    raise ValueError(f"no G1 ladder {ladder!r}")


def batch_exp_g2(ladder: str, x, y, scalars) -> G.JacobianBatch:
    """k_i Q_i for G2 points and canonical scalars (N, 16) by the named
    ladder: "gls_signed" (K2), "gls" (K10) or "windowed" (K9)."""
    if ladder == "gls_signed":
        return batch_exp_gls_signed(x, y, gls.decompose_signed(scalars))
    if ladder == "gls":
        return batch_exp_gls(x, y, *gls.decompose(scalars))
    if ladder == "windowed":
        return batch_exp_g2_windowed(x, y, scalars)
    raise ValueError(f"no G2 ladder {ladder!r}")
