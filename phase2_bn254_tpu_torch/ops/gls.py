"""GLS 4-D scalar split for BN254 G2 on torch tensors (counterpart of
`phase2_bn254_tpu/ops/gls_device.py:39-129`).

k = k0 + k1 L + k2 L^2 + k3 L^3 (mod r), L = q mod r, by Babai round-off
against the LLL basis B of `refimpl.gls`:

    c_j ~ round(k adjB[0][j] / det B),   (k0..k3) = (k, 0, 0, 0) - sum_j c_j B[j]

all mod 2^80 in 16-bit digits (|ki| < 2^67), then the same signed base-32
recode as `ops.glv`. The digits agree exactly with the JAX package.
"""

from __future__ import annotations

import torch

from ..field.fp import LIMB_BITS
from ..refimpl import gls as rgls
from .glv import TDIG, barrett, mul_const, signed_sum, signed_windows5, twos_complement_abs

KDIG = 5  # two's-complement width of k0..k3 in digits (80 bits >> 2^67)
GLS_WINDOWS5 = 14  # signed base-32 digits per component
assert 15 * ((1 << (5 * GLS_WINDOWS5)) - 1) // 31 >= 1 << 67

_SD = 1 if rgls._DET > 0 else -1
# c_j = round(k adj[j] / det): reciprocal magnitude and effective sign
_M = [barrett(abs(a), abs(rgls._DET)) for a in rgls._ADJ_COL0]
_S = [(1 if a > 0 else -1) * _SD for a in rgls._ADJ_COL0]


def decompose_signed(scalars: torch.Tensor) -> torch.Tensor:
    """Canonical Fr scalars int64 (N, 16) -> int64 (4, 14, N) signed base-32
    digits, MSB first, component signs folded in (JAX
    `gls_device.decompose_signed_device_t`)."""
    k = scalars
    round_bit = LIMB_BITS * TDIG - 1
    cs = [mul_const(k, m, KDIG + TDIG, round_bit)[:, TDIG:] for m in _M]
    out = []
    for t in range(4):
        acc = k[:, :KDIG] if t == 0 else torch.zeros_like(k[:, :KDIG])
        terms = [
            (_S[j] * (1 if rgls._BASIS[j][t] >= 0 else -1), mul_const(cs[j], abs(rgls._BASIS[j][t]), KDIG))
            for j in range(4)
            if rgls._BASIS[j][t]
        ]
        out.append(signed_windows5(*twos_complement_abs(signed_sum(acc, terms)), GLS_WINDOWS5))
    return torch.stack(out)
