"""GLS 4-D scalar split for BN254 G2 on torch tensors (counterpart of
`phase2_bn254_tpu/ops/gls_device.py:39-129`).

k = k0 + k1 L + k2 L^2 + k3 L^3 (mod r), L = q mod r, by Babai round-off
against the LLL basis B of `refimpl.gls`:

    c_j ~ round(k adjB[0][j] / det B),   (k0..k3) = (k, 0, 0, 0) - sum_j c_j B[j]

all mod 2^80 in 16-bit digits (|ki| < 2^67). Two recodes of the four
components, each most significant first: signed base-32 digits with the
signs folded in (`decompose_signed`, K2), or 4-bit windows of |ki| and one
sign flag per component and lane (`decompose`, K10). The digits agree
exactly with the JAX package.
"""

from __future__ import annotations

import torch

from ..field.fp import LIMB_BITS
from ..refimpl import gls as rgls
from .glv import TDIG, barrett, mul_const, signed_sum, signed_windows5, twos_complement_abs, windows4

KDIG = 5  # two's-complement width of k0..k3 in digits (80 bits >> 2^67)
GLS_WINDOWS5 = 14  # signed base-32 digits per component
assert 15 * ((1 << (5 * GLS_WINDOWS5)) - 1) // 31 >= 1 << 67
GLS_WINDOWS = 17  # 4-bit windows per component: 68 bits >= 2^67

_SD = 1 if rgls._DET > 0 else -1
# c_j = round(k adj[j] / det): reciprocal magnitude and effective sign
_M = [barrett(abs(a), abs(rgls._DET)) for a in rgls._ADJ_COL0]
_S = [(1 if a > 0 else -1) * _SD for a in rgls._ADJ_COL0]


def components(scalars: torch.Tensor):
    """Canonical Fr scalars int64 (N, 16) -> four (|ki| digits (N, KDIG),
    ki < 0) pairs (JAX `gls_device._components_t`)."""
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
        out.append(twos_complement_abs(signed_sum(acc, terms)))
    return out


def decompose_signed(scalars: torch.Tensor) -> torch.Tensor:
    """Canonical Fr scalars int64 (N, 16) -> int64 (4, 14, N) signed base-32
    digits, MSB first, component signs folded in (JAX
    `gls_device.decompose_signed_device_t`)."""
    return torch.stack([signed_windows5(mag, neg, GLS_WINDOWS5) for mag, neg in components(scalars)])


def decompose(scalars: torch.Tensor):
    """Canonical Fr scalars int64 (N, 16) -> (digits int64 (4, 17, N), 4-bit
    windows of |ki| MSB first; negs int64 (4, N), 1 where ki < 0) (JAX
    `gls_device.decompose_device_t`)."""
    comps = components(scalars)
    digits = torch.stack([windows4(mag, GLS_WINDOWS) for mag, _ in comps])
    return digits, torch.stack([neg for _, neg in comps]).to(digits.dtype)
