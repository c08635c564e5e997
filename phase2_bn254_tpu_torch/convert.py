"""State carried between the JAX package and the port, and between host and
device.

* AffineBatch coordinates: the JAX package holds uint32 (N, n) for G1 and
  (N, 2, n) for G2, Montgomery limbs (n = 16 for BN254, 24 for BLS12-381);
  the port holds the same limbs as int64 tensors. `affine_from_numpy` /
  `affine_to_numpy` convert, through numpy so that this module never
  imports JAX.
* Canonical limbs <-> Python ints, and host Points <-> AffineBatch: refimpl
  Points (BN254) or, with curve="bls12_381", the port's
  `bls12_381.curve` Points.
* `to_device`: a host tensor to a device without waiting for the device
  (pinned memory, non-blocking copy), so uploads do not stall the stream.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve.group import AffineBatch
from .field import fp
from .refimpl import curve as rc
from .refimpl.field import Fq2


def to_device(t: torch.Tensor | np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on `device`; to a GPU through pinned memory with
    a non-blocking copy (a pageable copy would wait for the stream)."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def affine_from_numpy(x, y, inf, device) -> AffineBatch:
    """JAX-package coordinates (uint32 limbs, bool inf; anything np.asarray
    takes) -> the port's AffineBatch on `device`."""
    return AffineBatch(
        to_device(np.asarray(x).astype(np.int64), device),
        to_device(np.asarray(y).astype(np.int64), device),
        to_device(np.asarray(inf).astype(bool), device),
    )


def affine_to_numpy(batch: AffineBatch):
    """The port's AffineBatch -> (x, y uint32 limbs, inf bool) numpy arrays,
    the JAX package's layout."""
    return (
        batch.x.cpu().numpy().astype(np.uint32),
        batch.y.cpu().numpy().astype(np.uint32),
        batch.inf.cpu().numpy().astype(bool),
    )


def ints_to_limbs(vals, device, nlimbs: int = fp.NLIMBS) -> torch.Tensor:
    """Python ints -> int64 (N, nlimbs) little-endian 16-bit limbs on `device`."""
    buf = b"".join(int(v).to_bytes(2 * nlimbs, "little") for v in vals)
    arr = np.frombuffer(buf, dtype="<u2").reshape(-1, nlimbs).astype(np.int64)
    return to_device(arr, device)


def limbs_to_ints(t: torch.Tensor) -> list[int]:
    """int64 (N, n) limbs -> Python ints."""
    buf = t.detach().cpu().numpy().astype("<u2").tobytes()
    n = 2 * t.shape[-1]
    return [int.from_bytes(buf[i : i + n], "little") for i in range(0, len(buf), n)]


def _engine(curve: str):
    """(Fq context, host curve module, host Fq2 class) of the named curve."""
    if curve == "bn254":
        return fp.FQ_CTX, rc, Fq2
    if curve == "bls12_381":
        from .bls12_381 import curve as bc
        from .bls12_381.field import Fq2 as BlsFq2

        return fp.BLS_FQ_CTX, bc, BlsFq2
    raise ValueError(f"no curve {curve!r}")


def points_to_affine(points, group: str, device, curve: str = "bn254") -> AffineBatch:
    """Host Points of `curve` -> Montgomery AffineBatch on `device` (a point
    at infinity as (0, 1) with its inf flag, as the JAX package writes it)."""
    ctx, _, Fq2 = _engine(curve)

    def mont(vals):
        return ints_to_limbs([ctx.to_mont_int(v) for v in vals], device, ctx.nlimbs)

    if group == "g1":
        x = mont([0 if p.inf else p.x for p in points])
        y = mont([1 if p.inf else p.y for p in points])
    else:
        xs = [Fq2(0, 0) if p.inf else p.x for p in points]
        ys = [Fq2(1, 0) if p.inf else p.y for p in points]
        x = torch.stack([mont([v.c0 for v in xs]), mont([v.c1 for v in xs])], dim=1)
        y = torch.stack([mont([v.c0 for v in ys]), mont([v.c1 for v in ys])], dim=1)
    inf = torch.tensor([p.inf for p in points], dtype=torch.bool, device=device)
    return AffineBatch(x, y, inf)


def affine_to_points(batch: AffineBatch, group: str, curve: str = "bn254") -> list:
    """Montgomery AffineBatch -> host Points of `curve`."""
    ctx, rc, Fq2 = _engine(curve)

    def ints(t):
        return [ctx.from_mont_int(v) for v in limbs_to_ints(t)]

    infs = batch.inf.tolist()
    if group == "g1":
        coords = zip(ints(batch.x), ints(batch.y))
    else:
        xs = [Fq2(a, b) for a, b in zip(ints(batch.x[:, 0]), ints(batch.x[:, 1]))]
        ys = [Fq2(a, b) for a, b in zip(ints(batch.y[:, 0]), ints(batch.y[:, 1]))]
        coords = zip(xs, ys)
    return [rc.point_zero(group) if inf else rc.Point(x, y, False, group) for (x, y), inf in zip(coords, infs)]
