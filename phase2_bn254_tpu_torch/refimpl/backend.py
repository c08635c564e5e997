"""Exact (slow) host backend for the ceremony accumulator.

Implements the bulk-point backend protocol over lists of refimpl Points.
This is the "DummyEngine"-style exact mock device (cf. the reference's
bellman/src/tests/dummy_engine.rs testing strategy): protocol logic can be
validated end-to-end against it, and the TPU backend must produce identical
bytes.

The port's own copy of `phase2_bn254_tpu/refimpl/backend.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

import secrets

from .curve import Point, point_from_bytes, point_to_bytes
from .field import R_MOD


class ExactBackend:
    """Backend over Python lists of affine Points."""

    name = "exact"

    def decode(self, raw: bytes, group: str, count: int, compressed: bool, check: bool):
        esize = (32 if group == "g1" else 64) * (1 if compressed else 2)
        assert len(raw) == esize * count
        pts = []
        for i in range(count):
            p = point_from_bytes(raw[i * esize : (i + 1) * esize], group, compressed, check)
            if p.is_zero():
                raise ValueError("point at infinity in accumulator")
            pts.append(p)
        return pts

    def encode(self, batch: list[Point], compressed: bool) -> bytes:
        return b"".join(point_to_bytes(p, compressed) for p in batch)

    def pow_mul(self, batch: list[Point], tau: int, start: int, coeff: int | None):
        """batch[i] * (coeff * tau^(start+i)) - the transform hot loop."""
        out = []
        s = pow(tau, start, R_MOD)
        if coeff is not None:
            s = (s * coeff) % R_MOD
        for p in batch:
            q = p.mul(s)
            assert not q.is_zero(), "contribution produced infinity, re-run"
            out.append(q)
            s = (s * tau) % R_MOD
        return out

    def power_pairs(self, batch: list[Point]) -> tuple[Point, Point]:
        """Random-linear-combination pair (merge_pairs of v[:-1] vs v[1:],
        powersoftau/src/utils.rs:112-135). Coefficients come
        from system randomness, as in the reference's thread_rng."""
        n = len(batch) - 1
        coeffs = [secrets.randbelow(R_MOD) for _ in range(n)]
        s = self.msm(batch[:-1], coeffs)
        sx = self.msm(batch[1:], coeffs)
        return s, sx

    def msm(self, points: list[Point], scalars: list[int]) -> Point:
        assert len(points) == len(scalars)
        from .curve import jacobian_add, jacobian_zero, affine_to_jacobian, jacobian_to_affine
        from .curve import jacobian_double

        acc = jacobian_zero(points[0].group)
        # simple double-and-add over shared bit positions (adequate for tests)
        for p, s in zip(points, scalars):
            q = p.mul(s % R_MOD)
            acc = jacobian_add(acc, affine_to_jacobian(q))
        return jacobian_to_affine(acc)

    # -- prepare_phase2 support -------------------------------------------
    def slice(self, batch: list[Point], start: int, stop: int):
        return batch[start:stop]

    def concat(self, parts):
        out = []
        for p in parts:
            out.extend(p)
        return out

    def group_intt(self, batch: list[Point]):
        """Exact inverse DFT: out[i] = m^-1 * sum_j a_j w^(-ij). O(m^2) -
        spec/golden path only (equality with any correct iFFT)."""
        from .field import FR_ROOT_OF_UNITY, FR_S

        m = len(batch)
        exp = m.bit_length() - 1
        assert 1 << exp == m
        omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - exp), R_MOD)
        winv = pow(omega, -1, R_MOD)
        minv = pow(m, -1, R_MOD)
        out = []
        for i in range(m):
            acc = None
            for j, p in enumerate(batch):
                term = p.mul((pow(winv, i * j, R_MOD) * minv) % R_MOD)
                acc = term if acc is None else acc.add(term)
            out.append(acc)
        return out

    def sub_batches(self, a: list[Point], b: list[Point]):
        return [x.add(y.neg()) for x, y in zip(a, b)]

    def encode_radix(self, batch: list[Point], compressed: bool = False) -> bytes:
        return b"".join(point_to_bytes(p, compressed) for p in batch)

    def first_point(self, batch: list[Point]) -> Point:
        return batch[0]

    def last_point(self, batch: list[Point]) -> Point:
        return batch[-1]

    def from_points(self, points: list[Point], group: str):
        return list(points)
