"""Groth16 containers with bellman-compatible serialization.

Byte formats mirror bellman/src/groth16/mod.rs:
Proof = 128B compressed a||b||c (mod.rs:42-54); VerifyingKey = uncompressed
points + u32-BE ic length (mod.rs:141-186); Parameters = vk then five
u32-BE-length-prefixed uncompressed point vectors h,l,a,b_g1,b_g2
(mod.rs:252-285).

Vectors are lists of exact host Points; bulk device math converts at the
boundary (ops.backend.points_to_batch).

The port's own copy of `phase2_bn254_tpu/groth16/containers.py` (code unchanged);
file:line citations of `.rs` files are to the upstream Rust repository.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field as dfield

from ..refimpl import curve as rc


def _read_point(buf, group: str, compressed: bool, check: bool, allow_inf: bool):
    size = (32 if group == "g1" else 64) * (1 if compressed else 2)
    data = buf.read(size)
    if len(data) != size:
        raise ValueError("unexpected EOF reading point")
    p = rc.point_from_bytes(data, group, compressed, check)
    if p.is_zero() and not allow_inf:
        raise ValueError("point at infinity")
    return p


@dataclass
class Proof:
    a: rc.Point
    b: rc.Point
    c: rc.Point

    def write(self) -> bytes:
        return (
            rc.point_to_bytes(self.a, True)
            + rc.point_to_bytes(self.b, True)
            + rc.point_to_bytes(self.c, True)
        )

    @classmethod
    def read(cls, data: bytes) -> "Proof":
        buf = io.BytesIO(data)
        a = _read_point(buf, "g1", True, True, False)
        b = _read_point(buf, "g2", True, True, False)
        c = _read_point(buf, "g1", True, True, False)
        return cls(a, b, c)


@dataclass
class VerifyingKey:
    alpha_g1: rc.Point
    beta_g1: rc.Point
    beta_g2: rc.Point
    gamma_g2: rc.Point
    delta_g1: rc.Point
    delta_g2: rc.Point
    ic: list[rc.Point] = dfield(default_factory=list)

    def write(self) -> bytes:
        out = bytearray()
        out += rc.point_to_bytes(self.alpha_g1, False)
        out += rc.point_to_bytes(self.beta_g1, False)
        out += rc.point_to_bytes(self.beta_g2, False)
        out += rc.point_to_bytes(self.gamma_g2, False)
        out += rc.point_to_bytes(self.delta_g1, False)
        out += rc.point_to_bytes(self.delta_g2, False)
        out += struct.pack(">I", len(self.ic))
        for p in self.ic:
            out += rc.point_to_bytes(p, False)
        return bytes(out)

    @classmethod
    def read(cls, buf) -> "VerifyingKey":
        alpha_g1 = _read_point(buf, "g1", False, True, True)
        beta_g1 = _read_point(buf, "g1", False, True, True)
        beta_g2 = _read_point(buf, "g2", False, True, True)
        gamma_g2 = _read_point(buf, "g2", False, True, True)
        delta_g1 = _read_point(buf, "g1", False, True, True)
        delta_g2 = _read_point(buf, "g2", False, True, True)
        (ic_len,) = struct.unpack(">I", buf.read(4))
        ic = [_read_point(buf, "g1", False, True, False) for _ in range(ic_len)]
        return cls(alpha_g1, beta_g1, beta_g2, gamma_g2, delta_g1, delta_g2, ic)

    def __eq__(self, o):
        return (
            isinstance(o, VerifyingKey)
            and self.alpha_g1 == o.alpha_g1
            and self.beta_g1 == o.beta_g1
            and self.beta_g2 == o.beta_g2
            and self.gamma_g2 == o.gamma_g2
            and self.delta_g1 == o.delta_g1
            and self.delta_g2 == o.delta_g2
            and self.ic == o.ic
        )


@dataclass
class Parameters:
    vk: VerifyingKey
    h: list[rc.Point]
    l: list[rc.Point]
    a: list[rc.Point]
    b_g1: list[rc.Point]
    b_g2: list[rc.Point]

    def write(self) -> bytes:
        out = bytearray(self.vk.write())
        for vec in (self.h, self.l, self.a, self.b_g1):
            out += struct.pack(">I", len(vec))
            for p in vec:
                out += rc.point_to_bytes(p, False)
        out += struct.pack(">I", len(self.b_g2))
        for p in self.b_g2:
            out += rc.point_to_bytes(p, False)
        return bytes(out)

    @classmethod
    def read(cls, buf, disallow_points_at_infinity: bool = False, checked: bool = True) -> "Parameters":
        if isinstance(buf, (bytes, bytearray)):
            buf = io.BytesIO(buf)
        vk = VerifyingKey.read(buf)
        vecs = []
        for group in ("g1", "g1", "g1", "g1", "g2"):
            (n,) = struct.unpack(">I", buf.read(4))
            vecs.append(
                [
                    _read_point(buf, group, False, checked, not disallow_points_at_infinity)
                    for _ in range(n)
                ]
            )
        h, l, a, b_g1, b_g2 = vecs
        return cls(vk, h, l, a, b_g1, b_g2)

    def __eq__(self, o):
        return (
            isinstance(o, Parameters)
            and self.vk == o.vk
            and self.h == o.h
            and self.l == o.l
            and self.a == o.a
            and self.b_g1 == o.b_g1
            and self.b_g2 == o.b_g2
        )
