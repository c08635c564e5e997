"""Streaming ParameterSource: Groth16 query bases read straight from bytes.

The reference reads proving parameters through the `ParameterSource`
abstraction (bellman/src/groth16/mod.rs:396-483) whose
`Source` iterators stream bases with checked / unchecked and
disallow-points-at-infinity read modes (source.rs:21-70, mod.rs:287-291).
`containers.Parameters` materializes h/l/a/b as Python lists of exact host
Points - at the reference design point (2^21 constraints, max 2^28) that is
millions of boxed objects per query, so the prover could not reach
reference-scale circuits through it.

`ParametersSource` parses the (small) VerifyingKey eagerly and leaves the
five query vectors as (offset, count) spans over the underlying buffer or
file. The prover reads each span in chunks of raw bytes that
`ops.backend.TorchBackend.decode` turns into limb tensors on the device (the
native-codec path the phase-1 accumulator streams through) - no host Point
objects in the hot path. `points` reads a span into host Points.

The port's own copy of `phase2_bn254_tpu/groth16/source.py` (code unchanged);
file:line citations of `.rs` files are to the upstream Rust repository.
"""

from __future__ import annotations

import io
import struct

from ..refimpl import curve as rc
from .containers import VerifyingKey

G1_UNCOMPRESSED = 64
G2_UNCOMPRESSED = 128

# (vector name, group) in file order - bellman groth16/mod.rs:252-285
VECTORS = (
    ("h", "g1"),
    ("l", "g1"),
    ("a", "g1"),
    ("b_g1", "g1"),
    ("b_g2", "g2"),
)


class ParametersSource:
    """Span-indexed view of the bellman `Parameters` byte format.

    `checked` / `disallow_points_at_infinity` mirror Parameters::read's
    flags (mod.rs:287-291); they apply at chunk-decode time, not here."""

    def __init__(self, f, checked: bool = True, disallow_points_at_infinity: bool = False):
        if isinstance(f, (bytes, bytearray)):
            f = io.BytesIO(f)
        self.f = f
        self.checked = checked
        self.allow_inf = not disallow_points_at_infinity
        self.vk = VerifyingKey.read(f)
        self.spans: dict[str, tuple[int, int, str, int]] = {}
        for name, group in VECTORS:
            (n,) = struct.unpack(">I", f.read(4))
            esize = G1_UNCOMPRESSED if group == "g1" else G2_UNCOMPRESSED
            off = f.tell()
            self.spans[name] = (off, n, group, esize)
            f.seek(off + n * esize)
        # .params files continue with cs_hash + contributions; callers that
        # need them keep reading from here
        self.end_offset = f.tell()

    @classmethod
    def open(cls, path: str, **kw) -> "ParametersSource":
        return cls(open(path, "rb"), **kw)

    def count(self, name: str) -> int:
        return self.spans[name][1]

    def group(self, name: str) -> str:
        return self.spans[name][2]

    def read_chunk(self, name: str, start: int, count: int) -> bytes:
        """Raw uncompressed bytes of vector[start : start+count]."""
        off, n, _group, esize = self.spans[name]
        if start < 0 or start + count > n:
            raise ValueError(f"not enough bases in {name}: [{start}, {start + count}) of {n}")
        self.f.seek(off + start * esize)
        data = self.f.read(count * esize)
        if len(data) != count * esize:
            raise ValueError("unexpected EOF reading parameter span")
        return data

    def points(self, name: str, start: int, count: int) -> list[rc.Point]:
        """Host-Point decode of a span slice (the exact-backend path);
        applies the checked / infinity read modes."""
        _off, _n, group, esize = self.spans[name]
        raw = self.read_chunk(name, start, count)
        pts = []
        for i in range(count):
            p = rc.point_from_bytes(raw[i * esize : (i + 1) * esize], group, False, self.checked)
            if p.is_zero() and not self.allow_inf:
                raise ValueError("point at infinity")
            pts.append(p)
        return pts
