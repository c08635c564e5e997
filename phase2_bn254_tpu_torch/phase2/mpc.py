"""Phase-2 MPC parameters: the .params file format (counterpart of
`phase2_bn254_tpu/phase2/mpc.py`, phase2/src/parameters.rs and keypair.rs):

    .params file = bellman Parameters || cs_hash(64) || u32-BE count
                   || contributions (each: delta_after,s,s_delta uncompressed
                   G1; r_delta uncompressed G2; transcript 64B)

`Phase2PublicKey` and `MPCParameters.read` / `write` are the JAX package's
code unchanged; `MPCParameters.new`, `contribute` and `verify` belong to the
phase-2 slice and raise NotImplementedError. File:line citations of `.rs`
files are to the upstream Rust repository.
"""

from __future__ import annotations

import hashlib
import io
import struct
from dataclasses import dataclass, field as dfield

from ..groth16.containers import Parameters
from ..refimpl import curve as rc


@dataclass
class Phase2PublicKey:
    """phase2/src/keypair.rs:30-47."""

    delta_after: rc.Point
    s: rc.Point
    s_delta: rc.Point
    r_delta: rc.Point
    transcript: bytes  # 64 bytes

    def write(self) -> bytes:
        return (
            rc.point_to_bytes(self.delta_after, False)
            + rc.point_to_bytes(self.s, False)
            + rc.point_to_bytes(self.s_delta, False)
            + rc.point_to_bytes(self.r_delta, False)
            + self.transcript
        )

    @classmethod
    def read(cls, buf) -> "Phase2PublicKey":
        def rd(group):
            size = 64 if group == "g1" else 128
            p = rc.point_from_bytes(buf.read(size), group, False, check=True)
            if p.is_zero():
                raise ValueError("point at infinity in phase2 public key")
            return p

        delta_after = rd("g1")
        s = rd("g1")
        s_delta = rd("g1")
        r_delta = rd("g2")
        transcript = buf.read(64)
        assert len(transcript) == 64
        return cls(delta_after, s, s_delta, r_delta, transcript)

    def __eq__(self, o):
        return (
            isinstance(o, Phase2PublicKey)
            and self.delta_after == o.delta_after
            and self.s == o.s
            and self.s_delta == o.s_delta
            and self.r_delta == o.r_delta
            and self.transcript == o.transcript
        )

    def digest(self) -> bytes:
        return hashlib.blake2b(self.write()).digest()


@dataclass
class MPCParameters:
    params: Parameters
    cs_hash: bytes
    contributions: list[Phase2PublicKey] = dfield(default_factory=list)

    def write(self) -> bytes:
        out = bytearray(self.params.write())
        out += self.cs_hash
        out += struct.pack(">I", len(self.contributions))
        for pk in self.contributions:
            out += pk.write()
        return bytes(out)

    @classmethod
    def read(cls, data: bytes, disallow_points_at_infinity: bool = False, checked: bool = True) -> "MPCParameters":
        buf = io.BytesIO(data)
        params = Parameters.read(buf, disallow_points_at_infinity, checked)
        cs_hash = buf.read(64)
        (n,) = struct.unpack(">I", buf.read(4))
        contributions = [Phase2PublicKey.read(buf) for _ in range(n)]
        return cls(params=params, cs_hash=cs_hash, contributions=contributions)

    def __eq__(self, o):
        return (
            isinstance(o, MPCParameters)
            and self.params == o.params
            and self.cs_hash == o.cs_hash
            and self.contributions == o.contributions
        )


def _not_ported(name: str):
    def method(*args, **kwargs):
        raise NotImplementedError(f"MPCParameters.{name} is not ported yet: ROADMAP.md queue 1 item 11 (phase-2)")

    method.__name__ = name
    return method


MPCParameters.new = classmethod(_not_ported("new"))
MPCParameters.contribute = _not_ported("contribute")
MPCParameters.verify = _not_ported("verify")
