"""Ceremony keypair and proof-of-knowledge transcript.

Mirrors powersoftau/src/keypair.rs:23-163. The keypair is
O(1) work per contribution, so it runs host-side on the exact Python layer;
the bulk accumulator math runs on TPU.

The port's own copy of `phase2_bn254_tpu/ceremony/keypair.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..crypto.chacha import ChaChaRng
from ..refimpl.curve import (
    G1_GEN,
    G2_GEN,
    Point,
    g1_to_uncompressed,
    g1_from_uncompressed,
    g2_to_uncompressed,
    g2_from_uncompressed,
)
from ..refimpl.sampling import hash_to_g2, rand_fr, rand_g1


@dataclass(frozen=True)
class PublicKey:
    """(s, s^x) G1 pairs and H(transcript)^x G2 elements for x in tau, alpha,
    beta (keypair.rs:23-30)."""

    tau_g1: tuple[Point, Point]
    alpha_g1: tuple[Point, Point]
    beta_g1: tuple[Point, Point]
    tau_g2: Point
    alpha_g2: Point
    beta_g2: Point

    def serialize(self) -> bytes:
        """Uncompressed, order per keypair.rs:107-125."""
        out = b"".join(
            g1_to_uncompressed(p)
            for pair in (self.tau_g1, self.alpha_g1, self.beta_g1)
            for p in pair
        )
        out += b"".join(
            g2_to_uncompressed(p) for p in (self.tau_g2, self.alpha_g2, self.beta_g2)
        )
        return out

    @classmethod
    def deserialize(cls, data: bytes) -> "PublicKey":
        """keypair.rs:127-163; uncompressed, checked, no infinities."""
        g1s = []
        pos = 0
        for _ in range(6):
            p = g1_from_uncompressed(data[pos : pos + 64], check=True)
            if p.is_zero():
                raise ValueError("point at infinity in public key")
            g1s.append(p)
            pos += 64
        g2s = []
        for _ in range(3):
            p = g2_from_uncompressed(data[pos : pos + 128], check=True)
            if p.is_zero():
                raise ValueError("point at infinity in public key")
            g2s.append(p)
            pos += 128
        return cls(
            tau_g1=(g1s[0], g1s[1]),
            alpha_g1=(g1s[2], g1s[3]),
            beta_g1=(g1s[4], g1s[5]),
            tau_g2=g2s[0],
            alpha_g2=g2s[1],
            beta_g2=g2s[2],
        )


@dataclass(frozen=True)
class PrivateKey:
    tau: int
    alpha: int
    beta: int


def compute_g2_s(digest: bytes, g1_s: Point, g1_s_x: Point, personalization: int) -> Point:
    """Blake2b(personalization || digest || g1_s || g1_s_x) hashed into G2
    (powersoftau/src/utils.rs:172-185)."""
    h = hashlib.blake2b()
    h.update(bytes([personalization]))
    h.update(digest)
    h.update(g1_to_uncompressed(g1_s))
    h.update(g1_to_uncompressed(g1_s_x))
    return hash_to_g2(h.digest())


def keypair(rng: ChaChaRng, digest: bytes) -> tuple[PublicKey, PrivateKey]:
    """keypair.rs:54-103; RNG consumption order is part of the contract."""
    assert len(digest) == 64
    tau = rand_fr(rng)
    alpha = rand_fr(rng)
    beta = rand_fr(rng)

    def op(x: int, personalization: int):
        g1_s = rand_g1(rng)
        g1_s_x = g1_s.mul(x)
        g2_s = compute_g2_s(digest, g1_s, g1_s_x, personalization)
        g2_s_x = g2_s.mul(x)
        return (g1_s, g1_s_x), g2_s_x

    pk_tau, tau_g2 = op(tau, 0)
    pk_alpha, alpha_g2 = op(alpha, 1)
    pk_beta, beta_g2 = op(beta, 2)
    return (
        PublicKey(
            tau_g1=pk_tau,
            alpha_g1=pk_alpha,
            beta_g1=pk_beta,
            tau_g2=tau_g2,
            alpha_g2=alpha_g2,
            beta_g2=beta_g2,
        ),
        PrivateKey(tau=tau, alpha=alpha, beta=beta),
    )
