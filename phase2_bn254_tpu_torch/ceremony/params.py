"""Ceremony geometry - sizes and file offsets.

Mirrors powersoftau/src/parameters.rs:39-121 (sizes) and the
accumulator file layout of
powersoftau/src/batched_accumulator.rs:87-178:

    64B hash || TauG1[2^(n+1)-1] || TauG2[2^n] || AlphaG1[2^n] || BetaG1[2^n]
    || BetaG2 ( || public key for responses )

The port's own copy of `phase2_bn254_tpu/ceremony/params.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

from dataclasses import dataclass, field

G1_UNCOMPRESSED = 64
G2_UNCOMPRESSED = 128
G1_COMPRESSED = 32
G2_COMPRESSED = 64
HASH_SIZE = 64

ELEMENT_KINDS = ("tau_g1", "tau_g2", "alpha_g1", "beta_g1", "beta_g2")


@dataclass(frozen=True)
class CeremonyParams:
    size: int
    batch_size: int
    powers_length: int = field(init=False)
    powers_g1_length: int = field(init=False)
    accumulator_size: int = field(init=False)
    public_key_size: int = field(init=False)
    contribution_size: int = field(init=False)

    def __post_init__(self):
        powers_length = 1 << self.size
        powers_g1_length = (powers_length << 1) - 1
        accumulator_size = (
            powers_g1_length * G1_UNCOMPRESSED
            + powers_length * (G2_UNCOMPRESSED + 2 * G1_UNCOMPRESSED)
            + G2_UNCOMPRESSED
            + HASH_SIZE
        )
        public_key_size = 3 * G2_UNCOMPRESSED + 6 * G1_UNCOMPRESSED
        contribution_size = (
            powers_g1_length * G1_COMPRESSED
            + powers_length * (G2_COMPRESSED + 2 * G1_COMPRESSED)
            + G2_COMPRESSED
            + HASH_SIZE
            + public_key_size
        )
        object.__setattr__(self, "powers_length", powers_length)
        object.__setattr__(self, "powers_g1_length", powers_g1_length)
        object.__setattr__(self, "accumulator_size", accumulator_size)
        object.__setattr__(self, "public_key_size", public_key_size)
        object.__setattr__(self, "contribution_size", contribution_size)

    # -- element sizes -----------------------------------------------------
    @staticmethod
    def element_size(kind: str, compressed: bool) -> int:
        if kind in ("tau_g2", "beta_g2"):
            return G2_COMPRESSED if compressed else G2_UNCOMPRESSED
        return G1_COMPRESSED if compressed else G1_UNCOMPRESSED

    def element_count(self, kind: str) -> int:
        if kind == "tau_g1":
            return self.powers_g1_length
        if kind == "beta_g2":
            return 1
        return self.powers_length

    def position(self, kind: str, index: int, compressed: bool) -> int:
        """batched_accumulator.rs:96-178 `calculate_mmap_position`."""
        g1 = G1_COMPRESSED if compressed else G1_UNCOMPRESSED
        g2 = G2_COMPRESSED if compressed else G2_UNCOMPRESSED
        if kind == "tau_g1":
            assert index < self.powers_g1_length
            off = g1 * index
        elif kind == "tau_g2":
            assert index < self.powers_length
            off = g1 * self.powers_g1_length + g2 * index
        elif kind == "alpha_g1":
            assert index < self.powers_length
            off = g1 * self.powers_g1_length + g2 * self.powers_length + g1 * index
        elif kind == "beta_g1":
            assert index < self.powers_length
            off = (
                g1 * self.powers_g1_length
                + g2 * self.powers_length
                + g1 * self.powers_length
                + g1 * index
            )
        elif kind == "beta_g2":
            off = (
                g1 * self.powers_g1_length
                + g2 * self.powers_length
                + 2 * g1 * self.powers_length
            )
        else:  # pragma: no cover
            raise ValueError(kind)
        return HASH_SIZE + off

    def pubkey_position(self, output_is_compressed: bool) -> int:
        """keypair.rs:178-183: after the (compressed) accumulator."""
        if output_is_compressed:
            return self.contribution_size - self.public_key_size
        return self.accumulator_size

    def file_size(self, compressed: bool, with_pubkey: bool) -> int:
        if compressed:
            assert with_pubkey, "compressed files always carry the public key"
            return self.contribution_size
        return self.accumulator_size + (self.public_key_size if with_pubkey else 0)

    def chunks(self, region: str):
        """Yield (start, size) batches for the two index regions, matching
        itertools-chunks semantics of batched_accumulator.rs:394-397."""
        if region == "low":  # [0, powers_length)
            lo, hi = 0, self.powers_length
        elif region == "high":  # [powers_length, powers_g1_length)
            lo, hi = self.powers_length, self.powers_g1_length
        else:  # pragma: no cover
            raise ValueError(region)
        start = lo
        while start < hi:
            size = min(self.batch_size, hi - start)
            yield start, size
            start += size
