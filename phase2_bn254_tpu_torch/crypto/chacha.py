"""Bit-exact ChaCha20 RNG matching Rust `rand` 0.4's `ChaChaRng`.

The ceremony consumes randomness through `rand 0.4` (reference Cargo.toml) in
exactly three places, all of which must replay word-for-word:

* `hash_to_g2` seeds ChaCha with 8 big-endian u32s of a Blake2b digest
  (powersoftau/src/utils.rs:31-45),
* participant RNG seeded the same way from a Blake2b digest
  (powersoftau/src/bin/compute_constrained.rs:41-80),
* the beacon RNG from iterated SHA-256
  (powersoftau/src/bin/beacon_constrained.rs:51-97).

`rand 0.4` semantics reproduced here:

* `ChaChaRng::from_seed(&[u32])`: the seed words are copied verbatim into
  state words 4..12 (the 256-bit key); remaining key words zero; the 64-bit
  counter and 64-bit nonce start at zero. The constants are the standard
  "expand 32-byte k" sigma words.
* `next_u32()` returns output-buffer words in order 0..15; the buffer is the
  20-round (10 double-round) ChaCha output added to the input state; then the
  64-bit counter in words 12..13 increments.
* `Rng::next_u64()` (trait default in rand 0.4) is
  `((next_u32() as u64) << 32) | next_u32() as u64` - FIRST draw is the HIGH
  word.
* `gen::<bool>()` is `next_u32() as u8 & 1 == 1` - consumes one u32.

The port's own copy of `phase2_bn254_tpu/crypto/chacha.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

MASK32 = 0xFFFFFFFF


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & MASK32


def _quarter_round(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & MASK32
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & MASK32
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & MASK32
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & MASK32
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha20_block(state: list[int]) -> list[int]:
    """One 64-byte ChaCha20 block: 10 double rounds + feed-forward add."""
    x = list(state)
    for _ in range(10):
        # column rounds
        _quarter_round(x, 0, 4, 8, 12)
        _quarter_round(x, 1, 5, 9, 13)
        _quarter_round(x, 2, 6, 10, 14)
        _quarter_round(x, 3, 7, 11, 15)
        # diagonal rounds
        _quarter_round(x, 0, 5, 10, 15)
        _quarter_round(x, 1, 6, 11, 12)
        _quarter_round(x, 2, 7, 8, 13)
        _quarter_round(x, 3, 4, 9, 14)
    return [(a + b) & MASK32 for a, b in zip(x, state)]


class ChaChaRng:
    """rand 0.4 `ChaChaRng` replica (word-level API)."""

    SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)

    def __init__(self, seed_words: list[int] | tuple[int, ...] = ()):
        assert len(seed_words) <= 8
        key = [0] * 8
        for i, w in enumerate(seed_words):
            key[i] = w & MASK32
        self.state = list(self.SIGMA) + key + [0, 0, 0, 0]
        self.buffer: list[int] = []
        self.index = 16  # force refill on first draw

    @classmethod
    def from_seed(cls, seed_words) -> "ChaChaRng":
        return cls(list(seed_words))

    @classmethod
    def from_digest_be(cls, digest: bytes) -> "ChaChaRng":
        """Seed from the first 32 bytes of a digest read as 8 BE u32s - the
        idiom used everywhere in the ceremony (utils.rs:35-44)."""
        assert len(digest) >= 32
        words = [int.from_bytes(digest[4 * i : 4 * i + 4], "big") for i in range(8)]
        return cls(words)

    def _refill(self):
        self.buffer = chacha20_block(self.state)
        self.index = 0
        # 64-bit counter in state words 12..13
        self.state[12] = (self.state[12] + 1) & MASK32
        if self.state[12] == 0:
            self.state[13] = (self.state[13] + 1) & MASK32

    def next_u32(self) -> int:
        if self.index == 16:
            self._refill()
        w = self.buffer[self.index]
        self.index += 1
        return w

    def next_u64(self) -> int:
        """rand 0.4 Rng::next_u64 default: first u32 is the HIGH half."""
        hi = self.next_u32()
        lo = self.next_u32()
        return (hi << 32) | lo

    def gen_bool(self) -> bool:
        """rand 0.4 `bool: Rand` via `u8: Rand` = `next_u32() as u8`."""
        return (self.next_u32() & 0xFF) & 1 == 1

    # -- field / point sampling (ff_ce `Rand` derive semantics) ------------
    def gen_fp_mont(self, modulus: int, shave_bits: int = 2) -> int:
        """ff_ce `#[derive(PrimeField)]` `Rand`: draw 4 u64 limbs (limb 0
        first), mask the top `shave_bits` of limb 3, retry until < modulus.
        The accepted 256-bit value IS the Montgomery form of the element."""
        mask = (1 << (64 - shave_bits)) - 1
        while True:
            limbs = [self.next_u64() for _ in range(4)]
            limbs[3] &= mask
            v = limbs[0] | (limbs[1] << 64) | (limbs[2] << 128) | (limbs[3] << 192)
            if v < modulus:
                return v
