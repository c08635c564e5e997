"""Blake2b file hashing and display helpers.

`calculate_hash` mirrors powersoftau/src/utils.rs:20-27
(Blake2b-512 over the whole file; chunking does not change the digest).
`pretty_hash` reproduces the 16-bytes-per-line hex layout printed by every
reference binary (e.g. compute_constrained.rs:141-151).

The port's own copy of `phase2_bn254_tpu/crypto/hashing.py` (imports changed
only); file:line citations of `.rs` files are to the upstream Rust
repository.
"""

from __future__ import annotations

import hashlib

BLANK_HASH = hashlib.blake2b(b"").digest()


def calculate_hash(path: str, chunk: int = 1 << 24) -> bytes:
    h = hashlib.blake2b()
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            h.update(data)
    return h.digest()


def reduced_hash(old_power: int, new_power: int) -> bytes:
    """utils.rs:142-146."""
    return hashlib.blake2b(bytes([old_power, new_power])).digest()


def pretty_hash(digest: bytes) -> str:
    lines = []
    for off in range(0, len(digest), 16):
        line = digest[off : off + 16]
        parts = [line[i : i + 4].hex() for i in range(0, len(line), 4)]
        lines.append("\t" + " ".join(parts))
    return "\n".join(lines)
