"""Portable phase-2 contribute on the host (counterpart of
`phase2_bn254_tpu/phase2/portable.py`): the analog of the reference's WASM
binding (phase2/src/lib.rs:26-88 in the upstream Rust repository), which
exposes one function to browser participants:

    contribute(params_bytes, entropy) -> updated params_bytes

RNG = ChaCha seeded with the first 32 bytes of Blake2b(entropy) as 8
big-endian u32 words (lib.rs:53-73); params read with
disallow_points_at_infinity=False, checked=True (lib.rs:75); the
contribution applied and the parameters written back. It runs on the CPU
(`TorchBackend("cpu")`: the plain versions of the kernels), so it needs no
card.
"""

from __future__ import annotations

import hashlib

from ..crypto.chacha import ChaChaRng
from ..ops.backend import TorchBackend
from .mpc import MPCParameters


def contribute(params: bytes, entropy: bytes) -> tuple[bytes, bytes]:
    """Returns (updated_params_bytes, contribution_hash)."""
    backend = TorchBackend("cpu")
    rng = ChaChaRng.from_digest_be(hashlib.blake2b(entropy).digest())
    mp = MPCParameters.read(params, disallow_points_at_infinity=False, checked=True, backend=backend)
    h = mp.contribute(rng, backend)
    return mp.write(), h
