"""Phase-1 tools of the port (counterpart of `phase2_bn254_tpu/cli/phase1.py`).

`new_constrained` and `compute_constrained` take the JAX CLI's arguments;
`compute_constrained` adds `--device` (default `cuda`). Both call the JAX
package's JAX-free protocol functions (`new_challenge`, `contribute`), the
second with `backend=TorchBackend(device)`.
"""

from __future__ import annotations

import argparse
import sys

from phase2_bn254_tpu.cli import phase1

from ..ops.backend import TorchBackend, check_device


def new_constrained(challenge_file: str, circuit_power: int, batch_size: int) -> bytes:
    """Write the empty challenge (host work only); returns its hash."""
    return phase1.new_challenge(challenge_file, circuit_power, batch_size)


def compute_constrained(challenge_file: str, response_file: str, circuit_power: int, batch_size: int, rng,
                        device="cuda") -> bytes:
    """One contribution with the participant's ChaCha `rng`, its point math
    on `device`; returns the response hash."""
    return phase1.contribute(challenge_file, response_file, circuit_power, batch_size, rng,
                             backend=TorchBackend(device))


def main_new(argv=None):
    phase1.main_new(argv)


def main_compute(argv=None):
    ap = argparse.ArgumentParser(prog="compute_constrained")
    ap.add_argument("challenge_file")
    ap.add_argument("response_file")
    ap.add_argument("circuit_power", type=int)
    ap.add_argument("batch_size", type=int)
    ap.add_argument("--entropy", default=None, help="skip the interactive prompt")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; never falls back to the CPU)")
    a = ap.parse_args(argv)
    check_device(a.device)  # before the entropy prompt
    entropy = a.entropy
    if entropy is None:
        print("Type some random text and press [ENTER] to provide additional entropy...")
        entropy = sys.stdin.readline()
    rng = phase1.participant_rng(entropy)
    compute_constrained(a.challenge_file, a.response_file, a.circuit_power, a.batch_size, rng, a.device)
