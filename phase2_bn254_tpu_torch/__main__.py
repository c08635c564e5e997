"""python -m phase2_bn254_tpu_torch <tool> [args]: the port's phase-1 and
phase-2 tools."""

from __future__ import annotations

import sys

from .cli import phase1, phase2, transcript

TOOLS = {
    "new_constrained": phase1.main_new,
    "compute_constrained": phase1.main_compute,
    "beacon_constrained": phase1.main_beacon,
    "verify_transform_constrained": phase1.main_verify,
    "prepare_phase2": phase1.main_prepare_phase2,
    "reduce_powers": phase1.main_reduce_powers,
    "verify_transcript": transcript.main_verify_transcript,
    "new": phase2.main_new,
    "contribute": phase2.main_contribute,
    "beacon": phase2.main_beacon,
    "verify_contribution": phase2.main_verify_contribution,
    "prove": phase2.main_prove,
    "export_keys": phase2.main_export_keys,
    "generate_verifier": phase2.main_generate_verifier,
    "copy_json": phase2.main_copy_json,
    "snarkjs_verify": phase2.main_snarkjs_verify,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in TOOLS:
        print("usage: python -m phase2_bn254_tpu_torch <tool> [args]\ntools: " + ", ".join(TOOLS))
        return 2
    TOOLS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
