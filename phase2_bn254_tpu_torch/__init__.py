"""PyTorch + CUDA port of `phase2_bn254_tpu` for NVIDIA Hopper (H100).

The first slice: the phase-1 powers-of-tau contribution
(`python -m phase2_bn254_tpu_torch compute_constrained`). The file protocol
(`cli.phase1`, `ceremony`, `crypto`, `refimpl`, `native`) is the JAX
package's own JAX-free code, imported by its own names; this package supplies
`ops.backend.TorchBackend` and its kernels: K1 (csrc/batch_exp_g1.cu) and K2
(csrc/batch_exp_g2.cu). It imports torch and never jax, also where JAX is
installed (see `_import_jax_free_host_package`).
"""

import os
import sys


def _import_jax_free_host_package() -> None:
    """Import `phase2_bn254_tpu` without loading jax.

    Its `__init__` imports jax only to switch on the persistent XLA
    compilation cache, and skips that when PHASE2_TPU_NO_CACHE is set (as
    tests/conftest.py sets it). The port sets the switch for that one import
    and restores the environment, so that its later imports of the package's
    JAX-free modules find the package initialised and jax never loaded. In a
    process that imported the JAX package first, this does nothing."""
    if "phase2_bn254_tpu" in sys.modules:
        return
    saved = os.environ.get("PHASE2_TPU_NO_CACHE")
    os.environ["PHASE2_TPU_NO_CACHE"] = "1"
    try:
        import phase2_bn254_tpu  # noqa: F401
    finally:
        if saved is None:
            del os.environ["PHASE2_TPU_NO_CACHE"]
        else:
            os.environ["PHASE2_TPU_NO_CACHE"] = saved


_import_jax_free_host_package()
