"""PyTorch + CUDA port of `phase2_bn254_tpu` for NVIDIA Hopper (H100).

Two slices of the phase-1 powers-of-tau ceremony run on the card:

* the contribution (`python -m phase2_bn254_tpu_torch compute_constrained`,
  and `beacon_constrained`): kernels K1 (csrc/batch_exp_g1.cu) and K2
  (csrc/batch_exp_g2.cu);
* the coordinator's verification (`verify_transform_constrained`): the
  Pippenger MSM kernels K3, K4 and K5 (csrc/msm.cu) and point decompression
  D1 (csrc/decompress.cu).

and the Groth16 prover (`python -m phase2_bn254_tpu_torch prove`): the
four-step Fr NTT K6 (csrc/ntt.cu) and K3-K5 (`groth16/`, `phase2/circom`).

The package carries its own copy of the host protocol (`cli.phase1`,
`ceremony`, `crypto`, `refimpl`, `native`, and of `groth16` and
`phase2.circom`); it imports torch, and nothing of jax or of the JAX
package.
"""
