"""The kernels' field code on a card (`gpu`; skips without one): the inline
PTX of field_ptx.cuh (generated by ops/_ptx.py) through csrc/fieldops.cu
(a b, a^2, a + b, a - b of Fq, Fr and Fq2 pairs, and of BLS12-381's Fq and
Fq2, one launch) against
field/fp.py (field/fq2.py) on the same operands, the edge operands of
`ops.fieldops.edge_pairs` / `edge_pairs_fq2` first.
The CPU tests hold the PTX's instructions (run on Python integers) and the
C++ host path against field/fp.py too; only here does the card's compiler
take part.

The file imports nothing of JAX, so it runs on a machine with a card and
without JAX:

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_field_gpu.py

Tolerance: exact equality of every limb.
"""

import random

import pytest
import torch

from phase2_bn254_tpu_torch.ops import fieldops


@pytest.mark.gpu
@pytest.mark.parametrize("field", ["fq", "fr", "fq2", "bls_fq", "bls_fq2"])
def test_field_ptx_matches_fp_on_gpu(field):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = random.Random(f"field {field}")
    pairs = fieldops.edge_pairs_fq2(rng, field) if fieldops.is_fq2(field) else fieldops.edge_pairs(field, rng)
    pairs += [(fieldops.random_element(field, rng), fieldops.random_element(field, rng))
              for _ in range(4096 - len(pairs))]
    a, b = (fieldops.to_limbs([pair[k] for pair in pairs], field, "cpu") for k in (0, 1))
    before = fieldops.LAUNCHES["field_ops"]
    got = fieldops.field_ops(a.cuda(), b.cuda(), field)
    assert fieldops.LAUNCHES["field_ops"] == before + 1
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, fieldops.field_ops_plain(a, b, field)))
