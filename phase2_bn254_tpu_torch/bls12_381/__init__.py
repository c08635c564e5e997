"""BLS12-381 engine of the port (counterpart of `phase2_bn254_tpu/bls12_381/`).

The host layer is the port's own copy of the JAX package's JAX-free
modules: exact Fq, Fq2 and Fr values and constants (`field`), the G1 / G2
group law and the zcash point codecs (`curve`), and G1's GLV endomorphism
split (`glv`). The device layer is the port's: `device` (contexts, host <->
tensor converters, the plain batch multiplication, the windowed ladders
K8-BLS / K9-BLS, and on G1 the device GLV splits with the GLV ladders
K7-BLS / K1-BLS, all on the card) and `codecs_device` (zcash bytes <->
AffineBatch, decompression in the kernel D1-BLS on the card, its plain
torch version on the CPU). The pairing (Fq6, Fq12) is not ported yet.
"""

from . import curve, field  # noqa: F401
