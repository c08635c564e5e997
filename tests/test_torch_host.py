"""The port's own copy of the host protocol against the JAX package's.

The port carries `refimpl`, `crypto`, `native`, `ceremony`, `cli.phase1`,
`groth16` and `phase2` of its own so that it imports nothing of the JAX
package. These cases hold each copy against its original on the same inputs
(seeded): field and curve constants, point bytes both ways, the ChaCha
stream and the keypair it seeds, `CeremonyParams` geometry, Blake2b file
hashes, the native codec's digits and bytes, the GLV / GLS splits and
`same_ratio` on a true and a false pair. The host-only Groth16, circom and
Solidity modules and BLS12-381's curve copied unchanged (`COPIES`) must
equal their originals' code, every docstring left out, and the Solidity
template its original's text but the two header lines that name its
origin; BLS12-381's field is its original's code up to the curve
coefficients (`PREFIX_COPIES`: Fq6, Fq12 and the Frobenius coefficients
wait for the pairing). Tolerance: exact equality of integers, bytes and
code.

`test_port_imports_neither_jax_nor_the_jax_package` reads every module of
the port and `chip_smoke.py` (ast), the BLS12-381 engine's among them, and
fails on any import of `jax` or of `phase2_bn254_tpu` (the jax-blocked
subprocess of tests/test_torch_contribute.py imports that engine too).
"""

import ast
import os
import random

import numpy as np
import pytest
import torch

from phase2_bn254_tpu import native as jnative
from phase2_bn254_tpu.bls12_381 import field as jbls_field
from phase2_bn254_tpu.ceremony import keypair as jkeypair
from phase2_bn254_tpu.ceremony import params as jparams
from phase2_bn254_tpu.crypto import chacha as jchacha
from phase2_bn254_tpu.crypto import hashing as jhashing
from phase2_bn254_tpu.refimpl import curve as jcurve
from phase2_bn254_tpu.refimpl import field as jfield
from phase2_bn254_tpu.refimpl import gls as jgls
from phase2_bn254_tpu.refimpl import glv as jglv
from phase2_bn254_tpu.refimpl import pairing as jpairing
from phase2_bn254_tpu.refimpl import sampling as jsampling
from phase2_bn254_tpu_torch import native
from phase2_bn254_tpu_torch.bls12_381 import field as bls_field
from phase2_bn254_tpu_torch.ceremony import keypair, params
from phase2_bn254_tpu_torch.crypto import chacha, hashing
from phase2_bn254_tpu_torch.refimpl import curve, field, gls, glv, pairing, sampling

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = bytes(range(64))


def _constants(mod):
    return {k: v for k, v in vars(mod).items() if k.isupper() and isinstance(v, (int, field.Fq2, jfield.Fq2))}


@pytest.mark.parametrize("ours,theirs", [(field, jfield), (glv, jglv), (gls, jgls), (bls_field, jbls_field)],
                         ids=["field", "glv", "gls", "bls_field"])
def test_constants_match(ours, theirs):
    mine, ref = _constants(ours), _constants(theirs)
    assert mine.keys() == ref.keys() and mine
    for k in mine:
        v, w = mine[k], ref[k]
        assert (v.c0, v.c1) == (w.c0, w.c1) if isinstance(v, field.Fq2) else v == w, k


def _pair(group: str, m: int):
    return (curve.G1_GEN if group == "g1" else curve.G2_GEN).mul(m), (
        jcurve.G1_GEN if group == "g1" else jcurve.G2_GEN).mul(m)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_bytes_match(group):
    rng = random.Random(5)
    for m in [1, 2, field.R_MOD - 1] + [rng.randrange(field.R_MOD) for _ in range(5)]:
        p, q = _pair(group, m)
        for compressed in (True, False):
            raw = curve.point_to_bytes(p, compressed)
            assert raw == jcurve.point_to_bytes(q, compressed)
            back = curve.point_from_bytes(raw, group, compressed)
            assert curve.point_to_bytes(back, False) == jcurve.point_to_bytes(
                jcurve.point_from_bytes(raw, group, compressed), False)


def test_chacha_and_sampling_match():
    a, b = chacha.ChaChaRng.from_digest_be(SEED), jchacha.ChaChaRng.from_digest_be(SEED)
    assert [a.next_u64() for _ in range(40)] == [b.next_u64() for _ in range(40)]
    assert sampling.rand_fr(a) == jsampling.rand_fr(b)
    assert curve.point_to_bytes(sampling.rand_g2(a), False) == jcurve.point_to_bytes(jsampling.rand_g2(b), False)
    digest = bytes(range(64, 128))
    assert curve.point_to_bytes(sampling.hash_to_g2(digest), True) == jcurve.point_to_bytes(
        jsampling.hash_to_g2(digest), True)


def test_keypair_matches():
    digest = hashing.calculate_hash(os.path.join(REPO, "tests", "fixtures", "golden_challenge_s4_b16.bin"))
    pub, priv = keypair.keypair(chacha.ChaChaRng.from_digest_be(SEED), digest)
    jpub, jpriv = jkeypair.keypair(jchacha.ChaChaRng.from_digest_be(SEED), digest)
    assert pub.serialize() == jpub.serialize()
    assert (priv.tau, priv.alpha, priv.beta) == (jpriv.tau, jpriv.alpha, jpriv.beta)
    assert keypair.PublicKey.deserialize(jpub.serialize()).serialize() == jpub.serialize()


@pytest.mark.parametrize("size,batch", [(4, 16), (10, 256), (21, 1 << 16), (5, 7)])
def test_ceremony_params_match(size, batch):
    p, q = params.CeremonyParams(size, batch), jparams.CeremonyParams(size, batch)
    for name in ("powers_length", "powers_g1_length", "accumulator_size", "public_key_size", "contribution_size"):
        assert getattr(p, name) == getattr(q, name), name
    for region in ("low", "high"):
        assert list(p.chunks(region)) == list(q.chunks(region))
    for kind in params.ELEMENT_KINDS:
        last = p.element_count(kind) - 1
        for compressed in (True, False):
            assert p.element_size(kind, compressed) == q.element_size(kind, compressed)
            for i in {0, last // 2, last}:
                assert p.position(kind, i, compressed) == q.position(kind, i, compressed), (kind, i)
    assert p.pubkey_position(True) == q.pubkey_position(True)


def test_hashes_match(tmp_path):
    path = tmp_path / "blob"
    path.write_bytes(np.random.default_rng(3).integers(0, 256, size=(1 << 20) + 17, dtype=np.uint8).tobytes())
    h = hashing.calculate_hash(str(path), chunk=1 << 16)
    assert h == jhashing.calculate_hash(str(path))
    assert hashing.pretty_hash(h) == jhashing.pretty_hash(h)
    assert hashing.reduced_hash(21, 10) == jhashing.reduced_hash(21, 10)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_native_codec_matches(group):
    assert native.available()
    rng = random.Random(9)
    pts = [_pair(group, rng.randrange(1, field.R_MOD))[0] for _ in range(6)]
    q_be = field.Q.to_bytes(32, "big")
    for compressed in (True, False):
        raw = b"".join(curve.point_to_bytes(p, compressed) for p in pts)
        ncoords = (1 if group == "g1" else 2) * (1 if compressed else 2)
        got = native.decode_digits(raw, len(pts), ncoords, 16, q_be, reject_greatest=not compressed)
        want = jnative.decode_digits(raw, len(pts), ncoords, 16, q_be, reject_greatest=not compressed)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        digits = got[0].reshape(len(pts), -1)
        greatest = got[1].astype(np.uint32)[:, None]
        packed = np.ascontiguousarray(np.concatenate([digits, greatest], axis=1), dtype=np.uint32)
        cols = list(range(0, 16 * ncoords, 16))
        gcol = packed.shape[1] - 1 if compressed else -1
        enc = native.encode_digits(packed, cols, 16, greatest_col=gcol)
        assert np.array_equal(enc, jnative.encode_digits(packed, cols, 16, greatest_col=gcol))
        assert enc.tobytes() == raw


def test_glv_gls_splits_match():
    rng = random.Random(11)
    for k in [0, 1, field.R_MOD - 1, glv.LAMBDA] + [rng.randrange(field.R_MOD) for _ in range(20)]:
        assert glv.decompose(k) == jglv.decompose(k)
        assert gls.decompose(k) == jgls.decompose(k)


def test_same_ratio_matches():
    """A true pair (a, a x) ~ (g, g x) and a false one, in both copies."""
    x = 1234567
    g1, j1 = _pair("g1", 77)
    g2, j2 = _pair("g2", 5)
    g1x, j1x = _pair("g1", 77 * x)
    g2x, j2x = _pair("g2", 5 * x)
    g2y, j2y = _pair("g2", 5 * (x + 1))
    assert pairing.same_ratio((g1, g1x), (g2, g2x)) and jpairing.same_ratio((j1, j1x), (j2, j2x))
    assert not pairing.same_ratio((g1, g1x), (g2, g2y)) and not jpairing.same_ratio((j1, j1x), (j2, j2y))


# modules of the port that are the JAX package's code unchanged (their
# docstrings differ: each names its original), and the Solidity template
COPIES = ["groth16/cs.py", "groth16/containers.py", "groth16/source.py", "groth16/verifier.py", "phase2/circom.py",
          "phase2/solidity.py", "phase2/verifier_template.sol", "bls12_381/curve.py", "bls12_381/glv.py"]
# modules of the port that are a leading part of their original's code:
# rel -> the names that only the original's remaining statements define
PREFIX_COPIES = {"bls12_381/field.py": {"Fq6", "Fq12", "FQ6_ZERO", "FQ6_ONE", "FQ12_ZERO", "FQ12_ONE",
                                        "FROBENIUS_COEFF_FQ6_C1", "FROBENIUS_COEFF_FQ6_C2",
                                        "FROBENIUS_COEFF_FQ12_C1"}}
# the Solidity template's header lines that say where its upstream
# counterpart lies: the port's copy names it as a path of the upstream
# repository, the original as a local path; every other line is the same
TEMPLATE_ORIGIN = slice(3, 5)


def _tree(path: str) -> ast.Module:
    """The module's ast without docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _code(path: str) -> str:
    """The module's ast without docstrings; the Solidity template's text
    without its TEMPLATE_ORIGIN comment lines."""
    if path.endswith(".sol"):
        with open(path) as f:
            lines = f.read().splitlines(keepends=True)
        assert all(line.startswith("//") for line in lines[TEMPLATE_ORIGIN])
        del lines[TEMPLATE_ORIGIN]
        return "".join(lines)
    return ast.dump(_tree(path))


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_original(rel):
    assert _code(os.path.join(REPO, "phase2_bn254_tpu_torch", rel)) == _code(os.path.join(REPO, "phase2_bn254_tpu", rel))


@pytest.mark.parametrize("rel", sorted(PREFIX_COPIES))
def test_prefix_copy_matches_original(rel):
    """The copy's statements are its original's first ones, unchanged, and
    the original's others define only the names PREFIX_COPIES lists."""
    mine = _tree(os.path.join(REPO, "phase2_bn254_tpu_torch", rel)).body
    theirs = _tree(os.path.join(REPO, "phase2_bn254_tpu", rel)).body
    assert [ast.dump(n) for n in mine] == [ast.dump(n) for n in theirs[: len(mine)]]
    rest = set()
    for node in theirs[len(mine):]:
        if isinstance(node, ast.ClassDef):
            rest.add(node.name)
        else:
            assert isinstance(node, ast.Assign), ast.dump(node)
            rest |= {t.id for t in node.targets}
    assert rest == PREFIX_COPIES[rel]



def _sources():
    pkg = os.path.join(REPO, "phase2_bn254_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = {"jax", "jaxlib", "phase2_bn254_tpu"}
    found = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names if n.split(".")[0] in banned]
    assert not found, found
    walked = {os.path.relpath(p, REPO) for p in _sources()}
    assert len(walked) > 30  # the walk found the package
    assert {f"phase2_bn254_tpu_torch/bls12_381/{m}.py" for m in ("field", "curve", "device", "codecs_device")} <= walked
