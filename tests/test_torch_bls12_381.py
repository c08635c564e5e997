"""The port's BLS12-381 engine on the CPU, against the JAX package's host
layer.

The JAX package's own BLS device tests spend minutes in XLA compiles, so
these call no JAX-jitted function. They hold the port against what those
tests hold `pallas_batch_mul` and `decode_batch` to: the exact host layer
`phase2_bn254_tpu.bls12_381.field` / `curve` (Python integers), and the
JAX package's `device.points_to_batch` numpy limbs for the layout.

* Fq and Fq2 at 24 x 16-bit limbs (R = 2^384): product, square, sum,
  difference, negation, conversions, inverses, powers, on the edge operands
  of `ops.fieldops.edge_pairs` / `edge_pairs_fq2` and seeded random ones;
* host points <-> AffineBatch against `device.points_to_batch`, and the JAX
  package's uint32 limbs through `convert`;
* the plain K8-BLS / K9-BLS ladders (the wrappers on the CPU), through the
  port's `device.ladder`, on the scalars 0, 1, 2, (r - 1)/2, (r + 1)/2, r -
  1, 16^j and a random one, plus a lane whose input is at infinity (it gives
  infinity, where the JAX package's `pallas_batch_mul` does not: ROADMAP
  queue 3), against host `Point.mul`; `device.batch_mul` (the group law)
  and `windowed_batch_mul` likewise;
* the CUDA sources' per-point K8-BLS / K9-BLS functions compiled with g++
  against the plain versions, limb for limb;
* decode / encode, compressed and uncompressed, G1 and G2, against the host
  codecs, and every rejection of the JAX package's `decode_batch`
  (codecs_device.py:175-215): a missing or stray compression flag, a sort
  flag on an uncompressed point, an infinity flag, a coordinate >= q, an
  off-curve point and a non-residue x;
* the slice as a whole: zcash bytes -> decode -> ladder -> normalize ->
  encode, byte for byte against the host chain.

The kernels on a card: tests/test_torch_bls12_381_gpu.py. Inputs from seeded
generators; tolerance zero (exact equality of limbs, integers and bytes).
"""

import ctypes
import os
import random
import subprocess

import numpy as np
import pytest
import torch

from phase2_bn254_tpu.bls12_381 import curve as jcurve
from phase2_bn254_tpu.bls12_381 import field as jfield
from phase2_bn254_tpu_torch import convert
from phase2_bn254_tpu_torch.bls12_381 import codecs_device as C
from phase2_bn254_tpu_torch.bls12_381 import device as D
from phase2_bn254_tpu_torch.curve import group as G
from phase2_bn254_tpu_torch.field import fp
from phase2_bn254_tpu_torch.field.fq2 import BLS_FQ, BLS_FQ2
from phase2_bn254_tpu_torch.ops import _build, batch_exp, fieldops

# Under pytest-xdist several worker processes share a few cores; torch's
# default of one OpenMP thread per core then oversubscribes them and slows
# every process many times over, so each worker keeps one torch thread.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module in any run: its tensors are a few
    dozen limbs wide, and a thread pool made them twice as slow on an 8-core
    CPU. The count is restored for the modules after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

Q, R = jfield.Q, jfield.R_MOD
CTX = fp.BLS_FQ_CTX
# the recoding's edges (k <= (r - 1)/2 as it is, above as (r - k)(-P)), a
# single window, a single high digit, and a random scalar
SCALARS = [0, 1, 2, (R - 1) // 2, (R + 1) // 2, R - 1, 16 ** 40, 16 ** 63 + 15]
INF_LANE = 3  # this lane's input point is at infinity
GENS = {"g1": jcurve.G1_GEN, "g2": jcurve.G2_GEN}
ENCODERS = {("g1", True): jcurve.g1_to_compressed, ("g1", False): jcurve.g1_to_uncompressed,
            ("g2", True): jcurve.g2_to_compressed, ("g2", False): jcurve.g2_to_uncompressed}


def _ints(seed: int, n: int, p: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 12), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]


def _mont(v: int) -> int:
    return jfield.to_mont_fq(v)


def _real(v: int) -> int:
    return jfield.from_mont_fq(v)


def _points(group: str, n: int, seed: str) -> list:
    """n random points of the group, from the JAX package's host layer."""
    rng = random.Random(seed)
    return [GENS[group].mul(rng.randrange(1, R)) for _ in range(n)]


def _host(points) -> list:
    """JAX-package host points -> the port's host points (the same values)."""
    from phase2_bn254_tpu_torch.bls12_381 import curve as pc
    from phase2_bn254_tpu_torch.bls12_381.field import Fq2

    def el(v):
        return v if isinstance(v, int) else Fq2(v.c0, v.c1)

    return [pc.point_zero(p.group) if p.inf else pc.Point(el(p.x), el(p.y), False, p.group) for p in points]


def _same_points(got, want) -> bool:
    """Port host points == JAX-package host points, by value."""
    def key(p):
        if p.inf:
            return None
        return tuple((v,) if isinstance(v, int) else (v.c0, v.c1) for v in (p.x, p.y))

    return [key(p) for p in got] == [key(p) for p in want]


# ---------------------------------------------------------------------------
# Fq and Fq2 at 24 limbs
# ---------------------------------------------------------------------------

def test_fq_ops_match_host_integers():
    """fp.py over the 24-limb context against the JAX package's integers
    (R = 2^384: `to_mont_fq` / `from_mont_fq`), on the edge pairs and random
    ones, Montgomery values throughout."""
    rng = random.Random("bls fq")
    pairs = fieldops.edge_pairs("bls_fq", rng)
    a_vals = [x for x, _ in pairs] + _ints(1, 24, Q)
    b_vals = [y for _, y in pairs] + _ints(2, 24, Q)
    a, b = (convert.ints_to_limbs(v, "cpu", 24) for v in (a_vals, b_vals))
    real = [(_real(x), _real(y)) for x, y in zip(a_vals, b_vals)]
    assert convert.limbs_to_ints(fp.mont_mul(CTX, a, b)) == [_mont(x * y % Q) for x, y in real]
    assert convert.limbs_to_ints(BLS_FQ.sqr(a)) == [_mont(x * x % Q) for x, _ in real]
    assert convert.limbs_to_ints(fp.add(CTX, a, b)) == [(x + y) % Q for x, y in zip(a_vals, b_vals)]
    assert convert.limbs_to_ints(fp.sub(CTX, a, b)) == [(x - y) % Q for x, y in zip(a_vals, b_vals)]
    assert convert.limbs_to_ints(fp.neg(CTX, a)) == [-x % Q for x in a_vals]
    assert convert.limbs_to_ints(fp.to_mont(CTX, a)) == [_mont(x) for x in a_vals]
    assert convert.limbs_to_ints(fp.from_mont(CTX, a)) == [_real(x) for x in a_vals]
    assert fp.gt(a, b).tolist() == [x > y for x, y in zip(a_vals, b_vals)]
    inv = convert.limbs_to_ints(fp.batch_inv(CTX, a[:40]))
    assert inv == [0 if x == 0 else _mont(jfield.inv(x, Q)) for x, _ in real[:40]]
    e = (1 << 40) + 0x1234567  # decode_batch's square roots take (q + 1) / 4
    assert convert.limbs_to_ints(fp.pow_fixed(CTX, a[:8], e)) == [_mont(pow(x, e, Q)) for x, _ in real[:8]]
    assert CTX.nlimbs == 24 and CTX.mont_bits == 384 and CTX.zeros((3,), "cpu").shape == (3, 24)


def test_fq2_ops_match_host_fq2():
    """field/fq2.py over the 24-limb context (BLS_FQ2) against the JAX
    package's host Fq2, on edge_pairs_fq2("bls_fq2") and random pairs."""
    rng = random.Random("bls fq2")
    pairs = fieldops.edge_pairs_fq2(rng, "bls_fq2") + [
        (fieldops.random_element("bls_fq2", rng), fieldops.random_element("bls_fq2", rng)) for _ in range(16)]
    a, b = (fieldops.to_limbs([p[k] for p in pairs], "bls_fq2", "cpu") for k in (0, 1))
    assert a.shape == (len(pairs), 2, 24)

    def host(v):
        return jfield.Fq2(_real(v[0]), _real(v[1]))

    def back(t):
        c0, c1 = convert.limbs_to_ints(t[:, 0]), convert.limbs_to_ints(t[:, 1])
        return [jfield.Fq2(_real(x), _real(y)) for x, y in zip(c0, c1)]

    ha, hb = [host(p[0]) for p in pairs], [host(p[1]) for p in pairs]
    assert back(BLS_FQ2.mul(a, b)) == [x * y for x, y in zip(ha, hb)]
    assert back(BLS_FQ2.sqr(a)) == [x.square() for x in ha]
    assert back(BLS_FQ2.add(a, b)) == [x + y for x, y in zip(ha, hb)]
    assert back(BLS_FQ2.sub(a, b)) == [x - y for x, y in zip(ha, hb)]
    assert back(BLS_FQ2.neg(a)) == [-x for x in ha]
    assert back(BLS_FQ2.conjugate(a)) == [x.conjugate() for x in ha]
    assert BLS_FQ2.gt(fp.from_mont(CTX, a), fp.from_mont(CTX, b)).tolist() == [x.gt(y) for x, y in zip(ha, hb)]
    live = [i for i, x in enumerate(ha) if not x.is_zero()][:12]
    assert back(BLS_FQ2.batch_inv(a[live])) == [ha[i].inverse() for i in live]
    e = (1 << 40) + 0x1234567  # decode_batch's square roots take (q - 3) / 4 and (q - 1) / 2
    assert back(BLS_FQ2.pow_fixed(a[live[:4]], e)) == [ha[i].pow(e) for i in live[:4]]


# ---------------------------------------------------------------------------
# layout: host points <-> tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", ["g1", "g2"])
def test_points_to_batch_matches_jax_layout(group):
    """device.points_to_batch against the JAX package's (numpy of its uint32
    arrays, no jit), an infinity point included; back through
    batch_to_points, and the JAX limbs through convert.affine_from_numpy /
    affine_to_numpy."""
    from phase2_bn254_tpu.bls12_381 import device as jdevice

    pts = _points(group, 4, f"layout {group}") + [jcurve.point_zero(group)]
    mine = D.points_to_batch(_host(pts), group, "cpu")
    theirs = jdevice.points_to_batch(pts, group)
    jx, jy, jinf = (np.asarray(t) for t in theirs)
    assert mine.x.shape == ((5, 24) if group == "g1" else (5, 2, 24))
    assert np.array_equal(mine.x.numpy(), jx.astype(np.int64)) and np.array_equal(mine.y.numpy(), jy.astype(np.int64))
    assert mine.inf.tolist() == jinf.tolist() == [False] * 4 + [True]
    assert _same_points(D.batch_to_points(mine, group), pts)
    batch = convert.affine_from_numpy(jx, jy, jinf, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(batch, mine))
    assert all(np.array_equal(a, b) for a, b in zip(convert.affine_to_numpy(batch), (jx, jy, jinf)))
    assert D.scalars_to_canon([R + 5, R - 1], "cpu").tolist() == [fp.int_to_limbs(5), fp.int_to_limbs(R - 1)]


# ---------------------------------------------------------------------------
# the windowed ladders and the slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slices():
    """Per group, the slice on the CPU: random points (lane INF_LANE at
    infinity), their compressed bytes decoded by decode_batch (the finite
    lanes), the ladder (device.ladder: the K8-BLS / K9-BLS wrapper, plain on
    the CPU) on SCALARS, normalized."""
    out = {}
    for group in ("g1", "g2"):
        pts = _points(group, len(SCALARS), f"slice {group}")
        pts[INF_LANE] = jcurve.point_zero(group)
        fin = [p for p in pts if not p.inf]
        raw = b"".join(ENCODERS[group, True](p) for p in fin)
        dec = C.decode_batch(raw, group, len(fin), True, device="cpu")
        full = D.points_to_batch(_host(pts), group, "cpu")
        lanes = torch.tensor([i for i, p in enumerate(pts) if not p.inf])
        for t, d in zip(full[:2], dec[:2]):
            t[lanes] = d  # the decoded finite lanes, the infinity lane as (0, 1)
        k = D.scalars_to_canon(SCALARS, "cpu")
        jac = D.ladder(full, k, group)
        out[group] = {"pts": pts, "batch": full, "k": k, "jac": jac,
                      "aff": G.jac_normalize(D.field_ops(group), jac), "raw": raw}
    return out


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_windowed_ladder_matches_host_mul(slices, group):
    """K8-BLS / K9-BLS through device.ladder + normalize == host Point.mul,
    on the edge scalars; the infinity lane gives infinity."""
    s = slices[group]
    got = D.batch_to_points(s["aff"], group)
    assert _same_points(got, [p.mul(k) for p, k in zip(s["pts"], SCALARS)])
    assert got[INF_LANE].inf and s["aff"].inf.tolist() == [k == 0 or i == INF_LANE for i, k in enumerate(SCALARS)]
    recoded, neg = batch_exp.half_recode(s["k"], R)
    assert neg.tolist() == [k > (R - 1) // 2 for k in SCALARS]
    assert convert.limbs_to_ints(recoded) == [min(k, R - k) if k else 0 for k in SCALARS]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_slice_bytes_match_host_chain(slices, group):
    """zcash bytes -> decode_batch -> ladder -> normalize -> encode_batch ==
    host decode, Point.mul, host encode, on every lane whose result is
    finite; encode_batch refuses the lanes at infinity."""
    s = slices[group]
    fin = [i for i, inf in enumerate(s["aff"].inf.tolist()) if not inf]
    aff = G.AffineBatch(*(t[fin] for t in s["aff"]))
    decode = jcurve.g1_from_compressed if group == "g1" else jcurve.g2_from_compressed
    size = 48 if group == "g1" else 96
    host_in = [decode(s["raw"][j * size : (j + 1) * size], check=False) for j in range(len(s["raw"]) // size)]
    host_in.insert(INF_LANE, jcurve.point_zero(group))
    want = b"".join(ENCODERS[group, True](host_in[i].mul(SCALARS[i])) for i in fin)
    assert C.encode_batch(aff, group, True) == want
    with pytest.raises(ValueError, match="infinity"):
        C.encode_batch(s["aff"], group, True)


def test_batch_mul_and_windowed_batch_mul_match_host():
    """device.batch_mul (the group law, as the JAX package's batch_mul) and
    windowed_batch_mul (K8-BLS / K9-BLS on host points, the counterpart of
    its pallas_batch_mul) == host Point.mul, an infinity input and the
    scalars 0 and 1 among them. The scalars stay below 2^40 (10 windows):
    each window costs the plain group law a second here, and the full width
    runs in the slice above."""
    for group in ("g1", "g2"):
        pts = _points(group, 3, f"batch_mul {group}") + [jcurve.point_zero(group)]
        vals = [0, (1 << 38) + 12345, 1, 0xF00F]
        want = [p.mul(k) for p, k in zip(pts, vals)]
        assert _same_points(D.batch_mul(_host(pts), vals, group, device="cpu"), want)
        assert _same_points(D.windowed_batch_mul(_host(pts), vals, group, device="cpu"), want)


_HOST_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include "batch_exp_g1_windowed.cu"
#include "batch_exp_g2_windowed.cu"
extern "C" void host_bls_k8(const int64_t* x, const int64_t* y, const int64_t* k, int64_t* ox, int64_t* oy,
                            int64_t* oz, int n) {
  for (int i = 0; i < n; ++i) batch_exp_bls_g1_windowed_point(x, y, k, ox, oy, oz, i);
}
extern "C" void host_bls_k9(const int64_t* x, const int64_t* y, const int64_t* k, int64_t* ox, int64_t* oy,
                            int64_t* oz, int n) {
  for (int i = 0; i < n; ++i) batch_exp_bls_g2_windowed_point(x, y, k, ox, oy, oz, i);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("bls_ladder_shim")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(d / "shim.so")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(d / "shim.so"))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_cuda_sources_bls_ladder_on_host_matches_plain(slices, host_lib, group):
    """csrc/batch_exp_g1_windowed.cu / batch_exp_g2_windowed.cu's BLS
    instantiations (windowed_ladder_point<BFp / BFp2, Bls12381Scalars>,
    field.cuh's 12-limb C++ path) compiled by g++, limb for limb with the
    plain version on the slice's finite lanes."""
    s = slices[group]
    b, k = s["batch"], s["k"]
    out = [torch.empty_like(b.x) for _ in range(3)]
    fn = host_lib.host_bls_k8 if group == "g1" else host_lib.host_bls_k9
    fn(*[ctypes.c_void_p(t.data_ptr()) for t in (b.x, b.y, k, *out)], ctypes.c_int(k.shape[0]))
    live = ~b.inf
    assert all(torch.equal(o[live], w[live]) for o, w in zip(out, s["jac"]))


# ---------------------------------------------------------------------------
# the device codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("compressed", [True, False], ids=["compressed", "uncompressed"])
def test_codec_round_trip_matches_host(group, compressed):
    """decode_batch == the host decoder's points, and encode_batch gives the
    input bytes back (both y orders occur among the points)."""
    pts = _points(group, 4, f"codec {group}")
    flag = [ENCODERS[group, True](p)[0] & 0x20 for p in pts]
    if flag[1] == flag[0]:
        pts[1] = pts[1].neg()
    raw = b"".join(ENCODERS[group, compressed](p) for p in pts)
    batch = C.decode_batch(raw, group, len(pts), compressed, device="cpu")
    assert _same_points(D.batch_to_points(batch, group), pts)
    assert C.encode_batch(batch, group, compressed) == raw
    flags = {b[0] & 0x20 for b in (ENCODERS[group, True](p) for p in pts)}
    assert flags == {0, 0x20}


def _non_residue_x(group: str) -> bytes:
    """The compressed bytes of an x with no point on the curve (the host's
    get_point_from_x finds none)."""
    rng = random.Random(f"non-residue {group}")
    while True:
        if group == "g1":
            x = rng.randrange(Q)
            if jcurve.get_point_from_x(x, False, "g1") is None:
                return bytes([x.to_bytes(48, "big")[0] | 0x80]) + x.to_bytes(48, "big")[1:]
        else:
            x = jfield.Fq2(rng.randrange(Q), rng.randrange(Q))
            if jcurve.get_point_from_x(x, False, "g2") is None:
                raw = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
                raw[0] |= 0x80
                return bytes(raw)


def _tampered(group: str, compressed: bool, case: str) -> bytes:
    """Two valid encodings, the second changed as `case` says."""
    pts = _points(group, 2, f"tamper {group}")
    enc = [bytearray(ENCODERS[group, compressed](p)) for p in pts]
    t = enc[1]
    if case == "flag":  # compressed: its flag cleared; uncompressed: a stray one
        t[0] ^= 0x80
    elif case == "sort":
        t[0] |= 0x20
    elif case == "infinity":
        t[0] |= 0x40
    elif case == "coordinate":  # x (c1 first on G2) = q
        t[:48] = Q.to_bytes(48, "big")
        t[0] |= 0x80 if compressed else 0
    elif case == "off_curve":  # y + 1
        y = int.from_bytes(t[-48:], "big")
        t[-48:] = ((y + 1) % Q).to_bytes(48, "big")
    elif case == "non_residue":
        t[:] = _non_residue_x(group)
    return bytes(enc[0] + t)


REJECTIONS = [  # (case, compressed, the message decode_batch raises)
    ("flag", True, "compressed bit not set"),
    ("flag", False, "compressed bit set on uncompressed"),
    ("sort", False, "sort bit set on uncompressed"),
    ("infinity", True, "point at infinity"),
    ("infinity", False, "point at infinity"),
    ("coordinate", True, "not below field modulus"),
    ("coordinate", False, "not below field modulus"),
    ("off_curve", False, "off curve or non-residue"),
    ("non_residue", True, "off curve or non-residue"),
]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("case,compressed,message", REJECTIONS,
                         ids=[f"{c}-{'compressed' if z else 'uncompressed'}" for c, z, _ in REJECTIONS])
def test_decode_rejects_what_the_jax_package_rejects(group, case, compressed, message):
    """Each tampered batch raises with the JAX package's message; the host
    decoder refuses the tampered point too. No subgroup check: a point of
    the curve outside the r-torsion decodes (as in the JAX package)."""
    raw = _tampered(group, compressed, case)
    with pytest.raises(ValueError, match=message):
        C.decode_batch(raw, group, 2, compressed, device="cpu")
    size = len(raw) // 2
    decode = {("g1", True): jcurve.g1_from_compressed, ("g1", False): jcurve.g1_from_uncompressed,
              ("g2", True): jcurve.g2_from_compressed, ("g2", False): jcurve.g2_from_uncompressed}[group, compressed]
    with pytest.raises((ValueError, AssertionError)):
        point = decode(raw[size:], check=False) if case != "off_curve" else decode(raw[size:])
        assert not point.inf  # the host reads an infinity flag as the point at infinity


def test_decode_makes_no_subgroup_check():
    """A G1 point on the curve but outside the r-order subgroup decodes, as
    in the JAX package's decode_batch (the host decoder with check=True
    refuses it)."""
    rng = random.Random("cofactor")
    while True:
        p = jcurve.get_point_from_x(rng.randrange(Q), False, "g1")
        if p is not None and not p.in_subgroup():
            break
    raw = jcurve.g1_to_compressed(p)
    assert _same_points(D.batch_to_points(C.decode_batch(raw, "g1", 1, True, device="cpu"), "g1"), [p])
    with pytest.raises(ValueError, match="subgroup"):
        jcurve.g1_from_compressed(raw)
