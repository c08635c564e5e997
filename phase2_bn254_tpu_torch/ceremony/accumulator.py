"""Batched powers-of-tau accumulator: generate / transform / verify / decompress.

Backend-agnostic port-free reimplementation of
powersoftau/src/batched_accumulator.rs. Bulk point math is
delegated to a pluggable backend (exact host backend for golden tests, JAX/TPU
backend for production); file bytes are identical either way.

File layout: see ceremony.params.CeremonyParams.position.

The port's own copy of `phase2_bn254_tpu/ceremony/accumulator.py`: imports
changed, and `SameRatioBatch` keeps only its host flush (the JAX package's
device pairing batch imports jax). file:line citations of `.rs` files are to
the upstream Rust repository.
"""

from __future__ import annotations

import logging
from typing import BinaryIO

from ..refimpl import curve as rc
from ..refimpl.pairing import same_ratio
from .keypair import PrivateKey, PublicKey, compute_g2_s
from .params import CeremonyParams

log = logging.getLogger(__name__)

_G1_KINDS = ("tau_g1", "alpha_g1", "beta_g1")


def _group_of(kind: str) -> str:
    return "g2" if kind in ("tau_g2", "beta_g2") else "g1"


def _read_elements(
    f: BinaryIO, params: CeremonyParams, kind: str, start: int, count: int, compressed: bool
) -> bytes:
    esize = params.element_size(kind, compressed)
    f.seek(params.position(kind, start, compressed))
    raw = f.read(esize * count)
    assert len(raw) == esize * count, f"short read for {kind}[{start}:{start + count}]"
    return raw


def _write_elements(
    f: BinaryIO, params: CeremonyParams, kind: str, start: int, raw: bytes, compressed: bool
) -> None:
    f.seek(params.position(kind, start, compressed))
    f.write(raw)


def generate_initial(f: BinaryIO, params: CeremonyParams, compressed: bool = False) -> None:
    """All-generator initial accumulator (batched_accumulator.rs:1295-1347).

    Every element is the G1/G2 generator, so this is pure byte replication -
    no backend needed.
    """
    g1 = rc.point_to_bytes(rc.G1_GEN, compressed)
    g2 = rc.point_to_bytes(rc.G2_GEN, compressed)
    _write_elements(f, params, "tau_g1", 0, g1 * params.powers_g1_length, compressed)
    _write_elements(f, params, "tau_g2", 0, g2 * params.powers_length, compressed)
    _write_elements(f, params, "alpha_g1", 0, g1 * params.powers_length, compressed)
    _write_elements(f, params, "beta_g1", 0, g1 * params.powers_length, compressed)
    _write_elements(f, params, "beta_g2", 0, g2, compressed)


def transform(
    fin: BinaryIO,
    fout: BinaryIO,
    params: CeremonyParams,
    key: PrivateKey,
    backend,
    input_compressed: bool = False,
    output_compressed: bool = True,
    check_input: bool = False,
) -> None:
    """Multiply element i by tau^i (and alpha/beta coefficients)
    (batched_accumulator.rs:1119-1292).

    Software-pipelined: chunk i+1 is decoded and its device work launched
    (async dispatch) before chunk i's results are pulled back and encoded,
    overlapping transfers/host byte-swizzles with device compute.
    """

    def launch(region_kinds, start, size):
        outs = []
        for kind, coeff in region_kinds:
            raw = _read_elements(fin, params, kind, start, size, input_compressed)
            batch = backend.decode(raw, _group_of(kind), size, input_compressed, check_input)
            outs.append((kind, backend.pow_mul(batch, key.tau, start, coeff)))
        return start, outs

    def flush(pending):
        start, outs = pending
        for kind, batch in outs:
            _write_elements(
                fout, params, kind, start, backend.encode(batch, output_compressed), output_compressed
            )
        log.info("transform: wrote chunk at %d", start)

    low_kinds = (
        ("tau_g1", None),
        ("tau_g2", None),
        ("alpha_g1", key.alpha),
        ("beta_g1", key.beta),
    )
    high_kinds = (("tau_g1", None),)
    work = [("low", s, z) for s, z in params.chunks("low")] + [
        ("high", s, z) for s, z in params.chunks("high")
    ]

    pending = None
    for region, start, size in work:
        kinds = low_kinds if region == "low" else high_kinds
        nxt = launch(kinds, start, size)
        if pending is not None:
            flush(pending)
        pending = nxt
        if region == "low" and start == 0:
            # beta_g2 ^= beta (written once; host math, O(1))
            raw = _read_elements(fin, params, "beta_g2", 0, 1, input_compressed)
            beta_g2 = rc.point_from_bytes(raw, "g2", input_compressed, check=check_input)
            beta_g2 = beta_g2.mul(key.beta)
            assert not beta_g2.is_zero(), "contribution produced infinity, re-run"
            _write_elements(
                fout, params, "beta_g2", 0, rc.point_to_bytes(beta_g2, output_compressed), output_compressed
            )
    if pending is not None:
        flush(pending)


def _power_pairs_check(backend, batch, g2_pair: tuple[rc.Point, rc.Point]) -> bool:
    """same_ratio(power_pairs(v), g2_pair)
    (powersoftau/src/utils.rs:112-135): random linear
    combination of v[:-1] vs v[1:] with shared coefficients."""
    s, sx = backend.power_pairs(batch)
    return same_ratio((s, sx), g2_pair)


def _power_pairs_check_g2(backend, batch, g1_pair: tuple[rc.Point, rc.Point]) -> bool:
    s, sx = backend.power_pairs(batch)
    return _same_ratio_g2((s, sx), g1_pair)


def _same_ratio_g2(g2s: tuple[rc.Point, rc.Point], g1_pair: tuple[rc.Point, rc.Point]) -> bool:
    s, sx = g2s
    # same_ratio with G2 on the left swaps pairing sides
    if s.is_zero() or sx.is_zero() or g1_pair[0].is_zero() or g1_pair[1].is_zero():
        return False
    from ..refimpl.pairing import pairing

    return pairing(g1_pair[1], s) == pairing(g1_pair[0], sx)


class SameRatioBatch:
    """Queue same-ratio checks and evaluate them together on the host.

    Each same_ratio((a,b),(c,d)) is e(a,d) == e(b,c): two pairings. The JAX
    package can run the queue as one device pairing batch; the port keeps
    only the host pairings (the device batch is still to be ported), with
    the same result: pass, or the first failing label.

    Zero-point rejection happens at add() time, mirroring
    refimpl.pairing.same_ratio (utils.rs:151-159)."""

    def __init__(self):
        self.items: list[tuple[str, tuple, tuple]] = []  # (label, (a,d), (b,c))
        self.zero_failure: str | None = None

    def add(self, label: str, g1_pair, g2_pair) -> None:
        a, b = g1_pair
        c, d = g2_pair
        if any(p.is_zero() for p in (a, b, c, d)):
            self.zero_failure = self.zero_failure or label
            return
        self.items.append((label, (a, d), (b, c)))

    def add_g2(self, label: str, g2s, g1_pair) -> None:
        """same-ratio with the G2 elements on the ratio side (swaps which
        group feeds each pairing slot)."""
        s, sx = g2s
        if any(p.is_zero() for p in (s, sx, g1_pair[0], g1_pair[1])):
            self.zero_failure = self.zero_failure or label
            return
        self.items.append((label, (g1_pair[1], s), (g1_pair[0], sx)))

    def flush(self) -> str | None:
        """Evaluate every queued check; returns the first failing label (or
        the first zero-rejected one), None when all pass."""
        if not self.items:
            return self.zero_failure
        failing = self._flush_host()
        if failing is not None:
            return failing
        self.items = []
        if self.zero_failure:
            log.error("%s rejected: point at infinity", self.zero_failure)
        return self.zero_failure

    def _flush_host(self) -> str | None:
        from ..refimpl.pairing import pairing as host_pairing

        for label, (a, d), (b, c) in self.items:
            if host_pairing(a, d) != host_pairing(b, c):
                log.error("%s ratio mismatch", label)
                return label
        return None


class _RatioAccumulator:
    """Cross-chunk batching of power_pairs same-ratio checks.

    The reference runs two pairings per chunk per element kind
    (powersoftau/src/batched_accumulator.rs:427-455); at
    2^26 / batch 2^16 that is ~8000 pairings of host work. Every chunk of a
    kind checks the SAME ratio (tau, alpha*tau, ... against the same
    g2/g1 pair), so a second random-linear-combination layer is sound by
    Schwartz-Zippel: accumulate r_k-weighted chunk pairs and run ONE
    same_ratio per kind. On failure, fall back to per-chunk checks so the
    offending chunk is still reported."""

    def __init__(self, label: str, group: str = "g1"):
        self.label = label
        self.acc_s = rc.point_zero(group)
        self.acc_sx = rc.point_zero(group)
        self.chunks: list[tuple[int, rc.Point, rc.Point]] = []

    def add(self, start: int, s: rc.Point, sx: rc.Point) -> None:
        import secrets

        r = 1 + secrets.randbelow(rc.R_MOD - 1)
        self.acc_s = self.acc_s.add(s.mul(r))
        self.acc_sx = self.acc_sx.add(sx.mul(r))
        self.chunks.append((start, s, sx))

    def check(self, pair, g2_side: bool = False) -> bool:
        ok = (
            _same_ratio_g2((self.acc_s, self.acc_sx), pair)
            if g2_side
            else same_ratio((self.acc_s, self.acc_sx), pair)
        )
        if ok:
            return True
        for start, s, sx in self.chunks:
            chunk_ok = (
                _same_ratio_g2((s, sx), pair) if g2_side else same_ratio((s, sx), pair)
            )
            if not chunk_ok:
                log.error("%s power_pairs failed at chunk %d", self.label, start)
                return False
        log.error("%s combined power_pairs failed (no single chunk isolated)", self.label)
        return False


def verify_transformation(
    fin: BinaryIO,
    fout: BinaryIO,
    pubkey: PublicKey,
    digest: bytes,
    params: CeremonyParams,
    backend,
    input_compressed: bool = False,
    output_compressed: bool = True,
    check_input: bool = False,
    check_output: bool = True,
) -> bool:
    """batched_accumulator.rs:277-541. `digest` is the challenge-file hash."""
    assert len(digest) == 64

    tau_g2_s = compute_g2_s(digest, pubkey.tau_g1[0], pubkey.tau_g1[1], 0)
    alpha_g2_s = compute_g2_s(digest, pubkey.alpha_g1[0], pubkey.alpha_g1[1], 1)
    beta_g2_s = compute_g2_s(digest, pubkey.beta_g1[0], pubkey.beta_g1[1], 2)


    # proofs of knowledge for tau/alpha/beta + header update ratios, queued
    # into one pairing batch
    heads = SameRatioBatch()
    heads.add("tau PoK", pubkey.tau_g1, (tau_g2_s, pubkey.tau_g2))
    heads.add("alpha PoK", pubkey.alpha_g1, (alpha_g2_s, pubkey.alpha_g2))
    heads.add("beta PoK", pubkey.beta_g1, (beta_g2_s, pubkey.beta_g2))

    def head(f, compressed, check, kind, count=2):
        raw = _read_elements(f, params, kind, 0, count, compressed)
        esize = params.element_size(kind, compressed)
        return [
            rc.point_from_bytes(raw[i * esize : (i + 1) * esize], _group_of(kind), compressed, check)
            for i in range(count)
        ]

    b_tau_g1 = head(fin, input_compressed, check_input, "tau_g1")
    a_tau_g1 = head(fout, output_compressed, check_output, "tau_g1")
    a_tau_g2 = head(fout, output_compressed, check_output, "tau_g2")
    b_alpha = head(fin, input_compressed, check_input, "alpha_g1", 1)
    a_alpha = head(fout, output_compressed, check_output, "alpha_g1", 1)
    b_beta = head(fin, input_compressed, check_input, "beta_g1", 1)
    a_beta = head(fout, output_compressed, check_output, "beta_g1", 1)
    b_beta_g2 = head(fin, input_compressed, check_input, "beta_g2", 1)[0]
    a_beta_g2 = head(fout, output_compressed, check_output, "beta_g2", 1)[0]

    if a_tau_g1[0] != rc.G1_GEN:
        log.error("tau_powers_g1[0] != generator")
        return False
    if a_tau_g2[0] != rc.G2_GEN:
        log.error("tau_powers_g2[0] != generator")
        return False
    heads.add("tau update", (b_tau_g1[1], a_tau_g1[1]), (tau_g2_s, pubkey.tau_g2))
    heads.add("alpha update", (b_alpha[0], a_alpha[0]), (alpha_g2_s, pubkey.alpha_g2))
    heads.add("beta update", (b_beta[0], a_beta[0]), (beta_g2_s, pubkey.beta_g2))
    heads.add("beta_g2 update", (b_beta[0], a_beta[0]), (b_beta_g2, a_beta_g2))
    if heads.flush() is not None:
        return False  # fail before the chunk sweep, as the reference does

    g2_pair = (a_tau_g2[0], a_tau_g2[1])
    g1_pair = (a_tau_g1[0], a_tau_g1[1])

    # chunked power_pairs spot checks with one-element overlap; per-chunk
    # MSMs feed cross-chunk ratio accumulators (one pairing check per kind
    # at the end instead of two pairings per chunk)
    accs = {
        "tau_g1": _RatioAccumulator("tau_g1"),
        "tau_g2": _RatioAccumulator("tau_g2", group="g2"),
        "alpha_g1": _RatioAccumulator("alpha_tau_g1"),
        "beta_g1": _RatioAccumulator("beta_tau_g1"),
    }
    seam = [None, None]
    for start, size in params.chunks("low"):
        end = start + size - 1
        rsize = size + (0 if end == params.powers_length - 1 else 1)
        for kind in ("tau_g1", "tau_g2", "alpha_g1", "beta_g1"):
            raw = _read_elements(fout, params, kind, start, rsize, output_compressed)
            batch = backend.decode(
                raw, _group_of(kind), rsize, output_compressed, check_output
            )
            s, sx = backend.power_pairs(batch)
            accs[kind].add(start, s, sx)
            if kind == "tau_g1" and end == params.powers_length - 1:
                seam[0] = backend.last_point(batch)
        log.info("verify: low region processed up to %d", end)

    for start, size in params.chunks("high"):
        end = start + size - 1
        rsize = size + (0 if end == params.powers_g1_length - 1 else 1)
        raw = _read_elements(fout, params, "tau_g1", start, rsize, output_compressed)
        batch = backend.decode(raw, "g1", rsize, output_compressed, check_output)
        s, sx = backend.power_pairs(batch)
        accs["tau_g1"].add(start, s, sx)
        if start == params.powers_length:
            seam[1] = backend.first_point(batch)
        log.info("verify: high region processed up to %d", end)

    # seam between the two regions (batched_accumulator.rs:533-539)
    seam_batch = backend.from_points(seam, "g1")
    s, sx = backend.power_pairs(seam_batch)
    accs["tau_g1"].add(-1, s, sx)  # chunk id -1 = region seam

    # combined power_pairs ratios, one pairing batch for all four kinds
    tails = SameRatioBatch()
    for kind, acc in accs.items():
        if kind == "tau_g2":
            tails.add_g2(f"{acc.label} power_pairs", (acc.acc_s, acc.acc_sx), g1_pair)
        else:
            tails.add(f"{acc.label} power_pairs", (acc.acc_s, acc.acc_sx), g2_pair)
    if tails.flush() is not None:
        # localize the failure: per-chunk host fallback per kind
        for kind, acc in accs.items():
            if not acc.check(g1_pair if kind == "tau_g2" else g2_pair, g2_side=kind == "tau_g2"):
                return False
        return False
    return True


def decompress(
    fin: BinaryIO, fout: BinaryIO, params: CeremonyParams, backend, check_input: bool = False
) -> None:
    """Compressed response -> uncompressed new challenge
    (batched_accumulator.rs:543-618)."""
    for start, size in params.chunks("low"):
        for kind in ("tau_g1", "tau_g2", "alpha_g1", "beta_g1"):
            raw = _read_elements(fin, params, kind, start, size, True)
            batch = backend.decode(raw, _group_of(kind), size, True, check_input)
            _write_elements(fout, params, kind, start, backend.encode(batch, False), False)
        if start == 0:
            raw = _read_elements(fin, params, "beta_g2", 0, 1, True)
            p = rc.point_from_bytes(raw, "g2", True, check=check_input)
            _write_elements(fout, params, "beta_g2", 0, rc.point_to_bytes(p, False), False)
    for start, size in params.chunks("high"):
        raw = _read_elements(fin, params, "tau_g1", start, size, True)
        batch = backend.decode(raw, "g1", size, True, check_input)
        _write_elements(fout, params, "tau_g1", start, backend.encode(batch, False), False)
