"""prepare_phase2 and reduce_powers: the phase-1 -> phase-2 bridge
(counterpart of `phase2_bn254_tpu/ceremony/prepare.py`).

prepare_phase2 (powersoftau/src/bin/prepare_phase2.rs:27-242) reads a
compressed response, converts the tau-power point vectors into Lagrange
vectors by an inverse group NTT per degree, computes the Groth16 H-query
bases tau^(i+m) - tau^i, and writes one `phase1radix2m{m}` file per degree
m:

    alpha_g1[0] || beta_g1[0] || beta_g2
    || Lagrange G1 (2^m) || Lagrange G2 (2^m)
    || Lagrange alpha G1 (2^m) || Lagrange beta G1 (2^m)
    || H bases (2^m - 1)           (all uncompressed)

The exact host backend (`refimpl.backend.ExactBackend`) keeps the JAX
package's in-memory path; a `TorchBackend` takes the streamed one: each
region decoded chunk by chunk (D1 on the device, the on-curve check
included) into host RAM, then per degree one `ceremony.streaming.
group_intt_streamed` call for the three G1 vectors (stacked) and one for
the G2 vector, which come back as the file's bytes (normalized and encoded
on the device), and the H bases in batch-size chunks through
`TorchBackend.sub_batches`.

reduce_powers truncates a larger uncompressed challenge to a smaller power
with a `reduced_hash(old, new)` header (reduce_powers.rs:22-131). As in the
JAX package it reads the original file at its original geometry: the
reference binary passes the reduced geometry to `deserialize` on the
original file, which mis-addresses every section after TauG1. File:line
citations of `.rs` files are to the upstream Rust repository.
"""

from __future__ import annotations

import os
from typing import BinaryIO

from .. import convert
from ..crypto.hashing import calculate_hash, pretty_hash, reduced_hash
from ..refimpl import curve as rc
from . import streaming
from .accumulator import _read_elements, _write_elements
from .params import CeremonyParams


def _group_of(kind: str) -> str:
    return "g2" if kind in ("tau_g2", "beta_g2") else "g1"


def _read_region(fin: BinaryIO, params: CeremonyParams, kind: str, backend, compressed: bool, check: bool):
    """Decode a full element region in batch_size chunks."""
    total = params.element_count(kind)
    parts = []
    for start in range(0, total, params.batch_size):
        size = min(params.batch_size, total - start)
        raw = _read_elements(fin, params, kind, start, size, compressed)
        parts.append(backend.decode(raw, _group_of(kind), size, compressed, check))
    return backend.concat(parts) if len(parts) > 1 else parts[0]


def _read_region_host(fin: BinaryIO, params: CeremonyParams, kind: str, backend, compressed: bool,
                      check: bool) -> streaming.HostPoints:
    """Decode a full element region chunk by chunk on the backend's device
    into host RAM (pinned where the device is a card)."""
    total = params.element_count(kind)
    region = streaming.host_empty(_group_of(kind), total, pin=backend.device.type == "cuda")
    for start in range(0, total, params.batch_size):
        size = min(params.batch_size, total - start)
        raw = _read_elements(fin, params, kind, start, size, compressed)
        streaming.pointset_to_host(backend.decode(raw, _group_of(kind), size, compressed, check),
                                   region.slice(start, start + size))
    return region


def _header(response_path: str, params: CeremonyParams) -> None:
    if os.path.getsize(response_path) != params.contribution_size:
        raise ValueError("response file has wrong size")


def prepare_phase2(response_path: str, size: int, batch: int, backend, out_dir: str = ".",
                   max_degree: int | None = None) -> list[str]:
    """Write phase1radix2m{m} files for m in 0..=size (or max_degree) into
    out_dir; returns their paths. ExactBackend: the in-memory path; any
    other backend (a TorchBackend): the streamed one."""
    if getattr(backend, "name", "") != "exact":
        return _prepare_phase2_streamed(response_path, size, batch, backend, out_dir, max_degree)
    params = CeremonyParams(size, batch)
    _header(response_path, params)

    with open(response_path, "rb") as fin:
        tau_g1 = _read_region(fin, params, "tau_g1", backend, True, True)
        tau_g2 = _read_region(fin, params, "tau_g2", backend, True, True)
        alpha_g1 = _read_region(fin, params, "alpha_g1", backend, True, True)
        beta_g1 = _read_region(fin, params, "beta_g1", backend, True, True)
        raw = _read_elements(fin, params, "beta_g2", 0, 1, True)
        beta_g2_pt = rc.point_from_bytes(raw, "g2", True)

    alpha0 = backend.first_point(alpha_g1)
    beta0 = backend.first_point(beta_g1)

    paths = []
    top = size if max_degree is None else max_degree
    for m in range(top + 1):
        degree = 1 << m
        name = os.path.join(out_dir, f"phase1radix2m{m}")
        lag_g1 = backend.group_intt(backend.slice(tau_g1, 0, degree))
        lag_g2 = backend.group_intt(backend.slice(tau_g2, 0, degree))
        lag_alpha = backend.group_intt(backend.slice(alpha_g1, 0, degree))
        lag_beta = backend.group_intt(backend.slice(beta_g1, 0, degree))
        with open(name, "wb") as w:
            w.write(rc.point_to_bytes(alpha0, False))
            w.write(rc.point_to_bytes(beta0, False))
            w.write(rc.point_to_bytes(beta_g2_pt, False))
            w.write(backend.encode_radix(lag_g1))
            w.write(backend.encode_radix(lag_g2))
            w.write(backend.encode_radix(lag_alpha))
            w.write(backend.encode_radix(lag_beta))
            if degree > 1:
                h = backend.sub_batches(
                    backend.slice(tau_g1, degree, 2 * degree - 1),
                    backend.slice(tau_g1, 0, degree - 1),
                )
                w.write(backend.encode_radix(h))
        paths.append(name)
        print(f"Created {name}")
    return paths


def _head_point(hp: streaming.HostPoints) -> rc.Point:
    return convert.affine_to_points(hp.row(slice(0, 1), "cpu"), hp.group)[0]


def _prepare_phase2_streamed(response_path: str, size: int, batch: int, backend, out_dir: str,
                             max_degree: int | None) -> list[str]:
    params = CeremonyParams(size, batch)
    _header(response_path, params)
    dev = backend.device

    with open(response_path, "rb") as fin:
        tau_g1, tau_g2, alpha_g1, beta_g1 = (_read_region_host(fin, params, kind, backend, True, True)
                                             for kind in ("tau_g1", "tau_g2", "alpha_g1", "beta_g1"))
        raw = _read_elements(fin, params, "beta_g2", 0, 1, True)
        beta_g2_pt = rc.point_from_bytes(raw, "g2", True)
    head = rc.point_to_bytes(_head_point(alpha_g1), False) + rc.point_to_bytes(_head_point(beta_g1), False) \
        + rc.point_to_bytes(beta_g2_pt, False)

    paths = []
    top = size if max_degree is None else max_degree
    for m in range(top + 1):
        degree = 1 << m
        name = os.path.join(out_dir, f"phase1radix2m{m}")
        lag_g1, lag_alpha, lag_beta = streaming.group_intt_streamed(
            [v.slice(0, degree) for v in (tau_g1, alpha_g1, beta_g1)], m, dev)
        (lag_g2,) = streaming.group_intt_streamed([tau_g2.slice(0, degree)], m, dev)
        with open(name, "wb") as w:
            w.write(head)
            for lag in (lag_g1, lag_g2, lag_alpha, lag_beta):
                w.write(lag)
            # H bases tau^(i+degree) - tau^i, in batch-size chunks
            for s in range(0, degree - 1, params.batch_size):
                e = min(s + params.batch_size, degree - 1)
                a = backend.from_batch(tau_g1.row(slice(degree + s, degree + e), dev), "g1")
                b = backend.from_batch(tau_g1.row(slice(s, e), dev), "g1")
                w.write(backend.encode_radix(backend.sub_batches(a, b)))
        paths.append(name)
        print(f"Created {name}")
    return paths


def reduce_powers(challenge_path: str, reduced_path: str, original_power: int, reduced_power: int,
                  batch: int) -> bytes:
    """Truncate an uncompressed challenge to a smaller power (pure byte
    copying: element regions are prefixes); returns the new file's hash."""
    orig = CeremonyParams(original_power, batch)
    red = CeremonyParams(reduced_power, batch)
    if os.path.getsize(challenge_path) != orig.accumulator_size:
        raise ValueError("challenge file has wrong size")

    with open(challenge_path, "rb") as fin, open(reduced_path, "wb") as fout:
        fout.truncate(red.accumulator_size)
        fout.seek(0)
        fout.write(reduced_hash(original_power, reduced_power))
        for kind in ("tau_g1", "tau_g2", "alpha_g1", "beta_g1", "beta_g2"):
            raw = _read_elements(fin, orig, kind, 0, red.element_count(kind), False)
            _write_elements(fout, red, kind, 0, raw, False)

    h = calculate_hash(reduced_path)
    print("Reduced contribution hash:")
    print(pretty_hash(h))
    return h
