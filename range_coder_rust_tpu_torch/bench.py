"""Throughput benchmark of the port: ``python -m range_coder_rust_tpu_torch
bench [--mb N] [--k K] [--device cuda|cpu]``.

The counterpart of the JAX package's root ``bench.py``, in its order:

1. a Zipf(1.2) byte corpus (:func:`.testing.make_corpus`, seed 0xC0) and
   its pow2 table;
2. the scalar baseline: the C++ golden coder (:mod:`.native.golden`) on
   the first 4 MiB, host clock, round trip asserted;
3. the device pipeline on data already on the device:
   * rans16 (default): the encode kernel (chain, offsets, compaction) on
     the whole-group rows at the codec's width, and the decode kernel on
     the real container's states and region, each uploaded once outside
     the timed window; the container from ``rans_codec.encode``, decoded
     once and held to the rows;
   * planar: ``blocks.encode_blocks`` / ``blocks.decode_blocks`` (the
     planar kernels on a card) on all blocks in one call each, round
     trip and capacity asserted;
   each timed as the best of 3 group averages of ``RC_BENCH_REPS`` calls
   after a warm-up, by CUDA events on a card and by the host clock on the
   CPU;
4. end to end: ``api.encode`` / ``api.decode`` (bytes in, bytes out),
   host clock, one warm-up encode, then 2 runs; best and mean.

It prints ONE JSON line on stdout and logs to stderr.  Its keys are the
reference's where the meaning is the same (its TPU and tunnel fields are
dropped), plus ``device``, ``power_limit_w``, ``build_s``,
``encode_ns_per_step``, ``decode_ns_per_step`` and ``groups``.
Throughputs are GB/s of input symbols (bytes); ``value`` is the device
pipeline's encode+decode GB/s and ``vs_baseline`` its ratio to the scalar
coder's.  ``encode_ns_per_step`` / ``decode_ns_per_step`` are the device
times over the steps of a lane's chain (L a device call, the calls run
one after another).  ``groups`` is the rans16 group count (NG), or the
planar block count.  ``build_s`` is the nvcc build of the kernels (0
where it was built already, or on the CPU).
``device`` and ``power_limit_w`` are the card's name and power limit from
``nvidia-smi``, or ``"cpu"`` and null.  The numbers are not rounded.

Env knobs (the reference's): RC_BENCH_MB (corpus MiB, default 256),
RC_BENCH_REPS (default 3), RC_BENCH_L (lane or block length, default
32768 rans16 / 512 planar), RC_BENCH_PROFILE (rans16 | planar),
RC_BENCH_K (table precision, default 16; rans16 needs 16) and
RC_BENCH_E2E_MB (the end-to-end slice, default the whole corpus).

``device="cuda"`` without a card raises; nothing falls back to the CPU.
``device="cpu"`` runs the plain versions of the kernels (for the tests).
A failed round trip raises ``AssertionError``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import api, blocks, rans_codec
from . import format as fmt
from .errors import ConfigError
from .kernels import (_build, launch_counts, launch_placements,
                      rans_decode_tiled, rans_encode_tiled)
from .models.table import Pow2Table, table_from_data_pow2
from .native import golden
from .testing import make_corpus

#: symbols of the scalar baseline's sample
_SCALAR_SAMPLE = 4 << 20


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_best(fn, device: torch.device, reps: int, groups: int = 3
               ) -> float:
    """Best group-average seconds per call of ``fn``, after one warm-up
    call: each group queues ``reps`` calls back to back and is timed by
    CUDA events on a card, by the host clock on the CPU."""
    fn()
    _sync(device)
    best = None
    for _ in range(groups):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop) / 1e3 / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            dt = (time.perf_counter() - t0) / reps
        best = dt if best is None else min(best, dt)
    return best


def card(device: torch.device) -> tuple:
    """(name, power limit in W or None) of the card behind ``device``,
    from ``nvidia-smi``; ``("cpu", None)`` on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    try:
        watts = float(limit.split()[0])
    except ValueError:  # "[N/A]" where nvidia-smi reports no limit
        watts = None
    return name.strip(), watts


def _build_kernels(device: torch.device) -> float:
    """Seconds the kernels' nvcc build took: 0 where the library
    was built already, or on the CPU (the plain versions run there)."""
    if device.type != "cuda":
        return 0.0
    built = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    return 0.0 if built else time.perf_counter() - t0


def bench_rans16(data: np.ndarray, t: Pow2Table, L: int, reps: int,
                 device: torch.device) -> dict:
    """The rans16 kernels on device-resident inputs of whole groups."""
    G = rans_codec.G
    n = data.size
    # shrink the lane length as the product path does when the corpus
    # cannot fill one group at the requested L
    L = rans_codec._shrink_lane_len(n, L)
    ng = max(1, n // (G * L))
    nfit = ng * G * L
    rows = data[:nfit].reshape(ng * G, L)
    tile, _ = rans_codec._tile_geometry(L)
    cum = rans_codec.cum_table(t.cum, device)
    gpc = rans_codec._groups_per_call(L, G)
    bounds = [(s, min(s + gpc, ng)) for s in range(0, ng, gpc)]

    t0 = time.perf_counter()
    dev_rows = [rans_codec._upload_rows(rows[a * G : b * G], device)
                for a, b in bounds]
    _sync(device)
    log(f"rans16 H2D ({len(bounds)} batches of <= {gpc} groups as "
        f"{dev_rows[0].dtype}): {time.perf_counter() - t0:.4f} s")

    # the real container through the product path (the size measurement)
    blob = rans_codec.encode(data[:nfit], alphabet=256, table=t,
                             block_len=L, device=device)
    cont_bits = 8 * len(blob) / nfit
    cont = fmt.unpack(blob)
    got = rans_codec.decode_groups(cont.payloads, t.c, L, device=device)
    if not np.array_equal(got, rows):
        raise AssertionError("rans16 round trip failed")

    def enc_step():
        return [rans_encode_tiled(r, cum, group_lanes=G, tile=tile)
                for r in dev_rows]

    enc_t = timed_best(enc_step, device, reps)

    # the decode's inputs: the container's states, regions and offsets,
    # parsed and uploaded once
    dec_args = [rans_codec._upload_payloads(cont.payloads[a:b], L, G, device)
                for a, b in bounds]

    def dec_step():
        return [rans_decode_tiled(*args, cum, group_lanes=G, block_len=L,
                                  a_count=256, out_dtype=torch.uint8)
                for args in dec_args]

    dec_t = timed_best(dec_step, device, reps)
    return {"enc_t": enc_t, "dec_t": dec_t, "cont_bits": cont_bits,
            "nfit": nfit, "L": L, "groups": ng, "steps": len(bounds) * L}


def bench_planar(data: np.ndarray, t: Pow2Table, L: int, k: int, reps: int,
                 device: torch.device) -> dict:
    """The planar block coder on all blocks at once, on the device."""
    B = data.size // L
    rows = data[: B * L].reshape(B, L)
    c = torch.from_numpy(t.c.astype(np.int64)).to(device)
    cum = torch.from_numpy(t.cum.astype(np.int64)).to(device)
    cap = blocks.default_capacity(L, k)
    syms = blocks.upload_rows(rows, device)
    code, lengths = blocks.encode_blocks(syms, c, cum, k=k, capacity=cap)
    if int(lengths.max()) > cap:
        raise AssertionError("planar capacity overflow")
    dec = blocks.decode_blocks(code, c, cum, k=k, block_len=L)
    if not torch.equal(dec, syms.to(torch.int32)):  # byte symbols
        raise AssertionError("planar round trip failed")
    # container-inclusive: payloads + 4 B length + 4 B CRC a block
    cont_bits = 8 * (int(lengths.sum()) + 8 * B) / (B * L)
    enc_t = timed_best(
        lambda: blocks.encode_blocks(syms, c, cum, k=k, capacity=cap),
        device, reps)
    dec_t = timed_best(
        lambda: blocks.decode_blocks(code, c, cum, k=k, block_len=L),
        device, reps)
    return {"enc_t": enc_t, "dec_t": dec_t, "cont_bits": cont_bits,
            "nfit": B * L, "L": L, "groups": B, "steps": L}


def run(n_bytes: int | None = None, device="cuda") -> dict:
    """Run the benchmark on ``device`` over a corpus of ``n_bytes``
    (default ``RC_BENCH_MB`` MiB), print its JSON line and return it."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"bench: no device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device (torch.cuda.is_available() "
                           "is False); --device cpu runs the plain versions")
    profile = os.environ.get("RC_BENCH_PROFILE", "rans16")
    if profile not in ("rans16", "planar"):
        raise ValueError(f"RC_BENCH_PROFILE {profile!r}: rans16 or planar")
    n = (n_bytes if n_bytes is not None
         else int(os.environ.get("RC_BENCH_MB", "256")) << 20)
    reps = int(os.environ.get("RC_BENCH_REPS", "3"))
    k = int(os.environ.get("RC_BENCH_K", "16"))
    if profile == "rans16" and k != 16:
        raise ConfigError("rans16 profile requires k == 16")
    e2e_mb = os.environ.get("RC_BENCH_E2E_MB")
    e2e_n = n if e2e_mb is None else min(n, int(e2e_mb) << 20)
    L = int(os.environ.get("RC_BENCH_L",
                           "32768" if profile == "rans16" else "512"))

    name, watts = card(device)
    log(f"device: {device} ({name}, power limit {watts} W), "
        f"profile={profile}")
    build_s = _build_kernels(device)
    t0 = time.perf_counter()
    data = make_corpus(n)
    t = table_from_data_pow2(data, 256, k)
    log(f"corpus: {n} bytes, L={L}, k={k}, made with its table in "
        f"{time.perf_counter() - t0:.4f} s; kernel build {build_s:.4f} s")

    # scalar baseline first, before any device work
    if not golden.is_available():
        raise RuntimeError("bench: the C++ golden coder did not build (g++)")
    sample = data[:_SCALAR_SAMPLE]
    t0 = time.perf_counter()
    ref_code = golden.encode(sample, t.c, t.cum[:-1], 1 << k)
    ref_enc_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_dec = golden.decode(ref_code, sample.size, t.c, t.cum[:-1], 1 << k)
    ref_dec_t = time.perf_counter() - t0
    if not np.array_equal(ref_dec, sample):
        raise AssertionError("scalar golden round trip failed")
    base_gbps = sample.size / 1e9 / (ref_enc_t + ref_dec_t)
    ref_bits = 8 * len(ref_code) / sample.size
    log(f"scalar C++ baseline: {base_gbps} GB/s, {ref_bits} bits/sym on "
        f"{sample.size} symbols")

    if profile == "rans16":
        dev = bench_rans16(data, t, L, reps, device)
    else:
        dev = bench_planar(data, t, L, k, reps, device)
    # the throughputs count the whole corpus: scale the times of the
    # symbols that fit whole groups or blocks
    scale = n / dev["nfit"]
    enc_t, dec_t = dev["enc_t"] * scale, dev["dec_t"] * scale
    gbps = n / 1e9 / (enc_t + dec_t)
    log(f"device encode {n / 1e9 / enc_t} GB/s, decode {n / 1e9 / dec_t} "
        f"GB/s, combined {gbps} GB/s; bits/sym (container) "
        f"{dev['cont_bits']} vs scalar {ref_bits}")

    # end to end: bytes in, bytes out through the api
    cfg = (api.CodecConfig(k=16, block_len=L, profile=profile)
           if profile == "rans16" else api.CodecConfig(k=k, block_len=L))
    e2e_data = data[:e2e_n]
    blob = api.encode(e2e_data, alphabet=256, config=cfg, device=device)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        blob = api.encode(e2e_data, alphabet=256, config=cfg, device=device)
        enc_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = api.decode(blob, device=device)
        runs.append((enc_wall, time.perf_counter() - t0))
        if not np.array_equal(out, e2e_data):
            raise AssertionError("api round trip failed")
    e2e_enc_t, e2e_dec_t = min(runs, key=sum)
    e2e_enc_mean = sum(r[0] for r in runs) / len(runs)
    e2e_dec_mean = sum(r[1] for r in runs) / len(runs)
    wall = e2e_enc_t + e2e_dec_t
    e2e_gbps = e2e_n / 1e9 / wall
    log(f"end to end api ({e2e_n} bytes): encode {e2e_n / 1e9 / e2e_enc_t} "
        f"GB/s, decode {e2e_n / 1e9 / e2e_dec_t} GB/s, combined {e2e_gbps} "
        f"GB/s; kernel launches {launch_counts()}, planar launches by "
        f"table placement {launch_placements()}")

    line = {
        "metric": "encode+decode GB/s/chip",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": gbps / base_gbps,
        "profile": profile,
        "encode_gbps": n / 1e9 / enc_t,
        "decode_gbps": n / 1e9 / dec_t,
        "decode_vs_encode": enc_t / dec_t,
        "e2e_gbps": e2e_gbps,
        "e2e_gbps_mean": e2e_n / 1e9 / (e2e_enc_mean + e2e_dec_mean),
        "e2e_encode_gbps": e2e_n / 1e9 / e2e_enc_t,
        "e2e_decode_gbps": e2e_n / 1e9 / e2e_dec_t,
        "e2e_mb": e2e_n / (1 << 20),
        "e2e_wall_s": wall,
        "corpus_mb": n / (1 << 20),
        "lane_len": dev["L"],
        "bits_per_symbol_container": dev["cont_bits"],
        "scalar_bits_per_symbol": ref_bits,
        "size_vs_scalar": dev["cont_bits"] / ref_bits,
        "baseline_gbps_scalar_cpp": base_gbps,
        "device": name,
        "power_limit_w": watts,
        "build_s": build_s,
        "encode_ns_per_step": dev["enc_t"] / dev["steps"] * 1e9,
        "decode_ns_per_step": dev["dec_t"] / dev["steps"] * 1e9,
        "groups": dev["groups"],
    }
    print(json.dumps(line), flush=True)
    return line
