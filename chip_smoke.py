#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one CUDA card.

    python3 chip_smoke.py [--corpus-mb 256]

Phases (any failure ends the run with a non-zero exit):

1. the card: its name and power limit (``nvidia-smi``);
2. the build of the CUDA kernels from ``range_coder_rust_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version (CUDA tensors against CPU
   tensors, identical output required) over the small geometries of
   ``range_coder_rust_tpu_torch.testing.KERNEL_CASES``: odd tile lengths,
   wide and non-pow2 alphabets, leading zero-frequency symbols, a symbol
   with c > 2^15, symbols with c = 1, the encode's u8 and u16 rows read
   by chunks or (L not a multiple of 16 bytes) symbol by symbol, and the
   decode's staged u16 stores with a ragged last stage, its direct-store
   variant (u8 and u16 symbols), the widest groups (32768 lanes) and its
   ring read past its window; then the planar kernels over
   ``testing.PLANAR_CASES``: k = 16 with a shared table on u8 rows at
   L = 512, a 4096-symbol u16 alphabet, a 65536-symbol one (its table in
   device memory), a raw total, a total of 1, per-block tables at k = 12,
   a forced capacity overflow, an odd L with byte stores, and a decode row
   width that is not a multiple of 4, each encode also on int32 and int64
   rows (code bytes, lengths and symbols identical);
4. the main path at full size: ``api.encode`` / ``api.decode`` of a 256 MB
   Zipf(1.2) byte corpus with ``CodecConfig(profile="rans16",
   block_len=32768)`` (4 groups of 2048 lanes), an exact round trip, and
   both kernels' launch counts over that run;
5. each kernel's output on the inputs the main path gave it (recorded as
   it ran) against its plain version on the same inputs on the card, and
   both versions' times there and for the first group alone, beside each
   kernel's bound: the larger of its bytes (each input read once, each
   output written once) over 3.35 TB/s and its 32-bit integer operations
   over 16.7 TOP/s, from this run's inputs; each kernel's plan (block
   sizes, loads, shared memory) and its time per step of the chain;
6. the adaptive path: a 256 MB mixed corpus (64 KB segments of Zipf,
   uniform, skewed and run-length data, seed 5; the JAX package's
   ``scripts/adaptive_bench.py``) with ``CodecConfig(profile="rans16",
   per_group_tables=True, block_len=32)``: 4096 groups, one table each;
   an exact round trip at the reference's 7.2703 bits/sym, both kernels
   against their plain versions on the inputs it gave them, their times
   beside their bounds, and their times for one step a lane on the same
   groups and tables (the per-block table build, the launch and one
   step);
7. the random-access path: the main path's corpus with ``sync_tiles=128``
   (7 sync states a group): the container exactly 4 * (7 * 6 * 2048 + 4)
   bytes larger, a full decode, ``decode_range`` on slices at the start,
   just after a sync point, across two lanes, across two groups and at
   the end (each exact, its wall and decode launches), and the encode
   kernel's sync states against the plain version's on the first group;
8. the chunked encode (the path for inputs of 2^31 symbols or more) of
   the main path's corpus in slabs of 2^27 symbols: byte-equal to the
   single call's container;
9. the planar profile (``CodecConfig()``'s default: k = 16, L = 512,
   device calls of 2^24 symbols; the planar encode and decode kernels,
   one launch of each a device call) on the main path's corpus: an exact
   int32 round trip at the reference's 5.53008 bits/sym (256 MiB), its
   walls, about 64 sampled blocks and the last one byte-equal to the
   port's scalar ``Encoder``, the first 1024 blocks encoded again on the
   CPU (byte-equal), and five ``decode_range`` slices; then ("9 planar
   loops") the first device call's blocks through each planar kernel and
   its plain version on the card: the payloads byte-equal to the
   container's, the decode of the container's payloads where they lie
   (joined, as ``api.decode`` uploads them) and of their ``(B, C)``
   matrix equal to the rows, each kernel's time (CUDA events; the
   decode's in both forms) beside the plain version's and its bound, and
   the device kernels and busy share of one kernel round trip
   (``torch.profiler``);
10. the other planar paths, one device call (16 MiB) each: raw-count
   tables (total 2^24, where the reference switches its decode divide),
   a 4096-symbol alphabet under a rans16 config (the planar fallback),
   and per-block tables (``adaptive.encode_adaptive``, k = 12, L = 512,
   on the adaptive path's mixed corpus); each exact, sampled blocks
   against the scalar coder, through the planar kernels;
11. the sharded rans16 path: the main path's rows, tables and decode
   inputs through ``parallel.make_sharded_rans16`` over two shards on the
   card (``[cuda:0, cuda:0]``; one below 128 MiB, where the main path is
   one group): every output bit-identical to the single calls', each
   kernel launched once a shard;
12. two processes (``torch.multiprocessing``, spawned, a ``gloo`` process
   group, both coding on ``cuda:0``) over ``parallel.multihost``: the main
   path's corpus (read by each rank from one ``.npy`` file, memory-mapped)
   with ``encode_multihost_rans16``, two groups a rank; rank 0's
   container byte-equal to phase 4's, and ``decode_multihost_rans16``
   exact on every rank; then its first 16 MiB with the planar
   ``encode_multihost`` (the planar encode kernel on each rank),
   byte-equal to ``api.encode(..., CodecConfig())``.
   Each rank's wall split into coding, gather and assembly; a rank that
   fails or hangs (a time limit) fails the run;
13. the command line, as subprocesses with ``--device cuda`` on the main
   path's corpus as a file: ``encode`` (rans16, the default at k = 16,
   ``--block-len 32768``), byte-equal to phase 4's container; ``decode``
   and ``decode --start/--count`` exact; ``inspect`` and ``selftest``;
14. the bench command (``range_coder_rust_tpu_torch/bench.py``) as
   subprocesses: ``bench --mb <corpus MiB>`` with
   ``RC_BENCH_PROFILE=rans16``, then ``bench --mb 16`` with
   ``RC_BENCH_PROFILE=planar``; each exits 0 and its JSON line is printed
   here; the rans16 line's container bits/sym equal phase 4's, and at
   256 MiB its scalar baseline reads the reference's 5.2923 bits/sym
   (``BENCH_256MB_r05.json``).

Each path resets the launch counts just before it runs and reads them
just after (the planar paths launch the planar kernels and no rans16
kernel; the CLI and the bench run in processes of their own).  Each phase's wall
is printed.  It prints one JSON line on the kernels (the main path's
numbers under the contract's keys, the other paths' under added keys),
then, as its last line, ``{"ok": true, "device": {...}}``.  It imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "range_coder_rust_tpu_torch"
#: the TPU kernel (rans16) or the XLA scan (planar: the reference has no
#: Pallas kernel there) each kernel replaces
REPLACES = {
    "rans_encode": "range_coder_rust_tpu/kernels/rans_encode.py:175",
    "rans_decode": "range_coder_rust_tpu/kernels/rans_decode.py:75",
    "planar_encode": "range_coder_rust_tpu/blocks.py:69",
    "planar_decode": "range_coder_rust_tpu/blocks.py:319",
}
SOURCES = {
    "rans_encode": f"{PKG}/csrc/rans_encode.cu",
    "rans_decode": f"{PKG}/csrc/rans_decode.cu",
    "planar_encode": f"{PKG}/csrc/planar_encode.cu",
    "planar_decode": f"{PKG}/csrc/planar_decode.cu",
}
#: H100 SXM peaks: device memory bytes/s (NVIDIA's data sheet), and 32-bit
#: integer operations/s: 64 INT32 lanes a SM (NVIDIA's Hopper architecture
#: white paper; half the 128 FP32 lanes behind the data sheet's 67 TFLOP/s
#: float32) x 132 SMs x 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 132 * 64 * 1.98e9
#: integer operations per symbol of the coder's arithmetic (encode: the
#: divide counted as one, multiply, subtract, shift, add, flag; decode:
#: mask, lookup, multiply, add, subtract, flag) and per emitted or
#: refilled halfword (shift and or)
OPS_PER_SYMBOL = {"rans_encode": 6, "rans_decode": 6}
OPS_PER_HALFWORD = 2
#: the planar kernels' operations per symbol, each u64 operation counted
#: as one (csrc/planar_step.cuh): the encode's symbol and table reads (3),
#: rpt = range >> k (1), the interval (2 multiplies, 2 adds), the
#: renormalisation (xor, 2 leading-zero counts, 2 clamps, 5 shifts, a
#: compare, 2 nots, a mask, 2 selects, an add: 18) = 26; the decode adds
#: the target value (subtract, divide counted as one, clamp: 3) and the
#: symbol write (1), and reads no symbol (-1) = 29, plus 4 a step of the
#: binary search (add, table read, compare, select) over log2(A + 1)
#: steps; per emitted or consumed byte 3 (shift, or, byte read or store)
PLANAR_OPS_PER_SYMBOL = {"planar_encode": 26, "planar_decode": 29}
PLANAR_OPS_PER_SEARCH_STEP = 4
PLANAR_OPS_PER_BYTE = 3


def symbol_bytes(a_count: int) -> int:
    """Bytes a symbol of an alphabet of ``a_count`` needs."""
    return 1 if a_count <= 256 else 2 if a_count <= 65536 else 4


def bound(name: str, nbytes: int, n_symbols: int, n_halfwords: int) -> tuple:
    """(bound ms, "bytes" or "operations"): the least time the card could
    take for a kernel's work, moving ``nbytes`` in all."""
    ops = OPS_PER_SYMBOL[name] * n_symbols + OPS_PER_HALFWORD * n_halfwords
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def planar_bound(name: str, nbytes: int, n_symbols: int, n_code_bytes: int,
                 a_count: int) -> tuple:
    """(bound ms, "bytes" or "operations") of a planar kernel's work: it
    moves ``nbytes`` in all and codes ``n_symbols`` into (or from)
    ``n_code_bytes`` stream bytes over an alphabet of ``a_count``."""
    ops = PLANAR_OPS_PER_SYMBOL[name] * n_symbols + (
        PLANAR_OPS_PER_BYTE * n_code_bytes)
    if name == "planar_decode":
        ops += (PLANAR_OPS_PER_SEARCH_STEP * n_symbols
                * max(1, (a_count).bit_length()))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Smoke:
    def __init__(self, card: str):
        self.card = card

    def say(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernels(smoke: Smoke) -> dict:
    """Phase 3: every kernel's output equals its plain version's on the
    small geometries.  Returns the largest absolute difference per
    kernel."""
    import torch

    from range_coder_rust_tpu_torch import testing

    err = {"rans_encode": 0, "rans_decode": 0, "planar_encode": 0,
           "planar_decode": 0}
    for name in testing.KERNEL_CASES:
        rows, g, a = testing.kernel_case(name)
        errs, _, _ = testing.kernels_vs_plain(
            rows, g, a, torch.device("cuda"),
            **testing.CASE_OPTIONS.get(name, {}))
        if any(errs.values()):
            raise AssertionError(f"{name}: kernel != plain version: {errs}")
        for k, e in errs.items():
            err[k] = max(err[k], e)
        smoke.say(f"kernel == plain: {name} (G={g} rows={rows.shape[0]} "
                  f"L={rows.shape[1]} A={a})")
    for name in testing.PLANAR_CASES:
        errs = testing.planar_vs_plain(name, torch.device("cuda"))
        torch.cuda.synchronize()
        if any(errs.values()):
            raise AssertionError(f"{name}: kernel != plain version: {errs}")
        case = testing.planar_case(name)
        smoke.say(f"planar kernels == plain: {name} (B, L = "
                  f"{case['rows'].shape}, {case['rows'].dtype}, A="
                  f"{case['c'].shape[-1]}, {case['total']}, "
                  f"{'per-block' if case['c'].ndim == 2 else 'shared'} "
                  f"table, capacity {case['capacity']}, decode width "
                  f"{case['width'] or case['capacity']})")
    return err


class Recorder:
    """Wraps a kernel wrapper where ``rans_codec`` calls it, and keeps the
    arguments and the result of each call."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.calls.append((args, kw, out))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn, device):
    """(result, host seconds) of one call, the card synchronised."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def plain_wall(fn):
    """(result, host milliseconds) of one call, the card synchronised."""
    out, seconds = timed(fn, "cuda")
    return out, seconds * 1e3


def main_path(smoke: Smoke, corpus_mb: int) -> dict:
    """Phase 4: the main path at full size, through the public API."""
    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch.testing import make_corpus

    n = corpus_mb << 20
    t0 = time.perf_counter()
    data = make_corpus(n)
    smoke.say(f"corpus: {n} bytes Zipf(1.2) seed 0xC0 made in "
              f"{time.perf_counter() - t0:.3f} s")
    cfg = rt.CodecConfig(profile="rans16", block_len=32768)
    rt_out = round_trip(smoke, "main path", data, cfg)
    if len(rt_out["enc"]) != 1 or len(rt_out["dec"]) != 1:
        raise AssertionError(f"kernel calls: encode {len(rt_out['enc'])}, "
                             f"decode {len(rt_out['dec'])}")
    (rows, cum), enc_kw, enc_k = rt_out["enc"][0]
    dec_args, dec_kw, dec_k = rt_out["dec"][0]
    g, tile = enc_kw["group_lanes"], enc_kw["tile"]
    ng, L = rows.shape[0] // g, rows.shape[1]
    smoke.say(f"main path: n={n} NG={ng} G={g} L={L} NT={L // tile}")
    counts, blob = rt_out["counts"], rt_out["blob"]
    return {"counts": counts, "enc": (rows, cum, enc_kw, enc_k),
            "dec": (dec_args, dec_kw, dec_k), "data": data, "blob": blob}


def kernel_bounds(rows, cum, enc_out, dec_call) -> dict:
    """Each kernel's bound from the tensors of one run: the encode reads
    the symbols at the width the alphabet needs and the table(s), and
    writes states, sizes, sync states and the region's used part (the
    decode's region); the decode reads states, region, offsets and
    table(s) and writes the symbols."""
    (states, region, grp_off, dcum), dec_kw, dec_out = dec_call
    n_sym, n_hw = rows.numel(), region.numel()
    sym_bytes = n_sym * symbol_bytes(dec_kw["a_count"])
    return {
        "rans_encode": bound("rans_encode", sym_bytes + nbytes(
            cum, enc_out[0], enc_out[1], enc_out[3], region), n_sym, n_hw),
        "rans_decode": bound("rans_decode", nbytes(
            states, region, grp_off, dcum, dec_out), n_sym, n_hw),
    }


def main_path_vs_plain(smoke: Smoke, main: dict) -> dict:
    """Phase 5: each kernel's main-path output against its plain version
    on the same inputs, on the card; then both versions' times at the
    main path's shape (``times``) and for its first group alone."""
    import torch

    from range_coder_rust_tpu_torch import kernels, testing

    rows, cum, enc_kw, enc_k = main["enc"]
    (states, region, grp_off, dcum), dec_kw, dec_k = main["dec"]
    g = enc_kw["group_lanes"]
    ng = rows.shape[0] // g
    enc_p, enc_plain_ms = plain_wall(
        lambda: kernels.rans_encode_plain(rows, cum, **enc_kw))
    dec_p, dec_plain_ms = plain_wall(lambda: kernels.rans_decode_plain(
        states, region, grp_off, dcum, **dec_kw))
    err = {"rans_encode": testing.encode_err(enc_k, enc_p),
           "rans_decode": testing.decode_err(dec_k, dec_p)}
    # the decode's inputs are what the encode wrote: the same states, the
    # same region, and group offsets from the same sizes
    sizes_off = torch.cat([enc_p[1].new_zeros(1, dtype=torch.int64),
                           enc_p[1].sum(1).cumsum(0)])
    if (any(err.values()) or not torch.equal(states, enc_p[0])
            or not torch.equal(grp_off, sizes_off)
            or not torch.equal(region, enc_p[2])):
        raise AssertionError(f"main path kernels != plain versions: {err}")
    smoke.say(f"main path kernels == plain versions on the card: NG={ng} "
              f"rows={tuple(rows.shape)} region_hw={region.numel()} "
              f"grp_off={grp_off.tolist()}")

    times = {
        "rans_encode": (cuda_ms(lambda: kernels.rans_encode_tiled(
            rows, cum, **enc_kw)), enc_plain_ms),
        "rans_decode": (cuda_ms(lambda: kernels.rans_decode_tiled(
            states, region, grp_off, dcum, **dec_kw)), dec_plain_ms),
    }
    bounds = kernel_bounds(rows, cum, enc_k, main["dec"])
    L = rows.shape[1]
    eplan = kernels.encode_plan(ng, g, L, rows.dtype)
    vector = rows.data_ptr() % 16 == 0 and L * rows.element_size() % 16 == 0
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    smoke.say(f"rans_encode plan at NG={ng} G={g} {rows.dtype}: chain blocks "
              f"of {eplan['chain_threads']} threads "
              f"({rows.shape[0] // eplan['chain_threads']} blocks on {n_sm} "
              f"SMs), {eplan['chunk_steps']} steps a 32-byte row read "
              f"({'16-byte vector' if vector else 'symbol by symbol'} "
              f"loads), scratch {eplan['scratch_bytes']} B; "
              f"{times['rans_encode'][0] / L * 1e6:.2f} ns per step")
    plan = kernels.decode_plan(g, dec_kw["a_count"], dec_kw["out_dtype"])
    smoke.say(f"rans_decode plan at G={g}: "
              f"{'staged' if plan['staged'] else 'direct-store'} variant, "
              f"{plan['threads']} threads, ring {plan['ring_hw']} "
              f"halfwords, {plan['smem_bytes']} B dynamic shared memory per "
              f"block; "
              f"{times['rans_decode'][0] / L * 1e6:.2f} ns per step")
    # the first group alone: its rows, and its preamble and region
    rows1, states1, off1 = rows[:g], states[:g], grp_off[:2]
    one = {
        "rans_encode": (lambda: kernels.rans_encode_tiled(rows1, cum, **enc_kw),
                        lambda: kernels.rans_encode_plain(rows1, cum, **enc_kw),
                        testing.encode_err),
        "rans_decode": (lambda: kernels.rans_decode_tiled(
                            states1, region, off1, dcum, **dec_kw),
                        lambda: kernels.rans_decode_plain(
                            states1, region, off1, dcum, **dec_kw),
                        testing.decode_err),
    }
    first = {}
    for name, (kern, plain, diff) in one.items():
        e = diff(kern(), plain())
        if e:
            raise AssertionError(f"{name} first group: kernel != plain ({e})")
        err[name] = max(err[name], e)
        k_ms, p_ms = times[name]
        b_ms, b_by = bounds[name]
        smoke.say(f"{name} main path NG={ng} G={g} L={L}: kernel "
                  f"{k_ms:.4f} ms, plain PyTorch on the card {p_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})")
        first[name] = (cuda_ms(kern), plain_wall(plain)[1])
        smoke.say(f"{name} first group G={g} L={L}: kernel "
                  f"{first[name][0]:.4f} ms, plain PyTorch on the card "
                  f"{first[name][1]:.4f} ms")
    return {"times": times, "first": first, "bounds": bounds, "err": err}


def round_trip(smoke: Smoke, what: str, data, cfg) -> dict:
    """One api encode and decode on the card, each kernel call recorded:
    the container, both walls, the launch counts and the calls.  Fails
    unless the round trip is exact and each rans16 kernel ran (and no
    planar one)."""
    import numpy as np
    import torch

    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch import rans_codec

    with Recorder(rans_codec, "rans_encode_tiled") as enc, \
            Recorder(rans_codec, "rans_decode_tiled") as dec:
        rt.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = rt.encode(data, alphabet=256, config=cfg, device="cuda")
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = rt.decode(blob, device="cuda")
        t_dec = time.perf_counter() - t0
        counts = rt.launch_counts()
    if out.dtype != data.dtype or not np.array_equal(out, data):
        raise AssertionError(f"{what}: round trip is not exact "
                             f"({out.dtype} {out.shape})")
    if (min(counts["rans_encode"], counts["rans_decode"]) < 1
            or counts["planar_encode"] or counts["planar_decode"]):
        raise AssertionError(f"{what}: a rans16 kernel never launched, or "
                             f"a planar one did: {counts}")
    n = data.size
    smoke.say(f"{what}: round trip exact, encode wall {t_enc:.4f} s = "
              f"{n / t_enc / 1e9:.4f} GB/s, decode wall {t_dec:.4f} s = "
              f"{n / t_dec / 1e9:.4f} GB/s, container {len(blob)} B = "
              f"{8 * len(blob) / n:.5f} bits/sym, launches {counts}")
    return {"blob": blob, "counts": counts, "enc": enc.calls,
            "dec": dec.calls}


def adaptive_path(smoke: Smoke, corpus_mb: int) -> dict:
    """Phase 6: the adaptive mode (one table per group) on the mixed
    corpus of the JAX package's ``scripts/adaptive_bench.py``: its round
    trip, both kernels against their plain versions on the inputs it gave
    them, their times beside their bounds, and their times for one step a
    lane on the same groups and tables (the per-block table build, the
    launch and one step)."""
    import numpy as np

    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch import kernels, testing

    n = corpus_mb << 20
    t0 = time.perf_counter()
    data = testing.mixed_corpus(n).astype(np.uint8)
    smoke.say(f"adaptive corpus: {n} bytes, mixed 64 KB segments, seed 5, "
              f"made in {time.perf_counter() - t0:.3f} s")
    cfg = rt.CodecConfig(profile="rans16", per_group_tables=True,
                         block_len=32)
    rt_out = round_trip(smoke, "adaptive path", data, cfg)
    if len(rt_out["enc"]) != 1 or len(rt_out["dec"]) != 1:
        raise AssertionError("adaptive path: one kernel call each expected")
    (rows, cum), enc_kw, enc_k = rt_out["enc"][0]
    dec_args, dec_kw, dec_k = rt_out["dec"][0]
    g = enc_kw["group_lanes"]
    ng, L = rows.shape[0] // g, rows.shape[1]
    if tuple(cum.shape) != (ng, 1024):
        raise AssertionError(f"adaptive path: tables {tuple(cum.shape)}")
    bits = 8 * len(rt_out["blob"]) / n
    smoke.say(f"adaptive path: NG={ng} G={g} L={L}, {bits:.4f} bits/sym")
    if corpus_mb == 256 and round(bits, 4) != 7.2703:
        raise AssertionError(
            f"adaptive path: {bits:.4f} bits/sym, the reference's record "
            "for this corpus and geometry is 7.2703")
    enc_p, enc_plain_ms = plain_wall(
        lambda: kernels.rans_encode_plain(rows, cum, **enc_kw))
    dec_p, dec_plain_ms = plain_wall(
        lambda: kernels.rans_decode_plain(*dec_args, **dec_kw))
    err = {"rans_encode": testing.encode_err(enc_k, enc_p),
           "rans_decode": testing.decode_err(dec_k, dec_p)}
    if any(err.values()):
        raise AssertionError(f"adaptive path kernels != plain: {err}")
    states, region, grp_off, dcum = dec_args
    times = {
        "rans_encode": (cuda_ms(lambda: kernels.rans_encode_tiled(
            rows, cum, **enc_kw)), enc_plain_ms),
        "rans_decode": (cuda_ms(lambda: kernels.rans_decode_tiled(
            *dec_args, **dec_kw)), dec_plain_ms),
    }
    rows1 = rows[:, :1].contiguous()
    one_step = {
        "rans_encode": cuda_ms(lambda: kernels.rans_encode_tiled(
            rows1, cum, group_lanes=g, tile=1)),
        "rans_decode": cuda_ms(lambda: kernels.rans_decode_tiled(
            *dec_args, **{**dec_kw, "block_len": 1})),
    }
    bounds = kernel_bounds(rows, cum, enc_k, rt_out["dec"][0])
    for name in times:
        smoke.say(f"{name} adaptive path NG={ng} G={g} L={L}: kernel "
                  f"{times[name][0]:.4f} ms == plain (max_abs_err 0), plain "
                  f"PyTorch on the card {times[name][1]:.4f} ms, bound "
                  f"{bounds[name][0]:.4f} ms ({bounds[name][1]}); one step "
                  f"a lane on the same groups {one_step[name]:.4f} ms = "
                  f"{one_step[name] / times[name][0]:.4f} of the kernel")
    return {"counts": rt_out["counts"], "times": times, "bounds": bounds,
            "one_step": one_step, "err": err}


def random_access_path(smoke: Smoke, main: dict) -> dict:
    """Phase 7: sync points on the main path's corpus: the container's
    overhead, a full decode, ``decode_range`` on slices at the edges of
    sync points, lanes and groups, and the encode kernel's sync states
    against the plain version's on the first group."""
    import numpy as np

    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch import kernels, rans_codec, testing

    data = main["data"]
    n = data.size
    sync_tiles = 128
    cfg = rt.CodecConfig(profile="rans16", block_len=32768,
                         sync_tiles=sync_tiles)
    rt_out = round_trip(smoke, "random-access path", data, cfg)
    blob = rt_out["blob"]
    (rows, cum), enc_kw, enc_k = rt_out["enc"][0]
    g, tile = enc_kw["group_lanes"], enc_kw["tile"]
    ng, L = rows.shape[0] // g, rows.shape[1]
    n_sync = (L // tile - 1) // sync_tiles
    extra = len(blob) - len(main["blob"])
    want = ng * (n_sync * 6 * g + 4) if n_sync else 0
    if extra != want or enc_k[3].shape[1] != n_sync:
        raise AssertionError(f"sync overhead {extra} B for {ng} groups of "
                             f"{n_sync} syncs")
    smoke.say(f"random-access path: NG={ng} G={g} L={L} NT={L // tile} "
              f"sync_tiles={sync_tiles}: {n_sync} syncs a group, container "
              f"{extra} B larger than without")
    first = (rows[:g], cum)
    sync_k = kernels.rans_encode_tiled(*first, **enc_kw)
    sync_p, sync_plain_ms = plain_wall(
        lambda: kernels.rans_encode_plain(*first, **enc_kw))
    e = testing.encode_err(sync_k, sync_p)
    if e or not bool((sync_k[3] == enc_k[3][:1]).all()):
        raise AssertionError(f"first group's sync states: kernel != plain "
                             f"({e})")
    sync_ms = cuda_ms(lambda: kernels.rans_encode_tiled(rows, cum, **enc_kw))
    smoke.say(f"rans_encode with sync states, first group: kernel == plain "
              f"(max_abs_err 0, plain {sync_plain_ms:.4f} ms); main path "
              f"NG={ng} with sync states {sync_ms:.4f} ms")
    sync_step = sync_tiles * tile
    ranges = {"first": (0, 4096), "after_sync": (sync_step + 3, 4096),
              "two_lanes": (L - 2048, 4096),
              "two_groups": (g * L - 2048, 4096), "last": (n - 4096, 4096)}
    if ng < 2:  # a corpus cut to one group
        del ranges["two_groups"]
    range_ms = {}
    for name, (start, count) in ranges.items():
        with Recorder(rans_codec, "rans_decode_tiled") as dec:
            before = kernels.rans_decode_tiled.launches
            got, wall = plain_wall(lambda: rt.api.decode_range(
                blob, start, count, device="cuda"))
            launched = kernels.rans_decode_tiled.launches - before
        if got.dtype != np.int32 or not np.array_equal(
                got, data[start : start + count]):
            raise AssertionError(f"decode_range {name} [{start}, "
                                 f"{start + count}) is not exact")
        if launched < 1 or launched != len(dec.calls):
            raise AssertionError(f"decode_range {name}: {launched} launches")
        range_ms[name] = sum(cuda_ms(lambda a=a, kw=kw: kernels.
                                     rans_decode_tiled(*a, **kw))
                             for a, kw, _ in dec.calls)
        steps = [kw["block_len"] for _, kw, _ in dec.calls]
        smoke.say(f"decode_range {name} [{start}, {start + count}) exact: "
                  f"wall {wall:.4f} ms, {launched} decode launches of "
                  f"{steps} steps, kernel {range_ms[name]:.4f} ms")
    return {"sync_ms": sync_ms, "range_ms": range_ms}


def chunked_path(smoke: Smoke, main: dict) -> int:
    """Phase 8: the chunked encode (the path for inputs of 2^31 symbols or
    more) of the main path's corpus in slabs of 2^27 symbols; its
    container must be the single call's.  Returns its encode launches."""
    from range_coder_rust_tpu_torch import kernels, rans_codec

    data = main["data"]
    L = main["enc"][0].shape[1]  # the single call's lane length
    before = kernels.rans_encode_tiled.launches
    blob, wall = plain_wall(lambda: rans_codec._encode_chunked(
        data, alphabet=256, table=None, block_len=L, with_checksums=True,
        per_group_tables=False, sync_tiles=0, g=rans_codec.GROUP_LANES,
        device="cuda", slab_symbols=1 << 27))
    launched = kernels.rans_encode_tiled.launches - before
    if blob != main["blob"]:
        raise AssertionError("chunked container != the single call's")
    smoke.say(f"chunked encode in slabs of 2^27 symbols: {launched} encode "
              f"launches, wall {wall / 1e3:.4f} s, container byte-equal to "
              f"the single call's ({len(blob)} B)")
    return launched


def scalar_payload(block, table) -> bytes:
    """One block's stream from the port's scalar ``Encoder``: the golden
    coder the planar payloads are held to."""
    from range_coder_rust_tpu_torch import Encoder

    enc = Encoder()
    for s in block.tolist():
        enc.encode(table, s)
    return enc.finish()


def check_sampled_blocks(what, data, cont, n_sample: int = 64) -> int:
    """About ``n_sample`` evenly spaced blocks and the last one, each
    byte-equal to the scalar coder's stream with the container's table
    (the block's own for per-block tables; the last block padded as the
    encoder pads it).  Returns how many were checked."""
    import numpy as np

    from range_coder_rust_tpu_torch import FreqTable

    L, nb = cont.block_len, cont.n_blocks
    tables = np.asarray(cont.tables_c)
    shared = None if cont.per_block_tables else FreqTable.from_counts(tables)
    pad = 0 if cont.per_block_tables else int(np.argmax(tables))
    picks = sorted(set(np.linspace(0, nb - 1, n_sample).astype(int).tolist()
                       + [nb - 1]))
    for b in picks:
        block = np.full(L, pad, np.int64)
        part = data[b * L : (b + 1) * L]
        block[: part.size] = part
        table = (shared if shared is not None
                 else FreqTable.from_counts(tables[b]))
        if cont.payloads[b] != scalar_payload(block, table):
            raise AssertionError(f"{what}: block {b} != the scalar coder's")
    return len(picks)


def planar_round_trip(smoke, what, data, encode, device="cuda") -> dict:
    """Encode with ``encode(device)`` and decode with ``api.decode`` on
    ``device``, the launch counts reset before and read after: exact
    round trip (int32), walls, bits/sym, sampled blocks against the
    scalar coder, and the wall per step of the block coder (each device
    call of ``chunk_symbols`` symbols runs L + 1 encode steps and L decode
    steps).  On a card each device call launches each planar kernel once
    (the encode again for a capacity retry) and no rans16 kernel."""
    import numpy as np
    import torch

    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch import api, format as fmt

    rt.reset_launch_counts()
    blob, t_enc = timed(lambda: encode(device), device)
    out, t_dec = timed(lambda: rt.decode(blob, device=device), device)
    counts = rt.launch_counts()
    if out.dtype != np.int32 or not np.array_equal(out, data):
        raise AssertionError(f"{what}: round trip is not exact")
    cont = fmt.unpack(blob)
    n, L = data.size, cont.block_len
    calls = -(-cont.n_blocks // max(1, api._CHUNK_SYMBOLS // L))
    on_card = torch.device(device).type == "cuda"
    if (counts["rans_encode"] or counts["rans_decode"]
            or counts["planar_decode"] != (calls if on_card else 0)
            or not (counts["planar_encode"] >= calls if on_card
                    else counts["planar_encode"] == 0)):
        raise AssertionError(f"{what}: {calls} device calls, launches "
                             f"{counts}")
    checked = check_sampled_blocks(what, data, cont)
    res = {"blob": blob, "cont": cont, "enc_s": t_enc, "dec_s": t_dec,
           "bits": 8 * len(blob) / max(n, 1),
           "enc_step_ms": t_enc / (calls * (L + 1)) * 1e3,
           "dec_step_ms": t_dec / (calls * L) * 1e3, "counts": counts}
    smoke.say(f"{what}: n={n} L={L} blocks={cont.n_blocks} k={cont.k} "
              f"({calls} device calls): round trip exact (int32), encode "
              f"wall {t_enc:.4f} s = {n / t_enc / 1e9:.4f} GB/s "
              f"({res['enc_step_ms']:.4f} ms of wall a step), decode wall "
              f"{t_dec:.4f} s = {n / t_dec / 1e9:.4f} GB/s "
              f"({res['dec_step_ms']:.4f} ms of wall a step), container "
              f"{len(blob)} "
              f"B = {res['bits']:.5f} bits/sym, {checked} sampled blocks == "
              f"the scalar coder's, launches {counts}")
    return res


def planar_path(smoke, data, device="cuda") -> dict:
    """Phase 9: the planar profile, ``CodecConfig()``'s default (k = 16,
    L = 512, device calls of 2^24 symbols), on the main path's corpus:
    the round trip through the planar kernels (5.53008 bits/sym at
    256 MiB), the first 1024 blocks encoded again on the CPU (byte-equal
    payloads), and five ``decode_range`` slices."""
    import numpy as np

    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch import api
    from range_coder_rust_tpu_torch.models.table import Pow2Table

    cfg = rt.CodecConfig()
    res = planar_round_trip(smoke, "planar path", data, lambda dev: rt.encode(
        data, alphabet=256, config=cfg, device=dev), device)
    cont, L = res["cont"], cfg.block_len
    c = np.asarray(cont.tables_c, np.uint32)
    table = Pow2Table(c, np.concatenate([[0], np.cumsum(c)]).astype(np.uint32),
                      cont.k)
    nb = min(1024, data.size // L)
    (code, lengths), cpu_s = timed(lambda: api._encode_rows(
        data[: nb * L].reshape(nb, L), table,
        rt.blocks.default_capacity(L, cont.k), "cpu"), "cpu")
    if api._payloads(code, lengths) != cont.payloads[:nb]:
        raise AssertionError("planar path: the CPU's first blocks differ")
    smoke.say(f"planar path: the first {nb} blocks encoded again on the "
              f"CPU ({cpu_s:.4f} s): payloads byte-equal")
    n, chunk = data.size, cfg.chunk_symbols
    ranges = {"first": (0, 4096), "in_block": (3 * L + 5, 100),
              "two_blocks": (1000 * L - 7, 4096),
              "call_boundary": (max(0, min(chunk, n) - 2048), 4096),
              "last": (n - 4096, 4096)}
    if n == 256 << 20 and round(res["bits"], 5) != 5.53008:
        raise AssertionError(f"planar path: {res['bits']:.5f} bits/sym, the "
                             "reference's record for this corpus is 5.53008")
    range_ms = {}
    for name, (start, count) in ranges.items():
        count = min(count, n - start)
        got, wall = timed(lambda: rt.api.decode_range(
            res["blob"], start, count, device=device), device)
        if got.dtype != np.int32 or not np.array_equal(
                got, data[start : start + count]):
            raise AssertionError(f"planar decode_range {name} is not exact")
        range_ms[name] = wall * 1e3
        smoke.say(f"planar decode_range {name} [{start}, {start + count}) "
                  f"exact: wall {wall * 1e3:.4f} ms")
    res["range_ms"] = range_ms
    return res


def planar_kernels(smoke, data, cont, device="cuda") -> dict:
    """Phase 9's second half: phase 9's first device call (the first
    2^24 symbols of ``data``: 32768 blocks of 512, the container's table,
    k = 16) through each planar kernel and its plain version on the card.
    The kernel's payloads must be the container's and the plain version's
    bytes, and the decode the rows, both ways, in both input forms: the
    container's payloads where they lie (joined, as ``api.decode``
    uploads them) and their ``(B, C)`` matrix.  Returns each kernel's
    ms (CUDA events, mean of 3 after a warm-up; the decode's on the flat
    payloads, the matrix form's beside it) beside the plain version's
    (host clock, one run) and its bound, the largest differences, and the
    device kernels and busy share of one kernel round trip
    (``torch.profiler``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from range_coder_rust_tpu_torch import api, blocks, kernels, testing

    L, k = cont.block_len, cont.k
    nb = min(data.size, api._CHUNK_SYMBOLS) // L
    rows = blocks.upload_rows(data[: nb * L].reshape(nb, L), device)
    c_np = np.asarray(cont.tables_c, np.int64)
    c = torch.from_numpy(c_np).to(device)
    cum = torch.from_numpy(np.concatenate([[0], np.cumsum(c_np)])).to(device)
    enc_kw = dict(k=k, capacity=blocks.default_capacity(L, k))
    code_k, len_k = kernels.planar_encode_blocks(rows, c, cum, **enc_kw)
    (code_p, len_p), enc_plain_ms = plain_wall(
        lambda: kernels.planar_encode_plain(rows, c, cum, **enc_kw))
    lens = len_k.cpu().numpy()
    err = {"planar_encode": max(testing._max_abs(code_k, code_p),
                                testing._max_abs(len_k, len_p))}
    if (err["planar_encode"]
            or api._payloads(code_k.cpu().numpy(), lens)
            != cont.payloads[:nb]):
        raise AssertionError(f"planar encode kernel: {err}, or its payloads "
                             "differ from the container's")
    # the decode's two input forms: the payloads where they lie (joined,
    # with offsets and lengths, as api.decode uploads them) and the
    # (B, C) matrix of the rows, C rounded up to 1 KiB
    flat, offs, plens = blocks.payload_buffers(cont.payloads[:nb],
                                               cont.lengths[:nb], device)
    width = -(-max(int(cont.lengths.max()), 8) // 1024) * 1024
    rows_m = kernels.planar.payload_rows(flat, offs, plens)
    code = torch.zeros((nb, width), dtype=torch.uint8, device=device)
    code[:, : rows_m.shape[1]] = rows_m
    dec_kw = dict(k=k, block_len=L)
    flat_kw = dict(dec_kw, offsets=offs, lengths=plens)
    dec_k = kernels.planar_decode_blocks(flat, c, cum, **flat_kw)
    dec_m = kernels.planar_decode_blocks(code, c, cum, **dec_kw)
    dec_p, dec_plain_ms = plain_wall(
        lambda: kernels.planar_decode_plain(flat, c, cum, **flat_kw))
    err["planar_decode"] = max(testing._max_abs(dec_k, dec_p),
                               testing._max_abs(dec_m, dec_p))
    if err["planar_decode"] or not torch.equal(dec_k, rows.to(torch.int32)):
        raise AssertionError(f"planar decode kernel: {err}, or not the rows")
    smoke.say(f"planar kernels on the first device call ({nb} blocks x {L}, "
              f"{flat.numel()} payload bytes; code rows of {width} B): "
              f"payloads == the container's == the plain version's, decode "
              f"of the flat payloads and of the matrix == the rows == the "
              f"plain version's")
    times = {
        "planar_encode": (cuda_ms(lambda: kernels.planar_encode_blocks(
            rows, c, cum, **enc_kw)), enc_plain_ms),
        "planar_decode": (cuda_ms(lambda: kernels.planar_decode_blocks(
            flat, c, cum, **flat_kw)), dec_plain_ms),
    }
    matrix_ms = cuda_ms(lambda: kernels.planar_decode_blocks(
        code, c, cum, **dec_kw))
    # what the data needs: the symbols at their width and the table in,
    # the payload bytes and lengths out (the encode); the payload bytes
    # and the table in, the int32 symbols out (the decode)
    payload, tables, a = int(lens.sum()), nbytes(c, cum), c.numel()
    bounds = {
        "planar_encode": planar_bound(
            "planar_encode", nbytes(rows, len_k) + tables + payload,
            rows.numel(), payload, a),
        "planar_decode": planar_bound(
            "planar_decode", payload + tables + nbytes(dec_k), rows.numel(),
            payload, a),
    }
    for name, (k_ms, p_ms) in times.items():
        b_ms, b_by = bounds[name]
        smoke.say(f"{name} first device call B={nb} L={L} A={a}: kernel "
                  f"{k_ms:.4f} ms ({k_ms / L * 1e6:.2f} ns a step), plain "
                  f"PyTorch on the card {p_ms:.4f} ms, bound {b_ms:.6f} ms "
                  f"({b_by})")
    smoke.say(f"planar_decode of the (B, C) matrix: {matrix_ms:.4f} ms "
              f"({matrix_ms / L * 1e6:.2f} ns a step)")

    def round_trip():
        kernels.planar_encode_blocks(rows, c, cum, **enc_kw)
        kernels.planar_decode_blocks(flat, c, cum, **flat_kw)

    round_trip()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(round_trip, device)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    res = {"times": times, "bounds": bounds, "err": err,
           "matrix_ms": matrix_ms,
           "device_kernels": sorted({e.name[:60] for e in events}),
           "device_events": len(events),
           "busy_share": busy_us / (wall * 1e6) if events else None}
    smoke.say(f"planar kernel round trip under torch.profiler: "
              f"{res['device_events']} device events {res['device_kernels']},"
              f" busy share {res['busy_share']} of {wall * 1e3:.4f} ms "
              f"(None would mean: the trace held no device time)")
    return res


def planar_other_paths(smoke, data, mixed, device="cuda") -> dict:
    """Phase 10: the other planar paths, one device call (2^24 symbols)
    each: raw-count tables (total = the corpus count, 2^24), a
    4096-symbol alphabet under a rans16 config (the planar fallback), and
    per-block tables (``encode_adaptive``, k = 12, L = 512)."""
    import numpy as np

    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch import adaptive, testing

    n = min(data.size, 1 << 24)
    part, mixed = data[:n], mixed[:n]
    raw_cfg = rt.CodecConfig(raw_total=True)
    wide = testing.zipf(n, 4096, 0x4096, dtype=np.uint16)
    wide_cfg = rt.CodecConfig(profile="rans16")
    out = {
        "raw_total": planar_round_trip(
            smoke, "planar raw_total", part, lambda dev: rt.encode(
                part, alphabet=256, config=raw_cfg, device=dev), device),
        "fallback_4096": planar_round_trip(
            smoke, "planar fallback, 4096 symbols", wide,
            lambda dev: rt.encode(wide, alphabet=4096, config=wide_cfg,
                                  device=dev), device),
        "per_block": planar_round_trip(
            smoke, "planar per-block tables", mixed,
            lambda dev: adaptive.encode_adaptive(
                mixed, alphabet=256, k=12, block_len=512, device=dev),
            device),
    }
    total = int(np.asarray(out["raw_total"]["cont"].tables_c).sum())
    if out["fallback_4096"]["cont"].profile != "planar" or total != n:
        raise AssertionError("planar other paths: wrong container")
    smoke.say(f"planar raw_total total = {total} (the reference's two-stage "
              f"divide from 2^24 - 16 on); fallback container profile "
              f"{out['fallback_4096']['cont'].profile!r}")
    return out


def sharded_path(smoke, main: dict, device="cuda") -> dict:
    """Phase 11: the main path's kernel inputs through
    ``make_sharded_rans16`` over two shards on one device; every output
    must equal the single calls' (phase 4's), each kernel launched once a
    shard.  Returns the launch counts and walls."""
    import torch

    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch.parallel import make_sharded_rans16

    rows, cum, enc_kw, enc_k = main["enc"]
    (states, region, grp_off, dcum), dec_kw, dec_k = main["dec"]
    # a corpus cut below 128 MiB is one group: one shard
    shards = 2 if (grp_off.numel() - 1) % 2 == 0 else 1
    enc, dec = make_sharded_rans16(
        [torch.device(device)] * shards, block_len=rows.shape[1],
        a_count=dec_kw["a_count"])
    rt.reset_launch_counts()
    out, enc_s = timed(lambda: enc(rows, cum, **enc_kw), device)
    sym, dec_s = timed(lambda: dec(
        states, region, grp_off, dcum, group_lanes=dec_kw["group_lanes"],
        out_dtype=dec_kw["out_dtype"]), device)
    counts = rt.launch_counts()
    n = int(enc_k[1].sum())
    want = (enc_k[0], enc_k[1], enc_k[2][:n], enc_k[3])
    if (not all(torch.equal(a, b) for a, b in zip(out, want))
            or not torch.equal(sym, dec_k)):
        raise AssertionError("sharded rans16 != the single calls")
    if device == "cuda" and counts != {"rans_encode": shards,
                                       "rans_decode": shards,
                                       "planar_encode": 0,
                                       "planar_decode": 0}:
        raise AssertionError(f"sharded rans16 launches {counts}")
    smoke.say(f"sharded rans16 over {shards} shards on {device}: encode "
              f"{enc_s * 1e3:.4f} ms, decode {dec_s * 1e3:.4f} ms (host "
              f"walls, synchronised), outputs bit-identical to the single "
              f"calls', launches {counts}")
    return {"counts": counts, "enc_ms": enc_s * 1e3, "dec_ms": dec_s * 1e3}


def _table(c):
    """A shared ``Pow2Table`` from a container's counts."""
    import numpy as np

    from range_coder_rust_tpu_torch.models.table import Pow2Table

    c = np.asarray(c, np.uint32)
    return Pow2Table(c, np.concatenate([[0], np.cumsum(c)]).astype(np.uint32),
                     16)


class Stopwatch:
    """Wraps a module's function, summing the wall of its calls."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.seconds = 0.0

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kw)
        finally:
            self.seconds += time.perf_counter() - t0

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def rank_main(rank: int, port: int, world: int, tmp: str, job: dict) -> None:
    """One rank of phase 12 (spawned by ``multihost_path``): join the
    gloo group, code this rank's groups and blocks on ``job["device"]``,
    gather, and (rank 0) pack both containers into ``tmp``; write this
    rank's walls and launch counts to ``tmp/rank<r>.json``."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch.parallel import multihost as mh

    dev = job["device"]
    t_start = time.perf_counter()
    mh.initialize(f"localhost:{port}", world, rank)
    data = np.load(os.path.join(tmp, "corpus.npy"), mmap_mode="r")
    g, L = job["group_lanes"], job["block_len"]
    ng = data.size // (g * L)
    table = _table(job["rans16_c"])
    lo, hi = mh.local_group_range(ng)
    local = data[lo * g * L : hi * g * L].reshape(-1, L)
    res = {"rank": rank, "setup_s": time.perf_counter() - t_start}
    rt.reset_launch_counts()
    with Stopwatch(mh, "_gather") as gather:
        payloads, wall = timed(lambda: mh.encode_multihost_rans16(
            local, table, block_len=L, n_groups=ng, group_lanes=g,
            device=dev), dev)
    res["rans16"] = {"coding_s": wall - gather.seconds,
                     "gather_s": gather.seconds}
    back, res["rans16"]["decode_s"] = timed(lambda: mh.decode_multihost_rans16(
        payloads, table.c, block_len=L, group_lanes=g, device=dev), dev)
    res["launches"] = rt.launch_counts()
    if not np.array_equal(back, local):
        raise AssertionError(f"rank {rank}: rans16 decode is not exact")
    if rank == 0:
        blob, res["rans16"]["assembly_s"] = timed(
            lambda: mh.assemble_container(
                payloads, k=16, alphabet=256, block_len=L,
                n_symbols=data.size, tables_c=table.c, profile="rans16",
                group_lanes=g), "cpu")
        Path(tmp, "rans16.rc").write_bytes(blob)
    del payloads, back

    n, Lp = job["planar_n"], 512
    c = np.asarray(job["planar_c"], np.uint32)
    cum = np.concatenate([[0], np.cumsum(c)])
    blo, bhi = mh.local_block_range(n // Lp)
    rows = np.asarray(data[blo * Lp : bhi * Lp]).reshape(-1, Lp)
    rt.reset_launch_counts()
    with Stopwatch(mh, "_gather") as gather:
        (payloads, _), wall = timed(lambda: mh.encode_multihost(
            rows, c, cum, k=16, n_blocks=n // Lp, device=dev), dev)
    res["planar"] = {"coding_s": wall - gather.seconds,
                     "gather_s": gather.seconds}
    res["planar_launches"] = launched = rt.launch_counts()
    if (launched["rans_encode"] or launched["rans_decode"]
            or launched["planar_decode"]
            or launched["planar_encode"] < (dev.startswith("cuda"))):
        raise AssertionError(f"planar multihost launched {launched}")
    if rank == 0:
        blob, res["planar"]["assembly_s"] = timed(
            lambda: mh.assemble_container(
                payloads, k=16, alphabet=256, block_len=Lp, n_symbols=n,
                tables_c=c), "cpu")
        Path(tmp, "planar.rc").write_bytes(blob)
    torch.distributed.destroy_process_group()
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(res))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multihost_path(smoke, main: dict, tmp: str, device="cuda",
                   limit_s: float = 300.0) -> dict:
    """Phase 12: two spawned ranks over ``parallel.multihost`` (see
    ``rank_main``); rank 0's rans16 container must be phase 4's and its
    planar container ``api.encode``'s of the first 16 MiB.  Fails if a
    rank fails or the ranks take more than ``limit_s`` seconds."""
    import numpy as np
    import torch.multiprocessing as mp

    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch import format as fmt, rans_codec

    data, blob, world = main["data"], main["blob"], 2
    cont = fmt.unpack(blob)
    if cont.n_blocks % world:
        # a corpus cut below 128 MiB is one group: halve the lanes
        blob = rt.encode(data, alphabet=256, config=rt.CodecConfig(
            profile="rans16", block_len=cont.block_len // 2), device=device)
        cont = fmt.unpack(blob)
    n_planar = min(data.size, 1 << 24) // 512 * 512
    planar_blob, planar_s = timed(lambda: rt.encode(
        data[:n_planar], alphabet=256, config=rt.CodecConfig(),
        device=device), device)
    job = {"device": device, "group_lanes": cont.group_lanes,
           "block_len": cont.block_len,
           "rans16_c": np.asarray(cont.tables_c).tolist(),
           "planar_n": n_planar,
           "planar_c": np.asarray(fmt.unpack(planar_blob).tables_c).tolist()}
    if data.size != cont.n_blocks * cont.group_lanes * cont.block_len:
        raise AssertionError("phase 12 needs a corpus of whole groups")
    # what the ranks' coding splits: one process coding every group
    _, one_s = timed(lambda: rans_codec.encode_groups(
        data.reshape(-1, cont.block_len), _table(cont.tables_c),
        cont.block_len, cont.group_lanes, device=device), device)
    np.save(os.path.join(tmp, "corpus.npy"), data)
    t0 = time.perf_counter()
    ctx = mp.start_processes(rank_main, args=(free_port(), world, tmp, job),
                             nprocs=world, join=False, start_method="spawn")
    deadline = t0 + limit_s
    while not ctx.join(timeout=max(0.1, deadline - time.perf_counter())):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise AssertionError(f"multihost ranks still running after "
                                 f"{limit_s} s")
    wall = time.perf_counter() - t0
    ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
             for r in range(world)]
    if Path(tmp, "rans16.rc").read_bytes() != blob:
        raise AssertionError("two-rank rans16 container != api.encode's")
    if Path(tmp, "planar.rc").read_bytes() != planar_blob:
        raise AssertionError("two-rank planar container != api.encode's")
    for r in ranks:
        for leg in ("rans16", "planar"):
            x = r[leg]
            smoke.say(
                f"multihost rank {r['rank']} {leg}: coding "
                f"{x['coding_s']:.4f} s, gather {x['gather_s']:.4f} s "
                f"(both collectives, waiting for the other rank included)"
                + (f", assembly {x['assembly_s']:.4f} s"
                   if "assembly_s" in x else "")
                + (f", decode of its groups {x['decode_s']:.4f} s"
                   if "decode_s" in x else ""))
        smoke.say(f"multihost rank {r['rank']}: start to first coding "
                  f"{r['setup_s']:.4f} s, rans16 leg launches "
                  f"{r['launches']}, planar leg launches "
                  f"{r['planar_launches']}")
    smoke.say(f"multihost: one process coding all {cont.n_blocks} rans16 "
              f"groups (rans_codec.encode_groups): {one_s:.4f} s")
    smoke.say(f"multihost: 2 ranks ({wall:.4f} s in all, spawn included): "
              f"rans16 container byte-equal to api.encode's "
              f"({len(blob)} B), planar container of {n_planar} "
              f"symbols byte-equal to api.encode's ({len(planar_blob)} B, "
              f"api encode {planar_s:.4f} s)")
    return {"ranks": ranks, "wall_s": wall, "one_process_s": one_s,
            "launches": {k: [r["launches" if k.startswith("rans")
                                else "planar_launches"][k] for r in ranks]
                         for k in ("rans_encode", "rans_decode",
                                   "planar_encode", "planar_decode")}}


def cli_path(smoke, main: dict, tmp: str, device="cuda") -> dict:
    """Phase 13: ``python -m range_coder_rust_tpu_torch`` as subprocesses
    on the main path's corpus as a file: encode (with selftest beside
    it), then decode, decode --start/--count and inspect together.
    Returns each command's wall."""
    data, blob = main["data"], main["blob"]
    src = Path(tmp, "corpus.bin")
    data.tofile(src)
    rc, out, part = (Path(tmp, n) for n in ("cli.rc", "cli.out", "part.out"))
    L = main["enc"][0].shape[1]
    g = main["enc"][2]["group_lanes"]
    start, count = min(g * L, data.size - 2048) - 2048, 4096
    dev = ["--device", device]

    def run(batch: dict) -> dict:
        """Run the commands together; each must exit 0 within 300 s."""
        procs = {name: (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", PKG, *args], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
            for name, args in batch.items()}
        res = {}
        try:
            for name, (t0, p) in procs.items():
                so, se = p.communicate(timeout=300)
                res[name] = (time.perf_counter() - t0, so)
                if p.returncode != 0:
                    raise AssertionError(f"CLI {name} exited {p.returncode}:"
                                         f"\n{se[-3000:]}")
        finally:
            for _, p in procs.values():
                p.kill()
        return res

    walls = run({"encode": ["encode", str(src), "-o", str(rc),
                            "--block-len", str(L), *dev],
                 "selftest": ["selftest"]})
    if rc.read_bytes() != blob:
        raise AssertionError("CLI encode != api.encode's container")
    if not walls["selftest"][1].startswith("selftest passed"):
        raise AssertionError("CLI selftest")
    walls |= run({"decode": ["decode", str(rc), "-o", str(out), *dev],
                  "decode_range": ["decode", str(rc), "-o", str(part),
                                   "--start", str(start), "--count",
                                   str(count), *dev],
                  "inspect": ["inspect", str(rc)]})
    if out.read_bytes() != data.tobytes():
        raise AssertionError("CLI decode != the corpus")
    if part.read_bytes() != data[start : start + count].tobytes():
        raise AssertionError("CLI decode --start/--count != the slice")
    meta = json.loads(walls["inspect"][1])
    if (meta["n_symbols"] != data.size or meta["profile"] != "rans16"
            or meta["container_bytes"] != len(blob)):
        raise AssertionError(f"CLI inspect: {meta}")
    for name, (wall, so) in walls.items():
        said = (json.dumps(meta) if name == "inspect"
                else so.strip().splitlines()[-1])
        smoke.say(f"CLI {name}: exit 0 in {wall:.4f} s (process wall): "
                  f"{said[:200]}")
    smoke.say(f"CLI on {device}: encode byte-equal to phase 4's container, "
              f"decode exact, decode [{start}, {start + count}) exact, "
              f"inspect n_symbols {meta['n_symbols']}")
    return {name: wall for name, (wall, _) in walls.items()}


#: the reference's scalar baseline on the 256 MiB corpus's first 4 MiB
#: (``BENCH_256MB_r05.json``): a property of the bytes, not of a chip
SCALAR_BITS_256MB = 5.2923


def bench_path(smoke, main: dict, corpus_mb: int) -> dict:
    """Phase 14: ``python -m range_coder_rust_tpu_torch bench`` as a
    subprocess, rans16 at the main path's corpus size, then planar at
    16 MiB.  Each must exit 0 within 300 s; returns each JSON line and
    the process wall under ``wall_s``."""
    runs = {"rans16": corpus_mb, "planar": min(corpus_mb, 16)}
    lines = {}
    for profile, mb in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "bench", "--mb", str(mb),
             "--device", "cuda"], cwd=ROOT, text=True, capture_output=True,
            env={**os.environ, "RC_BENCH_PROFILE": profile}, timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"bench {profile} exited {proc.returncode}:"
                                 f"\n{proc.stderr[-3000:]}")
        for said in proc.stderr.strip().splitlines():
            smoke.say(f"bench {profile} log: {said}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        smoke.say(f"bench {profile} --mb {mb}: exit 0 in {wall:.4f} s "
                  f"(process wall): {json.dumps(line)}")
        lines[profile] = dict(line, wall_s=wall)
    r16 = lines["rans16"]
    bits, n = r16["bits_per_symbol_container"], main["data"].size
    want = 8 * len(main["blob"]) / n
    # the bench's container holds the whole groups: the corpus, at any
    # size that fills them
    if r16["groups"] * 2048 * r16["lane_len"] == n and bits != want:
        raise AssertionError(f"bench rans16 {bits} bits/sym, phase 4's "
                             f"container {want}")
    scalar = r16["scalar_bits_per_symbol"]
    if corpus_mb == 256 and round(scalar, 4) != SCALAR_BITS_256MB:
        raise AssertionError(f"bench scalar baseline {scalar} bits/sym, the "
                             f"reference's {SCALAR_BITS_256MB}")
    smoke.say(f"bench: rans16 container {bits} bits/sym == phase 4's, "
              f"scalar baseline {scalar} bits/sym")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus-mb", type=int, default=256,
                    help="corpus size of every path in MiB (default 256)")
    args = ap.parse_args()
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke.py: {PKG}/ not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    card = card_line()
    print(card, flush=True)
    smoke = Smoke(card)
    smoke.say(f"device {torch.cuda.get_device_name(0)}, count "
              f"{torch.cuda.device_count()}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")

    from range_coder_rust_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    smoke.say(f"kernels built and loaded in {time.perf_counter() - t0:.3f} s "
              f"({lib_path.relative_to(ROOT)})")
    ptxas = lib_path.parent / "ptxas.txt"  # written by the same build
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")):
                smoke.say(f"ptxas: {line.strip()}")

    walls = {}

    def phase(name, fn, *a):
        """Run one phase and keep its wall."""
        t0 = time.perf_counter()
        out = fn(smoke, *a)
        walls[name] = time.perf_counter() - t0
        smoke.say(f"phase {name}: {walls[name]:.3f} s")
        return out

    err = phase("3 kernels vs plain", check_kernels)
    main = phase("4 main path", main_path, args.corpus_mb)
    vs = phase("5 main path vs plain", main_path_vs_plain, main)
    adapt = phase("6 adaptive path", adaptive_path, args.corpus_mb)
    ra = phase("7 random access", random_access_path, main)
    chunked_launches = phase("8 chunked", chunked_path, main)
    import numpy as np

    from range_coder_rust_tpu_torch import testing

    planar = phase("9 planar", planar_path, main["data"])
    planar["kernels"] = phase("9 planar loops", planar_kernels, main["data"],
                              planar["cont"])
    mixed = testing.mixed_corpus(
        min(main["data"].size, 1 << 24)).astype(np.uint8)
    other = phase("10 other planar", planar_other_paths, main["data"], mixed)
    sharded = phase("11 sharded rans16", sharded_path, main)
    with tempfile.TemporaryDirectory() as tmp:
        multi = phase("12 two ranks", multihost_path, main, tmp)
        cli = phase("13 CLI", cli_path, main, tmp)
    phase("14 bench", bench_path, main, args.corpus_mb)
    smoke.say("phase walls (s): " + json.dumps(walls))
    smoke.say("planar paths: " + json.dumps({
        name: {k: r[k] for k in ("enc_s", "dec_s", "bits", "enc_step_ms",
                                 "dec_step_ms")}
        for name, r in {"main": planar, **other}.items()}
        | {"kernels": {k: planar["kernels"][k] for k in (
            "times", "bounds", "matrix_ms", "device_events",
            "busy_share")}}))
    for name in ("rans_encode", "rans_decode"):
        err[name] = max(err[name], vs["err"][name], adapt["err"][name])
    for name in ("planar_encode", "planar_decode"):
        err[name] = max(err[name], planar["kernels"]["err"][name])

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "range_coder_rust_tpu"))
    if foreign:
        raise AssertionError(f"the port imported jax or the JAX package: "
                             f"{foreign[:5]}")
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": main["counts"][name],
         "max_abs_err": err[name], "ms": vs["times"][name][0],
         "plain_ms": vs["times"][name][1],
         "bound_ms": vs["bounds"][name][0], "bound_by": vs["bounds"][name][1],
         "library_ms": None, "first_group_ms": vs["first"][name][0],
         "first_group_plain_ms": vs["first"][name][1],
         "adaptive_launches": adapt["counts"][name],
         "adaptive_ms": adapt["times"][name][0],
         "adaptive_plain_ms": adapt["times"][name][1],
         "adaptive_bound_ms": adapt["bounds"][name][0],
         "adaptive_one_step_ms": adapt["one_step"][name],
         **({"sync_ms": ra["sync_ms"], "chunked_launches": chunked_launches}
            if name == "rans_encode" else {"range_ms": ra["range_ms"]}),
         "sharded_launches": sharded["counts"][name],
         "multihost_launches": multi["launches"][name]}
        for name in ("rans_encode", "rans_decode")] + [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": planar["counts"][name],
         "max_abs_err": err[name],
         "ms": planar["kernels"]["times"][name][0],
         "plain_ms": planar["kernels"]["times"][name][1],
         "bound_ms": planar["kernels"]["bounds"][name][0],
         "bound_by": planar["kernels"]["bounds"][name][1],
         "library_ms": None,
         "other_paths_launches": {p: r["counts"][name]
                                  for p, r in other.items()},
         **({"matrix_ms": planar["kernels"]["matrix_ms"]}
            if name == "planar_decode" else {}),
         "multihost_launches": multi["launches"][name]}
        for name in ("planar_encode", "planar_decode")]}
    smoke.say("CLI walls (s): " + json.dumps(cli))
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
