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
   variant and its ring read past its window;
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
   device calls of 2^24 symbols; PyTorch ops on the card, no kernel of
   its own) on the main path's corpus: an exact int32 round trip, its
   bits/sym, walls and wall per step of the block loops, about 64
   sampled blocks and the last one byte-equal to the port's scalar
   ``Encoder``, the first 1024 blocks encoded again on the CPU
   (byte-equal), and five ``decode_range`` slices;
10. the other planar paths, one device call (16 MiB) each: raw-count
   tables (total 2^24, where the reference switches its decode divide),
   a 4096-symbol alphabet under a rans16 config (the planar fallback),
   and per-block tables (``adaptive.encode_adaptive``, k = 12, L = 512,
   on the adaptive path's mixed corpus); each exact, sampled blocks
   against the scalar coder.

Each path resets the launch counts just before it runs and reads them
just after (the planar paths launch no rans16 kernel).  It prints one
JSON line on the kernels (the main path's numbers under the contract's
keys, the other paths' under added keys), then, as its last line,
``{"ok": true, "device": {...}}``.  It imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "range_coder_rust_tpu_torch"
REPLACES = {
    "rans_encode": "range_coder_rust_tpu/kernels/rans_encode.py:175",
    "rans_decode": "range_coder_rust_tpu/kernels/rans_decode.py:75",
}
SOURCES = {
    "rans_encode": f"{PKG}/csrc/rans_encode.cu",
    "rans_decode": f"{PKG}/csrc/rans_decode.cu",
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

    err = {"rans_encode": 0, "rans_decode": 0}
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
    unless the round trip is exact and each kernel ran."""
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
    if min(counts.values()) < 1:
        raise AssertionError(f"{what}: a kernel never launched: {counts}")
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
    scalar coder, and the wall per step of the block loops (each device
    call of ``chunk_symbols`` symbols runs L + 1 encode steps and L decode
    steps)."""
    import numpy as np

    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch import api, format as fmt

    rt.reset_launch_counts()
    blob, t_enc = timed(lambda: encode(device), device)
    out, t_dec = timed(lambda: rt.decode(blob, device=device), device)
    counts = rt.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{what}: launched a rans16 kernel: {counts}")
    if out.dtype != np.int32 or not np.array_equal(out, data):
        raise AssertionError(f"{what}: round trip is not exact")
    cont = fmt.unpack(blob)
    checked = check_sampled_blocks(what, data, cont)
    n, L = data.size, cont.block_len
    calls = -(-cont.n_blocks // max(1, api._CHUNK_SYMBOLS // L))
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
              f"the scalar coder's, rans16 launches {counts}")
    return res


def planar_path(smoke, data, device="cuda") -> dict:
    """Phase 9: the planar profile, ``CodecConfig()``'s default (k = 16,
    L = 512, device calls of 2^24 symbols), on the main path's corpus:
    the round trip, the first 1024 blocks encoded again on the CPU
    (byte-equal payloads), and five ``decode_range`` slices."""
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


def planar_loops(smoke, data, device="cuda") -> dict:
    """The planar block loops alone, on the first device call's blocks
    (2^24 symbols of ``data``, k = 16, L = 512), synchronised: ms per step
    of the encode scan (L + 1 transitions) and of the decode (L), the
    compaction's ms, and from ``torch.profiler`` over 64 steps of each,
    the device kernels launched a step and the device's busy share (the
    kernels' summed device time over the profiled wall)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from range_coder_rust_tpu_torch import blocks
    from range_coder_rust_tpu_torch.models.table import build_table_pow2

    L, k = 512, 16
    nb = min(data.size, 1 << 24) // L
    host = data[: nb * L].reshape(nb, L)
    t = build_table_pow2(np.bincount(host.reshape(-1), minlength=256), k)
    c = torch.from_numpy(t.c.astype(np.int64)).to(device)
    cum = torch.from_numpy(t.cum.astype(np.int64)).to(device)
    rows = blocks.upload_rows(host, device)
    (emit, en, pos, lengths), t_scan = timed(
        lambda: blocks.encode_scan(rows, c, cum, k=k), device)
    cap = blocks.default_capacity(L, k)
    code, t_comp = timed(lambda: blocks.compact_emissions(
        emit, en, pos, capacity=cap), device)
    dec, t_dec = timed(lambda: blocks.decode_blocks(
        code, c, cum, k=k, block_len=L), device)
    if not torch.equal(dec.long(), rows):
        raise AssertionError("planar loops: decode != the rows")
    res = {"enc_step_ms": t_scan / (L + 1) * 1e3,
           "dec_step_ms": t_dec / L * 1e3, "compact_ms": t_comp * 1e3}
    steps = 64
    part = rows[:, :steps].contiguous()
    code_part = blocks.encode_blocks(part, c, cum, k=k,
                                     capacity=cap)[0]
    for name, fn in (("encode", lambda: blocks.encode_scan(part, c, cum, k=k)),
                     ("decode", lambda: blocks.decode_blocks(
                         code_part, c, cum, k=k, block_len=steps))):
        fn()
        sync(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = timed(fn, device)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        res[f"{name}_kernels_a_step"] = len(kernels) / steps
        res[f"{name}_busy_share"] = (busy_us / (wall * 1e6)
                                     if kernels else None)
    smoke.say(
        f"planar loops, {nb} blocks x {L} on {device}: encode scan "
        f"{t_scan:.4f} s = {res['enc_step_ms']:.4f} ms a step, compaction "
        f"{res['compact_ms']:.4f} ms, decode {t_dec:.4f} s = "
        f"{res['dec_step_ms']:.4f} ms a step; over {steps} steps "
        f"(torch.profiler): encode {res['encode_kernels_a_step']:.2f} "
        f"kernels a step, busy share {res['encode_busy_share']}, decode "
        f"{res['decode_kernels_a_step']:.2f} kernels a step, busy share "
        f"{res['decode_busy_share']} (None: the trace held no device "
        f"time, not measured)")
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

    err = check_kernels(smoke)
    main = main_path(smoke, args.corpus_mb)
    vs = main_path_vs_plain(smoke, main)
    adapt = adaptive_path(smoke, args.corpus_mb)
    ra = random_access_path(smoke, main)
    chunked_launches = chunked_path(smoke, main)
    import numpy as np

    from range_coder_rust_tpu_torch import testing

    planar = planar_path(smoke, main["data"])
    planar["loops"] = planar_loops(smoke, main["data"])
    mixed = testing.mixed_corpus(
        min(main["data"].size, 1 << 24)).astype(np.uint8)
    other = planar_other_paths(smoke, main["data"], mixed)
    smoke.say("planar paths: " + json.dumps({
        name: {k: r[k] for k in ("enc_s", "dec_s", "bits", "enc_step_ms",
                                 "dec_step_ms")}
        for name, r in {"main": planar, **other}.items()}
        | {"loops": planar["loops"]}))
    for name in err:
        err[name] = max(err[name], vs["err"][name], adapt["err"][name])

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
            if name == "rans_encode" else {"range_ms": ra["range_ms"]})}
        for name in ("rans_encode", "rans_decode")]}
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
