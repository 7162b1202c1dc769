#!/usr/bin/env python3
"""Where a hand-written kernel's time goes, on one CUDA card.

    python3 scripts_torch/decode_variants.py
        [--kernel decode|encode|planar_decode|planar_encode]
        [--corpus-mb 256] [--variants as_is,...] [--baseline DIR]

Builds the kernel's source (``range_coder_rust_tpu_torch/csrc/
rans_decode.cu``, ``rans_encode.cu``, ``planar_decode.cu`` or
``planar_encode.cu``) once per variant, each with one of the kernel's
``RC_VARIANT_*`` macros defined (the normal build defines none; the
planar ones are listed in ``csrc/planar_device.cuh``), into
``build/<kernel>_variants/<name>/``, one ``nvcc`` per variant, all
started together.  It then times each variant with CUDA events (mean of 3
after a warm-up) in the order given, then the first variant again, and
every variant must give the package kernel's output exactly; the run
fails otherwise.

* rans16 (``decode``, ``encode``): chip_smoke's main path (Zipf(1.2)
  bytes, seed 0xC0, 2048-lane groups, L = 32768) encoded by the package's
  own kernels, timed at the main path's shape and for its first group
  alone; the decode's symbols, the encode's states, sizes and region are
  compared.
* planar (``planar_decode``, ``planar_encode``): chip_smoke's phase 9
  first device call (the corpus's first 2^24 symbols, 32768 blocks of
  512, the table of the whole corpus at k = 16, as ``api.encode`` builds
  it), and the same rows under their raw counts (total 2^24, phase 10's
  raw-total path); the encode's payload matrix (zeroed in the timed call,
  as the wrapper does) and lengths, the decode's symbols from the
  payloads where they lie (as ``api.decode`` uploads them) are compared.

``--baseline DIR`` adds the kernel of another checkout (its
``range_coder_rust_tpu_torch/csrc``), for instance the parent commit
unpacked with ``git archive``, timed the same way.  A kernel is called
with the interface its source declares: without ``cum_stride`` (one
shared table, no sync states), an encode kernel without
``rc_rans_encode_plan`` with the older one of int32 rows (a u32 park, the
widening of the rows timed with it), and a planar decode without
``code_bytes`` with the ``(B, C)`` matrix of the payloads (C rounded up
to 1 KiB, as that interface's api built it).

Every line carries the card's name and power limit.  It imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import card_line  # noqa: E402

CSRC = ROOT / "range_coder_rust_tpu_torch" / "csrc"

#: kernel -> name -> (what it measures, nvcc defines).  The reverts undo
#: one design point each of the kernel's header.
VARIANTS = {
    "decode": {
        "as_is": ("the kernel as committed", []),
        "direct_stores": (
            "design point 1 reverted: one store per lane per step",
            ["RC_VARIANT_DIRECT_STORES"]),
        "binary_search": (
            "design point 2 reverted: binary search on cum for each symbol",
            ["RC_VARIANT_BINARY_SEARCH"]),
        "device_refill": (
            "design point 3 reverted: every refill read from device memory",
            ["RC_VARIANT_DEVICE_REFILL"]),
        "two_barriers": (
            "design point 4 reverted: a second barrier on every step",
            ["RC_VARIANT_TWO_BARRIERS"]),
        "lanes_2": ("2048-lane groups as 1024 threads of 2 lanes",
                    ["RC_VARIANT_WIDE_LANES=2"]),
        "lanes_8": ("2048-lane groups as 256 threads of 8 lanes",
                    ["RC_VARIANT_WIDE_LANES=8"]),
    },
    "encode": {
        "as_is": ("the kernel as committed", []),
        "int32_symbols": (
            "design point 1 reverted: int32 rows (their widening timed "
            "with the kernel), one scalar load per step",
            ["RC_VARIANT_INT32_SYMBOLS"]),
        "div64": ("design point 2 reverted: a 64-bit division per step",
                  ["RC_VARIANT_DIV64"]),
        "u32_park": (
            "design point 3 reverted: u32 park, flags ranked by block scans",
            ["RC_VARIANT_U32_PARK"]),
        "threads_32": ("chain blocks of 32 threads",
                       ["RC_VARIANT_CHAIN_THREADS=32"]),
        "threads_128": ("chain blocks of 128 threads",
                        ["RC_VARIANT_CHAIN_THREADS=128"]),
        "always_sync": (
            "design point 5 reverted: the sync-state build without syncs",
            ["RC_VARIANT_ALWAYS_SYNC"]),
    },
    "planar_decode": {
        "as_is": ("the kernel as committed", []),
        "binary_search": (
            "design point 1 reverted: binary search of the staged pairs, "
            "no slot table", ["RC_VARIANT_PLANAR_BINARY_SEARCH"]),
        "div64": ("design point 2 reverted: u64 `/` for the target (and a "
                  "raw total's rpt)", ["RC_VARIANT_PLANAR_DIV64"]),
        "byte_refill": (
            "design point 3 reverted: the window refilled one byte load at "
            "a time", ["RC_VARIANT_PLANAR_BYTE_REFILL"]),
        "scalar_stores": ("design point 4 reverted: one 4-byte store a "
                          "symbol", ["RC_VARIANT_PLANAR_SCALAR_STORES"]),
        "threads_64": ("design point 5 reverted: 64-thread CTAs",
                       ["RC_VARIANT_PLANAR_DECODE_THREADS=64"]),
        "threads_128": ("128-thread CTAs",
                        ["RC_VARIANT_PLANAR_DECODE_THREADS=128"]),
    },
    "planar_encode": {
        "as_is": ("the kernel as committed", []),
        "scalar_symbols": (
            "design point 1 reverted: a symbol and its table entry read in "
            "the step, one scalar load each",
            ["RC_VARIANT_PLANAR_SCALAR_SYMBOLS"]),
        "byte_writer": ("design point 2 reverted: the per-byte ByteSink",
                        ["RC_VARIANT_PLANAR_BYTE_WRITER"]),
        "div64": ("design point 3 reverted: a raw total's rpt by u64 `/`",
                  ["RC_VARIANT_PLANAR_DIV64"]),
        "threads_64": ("design point 4 reverted: 64-thread CTAs",
                       ["RC_VARIANT_PLANAR_ENCODE_THREADS=64"]),
        "threads_256": ("256-thread CTAs, the decode's",
                        ["RC_VARIANT_PLANAR_ENCODE_THREADS=256"]),
    },
}

#: kernel -> its source under csrc/
SOURCE = {"decode": "rans_decode.cu", "encode": "rans_encode.cu",
          "planar_decode": "planar_decode.cu",
          "planar_encode": "planar_encode.cu"}


def interface(src: Path, kernel: str) -> str:
    """Which C interface a kernel source declares: "current",
    "shared_table" (one shared table, no sync states), "int32_rows"
    (encode: int32 rows, a u32 park) or "matrix" (planar decode: a (B, C)
    code matrix)."""
    text = (src / SOURCE[kernel]).read_text()
    if kernel == "planar_decode":
        return "current" if "code_bytes" in text else "matrix"
    if kernel == "planar_encode" or "cum_stride" in text:
        return "current"
    return ("shared_table" if kernel == "decode"
            or "rc_rans_encode_plan" in text else "int32_rows")


def build_all(kernel: str, dirs: dict) -> dict:
    """Start one nvcc per variant, wait for all; name -> (loaded library,
    its interface).  ``dirs`` maps a name to (source directory,
    defines)."""
    from range_coder_rust_tpu_torch.kernels import _build

    procs = {}
    for name, (src, defines) in dirs.items():
        out = ROOT / "build" / f"{kernel}_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        lib = out / f"librc_{kernel}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               *[f"-D{d}" for d in defines], "-o", str(lib),
               str(src / SOURCE[kernel])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       lib)
    errs = {name: proc.communicate()[1] for name, (proc, _) in procs.items()}
    failed = [n for n, (proc, _) in procs.items() if proc.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{errs[failed[0]]}")
    return {name: (ctypes.CDLL(str(lib)), interface(dirs[name][0], kernel))
            for name, (_, lib) in procs.items()}


def _entry(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(err: int) -> None:
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def main_path_inputs(corpus_mb: int):
    """chip_smoke's main path encoded by the package's kernels: (u8 rows,
    cum, tile, encode output, decode output)."""
    import torch

    from range_coder_rust_tpu_torch import kernels, rans_codec
    from range_coder_rust_tpu_torch.models.table import table_from_data_pow2
    from range_coder_rust_tpu_torch.testing import make_corpus

    g, L = rans_codec.GROUP_LANES, 32768
    rows_np = make_corpus(corpus_mb << 20).reshape(-1, L)
    table = table_from_data_pow2(rows_np, 256, 16)
    cum = rans_codec.cum_table(table.cum, "cuda")
    rows = rans_codec._upload_rows(rows_np, "cuda")
    tile, _ = rans_codec._tile_geometry(L, g)
    enc = kernels.rans_encode_tiled(rows, cum, group_lanes=g, tile=tile)
    states, sizes, region, _ = enc
    n_hw = int(sizes.sum())
    grp_off = torch.cat([sizes.new_zeros(1, dtype=torch.int64),
                         sizes.sum(1).cumsum(0)])
    dec = kernels.rans_decode_tiled(
        states, region[:n_hw].clone(), grp_off, cum, group_lanes=g,
        block_len=L, a_count=256, out_dtype=torch.uint8)
    return rows, cum, tile, enc, dec


def decode_runners(libs: dict, rows, cum, tile, enc, want):
    """name -> (run(n_groups), exact()) for the decode variants."""
    import torch

    from range_coder_rust_tpu_torch.kernels import _build

    g, L = 2048, rows.shape[1]
    states, sizes, region, _ = enc
    n_hw = int(sizes.sum())
    region = region[:n_hw].clone()
    grp_off = torch.cat([sizes.new_zeros(1, dtype=torch.int64),
                         sizes.sum(1).cumsum(0)])
    out = torch.empty_like(want)
    runners = {}
    for name, (lib, iface) in libs.items():
        sig = list(_build.SIGNATURES["rc_rans_decode"])
        # the table's stride (0: one shared table), after cum
        stride = [] if iface == "shared_table" else [0]
        if iface == "shared_table":
            del sig[5]
        fn = _entry(lib, "rc_rans_decode", sig)

        def run(n_groups, fn=fn, stride=stride):
            _launch(fn(states.data_ptr(), region.data_ptr(), n_hw,
                       grp_off.data_ptr(), cum.data_ptr(), *stride,
                       out.data_ptr(), n_groups, g, L, 256, 1,
                       torch.cuda.current_stream().cuda_stream))

        def exact(run=run):
            out.zero_()
            run(rows.shape[0] // g)
            torch.cuda.synchronize()
            return bool(torch.equal(out, want))

        runners[name] = (run, exact)
    return runners


def encode_runners(libs: dict, rows, cum, tile, want):
    """name -> (run(n_groups), exact()) for the encode variants."""
    import torch

    from range_coder_rust_tpu_torch.kernels import _build

    g, L = 2048, rows.shape[1]
    ng, nt = rows.shape[0] // g, L // tile
    dev = rows.device
    states = torch.empty(rows.shape[0], dtype=torch.int64, device=dev)
    sizes = torch.empty((ng, nt), dtype=torch.int32, device=dev)
    offs = torch.empty(ng * nt + 1, dtype=torch.int64, device=dev)
    region = torch.empty(rows.numel(), dtype=torch.int16, device=dev)
    scratch = torch.empty(4 * rows.numel(), dtype=torch.uint8, device=dev)
    n_want = int(want[1].sum())
    runners = {}
    for name, (lib, iface) in libs.items():
        int32_rows = name == "int32_symbols" or iface == "int32_rows"
        if iface == "current":
            fn = _entry(lib, "rc_rans_encode",
                        _build.SIGNATURES["rc_rans_encode"])

            def call(r, n_groups, fn=fn):  # one shared table, no syncs
                return fn(r.data_ptr(), r.element_size(), cum.data_ptr(), 0,
                          states.data_ptr(), sizes.data_ptr(),
                          offs.data_ptr(), None, 0, scratch.data_ptr(),
                          scratch.numel(), region.data_ptr(), n_groups, g, L,
                          tile, torch.cuda.current_stream().cuda_stream)
        elif iface == "shared_table":
            fn = _entry(lib, "rc_rans_encode", [ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                                   ctypes.c_void_p]
                        + [ctypes.c_int] * 4 + [ctypes.c_void_p])

            def call(r, n_groups, fn=fn):
                return fn(r.data_ptr(), r.element_size(), cum.data_ptr(),
                          states.data_ptr(), sizes.data_ptr(),
                          offs.data_ptr(), scratch.data_ptr(),
                          scratch.numel(), region.data_ptr(), n_groups, g, L,
                          tile, torch.cuda.current_stream().cuda_stream)
        else:  # int32 rows, a u32 park
            fn = _entry(lib, "rc_rans_encode", [ctypes.c_void_p] * 7 +
                        [ctypes.c_int] * 4 + [ctypes.c_void_p])

            def call(r, n_groups, fn=fn):
                return fn(r.data_ptr(), cum.data_ptr(), states.data_ptr(),
                          sizes.data_ptr(), offs.data_ptr(),
                          scratch.data_ptr(), region.data_ptr(), n_groups,
                          g, L, tile, torch.cuda.current_stream().cuda_stream)

        def run(n_groups, call=call, int32_rows=int32_rows):
            r = rows[:n_groups * g]
            _launch(call(r.to(torch.int32) if int32_rows else r, n_groups))

        def exact(run=run):
            region.zero_()
            run(ng)
            torch.cuda.synchronize()
            return bool(torch.equal(states, want[0])
                        and torch.equal(sizes, want[1])
                        and torch.equal(region[:n_want], want[2][:n_want]))

        runners[name] = (run, exact)
    return runners


def planar_inputs(corpus_mb: int) -> dict:
    """chip_smoke's phase 9 first device call on the card: ``rows`` (u8),
    and for each of ``pow2`` (the corpus's table at k = 16) and ``raw``
    (the rows' own counts, total 2^24): the table, the total's kwargs, the
    package kernels' code matrix and lengths, and the payloads where they
    lie (flat, offsets, lengths)."""
    import numpy as np
    import torch

    from range_coder_rust_tpu_torch import blocks, kernels
    from range_coder_rust_tpu_torch.models.table import build_table_pow2
    from range_coder_rust_tpu_torch.testing import make_corpus

    data = make_corpus(corpus_mb << 20)
    L = 512
    nb = min(data.size, 1 << 24) // L
    rows_np = data[: nb * L].reshape(nb, L)
    rows = blocks.upload_rows(rows_np, "cuda")
    table = build_table_pow2(
        np.bincount(data, minlength=256).astype(np.uint64), 16)
    raw = np.bincount(rows_np.reshape(-1), minlength=256).astype(np.int64)
    out = {"rows": rows, "L": L}
    for name, c_np, kw in (("pow2", table.c.astype(np.int64), {"k": 16}),
                           ("raw", raw, {"total": int(raw.sum())})):
        c = torch.from_numpy(c_np).cuda()
        cum = torch.from_numpy(np.concatenate([[0], np.cumsum(c_np)])).cuda()
        cap = blocks.default_capacity(L, 16)
        code, lengths = kernels.planar_encode_blocks(rows, c, cum,
                                                     capacity=cap, **kw)
        keep = torch.arange(cap, device="cuda") < lengths[:, None]
        offsets = torch.cumsum(lengths, 0) - lengths
        width = -(-int(lengths.max()) // 1024) * 1024
        matrix = torch.zeros((nb, width), dtype=torch.uint8, device="cuda")
        matrix[:, : min(width, cap)] = code[:, :width]
        out[name] = {"c": c, "cum": cum, "kw": kw, "cap": cap, "code": code,
                     "lengths": lengths, "flat": code[keep],
                     "offsets": offsets, "matrix": matrix}
    return out


def _k_total(kw: dict) -> tuple:
    return (kw["k"], 1 << kw["k"]) if "k" in kw else (0, kw["total"])


def planar_runners(kernel: str, libs: dict, inp: dict) -> dict:
    """name -> (run(table), exact()) for the planar variants; `table` is
    "pow2" or "raw"."""
    import torch

    from range_coder_rust_tpu_torch.kernels import _build

    rows, L = inp["rows"], inp["L"]
    nb = rows.shape[0]
    dev_out = torch.empty((nb, L), dtype=torch.int32, device="cuda")
    enc_code = torch.empty_like(inp["pow2"]["code"])
    enc_len = torch.empty_like(inp["pow2"]["lengths"])
    def stream():
        return torch.cuda.current_stream().cuda_stream

    runners = {}
    for name, (lib, iface) in libs.items():
        if kernel == "planar_encode":
            fn = _entry(lib, "rc_planar_encode",
                        _build.SIGNATURES["rc_planar_encode"])

            def run(t, fn=fn):
                x = inp[t]
                k, total = _k_total(x["kw"])
                enc_code.zero_()  # the wrapper's zeroed output
                _launch(fn(rows.data_ptr(), 1, x["c"].data_ptr(),
                           x["cum"].data_ptr(), 0, 256, k, total,
                           enc_code.data_ptr(), enc_len.data_ptr(), nb, L,
                           x["cap"], stream(), None, None))

            def exact(run=run):
                ok = True
                for t in ("pow2", "raw"):
                    run(t)
                    torch.cuda.synchronize()
                    ok &= bool(torch.equal(enc_code, inp[t]["code"])
                               and torch.equal(enc_len, inp[t]["lengths"]))
                return ok
        elif iface == "matrix":
            fn = _entry(lib, "rc_planar_decode",
                        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_ulonglong, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])

            def run(t, fn=fn):
                x = inp[t]
                k, total = _k_total(x["kw"])
                _launch(fn(x["matrix"].data_ptr(), x["matrix"].shape[1],
                           x["c"].data_ptr(), x["cum"].data_ptr(), 0, 256, k,
                           total, dev_out.data_ptr(), nb, L, stream()))
        else:
            fn = _entry(lib, "rc_planar_decode",
                        _build.SIGNATURES["rc_planar_decode"])

            def run(t, fn=fn):
                x = inp[t]
                k, total = _k_total(x["kw"])
                _launch(fn(x["flat"].data_ptr(), x["flat"].numel(),
                           x["offsets"].data_ptr(), x["lengths"].data_ptr(),
                           0, x["c"].data_ptr(), x["cum"].data_ptr(), 0, 256,
                           k, total, dev_out.data_ptr(), nb, L, stream(),
                           None, None))
        if kernel == "planar_decode":
            def exact(run=run):
                ok = True
                for t in ("pow2", "raw"):
                    dev_out.fill_(-1)
                    run(t)
                    torch.cuda.synchronize()
                    ok &= bool(torch.equal(dev_out, rows.to(torch.int32)))
                return ok
        runners[name] = (run, exact)
    return runners


def time_planar(kernel: str, libs: dict, dirs: dict, variants: dict,
                corpus_mb: int, say, card: str, reps: int) -> int:
    """Time the planar variants on phase 9's first device call (2^k table
    and raw total), each checked for exactness first."""
    from chip_smoke import cuda_ms

    inp = planar_inputs(corpus_mb)
    nb, L = inp["rows"].shape
    say(f"{kernel} first device call: B={nb} L={L} A=256, payload "
        f"{int(inp['pow2']['lengths'].sum())} B (k = 16), "
        f"{int(inp['raw']['lengths'].sum())} B (raw total "
        f"{inp['raw']['kw']['total']})")
    runners = planar_runners(kernel, libs, inp)
    results, wrong = {}, []
    order = [*dirs, next(iter(dirs))]
    for i, name in enumerate(order):
        run, exact = runners[name]
        ok = exact()
        if not ok:
            wrong.append(name)
        ms = cuda_ms(lambda: run("pow2"), reps)
        raw_ms = cuda_ms(lambda: run("raw"), reps)
        key = name if i < len(dirs) else f"{name} (again)"
        results[key] = {"ms": ms, "raw_total_ms": raw_ms,
                        "ns_per_step": ms / L * 1e6, "exact": ok}
        what = variants.get(name, ("the --baseline checkout's kernel",))[0]
        say(f"{kernel} {key}: {ms:.4f} ms ({ms / L * 1e6:.2f} ns a step) at "
            f"k = 16, {raw_ms:.4f} ms at the raw total, exact {ok} -- {what}")
    print(json.dumps({"card": card, "kernel": kernel, "variants": results}),
          flush=True)
    if wrong:
        raise AssertionError(f"variants whose output differs: {wrong}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(VARIANTS), default="decode")
    ap.add_argument("--corpus-mb", type=int, default=256)
    ap.add_argument("--variants", default=None,
                    help="comma-separated names, timed in this order "
                         "(default: all of the kernel's)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another checkout whose kernel to time too")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed calls a variant, after one warm-up")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_variants.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms

    card = card_line()

    def say(msg):
        print(f"[{card}] {msg}", flush=True)

    variants = VARIANTS[args.kernel]
    names = (args.variants.split(",") if args.variants else list(variants))
    dirs = {n: (CSRC, variants[n][1]) for n in names if n}
    if args.baseline is not None:
        dirs["baseline"] = (
            args.baseline / "range_coder_rust_tpu_torch" / "csrc", [])
    libs = build_all(args.kernel, dirs)
    if args.kernel.startswith("planar"):
        return time_planar(args.kernel, libs, dirs, variants,
                           args.corpus_mb, say, card, args.reps)

    rows, cum, tile, enc, dec = main_path_inputs(args.corpus_mb)
    g, L = 2048, rows.shape[1]
    ng = rows.shape[0] // g
    say(f"{args.kernel} main path shape: NG={ng} G={g} L={L} tile={tile} "
        f"region {int(enc[1].sum())} halfwords")
    runners = (decode_runners(libs, rows, cum, tile, enc, dec)
               if args.kernel == "decode"
               else encode_runners(libs, rows, cum, tile, enc))

    results, wrong = {}, []
    order = [*dirs, next(iter(dirs))]
    for i, name in enumerate(order):
        run, exact = runners[name]
        ok = exact()
        if not ok:
            wrong.append(name)
        ms = cuda_ms(lambda: run(ng), args.reps)
        ms1 = cuda_ms(lambda: run(1), args.reps)
        key = name if i < len(dirs) else f"{name} (again)"
        results[key] = {"ms": ms, "first_group_ms": ms1,
                        "ns_per_step": ms / L * 1e6, "exact": ok}
        what = variants.get(name, ("the --baseline checkout's kernel",))[0]
        say(f"{args.kernel} {key}: {ms:.4f} ms at NG={ng}, {ms1:.4f} ms "
            f"first group, {ms / L * 1e6:.2f} ns/step, exact {ok} -- {what}")
    print(json.dumps({"card": card, "kernel": args.kernel,
                      "variants": results}), flush=True)
    if wrong:
        raise AssertionError(f"variants whose output differs: {wrong}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
