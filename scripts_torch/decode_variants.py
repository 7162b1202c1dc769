#!/usr/bin/env python3
"""Where a rans16 kernel's time goes, on one CUDA card.

    python3 scripts_torch/decode_variants.py [--kernel decode|encode]
        [--corpus-mb 256] [--variants as_is,...] [--baseline DIR]

Builds the kernel's source (``range_coder_rust_tpu_torch/csrc/
rans_decode.cu`` or ``rans_encode.cu``) once per variant, each with one of
the kernel's ``RC_VARIANT_*`` macros defined (the normal build defines
none), into ``build/<kernel>_variants/<name>/``, one ``nvcc`` per variant,
all started together.  It then encodes chip_smoke's main path (Zipf(1.2)
bytes, seed 0xC0, 2048-lane groups, L = 32768) with the package's own
kernels and times each variant on that path's inputs with CUDA events
(mean of 3 after a warm-up), at the main path's shape and for its first
group alone, in the order given, then the first variant again.  Every
variant must give the package kernel's output exactly (the decode's
symbols; the encode's states, sizes and region); the run fails otherwise.

``--baseline DIR`` adds the kernel of another checkout (its
``range_coder_rust_tpu_torch/csrc``), for instance the parent commit
unpacked with ``git archive``, timed the same way.  A kernel is called
with the interface its source declares: without ``cum_stride`` (one
shared table, no sync states), and an encode kernel without
``rc_rans_encode_plan`` with the older one of int32 rows (a u32 park, the
widening of the rows timed with it).

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
}


def interface(src: Path, kernel: str) -> str:
    """Which C interface a kernel source declares: "current",
    "shared_table" (one shared table, no sync states) or "int32_rows"
    (encode: int32 rows, a u32 park)."""
    text = (src / f"rans_{kernel}.cu").read_text()
    if "cum_stride" in text:
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
               str(src / f"rans_{kernel}.cu")]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(VARIANTS), default="decode")
    ap.add_argument("--corpus-mb", type=int, default=256)
    ap.add_argument("--variants", default=None,
                    help="comma-separated names, timed in this order "
                         "(default: all of the kernel's)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another checkout whose kernel to time too")
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
        ms = cuda_ms(lambda: run(ng))
        ms1 = cuda_ms(lambda: run(1))
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
