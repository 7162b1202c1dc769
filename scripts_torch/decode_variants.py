#!/usr/bin/env python3
"""Where the rans16 decode kernel's time goes, on one CUDA card.

    python3 scripts_torch/decode_variants.py [--corpus-mb 256]
        [--variants as_is,direct_stores,...] [--baseline DIR]

Builds ``range_coder_rust_tpu_torch/csrc/rans_decode.cu`` once per variant,
each with one of the kernel's ``RC_VARIANT_*`` macros defined (the normal
build defines none), into ``build/decode_variants/<name>/``, one ``nvcc``
per variant, all started together.  It then encodes chip_smoke's main
path (Zipf(1.2) bytes, seed 0xC0, 2048-lane groups, L = 32768) with the
package's own encode kernel, and times each variant's decode of it with
CUDA events (mean of 3 after a warm-up), in the order given, then the
first variant again.  Every variant must give the package kernel's
symbols exactly; the run fails otherwise.

``--baseline DIR`` adds the decode kernel of another checkout (its
``range_coder_rust_tpu_torch/csrc``), for instance the parent commit
unpacked with ``git archive``, timed the same way.

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
OUT = ROOT / "build" / "decode_variants"

#: name -> (what it measures, nvcc defines).  The four reverts undo one
#: design point each of the kernel's header.
VARIANTS = {
    "as_is": ("the kernel as committed", []),
    "direct_stores": ("design point 1 reverted: one store per lane per step",
                      ["RC_VARIANT_DIRECT_STORES"]),
    "binary_search": (
        "design point 2 reverted: binary search on cum for each symbol",
        ["RC_VARIANT_BINARY_SEARCH"]),
    "device_refill": (
        "design point 3 reverted: every refill read from device memory",
        ["RC_VARIANT_DEVICE_REFILL"]),
    "two_barriers": ("design point 4 reverted: a second barrier on every step",
                     ["RC_VARIANT_TWO_BARRIERS"]),
    "lanes_2": ("2048-lane groups as 1024 threads of 2 lanes",
                ["RC_VARIANT_WIDE_LANES=2"]),
    "lanes_8": ("2048-lane groups as 256 threads of 8 lanes",
                ["RC_VARIANT_WIDE_LANES=8"]),
}


def build_all(dirs: dict) -> dict:
    """Start one nvcc per variant, wait for all; name -> loaded entry point.
    ``dirs`` maps a name to (source directory, defines)."""
    from range_coder_rust_tpu_torch.kernels import _build

    procs = {}
    for name, (src, defines) in dirs.items():
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        lib = out / "librc_decode.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               *[f"-D{d}" for d in defines], "-o", str(lib),
               str(src / "rans_decode.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       lib)
    errs = {name: proc.communicate()[1] for name, (proc, _) in procs.items()}
    failed = [n for n, (proc, _) in procs.items() if proc.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{errs[failed[0]]}")
    libs = {}
    for name, (_, lib) in procs.items():
        fn = ctypes.CDLL(str(lib)).rc_rans_decode
        fn.argtypes = _build.SIGNATURES["rc_rans_decode"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus-mb", type=int, default=256)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names, timed in this order")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another checkout whose decode kernel to time too")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_variants.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms
    from range_coder_rust_tpu_torch import kernels, rans_codec
    from range_coder_rust_tpu_torch.models.table import table_from_data_pow2
    from range_coder_rust_tpu_torch.testing import make_corpus

    card = card_line()

    def say(msg):
        print(f"[{card}] {msg}", flush=True)

    dirs = {n: (CSRC, VARIANTS[n][1]) for n in args.variants.split(",") if n}
    if args.baseline is not None:
        dirs["baseline"] = (
            args.baseline / "range_coder_rust_tpu_torch" / "csrc", [])
    libs = build_all(dirs)

    g, L = rans_codec.GROUP_LANES, 32768
    data = make_corpus(args.corpus_mb << 20)
    rows_np = data.reshape(-1, L)
    table = table_from_data_pow2(rows_np, 256, 16)
    cum = rans_codec.cum_table(table.cum, "cuda")
    rows = torch.from_numpy(rows_np).cuda().to(torch.int32)
    tile, _ = rans_codec._tile_geometry(L, g)
    states, sizes, region = kernels.rans_encode_tiled(rows, cum, group_lanes=g,
                                                      tile=tile)
    del rows
    n_hw = int(sizes.sum())
    region = region[:n_hw].clone()
    grp_off = torch.cat([sizes.new_zeros(1, dtype=torch.int64),
                         sizes.sum(1).cumsum(0)])
    ng = states.numel() // g
    want = kernels.rans_decode_tiled(
        states, region, grp_off, cum, group_lanes=g, block_len=L,
        a_count=256, out_dtype=torch.uint8)
    say(f"main path shape: NG={ng} G={g} L={L} region {n_hw} halfwords")
    out = torch.empty_like(want)

    def run(fn, n_groups=ng):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(states.data_ptr(), region.data_ptr(), n_hw,
                 grp_off.data_ptr(), cum.data_ptr(), out.data_ptr(), n_groups,
                 g, L, 256, 1, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    results, wrong = {}, []
    order = [*dirs, next(iter(dirs))]
    for i, name in enumerate(order):
        fn = libs[name]
        out.zero_()
        run(fn)
        torch.cuda.synchronize()
        exact = bool(torch.equal(out, want))
        if not exact:
            wrong.append(name)
        ms = cuda_ms(lambda: run(fn))
        ms1 = cuda_ms(lambda: run(fn, 1))
        key = name if i < len(dirs) else f"{name} (again)"
        results[key] = {"ms": ms, "first_group_ms": ms1,
                        "ns_per_step": ms / L * 1e6, "exact": exact}
        what = VARIANTS.get(name, ("the --baseline checkout's kernel",))[0]
        say(f"{key}: {ms:.4f} ms at NG={ng}, {ms1:.4f} ms first group, "
            f"{ms / L * 1e6:.2f} ns/step, exact {exact} -- {what}")
    print(json.dumps({"card": card, "variants": results}), flush=True)
    if wrong:
        raise AssertionError(f"variants that changed the symbols: {wrong}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
