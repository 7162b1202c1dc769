"""Command-line interface: ``python -m range_coder_rust_tpu_torch <cmd>``.

The port's counterpart of ``python -m range_coder_rust_tpu``: the same
commands, options, outputs and containers, plus ``--device`` on encode,
decode and bench (default ``cuda``; ``cpu`` on request; nothing falls
back to the CPU on its own).  ``bench`` runs the port's own benchmark
(:mod:`.bench`), not the JAX package's ``bench.py``.

Commands:
  encode   FILE -o OUT [--profile rans16|planar] [--k K] [--block-len L]
           [--adaptive] [--raw-total] [--no-checksums] [--device D]
  decode   FILE -o OUT [--no-verify] [--start S --count N] [--device D]
  inspect  FILE              # print container header/geometry/ratios
  bench    [--mb N] [--k K] [--device D]  # throughput, one JSON line
  selftest                   # reference-parity round-trip (sample_impl)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _cmd_encode(args) -> int:
    data = open(args.file, "rb").read()
    t0 = time.time()
    if args.adaptive:
        print(
            "warning: --adaptive is the planar per-block-table CONFORMANCE "
            "mode (~0.004 GB/s); for fast adaptive coding use "
            "--per-group-tables (the adaptive rans16 mode, ~1 GB/s)",
            file=sys.stderr)
        from .adaptive import encode_adaptive

        # without --block-len, encode_adaptive's own default
        lens = {} if args.block_len is None else {"block_len": args.block_len}
        blob = encode_adaptive(
            data,
            alphabet=256,
            k=args.k,
            with_checksums=not args.no_checksums,
            device=args.device,
            **lens,
        )
    else:
        from .api import CodecConfig, encode

        if args.profile is None:
            args.profile = "rans16" if args.k == 16 else "planar"
        blob = encode(
            data,
            alphabet=256,
            config=CodecConfig(
                k=args.k,
                block_len=args.block_len,
                profile=args.profile,
                raw_total=args.raw_total,
                with_checksums=not args.no_checksums,
                per_group_tables=args.per_group_tables,
                sync_tiles=args.sync_tiles,
                group_lanes=args.group_lanes,
            ),
            device=args.device,
        )
    dt = time.time() - t0
    with open(args.output, "wb") as f:
        f.write(blob)
    ratio = len(blob) / max(len(data), 1)
    print(
        f"{len(data)} -> {len(blob)} bytes ({ratio:.3f}, "
        f"{8 * len(blob) / max(len(data), 1):.3f} bits/byte) in {dt:.2f}s "
        f"({len(data) / dt / 1e6:.1f} MB/s)"
    )
    return 0


def _cmd_decode(args) -> int:
    blob = open(args.file, "rb").read()
    from . import format as fmt

    cont = fmt.unpack(blob, verify_checksums=False, device=args.device,
                      copy=False)
    t0 = time.time()
    if args.count is not None:
        from .api import decode_range

        out = decode_range(blob, args.start, args.count,
                           verify_checksums=not args.no_verify,
                           device=args.device)
    else:
        from .api import decode

        out = decode(blob, verify_checksums=not args.no_verify,
                     device=args.device)
    dt = time.time() - t0
    # the output width follows the container's alphabet: byte alphabets
    # write bytes, wider ones little-endian u16 / u32 symbols
    if cont.alphabet <= 256:
        buf = out.astype(np.uint8).tobytes()
    elif cont.alphabet <= 65536:
        buf = out.astype("<u2").tobytes()
        print(f"note: alphabet {cont.alphabet} > 256 — writing u16 LE "
              "symbols", file=sys.stderr)
    else:
        buf = out.astype("<u4").tobytes()
        print(f"note: alphabet {cont.alphabet} > 65536 — writing u32 LE "
              "symbols", file=sys.stderr)
    with open(args.output, "wb") as f:
        f.write(buf)
    print(f"{len(blob)} -> {len(buf)} bytes ({out.size} symbols) in "
          f"{dt:.2f}s ({out.size / dt / 1e6:.1f} MB/s)")
    return 0


def _cmd_inspect(args) -> int:
    from . import format as fmt

    blob = open(args.file, "rb").read()
    cont = fmt.unpack(blob, verify_checksums=False, copy=False)
    payload = int(cont.lengths.sum())
    print(json.dumps({
        "k": cont.k,
        "alphabet": cont.alphabet,
        "block_len": cont.block_len,
        "n_symbols": cont.n_symbols,
        "n_blocks": cont.n_blocks,
        "profile": cont.profile,
        "group_lanes": cont.group_lanes,
        "per_block_tables": cont.per_block_tables,
        "checksums": cont.checksums is not None,
        "payload_bytes": payload,
        "container_bytes": len(blob),
        "header_overhead_bytes": len(blob) - payload,
        "bits_per_symbol": round(8 * payload / max(cont.n_symbols, 1), 4),
        "mean_block_payload": round(payload / cont.n_blocks, 1),
    }, indent=2))
    return 0


def _cmd_bench(args) -> int:
    import os

    from . import bench

    os.environ["RC_BENCH_MB"] = str(args.mb)
    os.environ["RC_BENCH_K"] = str(args.k)
    bench.run(n_bytes=args.mb << 20, device=args.device)
    return 0


def _cmd_selftest(args) -> int:
    """The reference's acceptance test (examples/sample_impl.rs:72-128)."""
    from .core.decoder import Decoder
    from .core.encoder import Encoder
    from .models.freq_table import FreqTable

    test_data = [2, 1, 1, 4, 1, 4, 2, 1, 0, 1, 5, 9, 8, 7, 6, 5]
    ft = FreqTable(10)
    ft.add_counts(test_data)
    ft.calc_cum()
    enc = Encoder()
    for s in test_data:
        enc.encode(ft, s)
    code = enc.finish()
    dec = Decoder(code)
    out = [dec.decode(ft) for _ in test_data]
    if out != test_data:
        raise AssertionError(f"{out} != {test_data}")
    print(f"selftest passed: {len(code)}-byte stream, round trip exact")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="range_coder_rust_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="compress a file")
    pe.add_argument("file")
    pe.add_argument("-o", "--output", required=True)
    pe.add_argument("--k", type=int, default=16)
    pe.add_argument("--block-len", type=int, default=None,
                    help="symbols per block/lane (default: per-profile)")
    pe.add_argument("--profile", choices=["rans16", "planar"],
                    default=None,
                    help="rans16 = interleaved rANS through the CUDA kernels "
                         "(default when k == 16); planar = byte-exact "
                         "reference-semantics streams (default for k < 16)")
    pe.add_argument("--raw-total", action="store_true",
                    help="raw-histogram table (arbitrary u32 total), "
                         "planar only")
    pe.add_argument("--adaptive", action="store_true", help="per-block tables")
    pe.add_argument(
        "--per-group-tables", action="store_true",
        help="adaptive rans16: one table per group (the fast adaptive mode)")
    pe.add_argument(
        "--sync-tiles", type=int, default=0,
        help="rans16 tile random access: record lane states every N tiles "
             "(e.g. 128 ~ 0.2%% size for fast decode --start/--count)")
    pe.add_argument(
        "--group-lanes", type=int, default=None,
        help="rans16 group width (a power of two in [128, 65536]; "
             "default 2048 — 1024 halves state overhead for small "
             "adaptive groups)")
    pe.add_argument("--no-checksums", action="store_true")
    pe.add_argument("--device", default="cuda",
                    help="where the coder runs (default cuda; cpu runs the "
                         "plain PyTorch versions)")
    pe.set_defaults(fn=_cmd_encode)

    pd = sub.add_parser("decode", help="decompress a container")
    pd.add_argument("file")
    pd.add_argument("-o", "--output", required=True)
    pd.add_argument("--no-verify", action="store_true", help="skip CRC checks")
    pd.add_argument("--start", type=int, default=0,
                    help="with --count: first symbol of the range")
    pd.add_argument("--count", type=int, default=None,
                    help="decode only [start, start+count) — touches only "
                         "the covering blocks/groups")
    pd.add_argument("--device", default="cuda",
                    help="where the coder runs (default cuda)")
    pd.set_defaults(fn=_cmd_decode)

    pi = sub.add_parser("inspect", help="print container metadata")
    pi.add_argument("file")
    pi.set_defaults(fn=_cmd_inspect)

    pb = sub.add_parser("bench", help="run the throughput benchmark")
    pb.add_argument("--mb", type=int, default=64)
    pb.add_argument("--k", type=int, default=16)
    pb.add_argument("--device", default="cuda",
                    help="where the coder runs (default cuda; cpu runs the "
                         "plain PyTorch versions)")
    pb.set_defaults(fn=_cmd_bench)

    ps = sub.add_parser("selftest", help="reference-parity round trip")
    ps.set_defaults(fn=_cmd_selftest)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
