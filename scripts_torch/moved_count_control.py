#!/usr/bin/env python3
"""A control for the benchmark's comparison that can fail at any width.

    python3 scripts_torch/moved_count_control.py [--workload tokens_planar.bulk]
        [--seed 7] [--seconds 1] [--device cuda] [--n-symbols N]

``python3 -m rc_bench.control`` puts the reference at a table one bit
coarser (``2**(k - 1)``) in ``api.encode``'s place.  At GPT-2's 50257
tokens that table cannot hold every present token, so the reference
raises and the run is "not correct" by ``calls_failed`` alone: the byte
comparison is never reached.  This script runs both controls on one
planar cell:

1. ``rc_bench.control`` as it stands;
2. the reference's container with one count of the apportioned table
   moved, from the symbol with the largest count to the most frequent
   other symbol.  The container is valid and the program decodes it back
   exactly, but its table and payloads differ from the reference's, so
   only ``container_wrong_bytes`` can catch it.

Each prints one JSON line with its checks.  The exit code is 0 only if
both come out not correct and the moved count is caught by the
comparison, with no call failed.  ``--n-symbols`` shrinks the data (with
``--device cpu``, a check of the script itself).  It imports no jax.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from rc_bench import control, harness  # noqa: E402
from rc_bench.reference import container, planar, table  # noqa: E402


class MovedCountApi:
    """``api.encode`` replaced by the reference with one table count
    moved; decodes and reads stay the program's."""

    def __init__(self, program_api, codec: dict):
        self._codec = codec
        self.CodecConfig = program_api.CodecConfig
        self.decode = program_api.decode
        self.decode_range = program_api.decode_range

    def encode(self, data, *, alphabet, config, device):
        k, block_len = self._codec["k"], self._codec["block_len"]
        counts = table.histogram(data, alphabet)
        c = table.build(counts, k).copy()
        i = int(np.argmax(c))
        j = next(int(s) for s in np.argsort(-counts.astype(np.int64),
                                            kind="stable") if s != i)
        c[i] -= 1
        c[j] += 1
        payloads, lengths = planar.encode(data, c, k, block_len, device)
        return container.pack(
            k=k, alphabet=alphabet, block_len=block_len, n_symbols=data.size,
            lengths=lengths, payload_bytes=payloads, tables_c=c,
            with_checksums=self._codec.get("with_checksums", True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="moved_count_control.py")
    ap.add_argument("--workload", default="tokens_planar.bulk")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-symbols", type=int, default=None)
    args = ap.parse_args(argv)
    from range_coder_rust_tpu_torch import api

    bench = harness.load_bench()
    codec = harness.config_of(bench, harness.cell_of(bench, args.workload))[
        "codec"]
    if codec.get("profile", "planar") != "planar":
        print(f"{args.workload}: not a planar cell", file=sys.stderr)
        return 2
    quiet = lambda *a, **k: None  # noqa: E731
    common = dict(device=args.device, n_symbols=args.n_symbols, log=quiet)
    results = {
        "rc_bench.control": control.run(bench, args.workload, args.seed,
                                        args.seconds, **common),
        "one count moved": harness.run(
            bench, args.workload, args.seed, args.seconds, False,
            api=MovedCountApi(api, codec), **common),
    }
    for name, r in results.items():
        print(json.dumps({"control": name, "workload": args.workload,
                          "seed": args.seed, "correct": r["correct"],
                          "failed": r["failed"], "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    moved = results["one count moved"]
    caught = (moved["checks"]["container_wrong_bytes"]["value"] > 0
              and moved["checks"]["calls_failed"]["value"] == 0)
    ok = caught and not any(r["correct"] for r in results.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
