"""The control: the comparison must fail the reference at a lower
precision put in the program's place.

    python3 -m rc_bench.control --workload <cell> --seeds 1 2 3 [--seconds 5]

The configuration states the table's precision (``k``, a total of
``2**k``).  The control encodes with the reference at one bit less: the
table apportioned at ``2**(k - 1)`` and doubled, a valid container of
the same layout that any decoder reads back exactly.  Decodes and reads
stay the program's, of the control's containers.  Each seed runs the
whole cell (set-up, a short window, the comparison) in this one process
and prints its line; the exit code is 0 only if every seed comes out not
correct.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import harness, reference


#: bits of table precision the control gives up
DROP_BITS = 1


class ControlApi:
    """``api.encode`` replaced by the reference at ``DROP_BITS`` less
    precision; the rest is the program's ``api``."""

    def __init__(self, program_api, codec: dict):
        self._codec = codec
        self.CodecConfig = program_api.CodecConfig
        self.decode = program_api.decode
        self.decode_range = program_api.decode_range

    def encode(self, data, *, alphabet, config, device):
        return reference.encode(data, self._codec, alphabet, device,
                                drop_bits=DROP_BITS)


def run(bench: dict, cell: str, seed: int, seconds: float, *,
        device="cuda", n_symbols=None, log=print) -> dict:
    from range_coder_rust_tpu_torch import api

    codec = harness.config_of(bench, harness.cell_of(bench, cell))["codec"]
    return harness.run(bench, cell, seed, seconds, False, device=device,
                       api=ControlApi(api, codec), n_symbols=n_symbols,
                       log=log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rc_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("rc_bench.control: no CUDA device", file=sys.stderr)
        return 1
    bench = harness.load_bench()
    failed_all = True
    for seed in args.seeds:
        r = run(bench, args.workload, seed, args.seconds)
        failed_all &= not r["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "checks": r["checks"]}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
