#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time, on one CUDA card.

    python3 scripts_torch/profile_main_path.py [--corpus-mb 256] [--top 12]
        [--adaptive | --planar]

Corpus and config are ``chip_smoke.py``'s main path: Zipf(1.2) bytes from
seed 0xC0, ``CodecConfig(profile="rans16", block_len=32768)``; with
``--adaptive``, its adaptive path: the mixed corpus (seed 5),
``CodecConfig(profile="rans16", per_group_tables=True, block_len=32)``;
with ``--planar``, its planar path: the same Zipf bytes with
``CodecConfig()`` (planar, one device call a 16 MiB, each a launch of
the planar encode or decode kernel).
After one
warm-up round trip (kernel build, allocator), each direction runs

1. once unprofiled: its wall time;
2. once under cProfile: the functions with the most self time;
3. once under ``torch.profiler``: device time per kernel and per copy,
   summed over the trace's device events, and the device busy share, the
   union of those events' intervals over the call's wall time.  Host ops
   such as ``aten::to`` are not summed: the copies they issue are already
   device events of their own.  The codec's named regions
   (``rans16.*``, ``planar.*``, and the container's ``format.unpack`` and
   ``format.crc32``; ``utils.profiling.annotate``) are listed with their
   host wall, summed over their calls; a nested region's wall is also in
   the region around it.

The kernel launches of the three calls are printed, the planar ones by
the placement of their table (``kernels.launch_placements``).

Every line carries the card's name and power limit.  It imports no jax.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import card_line, plain_wall  # noqa: E402


def top_self_time(fn, top: int):
    """[(self s, cumulative s, calls, 'file:line(function)')] of one call
    under cProfile, by self time."""
    prof = cProfile.Profile()
    prof.enable()
    plain_wall(fn)
    prof.disable()
    rows = []
    for (file, line, func), (_, ncalls, tt, ct, _) in \
            pstats.Stats(prof).stats.items():
        rows.append((tt, ct, ncalls, f"{Path(file).name}:{line}({func})"))
    rows.sort(reverse=True)
    return rows[:top]


#: name prefixes of the codec's profiler regions
REGIONS = ("rans16.", "planar.", "format.")


def device_time(fn):
    """(wall s, {device event name: (count, us)}, busy us, {region name:
    (count, host us)}) of one call under torch.profiler.  Busy is the
    union of the device events' intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = plain_wall(fn)
    per, spans, regions = {}, [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            if e.name.startswith(REGIONS):
                n, us = regions.get(e.name, (0, 0.0))
                regions[e.name] = (n + 1, us + e.time_range.elapsed_us())
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        n, us = per.get(e.name, (0, 0.0))
        per[e.name] = (n + 1, us + (t1 - t0))
        spans.append((t0, t1))
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return wall_ms / 1e3, per, busy, regions


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus-mb", type=int, default=256)
    ap.add_argument("--top", type=int, default=12,
                    help="cProfile rows per direction")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--adaptive", action="store_true",
                       help="profile chip_smoke's adaptive path instead")
    which.add_argument("--planar", action="store_true",
                       help="profile chip_smoke's planar path instead")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_main_path.py: no CUDA device", file=sys.stderr)
        return 1
    import range_coder_rust_tpu_torch as rt
    from range_coder_rust_tpu_torch.testing import make_corpus, mixed_corpus

    card = card_line()

    def say(msg):
        print(f"[{card}] {msg}", flush=True)

    n = args.corpus_mb << 20
    if args.adaptive:
        data = mixed_corpus(n).astype("uint8")
        cfg = rt.CodecConfig(profile="rans16", per_group_tables=True,
                             block_len=32)
    elif args.planar:
        data = make_corpus(n)
        cfg = rt.CodecConfig()
    else:
        data = make_corpus(n)
        cfg = rt.CodecConfig(profile="rans16", block_len=32768)
    blob = rt.encode(data, alphabet=256, config=cfg, device="cuda")
    if not (rt.decode(blob, device="cuda") == data).all():
        raise AssertionError("warm-up round trip is not exact")
    runs = {
        "encode": lambda: rt.encode(data, alphabet=256, config=cfg,
                                    device="cuda"),
        "decode": lambda: rt.decode(blob, device="cuda"),
    }
    for name, fn in runs.items():
        rt.reset_launch_counts()
        wall = plain_wall(fn)[1] / 1e3
        say(f"{name} n={n}: wall {wall:.4f} s = {n / wall / 1e9:.4f} GB/s "
            "(unprofiled)")
        for tt, ct, nc, where in top_self_time(fn, args.top):
            say(f"{name} cProfile self {tt:.4f} s cum {ct:.4f} s "
                f"calls {nc}: {where}")
        wall, per, busy, regions = device_time(fn)
        for name_r, (cnt, us) in sorted(regions.items(),
                                        key=lambda kv: -kv[1][1]):
            say(f"{name} region {name_r}: host {us / 1e3:.3f} ms x{cnt}")
        say(f"{name} kernel launches over the three calls "
            f"{rt.launch_counts()}; planar ones by table placement "
            f"{rt.launch_placements()}")
        if not per:
            say(f"{name} torch.profiler: no device events in the trace; "
                "device time not measured")
            continue
        for ev, (cnt, us) in sorted(per.items(), key=lambda kv: -kv[1][1]):
            say(f"{name} device {us / 1e3:.3f} ms x{cnt}: {ev[:90]}")
        say(f"{name} torch.profiler: wall {wall * 1e3:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms, busy share {busy / 1e3 / (wall * 1e3):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
