"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``.

    python3 -m rc_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name (``README.md``): the cell
in ``BENCHMARK.json``, its configuration's file, ``traffic/<mix>.json``,
``data/<kind>.py`` and one reader ``metrics/<metric>.py`` a metric.  The
harness measures ``range_coder_rust_tpu_torch.api`` only.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "range_coder_rust_tpu")

_IMPORTED_AT = time.monotonic()


def process_start_age() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``; the import of this module where that is not
    there)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic() - _IMPORTED_AT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``range_coder_rust_tpu_torch`` is not
    ``range_coder_rust_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "rc_bench_" + path.stem.replace(".", "_") + f"_{path.parent.name}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell: dict, root: Path = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / entry["file"]) as f:
        return json.load(f)


def mix_of(cell: dict) -> dict:
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        return json.load(f)


def metrics_of(bench: dict, cell: dict, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])]


@dataclasses.dataclass
class RunView:
    """What a metric reader sees of a run."""

    calls: list  # the window's calls (generator.Call)
    setup_s: float
    timeline: Optional[object]  # trace.Timeline in a traced run
    layout: dict  # reference.container.layout of the reference's container


def run(bench: dict, cell_name: str, seed: int, seconds: float,
        trace: bool, *, device="cuda", api=None, n_symbols=None,
        log=print) -> dict:
    """One run; returns the result line as a dict (``checks`` last).
    ``api`` replaces the program's (the control and the fault tests);
    ``n_symbols`` shrinks the data (CPU tests only)."""
    import torch

    from . import check, generator, reference
    from .reference import container
    from .trace import Timeline

    cell = cell_of(bench, cell_name)
    cfg = config_of(bench, cell)
    mix = mix_of(cell)
    spec = dict(cfg["data"])
    if n_symbols is not None:
        spec["n_symbols"] = n_symbols
    if api is None:
        from range_coder_rust_tpu_torch import api
    cuda = torch.device(device).type == "cuda"

    t_start = process_start_age()
    data = _load(HERE / "data" / f"{spec['kind']}.py").make(spec, seed, device)
    t_data = process_start_age()
    alphabet = int(spec["alphabet"])
    if cuda:  # the peak is the program's: the data lives on the host now
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    driver = generator.Driver(api, api.CodecConfig(**cfg["codec"]), data,
                              alphabet, mix, seed, device)
    driver.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = process_start_age()
    log(f"rc_bench: set-up {setup_s:.3f} s: to the harness {t_start:.3f}, "
        f"data {t_data - t_start:.3f}, set-up and warm-up calls "
        f"{setup_s - t_data:.3f}", file=sys.stderr)
    timeline = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            driver.window(seconds)
        timeline = Timeline.from_profiler(prof)
        del prof
    else:
        driver.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window = [c for c in driver.calls if c.in_window]
    for op, times in call_seconds(window).items():
        log(f"rc_bench: {len(times)} {op} calls in the window, s: min "
            f"{min(times):.4f} median {statistics.median(times):.4f} max "
            f"{max(times):.4f} sum {sum(times):.4f}", file=sys.stderr)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"] if cuda else 0,
           "memory_peak_bytes": peak}
    if timeline is not None:
        dev["busy_s"] = timeline.busy()
        dev["window_s"] = timeline.window[1] - timeline.window[0]

    # the program's state is freed before the reference runs
    driver.blob = None
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference.encode(data, cfg["codec"], alphabet, device)
    checks = check.compare(driver.calls, data, ref)
    log(f"rc_bench: reference and comparison {time.perf_counter() - t0:.3f} s",
        file=sys.stderr)
    # the work a call has to do is the reference container's
    view = RunView(window, setup_s, timeline, container.layout(ref))
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        value = _load(HERE / "metrics" / f"{m['name']}.py").read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": len(window),
        "failed": sum(c.output is None for c in window),
        "metrics": metrics,
        "device": dev,
    }
    if timeline is not None:
        result["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in
                           timeline.device_ops()[:10]],
            "idle_gaps": [[n, s] for n, s in timeline.idle_gaps()[:10]],
        }
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def call_seconds(calls) -> dict:
    """{op: [seconds of each call]} of the window's calls."""
    out = {}
    for c in calls:
        out.setdefault(c.op, []).append(c.t1 - c.t0)
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rc_bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell = cell_of(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"rc_bench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    result = run(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace))
    leaked = forbidden_modules()
    if leaked:
        print(f"rc_bench: JAX or the JAX package was loaded: {leaked}",
              file=sys.stderr)
        return 1
    print(f"rc_bench: {args.workload} seed {args.seed}; card "
          f"{power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
