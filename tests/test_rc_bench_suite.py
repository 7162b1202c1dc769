"""The benchmark's own CPU tests (``rc_bench/tests``), run as one item.

They hold the benchmark's frozen reference byte for byte against the
port's containers.  They run in a child pytest with ``--noconftest``,
as ``rc_bench/README.md`` runs them, so that the repo's conftests (which
set up JAX for the reference's tests) do not apply to them.

The child runs PyTorch on one thread: beside the rest of the suite, its
default of one OpenMP thread a core oversubscribes the host, and the 30
tests then take about 300 s instead of about 35 s.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rc_bench_tests_pass():
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "rc_bench/tests",
           "-q", "-p", "no:cacheprovider"]
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         timeout=300)
    tail = "\n".join((run.stdout + run.stderr).splitlines()[-40:])
    assert run.returncode == 0, f"rc {run.returncode}:\n{tail}"
