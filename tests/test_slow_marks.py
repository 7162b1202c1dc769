"""Tier-1 runs ``-m 'not slow'``: check that the filter leaves no test out.

Collects all of ``tests/`` with ``-m slow`` in a child pytest (one thread).
A ``slow`` mark on any test, by decorator or by a collection hook, would take
that test out of tier-1 and fails here.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_test_is_marked_slow():
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-m", "slow",
         "-p", "no:cacheprovider", "-p", "no:randomly", "tests/"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    out = proc.stdout[-4000:] + proc.stderr[-4000:]
    selected = sorted(line for line in proc.stdout.splitlines() if "::" in line)
    assert selected == [], out
    # rc 5: nothing selected, and collection itself raised no error
    assert proc.returncode == 5, out
    deselected = re.search(r"no tests collected \((\d+) deselected\)",
                           proc.stdout)
    assert deselected and int(deselected.group(1)) > 0, out
