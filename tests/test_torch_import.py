"""The PyTorch port imports, and codes, with jax blocked."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "range_coder_rust_tpu_torch"

_BLOCKED_RUN = r"""
import importlib.abc, sys

class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"blocked: {name}")

sys.meta_path.insert(0, _NoJax())
for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[m]

import numpy as np
import torch

torch.set_num_threads(1)
import range_coder_rust_tpu_torch as rt

data = (np.arange(3000) * 7 % 11).astype(np.uint8)
cfg = rt.CodecConfig(profile="rans16", block_len=16, group_lanes=128)
blob = rt.encode(data, config=cfg, device="cpu")
out = rt.decode(blob, device="cpu")
assert out.dtype == np.uint8 and np.array_equal(out, data)
assert rt.launch_counts() == {"rans_encode": 0, "rans_decode": 0}
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
assert not loaded, loaded
print("OK", len(blob))
"""


def test_import_and_roundtrip_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")))
def test_no_jax_import_in_source(path):
    src = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax", src, re.M), path
