"""The PyTorch port stands alone: it imports, and codes (rans16, planar,
planar per-block tables, the scalar coder, the CLI, the golden coder, the
bench and the scale-out modules), with jax and the JAX package blocked,
and its own copies of the JAX package's ``errors`` and ``format`` match
the originals."""

import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from range_coder_rust_tpu import errors as j_errors
from range_coder_rust_tpu import format as j_fmt
from range_coder_rust_tpu_torch import errors as t_errors
from range_coder_rust_tpu_torch import format as t_fmt

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "range_coder_rust_tpu_torch"

#: top-level module names the port must never import
_BLOCKED = ("jax", "jaxlib", "range_coder_rust_tpu")

_BLOCKED_RUN = r"""
import importlib.abc, sys

BLOCKED = %r

class _Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")

sys.meta_path.insert(0, _Blocked())
for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]

import numpy as np
import torch

torch.set_num_threads(1)
import range_coder_rust_tpu_torch as rt

data = (np.arange(3000) * 7 %% 11).astype(np.uint8)
cfg = rt.CodecConfig(profile="rans16", block_len=16, group_lanes=128)
blob = rt.encode(data, config=cfg, device="cpu")
out = rt.decode(blob, device="cpu")
assert out.dtype == np.uint8 and np.array_equal(out, data)
assert rt.launch_counts() == {"rans_encode": 0, "rans_decode": 0,
                             "planar_encode": 0, "planar_decode": 0,
                             "planar_histogram": 0, "planar_compact": 0}
from range_coder_rust_tpu_torch import adaptive
for blob in (rt.encode(data, config=rt.CodecConfig(block_len=64),
                       device="cpu"),
             rt.encode(data, config=rt.CodecConfig(raw_total=True,
                                                   block_len=64),
                       device="cpu"),
             adaptive.encode_adaptive(data, block_len=64, device="cpu")):
    assert np.array_equal(rt.decode(blob, device="cpu"), data)
table = rt.FreqTable.from_data(data[:50], 11)
enc = rt.Encoder()
for s in data[:50]:
    enc.encode(table, int(s))
dec = rt.Decoder(enc.finish())
assert [dec.decode(table) for _ in range(50)] == list(data[:50])
import contextlib, io, os, tempfile
from range_coder_rust_tpu_torch import parallel, rans, utils
from range_coder_rust_tpu_torch.__main__ import main
from range_coder_rust_tpu_torch.native import golden
said = io.StringIO()
with contextlib.redirect_stdout(said), tempfile.TemporaryDirectory() as tmp:
    assert main(["selftest"]) == 0
    src, rc, back = (os.path.join(tmp, n) for n in ("in", "rc", "out"))
    data.tofile(src)
    assert main(["encode", src, "-o", rc, "--block-len", "16",
                 "--group-lanes", "128", "--device", "cpu"]) == 0
    assert main(["decode", rc, "-o", back, "--device", "cpu"]) == 0
    assert open(back, "rb").read() == data.tobytes()
    os.environ["RC_BENCH_REPS"] = "1"
    os.environ["RC_BENCH_PROFILE"] = "rans16"
    assert main(["bench", "--mb", "1", "--device", "cpu"]) == 0
assert said.getvalue().startswith("selftest passed")
import json
line = json.loads(said.getvalue().strip().splitlines()[-1])
assert line["device"] == "cpu" and line["corpus_mb"] == 1, line
tab = (table.counts(), table.cum_counts(), table.total_freq())
code = golden.encode(data[:50], *tab)
assert rt.Decoder(code).decode(table) == data[0]
assert np.array_equal(golden.decode(code, 50, *tab), data[:50])
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
assert "range_coder_rust_tpu_torch" in sys.modules
print("OK", len(blob))
""" % (_BLOCKED,)


def test_import_and_roundtrip_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def _port_sources():
    paths = [*PKG.rglob("*.py"), *(ROOT / "scripts_torch").rglob("*.py"),
             ROOT / "chip_smoke.py"]
    return sorted(p.relative_to(ROOT).as_posix() for p in paths)


#: ``import jax...``, ``from jaxlib...``, or the JAX package by its own name
#: (``range_coder_rust_tpu`` not followed by ``_torch``)
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|range_coder_rust_tpu(?!_torch))\b",
    re.M)


@pytest.mark.parametrize("path", _port_sources())
def test_no_jax_import_in_source(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(src), path


def test_forbidden_import_pattern():
    for bad in ("import jax", "from jax import numpy", "import jaxlib",
                "from range_coder_rust_tpu import format",
                "import range_coder_rust_tpu.errors",
                "    from range_coder_rust_tpu.kernels import vreg"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import range_coder_rust_tpu_torch as rt",
               "from range_coder_rust_tpu_torch.kernels import _build",
               "from . import format as fmt", "import jaxtyping_free"):
        assert not _FORBIDDEN.search(ok), ok


def _error_classes(mod):
    return sorted(name for name, obj in vars(mod).items()
                  if inspect.isclass(obj) and issubclass(obj, Exception)
                  and obj.__module__ == mod.__name__)


@pytest.mark.parametrize("name", _error_classes(j_errors))
def test_port_errors_mirror_reference(name):
    ref = getattr(j_errors, name)
    port = getattr(t_errors, name)
    assert port.__module__ == "range_coder_rust_tpu_torch.errors"
    assert [b.__name__ for b in port.__bases__] == [
        b.__name__ for b in ref.__bases__]
    assert [c.__name__ for c in port.__mro__] == [
        c.__name__ for c in ref.__mro__]
    assert inspect.signature(port.__init__) == inspect.signature(ref.__init__)


def test_port_errors_have_no_extra_classes():
    assert _error_classes(t_errors) == _error_classes(j_errors)


def _fields(cont):
    return {k: getattr(cont, k) for k in cont.__dataclass_fields__}


def _assert_same_fields(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k])
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("name", ["exact_multiple", "partial_last_group",
                                  "u16_alphabet", "empty", "A129"])
def test_port_format_matches_reference(name):
    """On the containers ``test_torch_api.py`` builds, the port's
    ``unpack`` gives the reference's fields and its ``pack`` gives the
    reference's bytes back."""
    from test_torch_api import GEOMETRIES, JCFG
    from range_coder_rust_tpu import api as japi
    from range_coder_rust_tpu_torch.testing import zipf

    n, a = GEOMETRIES[name]
    blob = japi.encode(zipf(n, a, seed=n + a), alphabet=a, config=JCFG)
    j_cont, t_cont = j_fmt.unpack(blob), t_fmt.unpack(blob)
    _assert_same_fields(t_cont, j_cont)
    kw = dict(k=t_cont.k, alphabet=t_cont.alphabet,
              block_len=t_cont.block_len, n_symbols=t_cont.n_symbols,
              payloads=t_cont.payloads, tables_c=t_cont.tables_c,
              per_block_tables=t_cont.per_block_tables,
              with_checksums=t_cont.checksums is not None,
              profile=t_cont.profile, group_lanes=t_cont.group_lanes)
    assert t_fmt.pack(**kw) == j_fmt.pack(**kw) == blob


def test_port_format_raises_its_own_errors():
    with pytest.raises(t_errors.InvalidHeader):
        t_fmt.unpack(b"RCT1")
    with pytest.raises(j_errors.InvalidHeader):
        j_fmt.unpack(b"RCT1")
    assert not issubclass(t_errors.InvalidHeader, j_errors.RangeCoderError)
