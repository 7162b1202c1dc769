"""The planar encode's histogram on the CPU: the rule that picks the
kernel's path (``csrc/planar_histogram_path.cuh``, compiled alone with
g++; the kernel itself runs only on a card,
``tests/test_torch_kernels_gpu.py``), the plain version against
``np.bincount``, and ``api.encode``'s order: the input uploaded once at
its row width, counted there, then padded there (the raw-total and
per-block encodes upload and pad the same way, with no histogram)."""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu_torch import adaptive, api, kernels
from range_coder_rust_tpu_torch.kernels import (HISTOGRAM_PATHS,
                                                histogram_plain,
                                                planar_histogram)
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)

_CSRC = Path(rt.__file__).resolve().parent / "csrc"
_OPTIN = 232448  # an H100's opt-in shared memory a CTA


@pytest.fixture(scope="module")
def histogram_path(tmp_path_factory):
    """``planar_histogram::path_of`` as the launcher calls it, built from
    its header alone: ``(alphabet, width, opt-in bytes) -> path name``."""
    lib = tmp_path_factory.mktemp("path_rule") / "libpath_rule.so"
    src = ('#include "planar_histogram_path.cuh"\n'
           'extern "C" int path_of(int a, int width, int optin) {\n'
           '  return planar_histogram::path_of(a, width, optin);\n}\n')
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(_CSRC), "-o", str(lib), "-"], input=src,
                   text=True, capture_output=True, check=True)
    path_of = ctypes.CDLL(str(lib)).path_of
    path_of.argtypes = [ctypes.c_int] * 3
    return lambda a, width, optin=_OPTIN: HISTOGRAM_PATHS[
        path_of(a, width, optin)]


@pytest.mark.parametrize("width,paths", [
    (1, {1: "warp_private", 2: "warp_private", 256: "warp_private",
         257: "warp_private", 50257: "warp_private"}),
    (2, {1: "warp_private", 256: "warp_private", 257: "block_smem",
         50257: "block_smem", _OPTIN // 4: "block_smem",
         _OPTIN // 4 + 1: "global", 65536: "global", 70000: "global"}),
    (4, {256: "warp_private", 257: "block_smem", 50257: "block_smem",
         _OPTIN // 4: "block_smem", _OPTIN // 4 + 1: "global",
         1 << 20: "global"})])
def test_histogram_path_rule(width, paths, histogram_path):
    """A copy a warp up to 256 bins, a copy a CTA while the bins fit the
    opt-in shared memory, else atomics on the totals; the bins are the
    alphabet cut to what the width holds (256 for bytes, 65536 for u16)."""
    assert {a: histogram_path(a, width) for a in paths} == paths
    assert histogram_path(50257, width, 48 * 1024) == (
        "warp_private" if width == 1 else "global")


@pytest.mark.parametrize("np_dtype", [np.uint8, np.uint16, np.int32])
def test_histogram_plain_matches_bincount(np_dtype):
    """The plain version's counts equal ``np.bincount(..., minlength=a)``
    at each width (u16 as int16 bits), for empty, single, odd-length and
    Zipf inputs over small and wide alphabets."""
    view = {np.uint8: np.uint8, np.uint16: np.int16, np.int32: np.int32}
    for a in (1, 2, 256) + (() if np_dtype == np.uint8 else (257, 50257,
                                                             65536)):
        for n in (0, 1, 511, 20_003):
            values = zipf(n, a, n + a, alpha=1.0).astype(np_dtype)
            got = histogram_plain(torch.from_numpy(values.view(
                view[np_dtype])), a)
            assert got.dtype == torch.int64 and got.shape == (a,)
            np.testing.assert_array_equal(
                got.numpy(), np.bincount(values, minlength=a))


def test_histogram_leaves_out_symbols_outside_the_alphabet():
    """Symbols at or past ``a`` (and negative int32) are not counted, as
    the kernel leaves them out."""
    x = torch.tensor([0, 3, 3, 7, -1, 1 << 20], dtype=torch.int32)
    assert histogram_plain(x, 4).tolist() == [1, 0, 0, 2]
    assert histogram_plain(x[:4].to(torch.uint8), 2).tolist() == [1, 0]
    assert histogram_plain(torch.tensor([-1, 5], dtype=torch.int16),
                           6).tolist() == [0, 0, 0, 0, 0, 1]


def test_histogram_argument_checks_raise():
    """Wrong symbols or alphabets raise ValueError, and no launch is
    counted."""
    kernels.reset_launch_counts()
    x = torch.zeros(8, dtype=torch.uint8)
    for sym, a in [(x.long(), 4), (x.float(), 4), (x.view(2, 4), 4),
                   (x, 0), (x, 1 << 31), (x.to("meta"), 4)]:
        with pytest.raises(ValueError):
            planar_histogram(sym, a)
    assert kernels.launch_counts()["planar_histogram"] == 0


def test_row_width_follows_the_alphabet():
    """Rows travel at the input's width unless the alphabet's last symbol
    (a possible pad) does not fit it; the container does not depend on
    the row width."""
    u8 = np.zeros(3, np.uint8)
    assert api._row_dtype(u8, 256) == np.uint8
    assert api._row_dtype(u8, 257) == np.int32
    assert api._row_dtype(u8.astype(np.uint16), 65536) == np.uint16
    assert api._row_dtype(u8.astype(np.uint16), 65537) == np.int32
    data = zipf(3 * 128 + 50, 200, 9, dtype=np.uint8)
    cfg = rt.CodecConfig(block_len=128, chunk_symbols=256)
    blobs = {rt.encode(data.astype(dt), alphabet=300, config=cfg,
                       device="cpu")
             for dt in (np.uint8, np.uint16, np.int32)}
    assert len(blobs) == 1
    np.testing.assert_array_equal(rt.decode(blobs.pop(), device="cpu"), data)


def test_encode_takes_strided_views():
    """A reversed byte view and a strided u16 view encode to the blobs of
    their contiguous copies, with the histogram's table and with raw
    totals, over several pieces of the upload."""
    data = zipf(4 * 128 + 70, 200, 11, dtype=np.uint8)
    tokens = zipf(2 * (4 * 128 + 70), 50257, 12, dtype=np.uint16)
    for raw in (False, True):
        cfg = rt.CodecConfig(block_len=128, chunk_symbols=256,
                             raw_total=raw)
        for view, a in ((data[::-1], None), (tokens[::2], 50257)):
            assert not view.flags.c_contiguous
            blob = rt.encode(view, alphabet=a, config=cfg, device="cpu")
            assert blob == rt.encode(view.copy(), alphabet=a, config=cfg,
                                     device="cpu")
            np.testing.assert_array_equal(rt.decode(blob, device="cpu"),
                                          view)


@pytest.mark.parametrize("form", ["shared", "raw_total", "per_block"])
def test_encode_uploads_then_counts_then_pads(form):
    """The shared-table planar encode opens its phases in this order: the
    input's upload, the histogram (the table inside), the pad of the last
    row, the table's upload, then the coder's chunks; the input goes up
    once, before any chunk is coded.  The raw-total and per-block encodes
    go through the same encode: one upload before any chunk, a pad, and
    no histogram (raw counts are taken on the host, per-block tables a
    chunk)."""
    data = zipf(5 * 64 + 17, 40, 3, dtype=np.uint8)
    cfg = rt.CodecConfig(block_len=64, chunk_symbols=128,
                         raw_total=form == "raw_total")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if form == "per_block":
            adaptive.encode_adaptive(data, block_len=64, device="cpu")
        else:
            rt.encode(data, config=cfg, device="cpu")
    order = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.name.startswith("planar.")]
    if form == "shared":
        assert order[:5] == ["planar.upload", "planar.histogram",
                             "planar.table", "planar.pad", "planar.upload"]
        assert order.count("planar.upload") == 2
        assert order.count("planar.encode_steps") == 3
        return
    first_chunk = order.index("planar.encode_steps")
    assert order[0] == "planar.upload"
    assert order.index("planar.pad") < first_chunk
    assert "planar.histogram" not in order
    assert order.count("planar.upload") == 1 + (form == "raw_total")
    assert "planar.upload" not in order[first_chunk:]
