"""The port's typed errors, their messages and their order against the
JAX package's, on damaged containers, on the CPU.

The container parse leaves the payloads where they lie in the blob and
checks their bounds over the offsets at once; a decode or a read must
still raise what the reference raises, in the reference's order: the
first payload that runs past the end, then trailing bytes, then the
first unit whose CRC32 differs.  Five blobs a configuration (clean, last
byte flipped, middle byte flipped, 3 bytes cut, 1 trailing byte), each
decoded and read, with and without the checksums.  The port encodes the
blobs (byte-equal to the reference's, ``test_torch_api.py``); each JAX
outcome is computed once.
"""

import functools

import numpy as np
import pytest
import torch

from range_coder_rust_tpu import api as japi
from range_coder_rust_tpu import format as j_fmt
from range_coder_rust_tpu_torch import api as tapi
from range_coder_rust_tpu_torch import format as t_fmt
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)

#: name -> (CodecConfig keywords, symbols): planar default at a small
#: size (6 blocks), and rans16 with 128-lane groups of 1024 steps, two
#: tiles, so that a read starts from a sync point (2 groups)
CONFIGS = {
    "planar": ({}, 3000),
    "rans16_sync": (dict(profile="rans16", group_lanes=128, block_len=1024,
                         sync_tiles=1), 128 * 1024 + 3000),
}
BLOBS = ["clean", "last_byte", "middle_byte", "cut3", "trailing1"]


@functools.lru_cache(maxsize=None)
def _clean(config):
    kw, n = CONFIGS[config]
    data = zipf(n, 50, 7).astype(np.uint8)
    return data, tapi.encode(data, config=tapi.CodecConfig(**kw),
                             device="cpu")


def _blob(config, kind) -> bytes:
    blob = _clean(config)[1]
    if kind in ("last_byte", "middle_byte"):
        bad = bytearray(blob)
        bad[-1 if kind == "last_byte" else len(blob) // 2] ^= 0x10
        return bytes(bad)
    return {"clean": blob, "cut3": blob[:-3],
            "trailing1": blob + b"\x00"}[kind]


def _call(api, config, kind, op, verify, **kw):
    """``("ok", symbols)``, or the error's class name and message."""
    n = CONFIGS[config][1]
    try:
        if op == "decode":
            out = api.decode(_blob(config, kind), verify_checksums=verify,
                             **kw)
        else:  # the last unit's symbols
            out = api.decode_range(_blob(config, kind), n - 150, 120,
                                   verify_checksums=verify, **kw)
    except Exception as e:  # noqa: BLE001 - the class is the result
        return type(e).__name__, str(e)
    return "ok", np.asarray(out)


@functools.lru_cache(maxsize=None)
def _jax(config, kind, op, verify):
    return _call(japi, config, kind, op, verify)


@pytest.mark.parametrize("verify", [True, False])
@pytest.mark.parametrize("op", ["decode", "decode_range"])
@pytest.mark.parametrize("kind", BLOBS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_errors_and_their_order_match_reference(config, kind, op, verify):
    want = _jax(config, kind, op, verify)
    got = _call(tapi, config, kind, op, verify, device="cpu")
    assert got[0] == want[0]
    if got[0] != "ok":
        assert got[1] == want[1]
        return
    assert got[1].dtype == want[1].dtype
    if (config.startswith("rans16") and not verify
            and kind.endswith("_byte")):
        # declared difference: a corrupt rans16 lane that refills past
        # its group's region reads 0 in the port
        assert got[1].shape == want[1].shape
        return
    np.testing.assert_array_equal(got[1], want[1])
    if kind == "clean":
        data = _clean(config)[0]
        n = data.size
        np.testing.assert_array_equal(
            got[1], data if op == "decode" else data[n - 150 : n - 30])


@pytest.mark.parametrize("length", ["grown", "shrunk"])
def test_bounds_over_the_offsets_name_the_first_short_payload(length):
    """A length grown past the blob names its own payload (not the last,
    which the offsets' cumulative sum would also push out); a length
    shrunk leaves trailing bytes.  Same class and message as the
    reference's payload-by-payload parse."""
    blob = bytearray(_clean("planar")[1])
    at = t_fmt.HEADER_BYTES + 4 * 2  # payload 2's length
    old = int.from_bytes(blob[at : at + 4], "little")
    new = old + 10 ** 6 if length == "grown" else old - 5
    blob[at : at + 4] = new.to_bytes(4, "little")
    outcomes = []
    for fmt in (j_fmt, t_fmt):
        with pytest.raises(Exception) as e:
            fmt.unpack(bytes(blob))
        outcomes.append((type(e.value).__name__, str(e.value)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][1] == ("container truncated in payload 2"
                              if length == "grown"
                              else "5 trailing bytes after payloads")
