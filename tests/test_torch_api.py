"""The port's api against the JAX package's, on the CPU.

The port's rans16 containers must be byte-equal to
``range_coder_rust_tpu.api.encode``'s for the same input and config, each
package must decode the other's containers, and corruption must raise
typed errors of the same names (the port's own classes).  The planar
profile is held to the reference in ``test_torch_planar_api.py``.
"""

import numpy as np
import pytest
import torch

import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu import api as japi
from range_coder_rust_tpu import errors as jerr
from range_coder_rust_tpu import format as fmt
from range_coder_rust_tpu_torch.errors import (
    ChecksumMismatch, ConfigError, InvalidHeader, ZeroFrequency)
from range_coder_rust_tpu_torch.models.table import build_table_pow2
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)

G, L = 128, 64
JCFG = japi.CodecConfig(profile="rans16", block_len=L, group_lanes=G)
TCFG = rt.CodecConfig(profile="rans16", block_len=L, group_lanes=G)


GEOMETRIES = {
    "exact_multiple": (G * L, 256),
    "partial_last_group": (2 * G * L + 777, 256),
    "u16_alphabet": (G * L + 5, 400),
    "empty": (0, 256),
    "A129": (3000, 129),
}


@pytest.fixture(scope="module")
def blobs():
    """name -> (data, alphabet, JAX container, port container)."""
    cache = {}

    def get(name):
        if name not in cache:
            n, a = GEOMETRIES[name]
            data = zipf(n, a, seed=n + a)
            cache[name] = (
                data, a, japi.encode(data, alphabet=a, config=JCFG),
                rt.encode(data, alphabet=a, config=TCFG, device="cpu"))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_container_bytes_equal(name, blobs):
    data, a, jblob, tblob = blobs(name)
    assert tblob == jblob
    cont = fmt.unpack(tblob)
    assert cont.profile == "rans16" and cont.group_lanes == G
    assert cont.n_symbols == data.size


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_port_decodes_jax_container(name, blobs):
    data, a, jblob, _ = blobs(name)
    out = rt.decode(jblob, device="cpu")
    assert out.dtype == (np.uint8 if a <= 256 else np.uint16)
    np.testing.assert_array_equal(out.astype(np.int32), data)


@pytest.mark.parametrize("name", ["partial_last_group", "u16_alphabet"])
def test_jax_decodes_port_container(name, blobs):
    data, a, _, tblob = blobs(name)
    out = japi.decode(tblob)
    np.testing.assert_array_equal(np.asarray(out).astype(np.int32), data)


def test_decode_bytes_and_byte_input():
    data = bytes(zipf(5000, 256, 1).astype(np.uint8))
    blob = rt.encode(data, config=TCFG, device="cpu")
    assert rt.decode_bytes(blob, device="cpu") == data


def test_default_group_width_and_lane_shrink():
    """Default G = 2048: a small input shrinks the lane length exactly as
    the reference does (the header carries the shrunk length)."""
    data = zipf(2048 * 20 + 3, 256, 2)
    cfg = rt.CodecConfig(profile="rans16")
    cont = fmt.unpack(rt.encode(data, config=cfg, device="cpu"))
    assert (cont.group_lanes, cont.block_len, cont.n_blocks) == (2048, 21, 1)
    out = rt.decode(rt.encode(data, config=cfg, device="cpu"), device="cpu")
    np.testing.assert_array_equal(out.astype(np.int32), data)


def test_supplied_table_and_zero_frequency():
    data = zipf(4000, 64, 3)
    counts = np.bincount(data, minlength=80).astype(np.uint64) + 1
    table = build_table_pow2(counts, 16)
    blob = rt.encode(data, config=TCFG, table=table, device="cpu")
    assert fmt.unpack(blob).alphabet == 80
    np.testing.assert_array_equal(
        rt.decode(blob, device="cpu").astype(np.int32), data)
    counts[data[0]] = 0
    with pytest.raises(ZeroFrequency):
        rt.encode(data, config=TCFG, table=build_table_pow2(counts, 16),
                  device="cpu")


def test_flipped_payload_bit_raises_checksum_mismatch(blobs):
    _, _, _, tblob = blobs("partial_last_group")
    bad = bytearray(tblob)
    bad[-3] ^= 0x40
    with pytest.raises(ChecksumMismatch):
        rt.decode(bytes(bad), device="cpu")


def test_truncated_container_raises_invalid_header(blobs):
    _, _, _, tblob = blobs("exact_multiple")
    with pytest.raises(InvalidHeader):
        rt.decode(tblob[:-10], device="cpu")


def test_symbol_outside_alphabet_raises():
    with pytest.raises(ConfigError):
        rt.encode(np.array([1, 2, 300]), alphabet=256, config=TCFG,
                  device="cpu")
    with pytest.raises(ConfigError):
        rt.encode(np.array([1, -2]), config=TCFG, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(profile="rans16", k=12), dict(profile="nope"), dict(block_len=0),
    dict(raw_total=True, profile="rans16"), dict(per_group_tables=True),
    dict(sync_tiles=-1), dict(sync_tiles=2), dict(group_lanes=256),
    dict(profile="rans16", group_lanes=384), dict(k=25),
])
def test_codec_config_validation_matches_reference(kw):
    with pytest.raises(jerr.ConfigError):
        japi.CodecConfig(**kw)
    with pytest.raises(ConfigError):
        rt.CodecConfig(**kw)


def test_codec_config_takes_wide_planar_tables_only():
    """The port takes k 17 to 24 for a shared planar table, past the JAX
    package's 16 as the upstream coder's u32 totals allow, and still
    refuses them for rans16 and for per-block tables."""
    for k in range(17, 25):
        assert rt.CodecConfig(k=k).k == k
        with pytest.raises(jerr.ConfigError):
            japi.CodecConfig(k=k)
        with pytest.raises(ConfigError):
            rt.CodecConfig(k=k, profile="rans16")
    from range_coder_rust_tpu_torch import adaptive

    with pytest.raises(ConfigError):
        adaptive.encode_adaptive(np.arange(8), k=17, device="cpu")


def test_codec_config_defaults_match_reference():
    for kw in ({}, {"profile": "rans16"}):
        j, t = japi.CodecConfig(**kw), rt.CodecConfig(**kw)
        assert [getattr(t, f) for f in t.__dataclass_fields__] == [
            getattr(j, f) for f in t.__dataclass_fields__]


def test_default_device_is_cuda():
    """Nothing picks the CPU on its own: without a card the default
    device fails instead of running the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        rt.encode(zipf(100, 16, 5), config=TCFG)
    with pytest.raises((AssertionError, RuntimeError)):
        rt.encode(zipf(100, 16, 5))  # the planar default
