"""The planar encode's payload hand-off, on the CPU.

Each chunk's payloads are joined on the device
(``kernels.planar_compact``, whose plain version runs here) and copied
into one host payload area, which ``format.pack`` takes as a
``PayloadArea``.  The plain compaction must equal the rows' prefixes
joined; ``pack`` of an area must write the bytes ``pack`` of the same
payloads as a list writes, in every table form and in rans16; and an
encode over several chunks, whose later chunks code longer than the
first (so the host area grows), must give the JAX package's container
in each table form.  Each JAX container is made once.
"""

import numpy as np
import pytest
import torch

import range_coder_rust_tpu_torch as rt
from range_coder_rust_tpu import adaptive as jad
from range_coder_rust_tpu import api as japi
from range_coder_rust_tpu_torch import adaptive, api, format as fmt
from range_coder_rust_tpu_torch.kernels import planar_compact
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)

L = 64


def test_plain_compaction_joins_row_prefixes():
    """Random lengths from 0 to the capacity, off the 4-byte grid: the
    area is each row's prefix, joined in row order; a length past the
    row or the area, and an offset outside it, are cut as the kernel cuts
    them."""
    rng = np.random.default_rng(5)
    B, C = 37, 44
    code = rng.integers(0, 256, (B, C), dtype=np.uint8)
    lengths = rng.integers(0, C + 1, B)
    lengths[[0, 5, 9]] = [0, C, 13]
    offsets = np.concatenate([[0], np.cumsum(lengths[:-1])])
    size = int(lengths.sum())
    args = [torch.from_numpy(x) for x in (code, lengths, offsets)]
    area = planar_compact(*args, size=size)
    assert area.dtype == torch.uint8 and area.shape == (size,)
    assert area.numpy().tobytes() == b"".join(
        code[b, : lengths[b]].tobytes() for b in range(B))
    cut = planar_compact(args[0][:3], torch.tensor([C + 9, 4, 5]),
                         torch.tensor([0, -1, C + 7]), size=C + 10)
    want = np.zeros(C + 10, np.uint8)
    want[:C] = code[0]
    want[C + 7 :] = code[2, :3]
    np.testing.assert_array_equal(cut.numpy(), want)


def _forms():
    """name -> a container of that form, encoded by the port."""
    data = zipf(9 * L + 21, 40, 3, dtype=np.uint8)
    return {
        "shared": lambda: rt.encode(data, config=rt.CodecConfig(block_len=L),
                                    device="cpu"),
        "per_block": lambda: adaptive.encode_adaptive(data, block_len=L,
                                                      device="cpu"),
        "raw_total": lambda: rt.encode(
            data, config=rt.CodecConfig(block_len=L, raw_total=True),
            device="cpu"),
        "rans16": lambda: rt.encode(data, config=rt.CodecConfig(
            profile="rans16", block_len=4, group_lanes=128), device="cpu"),
    }


@pytest.mark.parametrize("form", ["shared", "per_block", "raw_total",
                                  "rans16"])
def test_pack_of_an_area_equals_pack_of_a_list(form):
    blob = _forms()[form]()
    listed = fmt.unpack(blob)
    area = fmt.unpack(blob, copy=False).payloads
    assert isinstance(area, fmt.PayloadArea) and isinstance(
        listed.payloads, list)
    kw = dict(k=listed.k, alphabet=listed.alphabet,
              block_len=listed.block_len, n_symbols=listed.n_symbols,
              tables_c=listed.tables_c,
              per_block_tables=listed.per_block_tables,
              profile=listed.profile, group_lanes=listed.group_lanes)
    assert fmt.pack(payloads=area, **kw) == blob
    assert fmt.pack(payloads=listed.payloads, **kw) == blob
    # a slice of an area (offsets rebased) packs as its payloads' list
    if listed.per_block_tables:
        kw["tables_c"] = listed.tables_c[1:]
    assert (fmt.pack(payloads=area[1:], **kw)
            == fmt.pack(payloads=listed.payloads[1:], **kw))


#: the input of each multi-chunk case: a first chunk of one repeated
#: symbol (short payloads), then Zipf bytes, and a partial last block
_DATA = np.concatenate([np.full(4 * L, 7, np.uint8),
                        zipf(13 * L + 29, 200, 4, dtype=np.uint8)])
_JAX = {}


def _jax_blob(form: str) -> bytes:
    if form not in _JAX:
        if form == "per_block":
            _JAX[form] = jad.encode_adaptive(_DATA, alphabet=256, k=12,
                                             block_len=L)
        else:
            cfg = japi.CodecConfig(block_len=L,
                                   raw_total=form == "raw_total")
            _JAX[form] = japi.encode(_DATA, alphabet=256, config=cfg)
    return _JAX[form]


@pytest.mark.parametrize("form", ["shared", "raw_total", "per_block"])
def test_multi_chunk_encode_equals_jax(form):
    """Chunks of 4 blocks, the last block partial, the later chunks
    coding longer than the first: the container equals the JAX
    package's, and decodes back."""
    cfg = rt.CodecConfig(block_len=L, chunk_symbols=4 * L,
                         raw_total=form == "raw_total")
    if form == "per_block":
        blob = api._encode_planar(
            _DATA, 256, cfg, "cpu", k=12,
            block_tables=lambda rows: adaptive.block_tables(
                rows, alphabet=256, k=12))
    else:
        blob = rt.encode(_DATA, alphabet=256, config=cfg, device="cpu")
    assert blob == _jax_blob(form)
    np.testing.assert_array_equal(rt.decode(blob, device="cpu"), _DATA)
