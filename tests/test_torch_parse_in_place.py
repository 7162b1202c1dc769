"""The api parses containers in place, on the CPU.

``api.decode``, ``api.decode_range`` and ``adaptive.decode_adaptive``
leave every payload where it lies in the blob: the copied-bytes counter
of :mod:`range_coder_rust_tpu_torch.format` stays at 0 through them,
and only the public ``fmt.unpack`` copies, exactly the payload area.  A
planar container whose payload area starts at a byte 2 (mod 4) of the
blob, decoded in chunks that start at odd offsets of the area, decodes
exactly.  Port-only: no JAX work.
"""

import numpy as np
import pytest
import torch

from range_coder_rust_tpu_torch import adaptive, api
from range_coder_rust_tpu_torch import format as fmt
from range_coder_rust_tpu_torch.testing import zipf

torch.set_num_threads(1)


def _planar(n=3000):
    data = zipf(n, 50, 3).astype(np.uint8)
    return data, api.encode(data, device="cpu")


def _rans16_sync():
    data = zipf(128 * 1024 + 3000, 50, 4).astype(np.uint8)
    cfg = api.CodecConfig(profile="rans16", group_lanes=128, block_len=1024,
                          sync_tiles=1)
    return data, api.encode(data, config=cfg, device="cpu")


def _adaptive():
    data = zipf(700, 40, 5).astype(np.uint8)
    return data, adaptive.encode_adaptive(data, k=10, block_len=64,
                                          device="cpu")


def _raw_total():
    data = zipf(700, 40, 6).astype(np.uint8)
    return data, api.encode(data, config=api.CodecConfig(
        raw_total=True, block_len=64), device="cpu")


CASES = {"planar": (_planar, api.decode),
         "rans16_sync": (_rans16_sync, api.decode),
         "adaptive": (_adaptive, adaptive.decode_adaptive),
         "raw_total": (_raw_total, api.decode)}


@pytest.mark.parametrize("case", list(CASES))
def test_api_decodes_copy_no_payload_bytes(case):
    make, decode = CASES[case]
    data, blob = make()
    n = data.size
    fmt.reset_copied_payload_bytes()
    np.testing.assert_array_equal(decode(blob, device="cpu"), data)
    # a long read, then a short one inside the last unit
    for start, count in ((n - 700, 600), (n - 40, 30)):
        np.testing.assert_array_equal(
            api.decode_range(blob, start, count, device="cpu"),
            data[start : start + count])
    assert fmt.copied_payload_bytes() == 0
    # a mutable blob is viewed too, and no view outlives the call
    mutable = bytearray(blob)
    np.testing.assert_array_equal(decode(mutable, device="cpu"), data)
    mutable += b"\x00"
    assert fmt.copied_payload_bytes() == 0
    # the public form copies exactly the payload area, as bytes
    cont = fmt.unpack(blob)
    area = int(cont.lengths.sum())
    assert fmt.copied_payload_bytes() == area
    assert all(type(p) is bytes for p in cont.payloads)
    view = fmt.unpack(blob, copy=False)
    assert isinstance(view.payloads, fmt.PayloadArea)
    assert view.payloads.area.readonly and view.payloads.area.nbytes == area
    assert [bytes(p) for p in view.payloads] == cont.payloads
    assert fmt.copied_payload_bytes() == area


def test_payload_area_slices_rebase_their_offsets():
    _, blob = _planar()
    cont = fmt.unpack(blob)
    pa = fmt.unpack(blob, copy=False).payloads
    sub = pa[2:5]
    assert len(sub) == 3 and sub.offsets[0] == 0
    assert [bytes(p) for p in sub] == cont.payloads[2:5]
    assert bytes(pa[-1]) == cont.payloads[-1] and len(pa[4:2]) == 0
    with pytest.raises(IndexError):
        pa[len(pa)]
    with pytest.raises(ValueError):
        pa[::2]


@pytest.mark.parametrize("tables", ["shared", "per_block"])
def test_planar_area_at_odd_offsets_decodes_exactly(tables, monkeypatch):
    """An odd alphabet under k < 16 makes the u16 table odd in length, so
    the payload area starts at a byte 2 (mod 4) of the blob; chunks of
    two blocks start at odd offsets of the area, uploaded with their
    offsets rebased, as the card's decode takes them."""
    L, A = 64, 37
    data = zipf(9 * L - 5, A, 12).astype(np.uint8)  # 9 blocks
    if tables == "shared":
        blob = api.encode(data, alphabet=A, device="cpu",
                          config=api.CodecConfig(k=12, block_len=L))
        decode = api.decode
    else:
        blob = adaptive.encode_adaptive(data, alphabet=A, k=12, block_len=L,
                                        device="cpu")
        decode = adaptive.decode_adaptive
    offsets = fmt.unpack(blob, copy=False).payloads.offsets
    assert (len(blob) - int(offsets[-1])) % 4 == 2
    assert np.any(offsets[2:-1:2] % 2 == 1)  # a chunk at an odd offset
    for mod in (api, adaptive):
        monkeypatch.setattr(mod, "_CHUNK_SYMBOLS", 2 * L)
    seen = []
    real = api.payload_buffers

    def spy(payloads, lengths, device):
        seen.append(isinstance(payloads, fmt.PayloadArea))
        return real(payloads, lengths, device)

    for mod in (api, adaptive):
        monkeypatch.setattr(mod, "payload_buffers", spy)
    fmt.reset_copied_payload_bytes()
    np.testing.assert_array_equal(decode(blob, device="cpu"), data)
    np.testing.assert_array_equal(
        api.decode_range(blob, L + 3, 5 * L, device="cpu"),
        data[L + 3 : 6 * L + 3])
    assert fmt.copied_payload_bytes() == 0
    assert len(seen) == 5 + 3 and all(seen)
