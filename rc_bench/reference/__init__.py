"""The benchmark's plain reference: whole containers from a data array.

It imports neither ``jax`` nor either package of the repository: the
table (:mod:`.table`), the planar block coder (:mod:`.planar`, plain
PyTorch on any device), the rans16 spec (:mod:`.rans16`, NumPy) and the
container writer (:mod:`.container`) are frozen copies kept here, so a
change to the program cannot change what it is held to.

``encode`` takes the configuration's ``codec`` settings as written in
its file.  ``drop_bits`` is for the control only: the table is
apportioned at ``2**(k - drop_bits)`` and scaled back up, a table of
lower precision in the same container layout.
"""

from __future__ import annotations

import numpy as np

from . import container, planar, rans16, table


def encode(data: np.ndarray, codec: dict, alphabet: int, device,
           drop_bits: int = 0) -> bytes:
    """The container that ``api.encode(data, alphabet=alphabet,
    config=CodecConfig(**codec))`` must write."""
    profile = codec.get("profile", "planar")
    k = codec.get("k", 16)
    block_len = codec.get("block_len") or (
        65536 if profile == "rans16" else 512)
    with_checksums = codec.get("with_checksums", True)
    c = table.build(table.histogram(data, alphabet), k - drop_bits)
    c = c << np.uint32(drop_bits)
    if profile == "rans16":
        g = codec.get("group_lanes") or rans16.GROUP_LANES
        payloads, lane_len = rans16.encode(data, c, block_len, g,
                                           codec.get("sync_tiles", 0))
        lengths = np.array([len(p) for p in payloads], np.int64)
        return container.pack(
            k=16, alphabet=alphabet, block_len=lane_len,
            n_symbols=data.size, lengths=lengths,
            payload_bytes=b"".join(payloads), tables_c=c,
            with_checksums=with_checksums, group_lanes=g)
    if profile != "planar":
        raise ValueError(f"no reference for profile {profile!r}")
    payloads, lengths = planar.encode(data, c, k, block_len, device)
    return container.pack(
        k=k, alphabet=alphabet, block_len=block_len, n_symbols=data.size,
        lengths=lengths, payload_bytes=payloads, tables_c=c,
        with_checksums=with_checksums)
