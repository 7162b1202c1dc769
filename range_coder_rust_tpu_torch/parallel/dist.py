"""Sharded block-parallel and group-parallel coding over several devices.

The port's counterpart of ``range_coder_rust_tpu/parallel/dist.py``.
Where the reference has a 1-D ``jax.sharding.Mesh`` and lets XLA split the
block axis, the port takes a sequence of ``torch.device``s, one shard
each, and splits the unit axis itself: shard ``i`` of ``n`` codes units
``[i * U / n, (i + 1) * U / n)`` on ``devices[i]``.  Planar blocks and
rans16 groups are independent coder units, so the shards exchange nothing
while they code; a shared table is copied to every shard's device, a
per-group table travels with its group.  Results come back in unit order
on the first shard's device, bit-identical to one unsharded call.

A device may appear more than once: several shards then take turns on
one device (``["cpu"] * 4`` in the CPU tests, ``[cuda:0, cuda:0]`` on a
machine with one card).  The shards are issued one after another without
a synchronisation between them, so shards on different cards overlap.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..blocks import decode_blocks, encode_blocks
from ..kernels.rans_decode import rans_decode_tiled
from ..kernels.rans_encode import rans_encode_tiled


def default_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The shard devices: the given ones, or every CUDA device.  Raises
    when no device is given and there is no card: it never picks the CPU
    on its own."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("default_mesh: no CUDA device; pass the devices "
                           "(e.g. ['cpu']) to shard on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def shard_bounds(n_units: int, n_shards: int, unit: str = "blocks",
                 shards: str = "devices") -> List[Tuple[int, int]]:
    """``[start, stop)`` of each shard's contiguous unit range.  Raises
    the reference's ``ValueError`` unless the units divide evenly."""
    if n_units % n_shards:
        raise ValueError(
            f"{n_units} {unit} not divisible by {n_shards} {shards}")
    per = n_units // n_shards
    return [(i * per, (i + 1) * per) for i in range(n_shards)]


def make_sharded_codec(
    devices: Sequence, *, k: int, block_len: int, capacity: int
) -> Tuple[Callable, Callable]:
    """Planar ``(encode, decode)`` over ``devices``, the block axis split
    evenly.

    encode(symbols (B, L) int, c (A,), cum (A+1,)) -> (code (B, capacity)
    uint8, lengths (B,) int64); decode(code (B, C) uint8, c, cum) ->
    symbols (B, block_len) int32.  Tables are int64 tensors, one shared
    table (copied to each shard's device).  ``B`` must be a multiple of
    the number of devices.  Each shard runs the planar wrappers
    (:func:`..blocks.encode_blocks`, :func:`..blocks.decode_blocks`; the
    CUDA kernels on a card, one launch a shard)."""
    devs = default_mesh(devices)

    def enc(symbols: torch.Tensor, c: torch.Tensor, cum: torch.Tensor):
        code, lengths = [], []
        for dev, (lo, hi) in zip(devs, shard_bounds(symbols.shape[0],
                                                    len(devs))):
            cd, n = encode_blocks(symbols[lo:hi].to(dev), c.to(dev),
                                  cum.to(dev), k=k, capacity=capacity)
            code.append(cd)
            lengths.append(n)
        return _gather(code, devs), _gather(lengths, devs)

    def dec(code: torch.Tensor, c: torch.Tensor, cum: torch.Tensor):
        return _gather([
            decode_blocks(code[lo:hi].to(dev), c.to(dev), cum.to(dev), k=k,
                          block_len=block_len)
            for dev, (lo, hi) in zip(devs, shard_bounds(code.shape[0],
                                                        len(devs)))], devs)

    return enc, dec


def make_sharded_rans16(
    devices: Sequence, *, block_len: int, a_count: int,
    per_group_tables: bool = False
) -> Tuple[Callable, Callable]:
    """rans16 ``(encode, decode)`` over ``devices``: groups are the
    data-parallel axis, each shard runs the kernel wrappers
    (:func:`..kernels.rans_encode_tiled`, :func:`..kernels.rans_decode_tiled`;
    the CUDA kernels on a card, the plain versions on the CPU).

    encode(rows (NG * G, block_len), cum, *, group_lanes, tile,
    sync_tiles=0) -> (states (NG * G,) int64, sizes (NG, NT) int32,
    region int16, syncs (NG, n_sync, G) int64): the wrapper's outputs,
    except that ``region`` holds exactly the ``sizes.sum()`` emitted
    halfwords, group after group (the wrapper's is a worst-case buffer
    whose head they are).

    decode(states, region, grp_off (NG + 1,), cum, *, group_lanes,
    out_dtype) -> (NG * G, block_len) symbols, as the wrapper.

    ``cum`` is the ``(1024,)`` padded table, copied to each shard, or with
    ``per_group_tables`` the ``(NG, 1024)`` tables, split with their
    groups.  ``NG`` must be a multiple of the number of devices."""
    devs = default_mesh(devices)

    def tables(cum: torch.Tensor, lo: int, hi: int, dev) -> torch.Tensor:
        return (cum[lo:hi] if per_group_tables else cum).to(dev)

    def enc(rows: torch.Tensor, cum: torch.Tensor, *, group_lanes: int,
            tile: int, sync_tiles: int = 0):
        if rows.shape[1] != block_len:
            raise ValueError(f"rows of {rows.shape[1]} steps, expected "
                             f"{block_len}")
        g = group_lanes
        outs = [rans_encode_tiled(
                    rows[lo * g : hi * g].to(dev), tables(cum, lo, hi, dev),
                    group_lanes=g, tile=tile, sync_tiles=sync_tiles)
                for dev, (lo, hi) in zip(devs, shard_bounds(
                    rows.shape[0] // g, len(devs), "groups"))]
        # one synchronisation for all shards: each region's used length
        used = [int(n) for n in torch.stack(
            [sizes.sum().to(devs[0]) for _, sizes, _, _ in outs]).tolist()]
        states, sizes, syncs = (_gather([o[i] for o in outs], devs)
                                for i in (0, 1, 3))
        region = _gather([o[2][:n] for o, n in zip(outs, used)], devs)
        return states, sizes, region, syncs

    def dec(states: torch.Tensor, region: torch.Tensor,
            grp_off: torch.Tensor, cum: torch.Tensor, *, group_lanes: int,
            out_dtype: torch.dtype):
        g = group_lanes
        off = grp_off.tolist()
        outs = []
        for dev, (lo, hi) in zip(devs, shard_bounds(len(off) - 1, len(devs),
                                                    "groups")):
            sub_off = torch.tensor([o - off[lo] for o in off[lo : hi + 1]],
                                   dtype=torch.int64, device=dev)
            outs.append(rans_decode_tiled(
                states[lo * g : hi * g].to(dev),
                region[off[lo] : off[hi]].to(dev), sub_off,
                tables(cum, lo, hi, dev), group_lanes=g, block_len=block_len,
                a_count=a_count, out_dtype=out_dtype))
        return _gather(outs, devs)

    return enc, dec


def _gather(parts: List[torch.Tensor], devs: List[torch.device]
            ) -> torch.Tensor:
    """The shards' outputs concatenated in shard order on the first
    shard's device."""
    return torch.cat([p.to(devs[0]) for p in parts])
