"""rans16 encode: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``_rans_encode_kernel`` of
``range_coder_rust_tpu/kernels/rans_encode.py`` (wrapper
``rans_encode_tiled``).  The kernel is ``csrc/rans_encode.cu``; its header
says what bounds it on the H100 and what its design does about that.

Both versions take lane-major symbol rows ``(NG * G, L)`` (lane ``l`` of
group ``g`` is row ``g * G + l``) as ``uint8``, ``int16`` (u16 bits) or
``int32``, the padded cum table of :func:`..kernels.vreg.prep_cum_vreg`
(``(1024,)``, shared) or one per group (``(NG, 1024)``, the adaptive
mode), and a sync period ``sync_tiles`` (0: none), and return

* ``states`` ``(NG * G,)`` int64: each lane's final state, the preamble;
* ``sizes`` ``(NG, L // tile)`` int32: per-tile region sizes in halfwords,
  in time order;
* ``region`` int16: the emitted halfwords of every group, group after
  group, each in (step ascending, lane ascending) order.  Only the first
  ``sizes.sum()`` entries are the region; the kernel's buffer is sized for
  the worst case (one halfword per symbol) so that it never synchronises
  to learn the total;
* ``syncs`` ``(NG, n_sync, G)`` int64, ``n_sync = (NT - 1) // sync_tiles``
  (0 without a period): sync ``j`` (1-based) is each lane's state right
  after the chain finishes time-tile ``j * sync_tiles``, the state the
  decoder holds before that tile (tile random access).

Per group this is exactly the NumPy spec :func:`..rans.encode_lanes`
(the port's copy of ``range_coder_rust_tpu/rans.py``):
the region is its ``regions`` concatenated, and the sizes are its counts
summed per tile.
"""

from __future__ import annotations

import ctypes

import torch

#: per-tile region capacity in halfwords, as in the reference: it fixes
#: the steps per tile, and so the tile count NT the container records
CAP_HW = 65536


def tile_steps_for(group_lanes: int) -> int:
    """Steps per tile for a group width (the container's per-tile
    bookkeeping unit)."""
    return max(1, CAP_HW // group_lanes)


#: symbol row dtypes the kernel reads, and their bytes
SYMBOL_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def n_syncs(n_tiles: int, sync_tiles: int) -> int:
    """Sync states a lane records for a sync period (0: none)."""
    return (n_tiles - 1) // sync_tiles if sync_tiles > 0 else 0


def _check_inputs(rows: torch.Tensor, cum: torch.Tensor, group_lanes: int,
                  tile: int, sync_tiles: int) -> None:
    if rows.dim() != 2 or rows.dtype not in SYMBOL_BYTES:
        raise ValueError(f"rows must be 2-D uint8, int16 or int32, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    B, L = rows.shape
    if B == 0 or B % group_lanes or group_lanes % 128:
        raise ValueError(f"{B} rows do not make groups of {group_lanes}")
    if (cum.shape not in ((1024,), (B // group_lanes, 1024))
            or cum.dtype != torch.int32):
        raise ValueError("cum must be the (1024,) or (NG, 1024) int32 "
                         "padded table")
    if cum.device != rows.device:
        raise ValueError("rows and cum must be on one device")
    if tile < 1 or L % tile:
        raise ValueError(f"lane length {L} is not a multiple of tile {tile}")
    if sync_tiles < 0:
        raise ValueError(f"sync_tiles {sync_tiles} must be >= 0")


def rans_encode_plain(rows: torch.Tensor, cum: torch.Tensor, *,
                      group_lanes: int, tile: int, sync_tiles: int = 0):
    """The encode in plain PyTorch on int64, lane-vectorized, one Python
    iteration per step."""
    _check_inputs(rows, cum, group_lanes, tile, sync_tiles)
    B, L = rows.shape
    ng = B // group_lanes
    dev = rows.device
    sym = rows.to(torch.int64)
    if rows.dtype == torch.int16:
        sym &= 0xFFFF  # u16 bits
    # each group's table, gathered per symbol
    cum64 = cum.to(torch.int64).expand(ng, 1024)
    by_group = sym.view(ng, -1)
    cs_all = torch.gather(cum64, 1, by_group).view(B, L)
    c_all = torch.gather(cum64, 1, by_group + 1).view(B, L) - cs_all
    n_sync = n_syncs(L // tile, sync_tiles)
    syncs = torch.empty((ng, n_sync, group_lanes), dtype=torch.int64,
                        device=dev)
    x = torch.full((B,), 1 << 32, dtype=torch.int64, device=dev)
    park = torch.empty((L, B), dtype=torch.int64, device=dev)
    for t in range(L - 1, -1, -1):
        c = c_all[:, t]
        emit = (x >> 32) >= c
        park[t] = (x & 0xFFFF) | (emit.to(torch.int64) << 16)
        x = torch.where(emit, x >> 16, x)
        q = torch.div(x, c, rounding_mode="floor")
        x = (q << 16) | (cs_all[:, t] + x - q * c)
        ti = t // tile
        if n_sync and t % tile == 0 and ti and ti % sync_tiles == 0:
            syncs[:, ti // sync_tiles - 1] = x.view(ng, group_lanes)
    # (step, lane) order within each group is region order
    grouped = park.view(L, ng, group_lanes).permute(1, 0, 2)
    flags = (grouped >> 16) != 0
    sizes = flags.reshape(ng, L // tile, tile * group_lanes).sum(-1)
    hw = grouped[flags] & 0xFFFF
    region = torch.where(hw >= 0x8000, hw - 0x10000, hw).to(torch.int16)
    return x, sizes.to(torch.int32), region, syncs


def encode_plan(n_groups: int, group_lanes: int, block_len: int,
                dtype: torch.dtype) -> dict:
    """What the kernel build needs for a shape: ``scratch_bytes`` (the
    parked halfwords and ballot words), ``chain_threads`` (the chain's
    block size) and ``chunk_steps`` (steps one 32-byte read of a row
    covers).  Builds the kernels on first use."""
    from ._build import check, library

    scratch = ctypes.c_longlong()
    threads, steps = ctypes.c_int(), ctypes.c_int()
    check(library().rc_rans_encode_plan(
        n_groups, group_lanes, block_len, SYMBOL_BYTES[dtype],
        ctypes.byref(scratch), ctypes.byref(threads), ctypes.byref(steps)),
        "rans16 encode plan")
    return {"scratch_bytes": scratch.value, "chain_threads": threads.value,
            "chunk_steps": steps.value}


def rans_encode_tiled(rows: torch.Tensor, cum: torch.Tensor, *,
                      group_lanes: int, tile: int, sync_tiles: int = 0):
    """Encode lane-major symbol rows: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor.  See the module docstring."""
    if rows.device.type == "cpu":
        return rans_encode_plain(rows, cum, group_lanes=group_lanes,
                                 tile=tile, sync_tiles=sync_tiles)
    if rows.device.type != "cuda":
        raise ValueError(f"no rans16 encode for device {rows.device}")
    _check_inputs(rows, cum, group_lanes, tile, sync_tiles)
    from ._build import check, library

    # keep the contiguous tensors referenced until the launch is queued
    rows, cum = rows.contiguous(), cum.contiguous()
    B, L = rows.shape
    ng, nt = B // group_lanes, L // tile
    n_sync = n_syncs(nt, sync_tiles)
    dev = rows.device
    states = torch.empty(B, dtype=torch.int64, device=dev)
    sizes = torch.empty((ng, nt), dtype=torch.int32, device=dev)
    offs = torch.empty(ng * nt + 1, dtype=torch.int64, device=dev)
    syncs = torch.empty((ng, n_sync, group_lanes), dtype=torch.int64,
                        device=dev)
    plan = encode_plan(ng, group_lanes, L, rows.dtype)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                          device=dev)
    region = torch.empty(B * L, dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().rc_rans_encode(
            rows.data_ptr(), SYMBOL_BYTES[rows.dtype], cum.data_ptr(),
            0 if cum.dim() == 1 else 1024, states.data_ptr(),
            sizes.data_ptr(), offs.data_ptr(),
            syncs.data_ptr() if n_sync else None, sync_tiles if n_sync else 0,
            scratch.data_ptr(), scratch.numel(), region.data_ptr(), ng,
            group_lanes, L, tile, stream)
    check(err, "rans16 encode kernel")
    rans_encode_tiled.launches += 1
    return states, sizes, region, syncs


#: launches of the CUDA kernel (the plain version does not count)
rans_encode_tiled.launches = 0
