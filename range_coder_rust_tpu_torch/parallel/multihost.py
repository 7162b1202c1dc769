"""Several processes, one container: scale-out over ``torch.distributed``.

The port's counterpart of ``range_coder_rust_tpu/parallel/multihost.py``
(which runs over ``jax.distributed``):

* processes join one process group with :func:`initialize`;
* the unit axis (planar blocks, rans16 groups) is split into contiguous,
  equal ranges, one a rank (:func:`local_block_range`,
  :func:`local_group_range`); each rank codes its range on its own
  device, with no communication while it codes;
* two collectives follow: an all-gather of the per-unit payload lengths,
  then one all-gather of each rank's trimmed payload bytes, concatenated
  and padded only to the largest rank's total (:func:`gather_payload_bytes`);
* any rank then packs the container (:func:`assemble_container`), byte for
  byte the single-process ``api.encode`` output at any world size.

The gathers run on host tensors, as the container is assembled on the
host: that needs the ``gloo`` backend, the default.  ``nccl`` is for
ranks with a card each (it refuses two ranks on one card); with it the
gathers go through this rank's card.  Without a process group every
function works as a world of one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import format as fmt
from .. import rans_codec
from ..blocks import default_capacity, upload_rows
from .dist import default_mesh, make_sharded_codec, shard_bounds


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: str = "gloo",
    **kw,
) -> None:
    """Join the process group at ``tcp://{coordinator_address}``
    (``host:port``) as rank ``process_id`` of ``num_processes``; ``kw``
    goes to ``torch.distributed.init_process_group``."""
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kw)


def _world() -> Tuple[int, int]:
    """(world size, rank); a world of one without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(device="cuda") -> List[torch.device]:
    """This rank's device list, one shard: the CPU when asked, else the
    card ``rank % card count`` (raises without a card)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    cards = default_mesh()
    return [cards[_world()[1] % len(cards)]]


def _local_range(n_units: int, unit: str) -> Tuple[int, int]:
    nproc, rank = _world()
    return shard_bounds(n_units, nproc, unit, "processes")[rank]


def local_block_range(n_blocks: int) -> Tuple[int, int]:
    """The ``[start, stop)`` rows of the global block axis this rank owns:
    contiguous, an equal share for every rank (``n_blocks`` must divide
    evenly; pad the corpus as ``api.encode`` does)."""
    return _local_range(n_blocks, "blocks")


def local_group_range(n_groups: int) -> Tuple[int, int]:
    """The ``[start, stop)`` rans16 groups this rank owns (the group
    analogue of :func:`local_block_range`)."""
    return _local_range(n_groups, "groups")


def _comm_device() -> torch.device:
    """Where collectives run: the host, or this rank's card under nccl."""
    if _world()[0] > 1 and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """``(world, *t.shape)``: every rank's ``t`` (equal shapes), on the
    host."""
    nproc, _ = _world()
    if nproc == 1:
        return t[None]
    t = t.to(_comm_device())
    out = [torch.empty_like(t) for _ in range(nproc)]
    dist.all_gather(out, t)
    return torch.stack(out).cpu()


def _gather(local_payloads: Sequence[bytes]) -> Tuple[list, np.ndarray]:
    """Both collectives: the global lengths, then the global payloads."""
    lens_local = torch.tensor([len(p) for p in local_payloads],
                              dtype=torch.int64)
    lengths_all = _all_gather(lens_local).reshape(-1).numpy()
    return gather_payload_bytes(local_payloads, lengths_all), lengths_all


def gather_payload_bytes(local_payloads, lengths_all: np.ndarray) -> list:
    """Ordered all-gather of variable-length payload bytes.

    Every rank holds the payloads of its contiguous unit range; the
    global per-unit ``lengths_all`` (already all-gathered) tell every rank
    how to split the gathered bytes.  Each rank sends its payloads
    concatenated and padded only to the largest rank's total.  Returns the
    global payload list, on every rank."""
    nproc, _ = _world()
    per_rank = np.asarray(lengths_all, np.int64).reshape(nproc, -1)
    max_tot = int(per_rank.sum(axis=1).max())
    buf = np.zeros(max_tot, np.uint8)
    cat = b"".join(bytes(p) for p in local_payloads)
    buf[: len(cat)] = np.frombuffer(cat, np.uint8)
    rows = _all_gather(torch.from_numpy(buf)).numpy()  # (nproc, max_tot)
    payloads = []
    for p in range(nproc):
        offs = np.concatenate([[0], np.cumsum(per_rank[p])])
        for i in range(per_rank.shape[1]):
            payloads.append(rows[p, offs[i] : offs[i + 1]].tobytes())
    return payloads


def encode_multihost(
    local_rows: np.ndarray,
    c: np.ndarray,
    cum: np.ndarray,
    *,
    k: int,
    n_blocks: int,
    capacity: Optional[int] = None,
    device="cuda",
) -> Tuple[list, np.ndarray]:
    """Encode this rank's planar block rows as part of the global batch.

    ``local_rows``: ``(B_local, L)`` symbols, exactly the rows
    :func:`local_block_range` assigns this rank.  ``c`` / ``cum``: the
    shared pow2 table (every rank passes the same one).  ``n_blocks``: the
    global block count.  A block that overflows ``capacity`` is encoded
    again with twice the room, as ``api.encode`` does.

    Returns ``(payloads, lengths)`` on every rank: the global list of
    trimmed block payloads in block order and their ``(B,)`` lengths."""
    lo, hi = local_block_range(n_blocks)
    if local_rows.shape[0] != hi - lo:
        raise ValueError(f"{local_rows.shape[0]} rows for blocks "
                         f"[{lo}, {hi})")
    L = int(local_rows.shape[1])
    cap = capacity if capacity is not None else default_capacity(L, k)
    dev = global_mesh(device)
    rows = upload_rows(local_rows, dev[0])
    c_t = torch.from_numpy(np.asarray(c, np.int64))
    cum_t = torch.from_numpy(np.asarray(cum, np.int64))
    while True:
        enc, _ = make_sharded_codec(dev, k=k, block_len=L, capacity=cap)
        code, lengths = enc(rows, c_t, cum_t)
        lens = lengths.cpu().numpy()
        if int(lens.max()) <= cap:
            break
        cap *= 2  # rare adversarial blocks
    code = code.cpu().numpy()
    return _gather([code[i, : lens[i]].tobytes() for i in range(len(lens))])


def encode_multihost_rans16(
    local_rows: np.ndarray,
    table,
    *,
    block_len: int,
    n_groups: int,
    group_lanes: int = None,
    sync_tiles: int = 0,
    device="cuda",
) -> list:
    """Encode this rank's rans16 groups; gather every payload, in order.

    ``local_rows``: ``(groups * group_lanes, block_len)``, exactly the rows
    of :func:`local_group_range`'s range.  Each rank runs the local
    pipeline (``rans_codec.encode_groups``, the encode kernel on a card)
    on its own device; the only collectives are the per-group payload
    lengths and the trimmed payload bytes.  Returns the global payload
    list on every rank."""
    g = group_lanes if group_lanes else rans_codec.GROUP_LANES
    lo, hi = local_group_range(n_groups)
    if local_rows.shape[0] != (hi - lo) * g:
        raise ValueError(f"{local_rows.shape[0]} rows for groups "
                         f"[{lo}, {hi}) of {g} lanes")
    local_payloads = rans_codec.encode_groups(
        local_rows, table, block_len, g, sync_tiles=sync_tiles,
        device=global_mesh(device)[0])
    return _gather(local_payloads)[0]


def decode_multihost_rans16(
    payloads, table_c: np.ndarray, *, block_len: int,
    group_lanes: int = None, device="cuda",
) -> np.ndarray:
    """Decode this rank's group range of the global payload list (the
    mirror of :func:`encode_multihost_rans16`): its
    ``(groups * group_lanes, block_len)`` rows.

    ``table_c``: ``(A,)`` shared counts, or ``(NG, A)`` per-group counts
    (an adaptive container), sliced to this rank's group range with the
    payloads."""
    lo, hi = local_group_range(len(payloads))
    tc = np.asarray(table_c)
    if tc.ndim == 2:
        tc = tc[lo:hi]
    return rans_codec.decode_groups(payloads[lo:hi], tc, block_len,
                                    group_lanes,
                                    device=global_mesh(device)[0])


def assemble_container(
    payloads,
    lengths: np.ndarray = None,
    *,
    k: int,
    alphabet: int,
    block_len: int,
    n_symbols: int,
    tables_c: np.ndarray,
    with_checksums: bool = True,
    profile: str = "planar",
    group_lanes: int = 0,
) -> bytes:
    """Pack the gathered payloads into the standard container, byte for
    byte the single-process ``api.encode`` output for the same corpus.

    ``payloads``: the list of per-unit payload bytes (the gather's
    output), or a padded ``(B, C)`` code matrix with ``lengths`` to trim
    it by."""
    if not isinstance(payloads, list):
        code = np.asarray(payloads)
        payloads = [code[i, : int(lengths[i])].tobytes()
                    for i in range(code.shape[0])]
    return fmt.pack(
        k=k,
        alphabet=alphabet,
        block_len=block_len,
        n_symbols=n_symbols,
        payloads=payloads,
        tables_c=np.asarray(tables_c, np.uint32),
        per_block_tables=False,
        with_checksums=with_checksums,
        profile=profile,
        group_lanes=group_lanes,
    )
