"""Several processes, one container (``parallel.multihost``), on the CPU.

Two processes join a ``gloo`` process group over ``torch.distributed``;
each codes its share of a planar and of a rans16 corpus and takes part in
the ordered gather, and rank 0 packs both containers.  They must be byte
for byte the port's single-process ``api.encode`` and the JAX package's
containers, as they are with no process group (a world of one).  The
geometry is the JAX package's own two-process test's
(``tests/multihost_worker.py``), with 128-lane rans16 groups.

This file is also the worker: ``python test_torch_multihost.py PORT NPROC
RANK OUTDIR``.
"""

import os
import socket
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, L, K, A = 16, 128, 12, 32  # planar
G, L16, NG, A16 = 128, 8, 2, 64  # rans16


def _corpora():
    planar = np.random.default_rng(42).integers(0, A, (B, L)).astype(np.int32)
    rans16 = np.random.default_rng(43).integers(
        0, A16, (NG * G, L16)).astype(np.int32)
    return planar, rans16


def _containers(outdir=None):
    """Code this rank's share of both corpora and gather; returns (planar
    container, rans16 container), packed on every rank.  Rank 0 writes
    them into ``outdir``; every rank checks its decoded share."""
    from range_coder_rust_tpu_torch.models.table import table_from_data_pow2
    from range_coder_rust_tpu_torch.parallel import multihost as mh

    planar, rans16 = _corpora()
    t = table_from_data_pow2(planar, A, K)
    lo, hi = mh.local_block_range(B)
    payloads, lengths = mh.encode_multihost(
        planar[lo:hi], t.c, t.cum, k=K, n_blocks=B, device="cpu")
    if list(lengths) != [len(p) for p in payloads]:
        raise AssertionError("gathered lengths != payload lengths")
    blob = mh.assemble_container(payloads, k=K, alphabet=A, block_len=L,
                                 n_symbols=B * L, tables_c=t.c)

    t16 = table_from_data_pow2(rans16, A16, 16)
    glo, ghi = mh.local_group_range(NG)
    payloads16 = mh.encode_multihost_rans16(
        rans16[glo * G : ghi * G], t16, block_len=L16, n_groups=NG,
        group_lanes=G, device="cpu")
    local = mh.decode_multihost_rans16(payloads16, t16.c, block_len=L16,
                                       group_lanes=G, device="cpu")
    if not np.array_equal(local, rans16[glo * G : ghi * G]):
        raise AssertionError("rans16 multihost decode")
    blob16 = mh.assemble_container(
        payloads16, k=16, alphabet=A16, block_len=L16,
        n_symbols=NG * G * L16, tables_c=t16.c, profile="rans16",
        group_lanes=G)
    if outdir is not None and mh._world()[1] == 0:
        with open(os.path.join(outdir, "planar.bin"), "wb") as f:
            f.write(blob)
        with open(os.path.join(outdir, "rans16.bin"), "wb") as f:
            f.write(blob16)
    return blob, blob16


if __name__ == "__main__":
    import torch

    torch.set_num_threads(1)
    from range_coder_rust_tpu_torch.parallel import multihost as mh

    port, nproc, rank, outdir = sys.argv[1:5]
    mh.initialize(f"localhost:{port}", int(nproc), int(rank))
    if mh._world() != (int(nproc), int(rank)):
        raise AssertionError(mh._world())
    _containers(outdir)
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK {rank}", flush=True)
    sys.exit(0)


import pytest  # noqa: E402
import torch  # noqa: E402

from range_coder_rust_tpu import api as japi  # noqa: E402
import range_coder_rust_tpu_torch as rt  # noqa: E402

torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(planar, rans16) containers of rank 0 of two gloo processes."""
    outdir = tmp_path_factory.mktemp("mh")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), "2", str(r),
         str(outdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"WORKER_OK {r}" in out
    return ((outdir / "planar.bin").read_bytes(),
            (outdir / "rans16.bin").read_bytes())


@pytest.fixture(scope="module")
def references():
    """(planar, rans16): the JAX package's containers, which the port's
    single-process api must give too."""
    planar, rans16 = _corpora()
    pcfg = dict(k=K, block_len=L)
    rcfg = dict(profile="rans16", block_len=L16, group_lanes=G)
    out = []
    for data, a, cfg in ((planar, A, pcfg), (rans16, A16, rcfg)):
        jblob = japi.encode(data.reshape(-1), alphabet=a,
                            config=japi.CodecConfig(**cfg))
        assert jblob == rt.encode(data.reshape(-1), alphabet=a,
                                  config=rt.CodecConfig(**cfg), device="cpu")
        out.append(jblob)
    return tuple(out)


def test_two_ranks_planar_container(two_ranks, references):
    assert two_ranks[0] == references[0]


def test_two_ranks_rans16_container(two_ranks, references):
    assert two_ranks[1] == references[1]


def test_two_ranks_containers_decode(two_ranks):
    planar, rans16 = _corpora()
    np.testing.assert_array_equal(
        rt.decode(two_ranks[0], device="cpu").reshape(B, L), planar)
    np.testing.assert_array_equal(
        rt.decode(two_ranks[1], device="cpu").reshape(-1, L16), rans16)


def test_world_of_one_containers(references):
    """Without a process group every function is a world of one: the
    same containers."""
    assert not torch.distributed.is_initialized()
    assert _containers() == references
