"""Scale-out: sharded coding over several devices, and several processes
that gather their payloads into one container.

The port's counterpart of ``range_coder_rust_tpu/parallel``: where the
reference shards over a ``jax.sharding.Mesh`` and joins processes with
``jax.distributed``, the port shards over a list of ``torch.device``s
(:mod:`.dist`) and joins processes with ``torch.distributed``
(:mod:`.multihost`).  Blocks and groups are independent coder units, so
coding needs no communication; only the payload lengths and bytes are
gathered, and the container is byte-identical at any shard or process
count.
"""

from .dist import default_mesh, make_sharded_codec, make_sharded_rans16
from . import multihost

__all__ = [
    "default_mesh",
    "make_sharded_codec",
    "make_sharded_rans16",
    "multihost",
]
