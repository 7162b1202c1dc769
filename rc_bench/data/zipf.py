"""Zipf-distributed symbols, made on the device from the seed.

Symbol ``r`` (0-based) has probability proportional to ``(r + 1) **
-alpha`` over ``[0, alphabet)``: the distribution of the JAX package's
``bench.py`` corpus (``make_corpus``: Zipf(1.2) bytes), drawn here by the
inverse CDF of seeded float64 uniforms from a ``torch.Generator`` on the
device, in a few large calls, then copied to the host once.  The same
seed, size and device give the same symbols.
"""

from __future__ import annotations

import numpy as np
import torch

_CHUNK = 1 << 26


def make(spec: dict, seed: int, device) -> np.ndarray:
    """``spec``: ``n_symbols``, ``alphabet``, ``alpha``, ``dtype`` (the
    host dtype users hand to the api)."""
    n, a = int(spec["n_symbols"]), int(spec["alphabet"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    ranks = torch.arange(1, a + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -float(spec["alpha"]), 0)
    cdf /= cdf[-1].clone()
    narrow = torch.uint8 if a <= 256 else torch.int32
    out = torch.empty(n, dtype=narrow, device=device)
    for i in range(0, n, _CHUNK):
        u = torch.rand(min(_CHUNK, n - i), dtype=torch.float64,
                       generator=gen, device=device)
        out[i : i + u.numel()] = torch.searchsorted(
            cdf, u, right=True).clamp_(max=a - 1).to(narrow)
    return out.cpu().numpy().astype(np.dtype(spec["dtype"]), copy=False)
