"""``correct`` comes out false for the control and for every fault that a
cell can have, the rest of the run driven as the command drives it (the
look for a card skipped, the CPU at a small size).

* The control: the reference at a table one bit coarser in the
  program's place (``rc_bench/control.py``).
* A call's answer altered where it is produced: one byte of a container,
  one decoded symbol, one symbol of a read.
* Half of the batch left out: half a container, half the decoded array,
  half a read.

A run of this codec has no training state to leave unchanged and no
exchange between chips, so those faults do not apply.
"""

import numpy as np
import pytest

from rc_bench import control, harness

SEED = (1 << 31) + 4099
SMALL = {"planar_default": 1 << 17, "rans16_sync": 2 << 20}
CELLS = {"planar_default.bulk": ("encode", "decode"),
         "rans16_sync.reads": ("encode", "decode_range")}


def altered(out):
    if isinstance(out, bytes):
        return out[:-1] + bytes([out[-1] ^ 0x10])
    out = out.copy()
    out[out.size // 2] = (int(out[out.size // 2]) + 1) % 256
    return out


def halved(out):
    return out[: len(out) // 2]


class FaultyApi:
    """The program's api with one op's answers changed by ``fault``."""

    def __init__(self, op, fault):
        from range_coder_rust_tpu_torch import api

        self.CodecConfig = api.CodecConfig
        for name in ("encode", "decode", "decode_range"):
            fn = getattr(api, name)
            if name == op:
                fn = (lambda f: lambda *a, **k: fault(f(*a, **k)))(fn)
            setattr(self, name, fn)


def run(cell, api=None, control_run=False):
    bench = harness.load_bench()
    n = SMALL[harness.cell_of(bench, cell)["config"]]
    quiet = lambda *a, **k: None  # noqa: E731
    if control_run:
        return control.run(bench, cell, SEED, 0.2, device="cpu",
                           n_symbols=n, log=quiet)
    return harness.run(bench, cell, SEED, 0.2, False, device="cpu",
                       api=api, n_symbols=n, log=quiet)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(cell):
    r = run(cell, control_run=True)
    assert not r["correct"]
    assert r["checks"]["container_wrong_bytes"]["value"] > 0


@pytest.mark.parametrize("fault", [altered, halved],
                         ids=["altered", "half_left_out"])
@pytest.mark.parametrize("cell,op", [(c, op) for c, ops in
                                     sorted(CELLS.items()) for op in ops])
def test_a_fault_is_not_correct(cell, op, fault):
    r = run(cell, FaultyApi(op, fault))
    assert not r["correct"]
    wrong = {n: c["value"] for n, c in r["checks"].items() if c["value"]}
    assert wrong, r["checks"]
    assert np.all([c["limit"] == 0 for c in r["checks"].values()])
