"""The reference writes the port's containers, byte for byte, and
depends on nothing of either package.

The port runs on the CPU here (its plain versions); the reference is
``rc_bench/reference``.  Sizes are small, but cover a partial last block,
sync states and several rans16 groups.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rc_bench import reference
from rc_bench.reference import container

REF_DIR = Path(reference.__file__).parent
ROOT = REF_DIR.parent.parent

CASES = {
    "planar_whole_blocks": (1 << 17, {"profile": "planar", "k": 16,
                                      "block_len": 512}),
    "planar_partial_block": (100_003, {"profile": "planar", "k": 16,
                                       "block_len": 512}),
    "planar_k12_no_crc": (40_000, {"profile": "planar", "k": 12,
                                   "block_len": 96,
                                   "with_checksums": False}),
    "rans16_sync": (1 << 21, {"profile": "rans16", "k": 16,
                              "block_len": 65536, "group_lanes": 2048,
                              "sync_tiles": 16}),
    "rans16_three_groups": (3 * 128 * 1024 - 77, {
        "profile": "rans16", "k": 16, "block_len": 1024,
        "group_lanes": 128, "sync_tiles": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_container_equals_the_port(case):
    import range_coder_rust_tpu_torch as rt

    n, codec = CASES[case]
    rng = np.random.default_rng(len(case))
    p = 1.0 / np.arange(1, 257) ** 1.2
    data = rng.choice(256, size=n, p=p / p.sum()).astype(np.uint8)
    port = rt.encode(data, alphabet=256, config=rt.CodecConfig(**codec),
                     device="cpu")
    ref = reference.encode(data, codec, 256, "cpu")
    assert ref == port
    lay = container.layout(ref)
    assert lay["n_symbols"] == n and lay["profile"] == codec["profile"]
    if codec["profile"] == "rans16":
        assert lay["halfwords"] > 0
    # the control's table, one bit coarser, is another container
    assert reference.encode(data, codec, 256, "cpu", drop_bits=1) != port


def test_reference_imports_nothing_of_either_package():
    for path in sorted(REF_DIR.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] in ("numpy", "torch", "struct",
                                              "zlib", "math", "__future__"), (
                    f"{path.name} imports {name}")
    code = ("import sys, numpy as np; from rc_bench import reference; "
            "d = np.arange(5000, dtype=np.uint8) % 7; "
            "reference.encode(d, {'profile': 'planar'}, 256, 'cpu'); "
            "reference.encode(d, {'profile': 'rans16', 'sync_tiles': 1}, "
            "256, 'cpu'); "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'range_coder_rust_tpu', "
            "'range_coder_rust_tpu_torch'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
