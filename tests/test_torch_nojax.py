"""trico_tpu_torch stays free of JAX: it imports and round-trips with JAX
blocked, with and without the C++ host library, and no source of the port
names JAX or the JAX-only modules of trico_tpu."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
sys.path.insert(0, {repo!r})
import numpy as np
import trico_tpu.native
if not {native}:  # as if the C++ toolchain were missing
    trico_tpu.native._LOAD_ERROR = "disabled for this test"
    assert not trico_tpu.native.available()
import trico_tpu_torch as tt
from trico_tpu import chunked
from trico_tpu.codec import fp_ref

r = np.random.default_rng(0)
t = np.linspace(0, 40 * np.pi, 3 * 1024 + 21)
vals = (np.sin(t) + np.cumsum(r.normal(0, 1e-3, len(t)))).astype(np.float32)
vals = vals.view(np.uint32)
vals64 = (np.cumsum(r.normal(0, 1e-3, 2 * 1024 + 9)) - 3.5).view(np.uint64)
for opt in (False, "fast", True):
    blob = tt.encode_chunked(vals, 1024, optimize=opt, device="cpu")
    back, bits = tt.decode_chunked(blob, device="cpu")
    assert bits == 32 and np.array_equal(back, vals), opt
    # f64 at its (20,20) default and adaptively: big tables decode on host
    blob = tt.encode_chunked(vals64, 1024, optimize=opt, device="cpu")
    back, bits = tt.decode_chunked(blob, device="cpu")
    assert bits == 64 and np.array_equal(back, vals64), opt
blob = tt.encode_chunked(vals, 1024, 16, 16, device="cpu")  # sort predictor
assert np.array_equal(tt.decode_chunked(blob, device="cpu")[0], vals)
assert tt.chunked.F32_TPU_EXP == chunked.F32_TPU_EXP
assert tt.chunked.DEFAULT_CHUNK_LEN == chunked.DEFAULT_CHUNK_LEN
e1, e2 = tt.chunked.F32_TPU_EXP
assert tt.fp_torch.hash_info(e1, e2) == fp_ref.compress(vals[:8], e1, e2)[0]
assert sys.modules["jax"] is None
print("ok")
"""


@pytest.mark.parametrize("native", [True, False])
def test_round_trip_with_jax_blocked(native):
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(repo=str(REPO), native=native)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_sources_name_no_jax():
    jax_only = r"\b(jax|fp_jax|fp64_jax|fp_pallas|bp_jax|lz4_jax)\b"
    patterns = [
        re.compile(rf"^\s*(import|from)\s[^\n]*{jax_only}", re.M),
        # trico_tpu's pack_funnel is JAX code; the port has its own
        re.compile(r"^\s*from\s+trico_tpu\.codec(\.pack_funnel|\s+import"
                   r"[^\n]*\bpack_funnel\b)", re.M),
    ]
    files = sorted((REPO / "trico_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 5
    for f in files:
        text = f.read_text()
        assert not any(p.search(text) for p in patterns), f
    assert patterns[0].search("from trico_tpu.codec import fp_ref, fp_jax")
    assert patterns[1].search("from trico_tpu.codec import pack_funnel")
