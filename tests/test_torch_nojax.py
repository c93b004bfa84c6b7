"""trico_tpu_torch stands alone: it imports, round-trips FP, BP and LZ4
containers, writes and reads v0 and v1 archives of every stream kind, runs
``compress_mesh`` / ``decompress_mesh`` on a mesh of two CPU shards, runs
its CLI and its bench (``trico_tpu_torch.bench.run``, smallest sizes) with
both JAX and trico_tpu blocked, with and without the C++ host library, and
no source of the port (``parallel/`` and ``bench.py`` included) imports JAX
or anything of trico_tpu."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
sys.modules["trico_tpu"] = None  # and so does any import of trico_tpu
sys.path.insert(0, {repo!r})
import numpy as np
import trico_tpu_torch.native
if not {native}:  # as if the C++ toolchain were missing
    trico_tpu_torch.native._LOAD_ERROR = "disabled for this test"
    assert not trico_tpu_torch.native.available()
import trico_tpu_torch as tt
from trico_tpu_torch.codec import fp_ref

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
assert tt.chunked.F32_TPU_EXP == (4, 6)
assert tt.chunked.DEFAULT_CHUNK_LEN == 4096
e1, e2 = tt.chunked.F32_TPU_EXP
assert tt.fp_torch.hash_info(e1, e2) == fp_ref.compress(vals[:8], e1, e2)[0]

idx = (np.arange(3 * 1024 + 40) // 2).astype(np.uint32)
for words in (idx, idx.astype(np.uint64) << np.uint64(20)):
    blob = tt.encode_bp_chunked(words, 1024, device="cpu")
    assert np.array_equal(tt.decode_bp_chunked(blob, device="cpu"), words)
plane = (np.arange(3 * 4096 + 5) // 9 % 7).astype(np.uint8)
blob = tt.encode_lz4_chunked(plane, 4096, device="cpu")
assert np.array_equal(tt.decode_lz4_chunked(blob), plane)

n = 1500
def f(width, dt, s):
    t = [np.sin(np.linspace(0, 9 + k + s, n)) for k in range(width)]
    return np.stack(t, axis=1).astype(dt)
kinds = []
for sfx, dt in (("", np.float32), ("_double", np.float64)):
    kinds += [("write_vertices" + sfx, f(3, dt, 0)),
              ("write_vertex_normals" + sfx, f(3, dt, 1)),
              ("write_triangle_normals" + sfx, f(3, dt, 2)),
              ("write_uv_per_vertex" + sfx, f(2, dt, 3)),
              ("write_uv_per_triangle" + sfx, f(2, dt, 4))]
tri = (np.arange(3 * n) // 2).astype(np.uint32).reshape(-1, 3)
kinds += [("write_attributes_float", f(1, np.float32, 5)[:, 0]),
          ("write_attributes_double", f(1, np.float64, 6)[:, 0]),
          ("write_triangles", tri),
          ("write_triangles_long", tri.astype(np.uint64)),
          ("write_vertex_colors", (np.arange(n) // 7).astype(np.uint32) | np.uint32(0xFF000000)),
          ("write_triangle_colors", (np.arange(n) % 5).astype(np.uint32)),
          ("write_attributes_uint8", (np.arange(n) % 3).astype(np.uint8)),
          ("write_attributes_uint16", np.arange(n, dtype=np.uint16)),
          ("write_attributes_uint32", np.arange(n, dtype=np.uint32) * 977),
          ("write_attributes_uint64", np.arange(n, dtype=np.uint64) << np.uint64(40))]
# without the host library the reference layout of f32 chunks is packed and
# parsed on the device
for layout in ("tpu", "ref"):
    w = tt.ArchiveWriter(chunk_len=1024, layout=layout, device="cpu")
    for method, arr in kinds:
        getattr(w, method)(arr)
    r = tt.ArchiveReader(w.tobytes(), device="cpu")
    got = list(r.streams())
    assert len(got) == len(kinds)
    for (method, arr), (st, back) in zip(kinds, got):
        assert np.array_equal(back.reshape(arr.shape), arr), (layout, method)
w = tt.ArchiveWriter(device="cpu")  # a v0 archive, on the host
for method, arr in kinds:
    getattr(w, method)(arr)
r = tt.ArchiveReader(w.tobytes(), device="cpu")
assert r.version == 0
for (method, arr), (st, back) in zip(kinds, list(r.streams())):
    assert np.array_equal(back.reshape(arr.shape), arr), ("v0", method)

from trico_tpu_torch.parallel import make_mesh, compress_mesh, decompress_mesh
mesh = make_mesh(2, device="cpu")
mesh_streams = dict(vertices=f(3, np.float32, 7), triangles=tri,
                    vertex_normals=f(3, np.float32, 8),
                    vertex_colors=(np.arange(n) // 7).astype(np.uint32))
for opt in (True, "fast", False):
    for dt in (np.float32, np.float64):
        verts = mesh_streams["vertices"].astype(dt)
        blob = compress_mesh(verts, tri, vertex_normals=mesh_streams["vertex_normals"],
                             vertex_colors=mesh_streams["vertex_colors"],
                             chunk_len=256, mesh=mesh, optimize=opt)
        stats = {{}}
        out = decompress_mesh(blob, mesh, route_stats=stats)
        assert stats["sharded_fp"] == 6 and stats["sharded_bp"] >= 1, stats
        for name, want in dict(mesh_streams, vertices=verts).items():
            assert out[name].dtype == want.dtype, name
            assert np.array_equal(out[name], want), (name, opt, dt)

import tempfile
from trico_tpu_torch import cli
from trico_tpu_torch.io import stl
bunny = {repo!r} + "/tests/data/StanfordBunny.stl"
with tempfile.TemporaryDirectory() as d:
    for flags in (["--chunked", "--device", "cpu"], ["--device", "cpu"], ["--backend", "auto"], ["--backend", "numpy"]):
        assert cli.main(["encode", "-i", bunny, "-o", d + "/b.trc", "--profile", *flags]) == 0
        assert tt.ArchiveReader(open(d + "/b.trc", "rb").read(), device="cpu").version == (0 if flags[:1] == ["--backend"] else 1)
        assert cli.main(["decode", "-i", d + "/b.trc", "-o", d + "/b.stl", "--device", "cpu", "--profile"]) == 0
        for a, b in zip(stl.read_stl(bunny), stl.read_stl(d + "/b.stl")):
            assert np.array_equal(a, b)
    for a, b in zip(tt.read_stl(bunny), stl.read_stl(bunny)):
        assert np.array_equal(a, b)
    from trico_tpu_torch import profiling
    with profiling.trace(d + "/trace"), profiling.annotate("encode"):
        tt.encode_chunked(vals, 1024, layout="ref", device="cpu")
from trico_tpu_torch import bench
line = bench.run(device="cpu", n_values=64 * 16, chunk_len=64, canary_len=64,
                 bp_chunk=1024, archive_verts=400, reps=1)
assert line["extra"]["exact"] and line["extra"]["fullmesh_archive"]["exact"]
assert "inexact_roundtrip" not in line["extra"], line
assert sys.modules["jax"] is None and sys.modules["trico_tpu"] is None
print("ok")
"""


@pytest.mark.parametrize("native", [True, False])
def test_round_trip_with_jax_blocked(native):
    if native:
        import trico_tpu_torch.native

        if not trico_tpu_torch.native.available():
            pytest.skip("needs the C++ host library (g++)")
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(repo=str(REPO), native=native)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_sources_name_no_jax():
    """No source of the port imports JAX or anything of trico_tpu."""
    patterns = [
        re.compile(r"^\s*(import|from)\s+jax(\.|\s|$)", re.M),
        re.compile(r"^\s*(from|import)\s+trico_tpu(\.|\s|$)", re.M),
    ]
    files = sorted((REPO / "trico_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    parallel = {f.name for f in files if f.parent.name == "parallel"}
    assert {"__init__.py", "mesh_codec.py", "mp_worker.py"} <= parallel
    assert REPO / "trico_tpu_torch" / "bench.py" in files
    for f in files:
        text = f.read_text()
        assert not any(p.search(text) for p in patterns), f
    assert patterns[0].search("    import jax.numpy as jnp")
    for line in ("from trico_tpu import native", "import trico_tpu.chunked as jc",
                 "from trico_tpu.io import ply, stl", "    import trico_tpu",
                 "from trico_tpu.codec import fp_ref"):
        assert patterns[1].search(line), line
    for line in ("from trico_tpu_torch import cli", "import trico_tpu_torch as tt",
                 "from trico_tpu_torch.codec import fp_ref"):
        assert not patterns[1].search(line), line
