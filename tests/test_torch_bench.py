"""trico_tpu_torch.bench (``python -m trico_tpu_torch.bench``) at a small
size on the CPU: the result line's keys, every leg exact, and each leg's
bytes held against trico_tpu on JAX's CPU backend on the same arrays (legs
1-6 through fp_jax / fp64_jax / bp_jax, leg 7 through trico_tpu's
ArchiveWriter, leg 8 through trico_tpu.parallel.mesh_codec on JAX's 8 CPU
devices). Tolerance: every payload byte, size and archive byte equal. The
exactness gate and the entry point are run too."""

import json
import os
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trico_tpu.archive as ja
import trico_tpu.chunked as jc
import trico_tpu_torch as tt
from torch_cases import no_native, require_native, tpu_native_available
from trico_tpu.codec import bp_jax, fp64_jax, fp_jax
from trico_tpu.io.stl import read_stl
from trico_tpu.parallel import mesh_codec as jmc
from trico_tpu_torch import _u32, _u64, bench
from trico_tpu_torch.codec import bp_torch, fp64_torch, fp_cuda, fp_torch
from trico_tpu_torch.parallel import mesh_codec

REPO = Path(__file__).resolve().parents[1]
L = 64
# leg 8's mesh is large enough that each byte plane of its triangles fills a
# 1 MiB LZ4 block, so the match search of a device host runs
SMALL = dict(n_values=L * 300, chunk_len=L, canary_len=128, bp_chunk=1024,
             archive_verts=200_000, reps=1)
# the codec calls whose inputs and outputs the fixture records
RECORDED = ((fp_torch, "encode_f32_chunks_v2"),
            (fp_torch, "encode_f32_chunks_v2_adaptive"),
            (fp64_torch, "encode_f64_chunks_v2"),
            (bp_torch, "encode_bp32_chunks"),
            (mesh_codec, "compress_mesh"),
            (tt.ArchiveWriter, "tobytes"))


@pytest.fixture(scope="module")
def aligned():
    """The host codecs' bytes depend on whether a package's C++ library is
    built; where only one of the two built, both run on their NumPy
    fallbacks for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        if tpu_native_available() != tt.native.available():
            no_native(mp)
        yield


@pytest.fixture(scope="module")
def ran(aligned):
    """One small run of the bench: (its line, the recorded calls by name as
    (args, result) pairs)."""
    calls = defaultdict(list)
    with pytest.MonkeyPatch.context() as mp:
        for module, name in RECORDED:
            def record(*args, _real=getattr(module, name), _name=name, **kw):
                out = _real(*args, **kw)
                calls[_name].append((args, out))
                return out
            mp.setattr(module, name, record)
        line = bench.run(device="cpu", **SMALL)
    return line, calls


@pytest.fixture(scope="module")
def extra(ran):
    return ran[0]["extra"]


def recorded(ran, name, x):
    """The result of the recorded call of ``name`` whose first argument
    equals ``x`` (a tensor or an array)."""
    for args, out in ran[1][name]:
        a = args[0]
        if type(a) is type(x) and a.shape == x.shape and (
                torch.equal(a, x) if torch.is_tensor(x) else np.array_equal(a, x)):
            return out
    raise AssertionError(f"no call of {name} on a {tuple(x.shape)} input")


def archives(ran) -> list[bytes]:
    """Every archive the run's ArchiveWriters wrote."""
    return [out for _, out in ran[1]["tobytes"]]


def rows(a: np.ndarray, length: int) -> np.ndarray:
    return a[: len(a) // length * length].reshape(-1, length)


def hl(x: np.ndarray):
    """uint64 (C, L) → JAX's (hi, lo) u32 words."""
    return (jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def assert_payloads(got, want):
    """The port's (payloads, sizes) tensors equal JAX's arrays."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------


def _gbps(v):
    return isinstance(v, float) and np.isfinite(v) and v > 0


def _ms(v):
    return set(v) == {"mean", "min", "max", "reps"} and 0 < v["min"] <= v["mean"] <= v["max"]


def _count(v):
    return isinstance(v, int) and not isinstance(v, bool) and v > 0


def _flag(v):
    return v is True


def _ratio(v):
    return isinstance(v, float) and 1.0 < v < 100.0


# every key of ``extra`` and what it must hold at this size
EXTRA_KEYS = {
    "decode_gbps": _gbps, "adaptive_encode_gbps": _gbps, "ratio": _ratio,
    "adaptive_ratio": _ratio, "compressed_bytes": _count,
    "adaptive_compressed_bytes": _count, "chunk_len": lambda v: v == L,
    "n_values": lambda v: v == SMALL["n_values"], "miscompile_canary": _flag,
    "ms": lambda v: set(v) == {"encode", "decode", "adaptive_encode"}
    and all(_ms(s) for s in v.values()),
    "scale": lambda v: set(v) == {"lucy42M"},
    "fullmesh": lambda v: v["verts"] == SMALL["n_values"] * 7 // 4 // L * L,
    "f64": lambda v: v["n_values"] == 2 * SMALL["n_values"] and v["exponents"] == [4, 6],
    "exact": _flag, "backend": lambda v: v == "cpu",
    "device": lambda v: v == {"name": "cpu", "power_limit": None},
    "bunny_trc_bytes": _count, "bunny_ref_trc_bytes": lambda v: v == 584613,
    "bunny_exact": _flag, "bunny_trc_v1_bytes": _count, "bunny_v1_exact": _flag,
    "bunny_encode_vertices_fp_gbps": _gbps, "bunny_encode_triangles_lz4_gbps": _gbps,
    "bunny_decode_vertices_fp_gbps": _gbps, "bunny_decode_triangles_lz4_gbps": _gbps,
    "fullmesh_archive": lambda v: v["backend"] == "cpu-mesh-1dev",
    "kernel_launches": lambda v: v == dict.fromkeys(fp_cuda.KERNELS, 0),
    "legs": lambda v: list(v) == ["headline", "canary", "scale", "fullmesh",
                                  "f64", "bunny", "fullmesh_archive"]
    and all(s["seconds"] > 0 and s["peak_mib"] is None
            and s["kernel_launches"] == dict.fromkeys(fp_cuda.KERNELS, 0)
            for s in v.values()),
}


def test_line_is_the_headline(ran):
    line = ran[0]
    assert set(line) == {"metric", "value", "unit", "extra"}
    assert line["metric"] == "fp32_encode_GBps_per_chip" and line["unit"] == "GB/s"
    assert isinstance(line["value"], float) and line["value"] >= 0
    assert json.loads(json.dumps(line)) == line
    assert "inexact_roundtrip" not in line["extra"]


def test_extra_has_no_other_key(extra):
    assert set(extra) == set(EXTRA_KEYS)


@pytest.mark.parametrize("key", sorted(EXTRA_KEYS))
def test_extra_key(extra, key):
    assert EXTRA_KEYS[key](extra[key]), (key, extra[key])


# every leg's sub-dictionary: its keys, and the timed legs' rates and ms
LEG_KEYS = {
    "scale": {"n_values", "encode_gbps", "decode_gbps", "ratio",
              "compressed_bytes", "exact", "reps", "ms"},
    "fullmesh": {"verts", "tris", "raw_GB", "encode_gbps", "decode_gbps",
                 "ratio", "fp_bytes", "bp32_bytes", "exact", "reps", "ms"},
    "f64": {"n_values", "exponents", "encode_gbps", "decode_gbps", "ratio",
            "compressed_bytes", "exact", "reps", "ms"},
    "fullmesh_archive": {"n_vertices", "n_triangles", "raw_bytes",
                         "archive_bytes", "ratio", "encode_wall_s",
                         "decode_wall_s", "encode_gbps", "decode_gbps",
                         "stage_seconds", "assembly_frac", "other_frac",
                         "exact", "backend"},
}


def _leg(extra, name):
    return extra["scale"]["lucy42M"] if name == "scale" else extra[name]


@pytest.mark.parametrize("name", sorted(LEG_KEYS))
def test_leg_keys(extra, name):
    assert set(_leg(extra, name)) == LEG_KEYS[name]


@pytest.mark.parametrize("name,way", [(n, w) for n in ("scale", "fullmesh", "f64")
                                      for w in ("encode", "decode")])
def test_timed_leg_rate(extra, name, way):
    leg = _leg(extra, name)
    assert leg["reps"] == 1 and _ms(leg["ms"][way])
    assert leg[f"{way}_gbps"] >= 0 and 1.0 < leg["ratio"] < 100.0


def test_archive_leg_stages(extra):
    leg = extra["fullmesh_archive"]
    assert set(bench.WRITE_STEPS) <= set(leg["stage_seconds"]) <= set(bench.WRITE_STEPS) | {
        "fp_h2d", "fp_d2h", "int_planes", "lz4_search", "lz4_d2h", "lz4_emit",
        "bp_encode", "bp_d2h", "bp_assembly", "write.vertices", "write.triangles"}
    assert 0 <= leg["assembly_frac"] <= 1 and 0 <= leg["other_frac"] <= 1
    side = int(np.sqrt(SMALL["archive_verts"]))
    assert leg["n_vertices"] == side * side
    assert leg["n_triangles"] == 2 * (side - 1) ** 2


EXACT = {"exact": lambda e: e["exact"],
         "miscompile_canary": lambda e: e["miscompile_canary"],
         "scale": lambda e: e["scale"]["lucy42M"]["exact"],
         "fullmesh": lambda e: e["fullmesh"]["exact"],
         "f64": lambda e: e["f64"]["exact"],
         "bunny_exact": lambda e: e["bunny_exact"],
         "bunny_v1_exact": lambda e: e["bunny_v1_exact"],
         "fullmesh_archive": lambda e: e["fullmesh_archive"]["exact"]}


@pytest.mark.parametrize("flag", sorted(EXACT))
def test_every_leg_exact(extra, flag):
    assert EXACT[flag](extra) is True


# ---------------------------------------------------------------------------
# each leg's bytes against trico_tpu on the same arrays
# ---------------------------------------------------------------------------


def test_headline_matches_fp_jax(ran, extra):
    x = rows(bench.bench_stream(SMALL["n_values"]), L)
    got = recorded(ran, "encode_f32_chunks_v2", _u32.from_numpy(x))
    assert_payloads(got, fp_jax.encode_f32_chunks_v2(jnp.asarray(x), 4, 6))
    assert extra["compressed_bytes"] == int(got[1].sum())
    assert extra["ratio"] == x.nbytes / extra["compressed_bytes"]


def test_adaptive_matches_fp_jax(ran, extra):
    x = rows(bench.bench_stream(SMALL["n_values"]), L)
    got = recorded(ran, "encode_f32_chunks_v2_adaptive", _u32.from_numpy(x))
    want = fp_jax.encode_f32_chunks_v2_adaptive(jnp.asarray(x),
                                                fp_jax.F32_TPU_CANDIDATES)
    assert_payloads(got, want)
    assert extra["adaptive_compressed_bytes"] == int(np.asarray(want[1]).sum())


def test_canary_matches_fp_jax(ran):
    xc = rows(bench.canary_stream(SMALL["n_values"]), SMALL["canary_len"])
    got = recorded(ran, "encode_f32_chunks_v2", _u32.from_numpy(xc))
    assert_payloads(got, fp_jax.encode_f32_chunks_v2(jnp.asarray(xc), 4, 6))


def device_made(ran, leg: int):
    """(input, result) of leg 4 (``leg`` 0) or leg 5's vertex planes (1):
    the encodes of 3 * 7/4 * n_values values, in the order the legs ran."""
    C = SMALL["n_values"] * 21 // 4 // L  # both legs' chunk count
    inputs = []
    for (x, *_), out in ran[1]["encode_f32_chunks_v2"]:
        if x.shape == (C, L) and not any(x is y for y, _ in inputs):
            inputs.append((x, out))
    assert len(inputs) == 2
    return inputs[leg]


@pytest.mark.parametrize("leg", ["scale", "fullmesh"])
def test_device_made_data(ran, leg):
    """Legs 4 and 5 make bench.py's formula with torch's generator: the
    scale leg's walk plus a sine of amplitude 10 (seed 0), the full mesh's
    three planes (seeds 10-12, amplitudes 3-5), as float32 bits."""
    x, _ = device_made(ran, ["scale", "fullmesh"].index(leg))
    n = x.numel() // (1 if leg == "scale" else 3)
    specs = [(0, 10.0)] if leg == "scale" else [(10 + ax, 3.0 + ax) for ax in range(3)]
    want = torch.cat([bench.device_stream(n, seed, amp, "cpu") for seed, amp in specs])
    # at most one float32 ulp apart: on the CPU the float64 sine of a few
    # values may round another way from run to run, as the threads' shares
    # of an elementwise op move; values of one sign, so the bits' distance
    # is the ulps'
    got = x.reshape(-1)
    assert torch.equal(got < 0, want < 0)
    assert int((got.long() - want.long()).abs().max()) <= 1


@pytest.mark.parametrize("leg", ["scale", "fullmesh"])
def test_device_made_legs_match_fp_jax(ran, extra, leg):
    x, got = device_made(ran, ["scale", "fullmesh"].index(leg))
    assert_payloads(got, fp_jax.encode_f32_chunks_v2(
        jnp.asarray(_u32.to_numpy(x)), 4, 6))
    total = (extra["scale"]["lucy42M"]["compressed_bytes"] if leg == "scale"
             else extra["fullmesh"]["fp_bytes"])
    assert total == int(got[1].sum())


def test_fullmesh_triangles_match_bp_jax(ran, extra):
    t = rows(bench.fullmesh_indices(SMALL["n_values"] * 7 // 2), SMALL["bp_chunk"])
    got = recorded(ran, "encode_bp32_chunks", _u32.from_numpy(t))
    want = bp_jax.encode_bp32_chunks(jnp.asarray(t))
    assert_payloads(got, want)
    assert extra["fullmesh"]["bp32_bytes"] == int(np.asarray(want[1]).sum())
    assert extra["fullmesh"]["tris"] == t.size // 3


def test_f64_matches_fp64_jax(ran, extra):
    x = rows(bench.bench_stream64(2 * SMALL["n_values"]), L)
    got = recorded(ran, "encode_f64_chunks_v2", _u64.from_numpy(x))
    assert_payloads(got, fp64_jax.encode_f64_chunks_v2(*hl(x), 4, 6))
    assert extra["f64"]["compressed_bytes"] == int(got[1].sum())


def _bunny_archive(path, **kw) -> bytes:
    verts, tris = read_stl(path)
    w = ja.ArchiveWriter(**kw)
    w.write_vertices(verts)
    w.write_triangles(tris)
    return w.tobytes()


def test_bunny_v0_matches_trico_tpu(ran, extra, bunny_path):
    want = _bunny_archive(bunny_path)
    assert extra["bunny_trc_bytes"] == len(want)
    assert want in archives(ran)


def test_bunny_v1_matches_trico_tpu(ran, extra, bunny_path, monkeypatch):
    monkeypatch.setattr(jc, "_tpu_available", lambda: True)  # a device host
    want = _bunny_archive(bunny_path, chunk_len=bench.ARCHIVE_CHUNK)
    assert extra["bunny_trc_v1_bytes"] == len(want)
    assert want in archives(ran)


def test_archive_matches_trico_tpu_mesh_codec(ran, extra, monkeypatch):
    if len(jax.devices()) < 8:
        pytest.skip("needs JAX's 8 CPU devices")
    monkeypatch.setattr(jc, "_tpu_available", lambda: True)  # a device host
    verts, tris = bench.lucy_mesh(SMALL["archive_verts"])
    blob = recorded(ran, "compress_mesh", verts)
    want = jmc.compress_mesh(verts, tris, chunk_len=bench.ARCHIVE_CHUNK,
                             mesh=jmc.make_mesh(8))
    assert blob == want
    assert extra["fullmesh_archive"]["archive_bytes"] == len(want)
    assert extra["fullmesh_archive"]["raw_bytes"] == verts.nbytes + tris.nbytes


def test_archive_leg_takes_the_device_search(ran, monkeypatch):
    """At this size the triangles' planes fill an LZ4 block, and trico_tpu's
    host search writes other bytes than its device search: the test above
    holds the port's search, not only the host codec both share."""
    require_native()
    if len(jax.devices()) < 8:
        pytest.skip("needs JAX's 8 CPU devices")
    verts, tris = bench.lucy_mesh(SMALL["archive_verts"])
    assert tris.size >= tt.chunked.DEFAULT_LZ4_BLOCK
    monkeypatch.setattr(jc, "_tpu_available", lambda: False)  # a CPU host
    host = jmc.compress_mesh(verts, tris, chunk_len=bench.ARCHIVE_CHUNK,
                             mesh=jmc.make_mesh(8))
    assert recorded(ran, "compress_mesh", verts) != host


# ---------------------------------------------------------------------------
# the exactness gate and the entry point
# ---------------------------------------------------------------------------

# a smaller run for the gate: the size variables, and the rest as arguments
GATE_ENV = {"TRICO_BENCH_VALUES": str(L * 40), "TRICO_BENCH_CHUNK": str(L),
            "TRICO_BENCH_MESH_VERTS": "2000"}


def _flip(out):
    """``out`` with one bit flipped: a tensor, an array, a tuple of them, or
    decompress_mesh's dict (in its vertices)."""
    if torch.is_tensor(out):
        out = out.clone()
        out.view(-1)[0] ^= 1
        return out
    if isinstance(out, dict):
        return {**out, "vertices": _flip(out["vertices"])}
    out = np.array(out)
    out.reshape(-1).view(np.uint8)[0] ^= 1
    return out


# each leg's decode, and the legs whose round trip it breaks
GATES = {"decode_f32_chunks_v2": (fp_torch, ["headline", "canary", "scale",
                                             "fullmesh"]),
         "decode_bp32_chunks": (bp_torch, ["fullmesh"]),
         "decode_f64_chunks_v2": (fp64_torch, ["f64"]),
         "read_vertices": (tt.ArchiveReader, ["bunny", "bunny_v1"]),
         "decompress_mesh": (mesh_codec, ["fullmesh_archive"])}


@pytest.fixture(scope="module")
def small_bunny(tmp_path_factory, bunny_path):
    """The bunny's first 3000 triangles, as an STL file."""
    verts, tris = tt.read_stl(bunny_path)
    tris = tris[:3000]
    used, tris = np.unique(tris, return_inverse=True)
    path = tmp_path_factory.mktemp("bench") / "part.stl"
    tt.write_stl(path, verts[used], tris.reshape(-1, 3).astype(np.uint32))
    return path


@pytest.mark.parametrize("decode", sorted(GATES))
def test_inexact_leg_voids_the_run(decode, small_bunny, monkeypatch, capsys):
    module, legs = GATES[decode]
    real = getattr(module, decode)
    monkeypatch.setattr(module, decode, lambda *a, **k: _flip(real(*a, **k)))
    real_run = bench.run
    monkeypatch.setattr(bench, "run", lambda **kw: real_run(
        **kw, canary_len=L, bp_chunk=1024, bunny=small_bunny, reps=1))
    for k, v in GATE_ENV.items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["extra"]["decode_gbps"] == 0.0
    assert line["extra"]["inexact_roundtrip"] is True
    assert "BENCH FAILURE" in err and all(leg in err for leg in legs)


def _module(args, env=None):
    return subprocess.run([sys.executable, "-m", "trico_tpu_torch.bench", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_entry_point_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _module([])
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not any(s.lstrip().startswith("{") for s in out.stdout.splitlines())


def test_entry_point_on_the_cpu():
    out = _module(["--device", "cpu"], GATE_ENV)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "fp32_encode_GBps_per_chip"
    assert line["extra"]["n_values"] == L * 40 and line["extra"]["chunk_len"] == L
    assert line["extra"]["fullmesh_archive"]["n_vertices"] == 44 * 44
    assert all(EXACT[f](line["extra"]) for f in EXACT)
