"""The corpus size gate of the port (``python -m
trico_tpu_torch.tools.corpus_gate``) on the CPU.

``trico_tpu_torch.tools.corpus`` makes the arrays of ``tests/corpus.py``
bit for bit; for all seven classes the port's v0 and v1 archives are the
bytes ``scripts/corpus_gate.our_archive`` writes with ``trico_tpu`` as a
device host runs it (``trico_tpu.chunked._tpu_available`` patched to
True), every stream comes back bit-exact through ``ArchiveReader``, and
the archives' sizes are those of ``CORPUS.json``. The gate's verdicts are
checked on doctored tables, and the tool runs once as ``python -m`` with
``jax`` and ``trico_tpu`` blocked. Tolerance: every array and archive byte
equal.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import corpus as jax_corpus
import trico_tpu.chunked as jc
from scripts.corpus_gate import our_archive as jax_archive
from torch_cases import align_native, require_native  # noqa: F401
from trico_tpu.io.stl import read_stl as jax_read_stl
from trico_tpu_torch.io.stl import write_stl
from trico_tpu_torch.tools import corpus, corpus_gate, ref_oracle

REPO = Path(__file__).resolve().parents[1]
RECORDED = json.loads((REPO / "CORPUS.json").read_text())
GENERATED = ("grid", "scan", "cad", "attrib", "double", "longidx")
CLASSES = GENERATED + ("bunny",)
# the reference's archive entry points, recording what each writer is given
STUB_C = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
typedef struct { uint8_t *buf; uint64_t size, cap; } archive;
void *trico_open_archive_for_writing(uint64_t cap) {
  archive *a = calloc(1, sizeof *a);
  a->cap = cap ? cap : 1;
  a->buf = malloc(a->cap);
  return a;
}
static void put(archive *a, const void *p, uint64_t n) {
  while (a->size + n > a->cap) a->buf = realloc(a->buf, a->cap *= 2);
  memcpy(a->buf + a->size, p, n);
  a->size += n;
}
static int record(void *v, uint8_t tag, const void *d, uint32_t n, uint32_t w) {
  put(v, &tag, 1);
  put(v, &n, 4);
  put(v, d, (uint64_t)n * w);
  return 1;
}
#define WRITER(name, tag, width) \
  int trico_write_##name(void *a, const void *d, uint32_t n) { \
    return record(a, tag, d, n, width); }
WRITER(vertices, 1, 12) WRITER(vertices_double, 2, 24) WRITER(triangles, 3, 12)
WRITER(triangles_long, 4, 24) WRITER(vertex_normals, 5, 12)
WRITER(vertex_colors, 6, 4) WRITER(uv_per_vertex, 7, 8)
uint8_t *trico_get_buffer_pointer(void *v) { return ((archive *)v)->buf; }
uint64_t trico_get_size(void *v) { return ((archive *)v)->size; }
void trico_close_archive(void *v) { free(((archive *)v)->buf); free(v); }
"""
# the tool as ``python -m`` runs it, with JAX and trico_tpu unimportable
LAUNCH = ("import runpy, sys; sys.modules['jax'] = None; "
          "sys.modules['trico_tpu'] = None; "
          "sys.argv = ['corpus_gate', *sys.argv[1:]]; "
          "runpy.run_module('trico_tpu_torch.tools.corpus_gate', "
          "run_name='__main__')")


def same_arrays(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.fixture(scope="module")
def meshes():
    return corpus.build_corpus()


@pytest.mark.parametrize("name", GENERATED)
def test_generators_match_tests_corpus(name):
    assert same_arrays(corpus.generators()[name](), jax_corpus.generators()[name]())


def test_bunny_is_the_repository_stl(meshes):
    verts, tris = jax_read_stl(corpus.BUNNY)
    assert corpus.BUNNY == REPO / "tests" / "data" / "StanfordBunny.stl"
    assert same_arrays(meshes["bunny"], {"vertices": verts, "triangles": tris})
    assert list(meshes) == list(CLASSES) == list(RECORDED)


def test_bunny_from_another_path_or_none(tmp_path, meshes):
    grid = meshes["grid"]
    write_stl(tmp_path / "grid.stl", grid["vertices"], grid["triangles"])
    other = corpus.build_corpus(bunny=tmp_path / "grid.stl")["bunny"]
    assert len(other["vertices"]) == len(grid["vertices"])
    assert len(other["triangles"]) == len(grid["triangles"])
    assert list(corpus.build_corpus(bunny=None)) == list(GENERATED)


@pytest.mark.parametrize("chunk_len", [None, 4096], ids=["v0", "v1"])
@pytest.mark.parametrize("name", CLASSES)
def test_archives_match_trico_tpu(meshes, name, chunk_len, monkeypatch,
                                  align_native):  # noqa: F811
    monkeypatch.setattr(jc, "_tpu_available", lambda: True)  # a device host
    mesh = meshes[name]
    ours = corpus_gate.our_archive(mesh, chunk_len, device="cpu")
    assert ours == jax_archive(mesh, chunk_len=chunk_len)
    assert corpus_gate.inexact_streams(ours, mesh, device="cpu") == []


@pytest.mark.parametrize("name", CLASSES)
def test_gate_row_holds_corpus_json(meshes, name):
    """With the C++ host library (whose codecs wrote CORPUS.json), each
    class's sizes are the recorded ones, the reference's size is the
    recorded one where the reference is not built, and both archives come
    back exact."""
    require_native()
    row, fails = corpus_gate.gate_class(name, meshes[name], RECORDED,
                                        torch.device("cpu"))
    assert fails == []
    want = RECORDED[name]
    for k in ("raw_bytes", "v0_bytes", "v1_bytes", "v0_ratio", "v1_ratio"):
        assert row[k] == want[k], k
    assert row["exact"]
    if ref_oracle.get() is None:
        assert row["ref_source"] == "recorded" and row["t_ref_s"] is None
        for k in ("ref_bytes", "ref_ratio", "v0_vs_ref", "v1_vs_ref"):
            assert row[k] == want[k], k


def run_main(monkeypatch, names, recorded, tmp_path, meshes):
    """The tool's ``main`` on the classes ``names`` against ``recorded``:
    (exit code, the result it wrote)."""
    monkeypatch.setattr(corpus_gate, "build_corpus",
                        lambda: {n: meshes[n] for n in names})
    table = tmp_path / "recorded.json"
    table.write_text(json.dumps(recorded))
    out = tmp_path / "result.json"
    rc = corpus_gate.main(["--device", "cpu", "--recorded", str(table),
                           "--json", str(out)])
    return rc, json.loads(out.read_text())


def test_gate_passes_on_the_recorded_table(monkeypatch, tmp_path, meshes, capsys):
    rc, result = run_main(monkeypatch, ["cad"], RECORDED, tmp_path, meshes)
    assert rc == 0 and result["ok"] and result["failures"] == []
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    row = result["rows"]["cad"]
    assert set(row) >= {"raw_bytes", "ref_bytes", "ref_source", "v0_bytes",
                        "v1_bytes", "ref_ratio", "v0_ratio", "v1_ratio",
                        "v0_vs_ref", "v1_vs_ref", "t_ref_s", "t_v0_s", "t_v1_s"}
    assert row["ref_source"] == "recorded" and row["ref_bytes"] == RECORDED["cad"]["ref_bytes"]
    assert result["device"] == {"name": "cpu", "power_limit": None}
    assert result["backend"] == "cpu"


@pytest.mark.parametrize("which", ["v0", "v1"])
def test_gate_fails_a_reference_one_byte_too_small(monkeypatch, tmp_path, meshes,
                                                   which):
    size = len(corpus_gate.our_archive(meshes["cad"],
                                       None if which == "v0" else 4096,
                                       device="cpu"))
    table = dict(RECORDED, cad=dict(RECORDED["cad"], ref_bytes=size - 1))
    rc, result = run_main(monkeypatch, ["cad"], table, tmp_path, meshes)
    assert rc == 1 and not result["ok"]
    assert f"cad: {which} {size} > ref {size - 1}" in result["failures"]
    table["cad"]["ref_bytes"] = size
    if which == "v0":  # v1 is the smaller: at v0's size both pass
        assert run_main(monkeypatch, ["cad"], table, tmp_path, meshes)[0] == 0


def test_gate_fails_a_class_without_reference(monkeypatch, tmp_path, meshes):
    table = {k: v for k, v in RECORDED.items() if k != "cad"}
    rc, result = run_main(monkeypatch, ["grid", "cad"], table, tmp_path, meshes)
    assert rc == 1
    assert result["failures"] == ["cad: no reference size, live or recorded"]
    assert result["rows"]["cad"]["ref_source"] is None
    table["cad"] = dict(RECORDED["cad"], ref_bytes=None)  # null, as recorded
    assert run_main(monkeypatch, ["cad"], table, tmp_path, meshes)[0] == 1


def test_gate_fails_an_inexact_round_trip(monkeypatch, tmp_path, meshes):
    real = corpus_gate.inexact_streams
    monkeypatch.setattr(corpus_gate, "inexact_streams",
                        lambda blob, mesh, device: real(
                            blob, dict(mesh, vertices=mesh["vertices"][::-1].copy()),
                            device=device))
    rc, result = run_main(monkeypatch, ["cad"], RECORDED, tmp_path, meshes)
    assert rc == 1 and not result["rows"]["cad"]["exact"]
    assert "cad: v1 round trip not bit-exact in ['vertices']" in result["failures"]


def test_inexact_streams_names_each_difference(meshes):
    mesh = meshes["attrib"]
    blob = corpus_gate.our_archive(mesh, 4096, device="cpu")
    assert corpus_gate.inexact_streams(blob, mesh, device="cpu") == []
    colors = mesh["vertex_colors"].copy()
    colors[7] ^= 1
    changed = dict(mesh, vertex_colors=colors,
                   uv_per_vertex=mesh["uv_per_vertex"].astype(np.float64))
    assert corpus_gate.inexact_streams(blob, changed, device="cpu") == [
        "uv_per_vertex", "vertex_colors"]
    fewer = {k: v for k, v in mesh.items() if k != "vertex_normals"}
    more = dict(mesh, attributes=np.zeros(3, np.uint8))
    assert corpus_gate.inexact_streams(blob, fewer, device="cpu") == ["vertex_normals"]
    assert corpus_gate.inexact_streams(blob, more, device="cpu") == ["attributes"]


@pytest.fixture(scope="module")
def stub_reference(tmp_path_factory):
    """A checkout of five C sources with the reference's archive entry
    points (``ref_oracle.SOURCES``), built by the oracle's own ``gcc`` line
    into a build directory of the test: (sources, build directory). The
    stub's archive records each ``trico_write_*`` call as a tag byte, the
    count (u32) and the bytes it was given, so the archive shows what the
    oracle passed through ctypes."""
    if shutil.which("gcc") is None:
        pytest.skip("needs gcc")
    ref = tmp_path_factory.mktemp("reference")
    for src in ref_oracle.SOURCES:
        (ref / src).parent.mkdir(parents=True, exist_ok=True)
        (ref / src).write_text("typedef int unused_t;\n")
    (ref / ref_oracle.SOURCES[0]).write_text(STUB_C)
    build = tmp_path_factory.mktemp("build")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRICO_TPU_BUILD_DIR", str(build))
        assert ref_oracle.get(ref) is not None
    return ref, build


def stub_archive(mesh: dict) -> bytes:
    """What the stub reference writes for ``mesh``."""
    verts, tris = mesh["vertices"], mesh["triangles"]
    calls = [(2 if verts.dtype == np.float64 else 1, verts),
             (4 if tris.dtype == np.uint64 else 3, tris)]
    calls += [(tag, mesh[k]) for tag, k in ((5, "vertex_normals"),
                                            (6, "vertex_colors"),
                                            (7, "uv_per_vertex")) if k in mesh]
    return b"".join(bytes([tag]) + np.uint32(len(verts) if tag > 4 else len(a)
                                             ).tobytes() + a.tobytes()
                    for tag, a in calls)


@pytest.mark.parametrize("name", ["cad", "attrib", "double", "longidx"])
def test_ref_oracle_builds_and_writes_through_the_library(stub_reference, meshes,
                                                          name):
    """The oracle builds the sources once into ``build/ref/`` (no temporary
    file left) and writes the mesh through every writer its streams need,
    in the reference encoder's order, with the counts and bytes given."""
    ref, build = stub_reference
    libs = list((build / "ref").iterdir())
    assert len(libs) == 1 and libs[0].name.startswith("libtrico_ref_")
    assert libs[0].suffix == ".so"
    assert ref_oracle.ref_archive(meshes[name], ref) == stub_archive(meshes[name])


def test_live_reference_is_preferred(monkeypatch, meshes, stub_reference):
    """Where the reference builds in the checkout's ``reference/``, its
    archive's size is the gate's, whatever the recorded table says."""
    monkeypatch.setattr(ref_oracle, "REFERENCE", stub_reference[0])
    row, fails = corpus_gate.gate_class("cad", meshes["cad"], RECORDED,
                                        torch.device("cpu"))
    size = len(stub_archive(meshes["cad"]))
    assert row["ref_source"] == "live" and row["ref_bytes"] == size
    assert size != RECORDED["cad"]["ref_bytes"]
    assert row["t_ref_s"] is not None and fails == []


def test_ref_oracle_without_sources(tmp_path, meshes):
    """Without the reference's sources the oracle builds nothing and
    returns None; the gate then reads the recorded table. The sources are
    looked for only inside the checkout, in a directory git ignores."""
    assert ref_oracle.get(tmp_path) is None
    assert ref_oracle.ref_archive(meshes["cad"], tmp_path) is None
    assert not (tmp_path / "build").exists()
    assert ref_oracle.REFERENCE == REPO / "reference"
    assert "/reference/" in (REPO / ".gitignore").read_text().splitlines()


def test_json_never_overwrites_the_recorded_table(tmp_path):
    with pytest.raises(SystemExit) as e:
        corpus_gate.main(["--device", "cpu", "--json", str(REPO / "CORPUS.json")])
    assert e.value.code == 2
    table = tmp_path / "t.json"
    table.write_text("{}")
    with pytest.raises(SystemExit):
        corpus_gate.main(["--device", "cpu", "--recorded", str(table),
                          "--json", str(table)])
    assert table.read_text() == "{}"


def test_entry_point_with_jax_blocked(tmp_path):
    """The whole gate as ``python -m`` on the CPU, JAX and trico_tpu
    unimportable: exit 0, one JSON line, every row exact and, where both
    C++ libraries are built, CORPUS.json's sizes."""
    out = tmp_path / "gate.json"
    res = subprocess.run([sys.executable, "-c", LAUNCH, "--device", "cpu",
                          "--json", str(out)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result == json.loads(out.read_text())
    assert result["ok"] and list(result["rows"]) == list(CLASSES)
    assert all(row["exact"] for row in result["rows"].values())
    assert result["recorded"] == str(REPO / "CORPUS.json")
    import trico_tpu_torch.native

    if trico_tpu_torch.native.available():
        for name, row in result["rows"].items():
            assert (row["v0_bytes"], row["v1_bytes"]) == (
                RECORDED[name]["v0_bytes"], RECORDED[name]["v1_bytes"]), name


def test_runs_on_the_card_unless_asked(tmp_path):
    """Without ``--device`` the gate writes v1 on the card: with no card it
    exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a card")
    res = subprocess.run([sys.executable, "-c", LAUNCH], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert res.stdout.strip() == ""
