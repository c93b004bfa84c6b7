"""The readers of the program's own spans and tally (``benchmark/inside.py``
and the metrics that use it): a traced CPU run of a shrunken Lucy cell in a
copy of the benchmark reports each of them, and a program without spans
and tally gives none of them, and raises nothing."""

import json
import numbers

import pytest

from benchmark import harness
from conftest import copy_benchmark, shrink

NEW = ("int_copy_ms.write", "int_emit_ms.write", "fp_copy_ms.write",
       "write_host_ms.write", "d2h_per_raw.write", "read_host_ms.read",
       "fp_host_decode_ms.read", "fp_host_share.read")
# Lucy at 96 x 96: two full float chunks of 4096 a plane, three full BP
# chunks of triangles, and (with 4096-byte LZ4 blocks) the device match
# search on every triangle plane that is not a fill
SIDES = {"lucy": 96, "vellum": 40}
LZ4_BLOCK = 4096


@pytest.fixture
def root(tmp_path, monkeypatch):
    from trico_tpu_torch import chunked, profiling
    monkeypatch.setattr(chunked, "DEFAULT_LZ4_BLOCK", LZ4_BLOCK)
    profiling.reset_tally()  # the tally counts the process: this run alone
    root = copy_benchmark(tmp_path)
    shrink(root, SIDES)
    return root


def _listed(root, cell):
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    return {m["name"] for m in harness.cell_metrics(manifest, cell, "per_layer")
            if m["name"] in NEW}


@pytest.mark.parametrize("cell", ["lucy.mesh", "lucy.points"])
def test_a_traced_run_reports_every_new_reader(root, cell):
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    res = harness.run_cell(root, cell, 2**32 + 3, 0.3, True, device="cpu")
    assert res["correct"]
    listed = _listed(root, cell)
    # lucy.points reports its write speed per layer (write_MBps), so the
    # readers that move encode_MBps are listed in lucy.mesh alone
    assert listed == (set(NEW) if cell == "lucy.mesh"
                      else {n for n in NEW if n.endswith(".read")})
    got = {k: v["value"] for k, v in res["metrics"].items() if k in NEW}
    assert set(got) == listed
    assert all(isinstance(v, numbers.Real) and v >= 0 for v in got.values())
    assert got["read_host_ms.read"] > 0
    if cell == "lucy.mesh":  # 8 bytes back a searched plane byte
        assert got["fp_copy_ms.write"] > 0 and got["write_host_ms.write"] > 0
        assert got["int_copy_ms.write"] > 0 and got["int_emit_ms.write"] > 0
        assert got["d2h_per_raw.write"] > 1
    assert 0 <= got["fp_host_share.read"] <= 100
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_program_without_spans_gives_none_of_them(root, monkeypatch):
    from trico_tpu_torch import profiling
    monkeypatch.delattr(profiling, "tally")
    res = harness.run_cell(root, "lucy.mesh", 11, 0.2, True, device="cpu")
    assert res["correct"]
    assert not set(res["metrics"]) & set(NEW)
    assert "fp_encode_ms.write" in res["metrics"]
