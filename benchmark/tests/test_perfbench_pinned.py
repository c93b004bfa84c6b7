"""The reader of pinned_d2h_share.write: a traced CPU run of a shrunken
Lucy mesh cell, with the program's copies to the host routed through a
pageable pool as a card's go through its page-locked one, reports the
tally's share; a program whose tally has no pinned_d2h entry (one without
the pool, or a CPU run, where nothing is copied into it) gives none."""

import pytest

from benchmark import harness
from conftest import copy_benchmark, shrink

NAME = "pinned_d2h_share.write"
SIDES = {"lucy": 96, "vellum": 40}  # as test_perfbench_inside.py: LZ4 search on every plane
LZ4_BLOCK = 4096


@pytest.fixture
def root(tmp_path, monkeypatch):
    from trico_tpu_torch import chunked, profiling
    monkeypatch.setattr(chunked, "DEFAULT_LZ4_BLOCK", LZ4_BLOCK)
    profiling.reset_tally()  # the tally counts the process: this run alone
    root = copy_benchmark(tmp_path)
    shrink(root, SIDES)
    return root


@pytest.mark.parametrize("pool", [True, False])
def test_the_share_is_the_tallys_pinned_bytes_over_the_bytes_copied_back(
        root, monkeypatch, pool):
    from trico_tpu_torch import profiling, staging
    if pool:
        host = staging.HostPool(pin=False)
        monkeypatch.setattr(staging, "to_host", lambda t, slot: host.copy(t, slot))
    res = harness.run_cell(root, "lucy.mesh", 2**32 + 5, 0.3, True, device="cpu")
    assert res["correct"]
    if not pool:
        assert NAME not in res["metrics"]
        return
    tally = profiling.tally()
    lz4, bp, fp = (tally[k][1] for k in ("lz4_d2h", "bp_d2h", "fp_d2h"))
    assert tally["pinned_d2h"][1] == lz4 + bp > 0
    got = res["metrics"][NAME]
    assert got["unit"] == "%"
    assert got["value"] == pytest.approx(100 * (lz4 + bp) / (lz4 + bp + fp), rel=1e-12)
    assert 50 < got["value"] < 100
