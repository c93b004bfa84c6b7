"""Percent of the bytes the program copies from the card to the host that
land in its reused page-locked buffers: its tally's pinned_d2h bytes over
its fp_d2h, lz4_d2h and bp_d2h bytes. The tally counts the whole process,
set-up's warm write too; every write of a cell has the same shapes, so the
ratio of the totals is each write's. A program with no pinned_d2h entry in
its tally gives nothing."""

from benchmark.inside import _profiling, tally_bytes_ratio


def read(run):
    profiling = _profiling()
    if profiling is None or "pinned_d2h" not in profiling.tally():
        return None
    share = tally_bytes_ratio(("pinned_d2h",), ("fp_d2h", "lz4_d2h", "bp_d2h"))
    return None if share is None else 100 * share
