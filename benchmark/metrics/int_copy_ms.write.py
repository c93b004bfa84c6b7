"""Milliseconds a write spends copying its integer streams' device results
to the host: the program's spans lz4_d2h (the LZ4 match search's offsets
and runs, 8 bytes a plane byte) and bp_d2h (the BP rows and sizes), per
write."""

from benchmark.inside import recorded_ms

STAGES = ("lz4_d2h", "bp_d2h")


def read(run):
    return recorded_ms(run, "write", STAGES)
