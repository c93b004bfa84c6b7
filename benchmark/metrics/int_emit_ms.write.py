"""Milliseconds a write spends in the host's LZ4 emit
(``native.lz4_emit_blocks`` over the device search's candidates): the
program's span lz4_emit, per write."""

from benchmark.inside import recorded_ms

STAGES = ("lz4_emit",)


def read(run):
    return recorded_ms(run, "write", STAGES)
