"""Milliseconds a read spends decoding full float chunks on the host's
threads (chunks whose tables pass chunked.DEVICE_TABLE_WORDS, such as the
f32 (14,18) winners): the program's span fp_host_chunks, from the trace's
annotations, per read."""

from benchmark.inside import traced_ms

STAGES = ("fp_host_chunks",)


def read(run):
    return traced_ms(run, "read", STAGES)
