"""Milliseconds a read spends on host work outside the decoders: the union
of the program's spans read_framing (the archive walk and each substream's
copy), fp_interleave (the float planes interleaved, SoA to AoS) and
int_join (LZ4 byte planes joined into words), from the trace's
annotations, per read."""

from benchmark.inside import traced_ms

STAGES = ("read_framing", "fp_interleave", "int_join")


def read(run):
    return traced_ms(run, "read", STAGES)
