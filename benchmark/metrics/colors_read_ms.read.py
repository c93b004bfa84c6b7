"""Milliseconds a read spends on its vertex colours: the program's span
read.vertex_colors in decompress_mesh, from the stream's first substream
read to its array (the LZ4 or BP decode and the join of the byte planes),
from the trace's annotations, per read. None where the program opens no
such span."""

from benchmark.per_stream import read_ms


def read(run):
    return read_ms(run, "vertex_colors")
