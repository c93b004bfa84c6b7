"""Milliseconds a read spends on its vertex normals: the program's span
read.vertex_normals in decompress_mesh, from the stream's first substream
read to its array (the sharded float decode of three planes and their
interleave), from the trace's annotations, per read. None where the
program opens no such span."""

from benchmark.per_stream import read_ms


def read(run):
    return read_ms(run, "vertex_normals")
