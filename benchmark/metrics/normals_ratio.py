"""Raw bytes of the vertex normals over the bytes the stream takes in the
archive (the program's count archive.vertex_normals: its header and framed
substreams), over the first archive of each pool entry: how well the
adaptive float codec packs unit vectors. None where the program counts no
such bytes."""

from benchmark.per_stream import ratio


def read(run):
    return ratio(run, "vertex_normals")
