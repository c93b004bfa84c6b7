"""Raw bytes of the vertex colours over the bytes the stream takes in the
archive (the program's count archive.vertex_colors: its header and framed
substreams), over the first archive of each pool entry: what
encode_int_best's choice of LZ4 byte planes or BP gives RGBA8 words. None
where the program counts no such bytes."""

from benchmark.per_stream import ratio


def read(run):
    return ratio(run, "vertex_colors")
