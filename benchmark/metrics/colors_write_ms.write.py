"""Milliseconds a write spends on its vertex colours: the program's span
write.vertex_colors around the stream's writer in compress_mesh
(encode_int_best: the LZ4 byte planes, the BP try and the fill check),
from the recorder, per write. None where the program opens no such span."""

from benchmark.per_stream import write_ms


def read(run):
    return write_ms(run, "vertex_colors")
