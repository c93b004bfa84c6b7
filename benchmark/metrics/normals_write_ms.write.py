"""Milliseconds a write spends on its vertex normals: the program's span
write.vertex_normals around the stream's writer in compress_mesh (the AoS
to SoA split, the sharded float encode, its copies, assembly and framing),
from the recorder, per write. None where the program opens no such span."""

from benchmark.per_stream import write_ms


def read(run):
    return write_ms(run, "vertex_normals")
