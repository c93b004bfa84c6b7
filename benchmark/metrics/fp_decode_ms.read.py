"""Milliseconds a read spends in mesh_codec.decode_plane_sharded (the
float planes), per read."""

STAGES = ("fp_decode",)


def read(run):
    n = len(run.of("read"))
    if run.spans is None or not n or not run.spans.count(STAGES, "read"):
        return None
    return run.spans.seconds(STAGES, "read") * 1e3 / n
