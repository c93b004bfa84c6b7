"""Milliseconds a read spends on its integer streams:
mesh_codec.decode_bp_sharded and chunked.decode_lz4_chunked, per read."""

STAGES = ("bp_decode", "lz4_decode")


def read(run):
    n = len(run.of("read"))
    if run.spans is None or not n or not run.spans.count(STAGES, "read"):
        return None
    return run.spans.seconds(STAGES, "read") * 1e3 / n
