"""Milliseconds a write spends on its integer streams: compress_mesh's
int_encode stage (chunked.encode_int_best), per write."""

STAGES = ("int_encode",)


def read(run):
    n = len(run.of("write"))
    if run.spans is None or not n or not run.spans.count(STAGES, "write"):
        return None
    return run.spans.seconds(STAGES, "write") * 1e3 / n
