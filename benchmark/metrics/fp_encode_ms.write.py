"""Milliseconds a write spends on its float streams: the stages
fp_device_encode, fp_gather, fp_assembly and fp_tails that compress_mesh
times through its profile hook, summed, per write."""

STAGES = ("fp_device_encode", "fp_gather", "fp_assembly", "fp_tails")


def read(run):
    n = len(run.of("write"))
    if run.spans is None or not n or not run.spans.count(STAGES, "write"):
        return None
    return run.spans.seconds(STAGES, "write") * 1e3 / n
