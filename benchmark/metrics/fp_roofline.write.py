"""Percent of the HBM roofline the float encode reaches: the bytes its
full chunks need (words read once, payload written once; see
benchmark/roofline.py) at the card's peak bandwidth, over the time the card
was busy inside the fp_device_encode spans of the writes."""

from benchmark.roofline import fp_full_chunk_bytes, hbm_bytes_per_s


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    if run.trace is None or peak is None:
        return None
    busy = run.trace.busy_in(["fp_device_encode"])
    nbytes = sum(fp_full_chunk_bytes(r.archive) for r in run.of("write"))
    if busy <= 0 or not nbytes:
        return None
    return 100 * nbytes / peak / busy
