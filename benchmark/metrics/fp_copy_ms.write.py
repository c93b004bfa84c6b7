"""Milliseconds a write spends copying its float chunks to the card and
the padded payload rows and sizes back: the program's spans fp_h2d and
fp_d2h (inside fp_device_encode; the card is waited for before the copy
back, so it holds no kernel), per write."""

from benchmark.inside import recorded_ms

STAGES = ("fp_h2d", "fp_d2h")


def read(run):
    return recorded_ms(run, "write", STAGES)
