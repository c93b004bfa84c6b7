"""Milliseconds a write spends on host copies outside the codecs: the
program's spans fp_split (the vertices' AoS to SoA split) and archive_join
(the archive's parts joined into its bytes), per write."""

from benchmark.inside import recorded_ms

STAGES = ("fp_split", "archive_join")


def read(run):
    return recorded_ms(run, "write", STAGES)
