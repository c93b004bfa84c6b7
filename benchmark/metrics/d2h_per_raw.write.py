"""Bytes the program copies from the card to the host per raw input byte
of a write: its tally's fp_d2h, lz4_d2h and bp_d2h bytes over the raw
bytes it tallies under compress_mesh. The tally counts the whole process,
set-up's warm write too; every write of a cell has the same shapes, so the
ratio of the totals is each write's."""

from benchmark.inside import tally_bytes_ratio


def read(run):
    return tally_bytes_ratio(("fp_d2h", "lz4_d2h", "bp_d2h"), ("compress_mesh",))
