"""Percent of the full float chunks' words that a read decodes on the
host: the program's tally of fp_host_chunks bytes over fp_read_words bytes
(the full chunks' words by any route). The tally counts the whole process,
set-up's warm read too; every read of a cell decodes archives of the same
shapes and of nearly the same exponent mix, so the ratio of the totals is
a read's."""

from benchmark.inside import tally_bytes_ratio


def read(run):
    share = tally_bytes_ratio(("fp_host_chunks",), ("fp_read_words",))
    return None if share is None else 100 * share
