"""Raw output bytes of every read in the window over the reads' summed
wall time, 1 MB = 1e6 B (host clock)."""


def read(run):
    s = run.seconds("read")
    return run.nbytes("read") / s / 1e6 if s > 0 else None
