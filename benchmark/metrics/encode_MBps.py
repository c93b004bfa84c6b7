"""Raw input bytes of every write in the window over the writes' summed
wall time, 1 MB = 1e6 B (host clock)."""


def read(run):
    s = run.seconds("write")
    return run.nbytes("write") / s / 1e6 if s > 0 else None
