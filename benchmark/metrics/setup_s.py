"""Seconds from the start of the process to the first timed request:
imports, the program's libraries (built on a checkout's first run; the
result line reports that part apart as ``setup_build_s``), the pool of
meshes, one warm write and read."""


def read(run):
    return run.setup_s
