"""Raw bytes of the pool's meshes over the bytes of their archives: what a
user saves in storage. Deterministic for a seed."""


def read(run):
    ks = sorted(run.archive_bytes)
    if not ks:
        return None
    return sum(run.pool_raw_bytes[k] for k in ks) / sum(run.archive_bytes[k] for k in ks)
