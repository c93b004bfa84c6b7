"""Integer inputs of the LZ4 and pick-best integer tests, shared by the
tests held against trico_tpu (test_torch_lz4.py) and the card cases of
test_torch_staging.py. Imports no JAX."""

import numpy as np


def plane(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """n bytes: zeros, text, a small random alphabet, the second byte plane
    of triangle-index-like u32 values, 0xFF runs (windows with every bit
    set) among random bytes, or uniformly random bytes."""
    r = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "text":
        text = b"the quick brown fox jumps over the lazy dog; "
        return np.frombuffer(text * (n // len(text) + 1), np.uint8)[:n].copy()
    if kind == "alphabet":
        return r.integers(0, 6, n).astype(np.uint8)
    if kind == "index":
        i = np.arange(n, dtype=np.uint32)
        return (i // 3 + (i % 3) * 7 + i % 1024).view(np.uint8)[1::4].copy()
    if kind == "ff":
        p = r.integers(0, 256, n).astype(np.uint8)
        for s in r.integers(0, n, n // 64):
            p[s : s + r.integers(4, 40)] = 0xFF
        return p
    return r.integers(0, 256, n).astype(np.uint8)


KINDS = ["zeros", "text", "alphabet", "index", "ff", "random"]


def int_cases() -> dict[str, np.ndarray]:
    """Integer streams by name: each width, constants, index-like and
    near-sorted values (BP wins), colours (LZ4 wins), short and empty."""
    r = np.random.default_rng(4)
    n = 20000
    i = np.arange(n, dtype=np.uint64)
    tri = i // 3 + (i % 3) * 7 + i % 1024
    near = (np.repeat(np.cumsum(r.integers(0, 200, n // 8)), 8)
            + r.integers(0, 64, n)).astype(np.uint64)  # BP wins
    col = (r.integers(0, 4, n) * 0x00010101 + 0xFF000000).astype(np.uint32)
    return {
        "u8": r.integers(0, 3, n).astype(np.uint8),
        "u8_const": np.full(n, 7, np.uint8),
        "u16": (r.integers(0, 4, n) * 257).astype(np.uint16),
        "u32_index": tri.astype(np.uint32),
        "u32_near": near.astype(np.uint32),
        "u32_colors": col,  # LZ4 wins; the alpha plane is a fill
        "u32_const": np.full(n, 0x12345678, np.uint32),
        "u64_index": tri,
        "u64_near": near,
        "u64_wide": tri | (np.uint64(0xABCD) << np.uint64(40)),
        "u32_short": tri[:100].astype(np.uint32),
        "u32_empty": np.zeros(0, np.uint32),
    }
