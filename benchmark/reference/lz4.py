"""Plain Python decoder of LZ4 blocks (the block format, FORMAT.md section 3).

A block is a run of sequences: a token (4 bits of literal count, 4 bits of
match length less 4, each extended by bytes of 255 and a last byte), the
literals, then a little-endian u16 offset and the match, which copies
bytes already written. The last sequence has literals only. A match
whose offset is shorter than its length repeats the last ``offset``
bytes. The walk is one loop per sequence; the copies are slices.
"""

from __future__ import annotations

import numpy as np


def decode_block(src: bytes, size: int) -> bytearray:
    """One LZ4 block → its ``size`` bytes."""
    out = bytearray()
    ip, n = 0, len(src)
    try:
        while ip < n:
            tok = src[ip]
            ip += 1
            lit = tok >> 4
            if lit == 15:
                b = 255
                while b == 255:
                    b = src[ip]
                    ip += 1
                    lit += b
            if ip + lit > n:
                raise ValueError("LZ4 literals run past the block")
            out += src[ip : ip + lit]
            ip += lit
            if ip >= n:
                break
            off = src[ip] | (src[ip + 1] << 8)
            ip += 2
            m = (tok & 15) + 4
            if m == 19:
                b = 255
                while b == 255:
                    b = src[ip]
                    ip += 1
                    m += b
            start = len(out) - off
            if off == 0 or start < 0:
                raise ValueError("LZ4 match offset outside the block")
            if off >= m:
                out += out[start : start + m]
            else:
                out += (out[start:] * (m // off + 1))[:m]
    except IndexError:
        raise ValueError("LZ4 block ends inside a sequence") from None
    if len(out) != size:
        raise ValueError(f"LZ4 block decodes to {len(out)} bytes, not {size}")
    return out


def decode_blocks(blocks: list[tuple[np.ndarray, int]]) -> list[np.ndarray]:
    """Decode LZ4 blocks given as (payload bytes, decoded size) → one byte
    array per block, in order."""
    return [np.frombuffer(decode_block(bytes(p), size), np.uint8)
            for p, size in blocks]
