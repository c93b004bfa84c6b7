"""Pure-Python LZ4 block codec (fallback when the native library is absent).

Implements the public LZ4 *block* format: token = 4-bit literal run | 4-bit
match length (biased by MINMATCH=4), 255-extension bytes, u16 little-endian
offsets, last-5-bytes-literals / 12-byte end-of-block encoder rules. The
compressor here favours simplicity (greedy dict matcher) — the production
paths are the native C++ codec and the device match finder
(:mod:`trico_tpu_torch.codec.lz4_torch`). The port's own copy of
``trico_tpu/codec/lz4_ref.py``.
"""

from __future__ import annotations

MINMATCH = 4
MFLIMIT = 12
LASTLITERALS = 5


def _write_len(first: int, n: int) -> bytes:
    """Emit the 255-extension byte chain for a length field that hit 15."""
    out = bytearray()
    n -= 15
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)
    return bytes(out)


def compress(data: bytes) -> bytes:
    data = bytes(data)
    n = len(data)
    out = bytearray()

    def emit(anchor: int, pos: int, mlen: int, offset: int):
        lit = pos - anchor
        token_lit = min(lit, 15)
        token_match = min(mlen - MINMATCH, 15) if mlen else 0
        out.append((token_lit << 4) | token_match)
        if lit >= 15:
            out.extend(_write_len(15, lit))
        out.extend(data[anchor:pos])
        if mlen:
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            if mlen - MINMATCH >= 15:
                out.extend(_write_len(15, mlen - MINMATCH))

    anchor = 0
    if n >= MFLIMIT + 1:
        table: dict[bytes, int] = {}
        pos = 0
        limit = n - MFLIMIT
        match_limit = n - LASTLITERALS
        while pos <= limit:
            key = data[pos : pos + 4]
            cand = table.get(key, -1)
            table[key] = pos
            if cand >= 0 and pos - cand <= 65535:
                # extend backwards
                while pos > anchor and cand > 0 and data[pos - 1] == data[cand - 1]:
                    pos -= 1
                    cand -= 1
                mlen = 4
                while pos + mlen < match_limit and data[cand + mlen] == data[pos + mlen]:
                    mlen += 1
                emit(anchor, pos, mlen, pos - cand)
                pos += mlen
                anchor = pos
            else:
                pos += 1
    emit(anchor, n, 0, 0)
    return bytes(out)


def decompress(data: bytes, out_size: int) -> bytes:
    data = bytes(data)
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        token = data[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                s = data[ip]
                ip += 1
                lit += s
                if s != 255:
                    break
        out += data[ip : ip + lit]
        ip += lit
        if ip >= n:
            break
        offset = data[ip] | (data[ip + 1] << 8)
        ip += 2
        if offset == 0 or offset > len(out):
            raise ValueError("corrupt LZ4 block")
        mlen = (token & 15) + MINMATCH
        if (token & 15) == 15:
            while True:
                s = data[ip]
                ip += 1
                mlen += s
                if s != 255:
                    break
        start = len(out) - offset
        for k in range(mlen):  # overlap-safe byte copy
            out.append(out[start + k])
    if len(out) != out_size:
        raise ValueError(f"corrupt LZ4 block (got {len(out)}, want {out_size})")
    return bytes(out)
