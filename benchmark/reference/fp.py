"""Plain NumPy decoder of FP (FCM/DFCM) chunks, f32 and f64, in both chunk
layouts (FORMAT.md sections 2 and 5).

A chunk is ``[u8 hash_info][u32 BE count]`` and then its groups: in the
reference layout each group's tag sits in front of its residual bytes, in
the v2 ("tpu") layout every tag comes first. A tag holds one code per
value (f32: eight 3-bit codes in 3 big-endian bytes, slot 0 in the low
bits; f64: two 4-bit codes in one byte, slot 0 in the low nibble). A code
says which predictor the residual is against and how many big-endian
bytes it takes; the value is the residual XOR the prediction.

Decoding is sequential inside a chunk, because each decoded value updates
the predictors' tables. Chunks are independent, so every chunk of one
exponent pair is replayed in lockstep: one pass over the value positions,
each step vectorized over the chunks, each chunk with tables of its own.
"""

from __future__ import annotations

import numpy as np

LEN32 = np.array([0, 1, 2, 3, 4, 1, 2, 3], np.int64)
LEN64 = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4, 5, 6, 7], np.int64)
# the predictor tables one lockstep pass may hold, and the bytes of the
# (rows, values) work arrays of one vectorized parse
TABLE_BYTES = 1 << 30
PARSE_VALUES = 1 << 22


def _spec(bits: int):
    """(word dtype, values per group, tag bytes per group, code lengths,
    largest FCM code)."""
    if bits == 32:
        return np.uint32, 8, 3, LEN32, 4
    if bits == 64:
        return np.uint64, 2, 1, LEN64, 8
    raise ValueError(f"FP chunks have 32- or 64-bit words, not {bits}")


def _header(p: np.ndarray) -> tuple[int, int]:
    if len(p) < 5:
        raise ValueError("FP chunk shorter than its header")
    return int(p[0]), int.from_bytes(p[1:5].tobytes(), "big")


def _codes(tags: np.ndarray, bits: int) -> np.ndarray:
    """(..., G, tag bytes) → (..., G * group) codes."""
    if bits == 32:
        word = ((tags[..., 0].astype(np.int64) << 16)
                | (tags[..., 1].astype(np.int64) << 8) | tags[..., 2])
        codes = (word[..., None] >> (3 * np.arange(8))) & 7
    else:
        t = tags[..., 0].astype(np.int64)
        codes = np.stack([t & 15, t >> 4], axis=-1)
    return codes.reshape(*codes.shape[:-2], -1)


def _residuals(buf: np.ndarray, offs: np.ndarray, lens: np.ndarray,
               dt) -> np.ndarray:
    """Big-endian residuals of ``lens`` bytes starting at ``offs`` in the
    flat byte array ``buf``."""
    x = np.zeros(offs.shape, dt)
    for k in range(int(lens.max(initial=0))):
        m = lens > k
        byte = buf[np.where(m, offs + k, 0)].astype(dt)
        x = np.where(m, (x << dt(8)) | byte, x)
    return x


def parse_v2(payloads: list[np.ndarray], bits: int):
    """Parse v2 chunks of one count n → (hash_info (C,), codes (C, n),
    residuals (C, n)). Every chunk must use exactly its declared bytes."""
    dt, group, tagb, lens_of, _ = _spec(bits)
    n = _header(payloads[0])[1]
    if n % group:
        raise ValueError(f"v2 FP chunk of {n} values is not whole groups")
    G = n // group
    C = len(payloads)
    sizes = np.array([len(p) for p in payloads], np.int64)
    W = int(sizes.max())
    if W < 5 + tagb * G:
        raise ValueError("v2 FP chunk shorter than its tags")
    mat = np.zeros((C, W), np.uint8)
    for c, p in enumerate(payloads):
        mat[c, : len(p)] = p
    counts = ((mat[:, 1].astype(np.int64) << 24) | (mat[:, 2].astype(np.int64) << 16)
              | (mat[:, 3].astype(np.int64) << 8) | mat[:, 4])
    if np.any(counts != n):
        raise ValueError("v2 FP chunks of different counts in one parse")
    codes = _codes(mat[:, 5 : 5 + tagb * G].reshape(C, G, tagb), bits)
    lens = lens_of[codes]
    start = 5 + tagb * G
    ends = np.cumsum(lens, axis=1)
    if np.any(start + ends[:, -1] != sizes):
        raise ValueError("v2 FP chunk size does not match its tags")
    offs = start + ends - lens + (np.arange(C, dtype=np.int64) * W)[:, None]
    res = _residuals(mat.reshape(-1), offs, lens, dt)
    return mat[:, 0].astype(np.int64), codes.astype(np.uint8), res


def parse_ref(p: np.ndarray, bits: int):
    """Parse one reference-layout chunk → (hash_info, codes (n,),
    residuals (n,)), walking its groups in order."""
    dt, group, tagb, lens_of, _ = _spec(bits)
    info, n = _header(p)
    G = -(-n // group)
    codes = np.zeros(G * group, np.int64)
    offs = np.zeros(G * group, np.int64)
    pos = 5
    for g in range(G):
        if pos + tagb > len(p):
            raise ValueError("reference FP chunk truncated in its tags")
        c = _codes(p[pos : pos + tagb].reshape(1, tagb), bits)
        pos += tagb
        ln = lens_of[c]
        codes[g * group : (g + 1) * group] = c
        offs[g * group : (g + 1) * group] = pos + np.cumsum(ln) - ln
        pos += int(ln.sum())
    if pos != len(p):
        raise ValueError("reference FP chunk size does not match its tags")
    lens = lens_of[codes]
    res = _residuals(p, offs, lens, dt)
    return info, codes[:n].astype(np.uint8), res[:n]


def replay(codes: np.ndarray, res: np.ndarray, e1: int, e2: int,
           bits: int) -> np.ndarray:
    """Decode (R, N) codes and residuals of R chunks at exponents (e1, e2),
    all chunks in lockstep (fps.c:212-417, 803-1164) → (R, N) words."""
    dt, _, _, _, fcm_max = _spec(bits)
    R, N = codes.shape
    out = np.empty((N, R), dt)
    codes_t = np.ascontiguousarray(codes.T)
    res_t = np.ascontiguousarray(res.T)
    m1, m2, half = (1 << e1) - 1, (1 << e2) - 1, e2 // 2
    s1, s2 = dt(bits - e1), dt(bits - e2)
    base1 = np.arange(R, dtype=np.int64) << e1
    base2 = np.arange(R, dtype=np.int64) << e2
    t1 = np.zeros(R << e1, dt)
    t2 = np.zeros(R << e2, dt)
    h1 = np.zeros(R, np.int64)
    h2 = np.zeros(R, np.int64)
    pred1 = np.zeros(R, dt)
    pred2 = np.zeros(R, dt)
    last = np.zeros(R, dt)
    for i in range(N):
        v = res_t[i] ^ np.where(codes_t[i] > fcm_max, pred2, pred1)
        t1[base1 + h1] = v
        if e1:
            h1 = ((h1 << e1) ^ (v >> s1).astype(np.int64)) & m1
        pred1 = t1[base1 + h1]
        stride = v - last
        t2[base2 + h2] = stride
        if e2:
            h2 = ((h2 << half) ^ (stride >> s2).astype(np.int64)) & m2
        pred2 = v + t2[base2 + h2]
        last = v
        out[i] = v
    return out.T


def exponents(info: int) -> tuple[int, int]:
    """hash_info → (e1, e2) (fps.c:214-217)."""
    return (info >> 4) << 1, (info & 15) << 1


def decode_chunks(chunks: list[tuple[np.ndarray, str]], bits: int) -> list[np.ndarray]:
    """Decode FP chunks given as (payload bytes, "ref" | "tpu") → one word
    array per chunk, in order."""
    dt = _spec(bits)[0]
    parsed = [None] * len(chunks)
    v2: dict[int, list[int]] = {}
    for k, (p, layout) in enumerate(chunks):
        if layout == "tpu":
            v2.setdefault(_header(p)[1], []).append(k)
        else:
            parsed[k] = parse_ref(p, bits)
    for n, ks in v2.items():
        step = max(1, PARSE_VALUES // max(n, 1))
        for a in range(0, len(ks), step):
            part = ks[a : a + step]
            info, codes, res = parse_v2([chunks[k][0] for k in part], bits)
            for j, k in enumerate(part):
                parsed[k] = (int(info[j]), codes[j], res[j])
    out = [None] * len(chunks)
    by_exp: dict[int, list[int]] = {}
    for k, (info, codes, _) in enumerate(parsed):
        if len(codes) == 0:
            out[k] = np.zeros(0, dt)
        else:
            by_exp.setdefault(info, []).append(k)
    for info, ks in by_exp.items():
        e1, e2 = exponents(info)
        per_row = ((1 << e1) + (1 << e2)) * np.dtype(dt).itemsize
        step = max(1, TABLE_BYTES // per_row)
        for a in range(0, len(ks), step):
            part = ks[a : a + step]
            N = max(len(parsed[k][1]) for k in part)
            codes = np.zeros((len(part), N), np.uint8)
            res = np.zeros((len(part), N), dt)
            for j, k in enumerate(part):
                n = len(parsed[k][1])
                codes[j, :n] = parsed[k][1]
                res[j, :n] = parsed[k][2]
            words = replay(codes, res, e1, e2, bits)
            for j, k in enumerate(part):
                out[k] = words[j, : len(parsed[k][1])].copy()
    return out
