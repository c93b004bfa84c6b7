"""Reference (NumPy) implementation of the trico FCM/DFCM floating-point stream codec.

Format semantics match the reference C implementation
(`trico/floating_point_stream_compression.c`):

* substream = ``[u8 hash_info][u32 big-endian count]`` then packed groups
  (f32: groups of 8 values with a 3-byte tag of eight 3-bit bcodes; f64: groups of
  2 values with a 1-byte tag of two 4-bit bcodes), residuals stored big-endian with
  only their low ``n`` bytes (fps.c:12-74, 421-561).
* two predictors run in lockstep: FCM (value hash table) and DFCM (stride hash
  table); the residual is ``value XOR prediction`` (fps.c:128-195, 617-788).
* f32 bcodes: 0 = FCM residual 0; 1..4 = FCM residual in that many bytes;
  5..7 = DFCM residual in 1..3 bytes (DFCM chosen iff strictly fewer bytes).
* f64 bcodes: 0..8 = FCM in 0..8 bytes, 9..15 = DFCM in 1..7 bytes.
* the final partial group is padded with ``bcode=1, xor=0`` sentinel slots
  (fps.c:196-204, 789-794); a zero residual always takes bcode 0, so the sentinel
  is unambiguous.

The port's own copy of ``trico_tpu/codec/fp_ref.py``: the oracle of the tests
and the host codec's fallback where the C++ library is missing.

The big idea that makes this implementation *vectorized* (and that powers the
device predictors in :mod:`trico_tpu_torch.codec.fp_cuda`): the reference hash recurrences
degenerate to **closed forms** because ``(hash << e) & (2**e - 1) == 0``:

* FCM hash after step i is just the top ``e1`` bits of ``value[i]``; so the
  table slot read/written at step i depends only on ``value[i-1]``.
* DFCM hash keeps only ``e2/2`` low bits of the previous hash, which themselves
  are the low ``e2/2`` bits of ``stride[i-1] >> (32-e2)``; so the slot at step i
  depends only on ``stride[i-2], stride[i-1]``.

Hence every table *slot* (key) is computable in parallel from the raw values, and
the prediction is "value at the most recent previous position with the same key"
— a problem solvable with one stable sort (see :func:`prev_occurrence`).
Encoding is therefore embarrassingly parallel; only decoding is sequential
(decoded values feed back into the keys).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "fcm_dfcm_keys",
    "prev_occurrence",
    "predictions",
    "compress",
    "decompress",
    "compressed_bound",
]

# Per-bcode residual byte lengths.
_LEN32 = np.array([0, 1, 2, 3, 4, 1, 2, 3], dtype=np.int64)
_LEN64 = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4, 5, 6, 7], dtype=np.int64)


def _norm_exponents(e1: int, e2: int) -> tuple[int, int]:
    """Reference clamps exponents to even values <= 30 (fps.c:88-93)."""
    e1 = min((e1 >> 1) << 1, 30)
    e2 = min((e2 >> 1) << 1, 30)
    return e1, e2


def fcm_dfcm_keys(values: np.ndarray, e1: int, e2: int):
    """Compute, in parallel, the FCM and DFCM hash-table slots used at each step.

    ``values`` is a 1-D uint32 or uint64 array of raw float bits. Returns
    ``(k1, k2, strides)`` where ``k1[i]``/``k2[i]`` is the table slot that step i
    both *reads* its prediction from and *writes* its value/stride to, matching
    the sequential reference recurrence (fps.c:133-143). ``strides`` is the
    wrapped difference stream (``values[i] - values[i-1]``, ``values[-1] == 0``).
    """
    dt = values.dtype
    assert dt in (np.uint32, np.uint64)
    bits = 32 if dt == np.uint32 else 64
    n = len(values)
    k1 = np.zeros(n, dtype=dt)
    k2 = np.zeros(n, dtype=dt)
    prev = np.zeros(n, dtype=dt)
    if n > 1:
        prev[1:] = values[:-1]
    strides = (values - prev).astype(dt)  # wraps mod 2**bits
    if n == 0:
        return k1, k2, strides
    if e1 > 0:
        # hash1 after step i == top e1 bits of values[i]; slot at step i uses i-1.
        k1[1:] = (values[:-1] >> dt.type(bits - e1)) & dt.type((1 << e1) - 1)
        # k1[0] stays 0 (initial hash state).
    if e2 > 0:
        half = e2 // 2
        halfmask = dt.type((1 << half) - 1)
        mask2 = dt.type((1 << e2) - 1)
        top = (strides >> dt.type(bits - e2)) & mask2
        # hash2 after step i = ((low-half-bits of top[i-1]) << half) ^ top[i]
        h2_after = top.copy()
        if n > 1:
            h2_after[1:] = (((top[:-1] & halfmask) << dt.type(half)) ^ top[1:]) & mask2
        # slot used at step i is the hash state *before* step i's update.
        k2[1:] = h2_after[:-1]
    return k1, k2, strides


def prev_occurrence(keys: np.ndarray, values: np.ndarray) -> np.ndarray:
    """For each i, return ``values[j]`` for the largest ``j < i`` with
    ``keys[j] == keys[i]``, else 0 (the hash tables start zeroed).

    One stable argsort turns the hash-table recurrence into a neighbour lookup:
    after sorting by key, equal keys are adjacent in original order, so the
    previous occurrence is simply the left neighbour within the run.
    """
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=values.dtype)
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    prev_idx_sorted = np.full(n, -1, dtype=np.int64)
    same = ks[1:] == ks[:-1]
    prev_idx_sorted[1:][same] = order[:-1][same]
    prev_idx = np.empty(n, dtype=np.int64)
    prev_idx[order] = prev_idx_sorted
    out = values[np.maximum(prev_idx, 0)]
    out[prev_idx < 0] = 0
    return out


def predictions(values: np.ndarray, e1: int, e2: int):
    """Vectorized FCM/DFCM predictions for an entire stream.

    Returns ``(pred1, pred2)`` where ``pred1[i]`` is the FCM prediction XOR'd
    against ``values[i]`` and ``pred2[i]`` the DFCM prediction (already
    including the ``last_value`` term, fps.c:139).
    """
    dt = values.dtype
    k1, k2, strides = fcm_dfcm_keys(values, e1, e2)
    pred1 = prev_occurrence(k1, values)
    stride_pred = prev_occurrence(k2, strides)
    prev = np.zeros_like(values)
    if len(values) > 1:
        prev[1:] = values[:-1]
    pred2 = (prev + stride_pred).astype(dt)
    return pred1, pred2


def _bcodes_f32(xor1: np.ndarray, xor2: np.ndarray) -> np.ndarray:
    nb1 = np.select(
        [xor1 == 0, xor1 >> 8 == 0, xor1 >> 16 == 0, xor1 >> 24 == 0],
        [0, 1, 2, 3],
        default=4,
    )
    nb2 = np.select([xor2 >> 8 == 0, xor2 >> 16 == 0, xor2 >> 24 == 0], [1, 2, 3], default=4)
    use_dfcm = (nb1 >= 2) & (nb2 < nb1)
    return np.where(use_dfcm, 4 + nb2, nb1).astype(np.int64)


def _bcodes_f64(xor1: np.ndarray, xor2: np.ndarray) -> np.ndarray:
    c1 = [xor1 == 0] + [(xor1 >> (8 * k)) == 0 for k in range(1, 8)]
    nb1 = np.select(c1, list(range(8)), default=8)
    c2 = [(xor2 >> (8 * k)) == 0 for k in range(1, 8)]
    nb2 = np.select(c2, list(range(1, 8)), default=8)
    use_dfcm = (nb1 >= 2) & (nb2 < nb1) & (nb2 <= 7)
    return np.where(use_dfcm, 8 + nb2, nb1).astype(np.int64)


def compressed_bound(n: int, bits: int) -> int:
    """Worst-case compressed size (header + tags + residuals + pad).

    Fixes reference quirk #4 (SURVEY.md): the reference underestimates by the
    5-byte header and the tail-pad bytes (fps.c:95, 585).
    """
    if bits == 32:
        groups = (n + 7) // 8
        return 5 + 3 * max(groups, 0) + 4 * n + 7
    groups = (n + 1) // 2
    return 5 + max(groups, 0) + 8 * n + 8


def compress(values: np.ndarray, e1: int | None = None, e2: int | None = None) -> bytes:
    """Compress a 1-D float32/float64 (or uint32/uint64 raw-bits) stream.

    Produces bytes bit-identical to the reference encoder
    (``trico_compress`` fps.c:86-210 / ``trico_compress_double_precision``
    fps.c:576-800), including the hash_info byte, big-endian count, tag packing,
    big-endian truncated residuals and tail sentinel padding.
    """
    values = np.asarray(values)
    if values.dtype == np.float32:
        values = values.view(np.uint32)
    elif values.dtype == np.float64:
        values = values.view(np.uint64)
    if values.dtype == np.uint32:
        bits = 32
        if e1 is None:
            e1, e2 = 4, 10
    elif values.dtype == np.uint64:
        bits = 64
        if e1 is None:
            e1, e2 = 20, 20
    else:
        raise TypeError(f"unsupported dtype {values.dtype}")
    e1, e2 = _norm_exponents(e1, e2)
    n = len(values)

    pred1, pred2 = predictions(values, e1, e2)
    xor1 = values ^ pred1
    xor2 = values ^ pred2

    if bits == 32:
        bcode = _bcodes_f32(xor1, xor2)
        group, lens = 8, _LEN32
        tag_bytes = 3
    else:
        bcode = _bcodes_f64(xor1, xor2)
        group, lens = 2, _LEN64
        tag_bytes = 1

    res = np.where(bcode <= (4 if bits == 32 else 8), xor1, xor2)

    header = bytes([((e1 >> 1) << 4) | (e2 >> 1)]) + int(n).to_bytes(4, "big")
    if n == 0:
        return header

    # Pad the tail group with the bcode=1, xor=0 sentinel (fps.c:196-204).
    pad = (-n) % group
    if pad:
        bcode = np.concatenate([bcode, np.ones(pad, dtype=np.int64)])
        res = np.concatenate([res, np.zeros(pad, dtype=res.dtype)])
    P = n + pad
    G = P // group
    length = lens[bcode]

    # Byte layout: header | per group: tag + that group's residual bytes.
    res_before = np.concatenate([[0], np.cumsum(length)])  # exclusive prefix
    data_off = 5 + tag_bytes * (np.arange(P) // group + 1) + res_before[:-1]
    total = 5 + tag_bytes * G + int(res_before[-1])

    out = np.zeros(total, dtype=np.uint8)
    out[:5] = np.frombuffer(header, dtype=np.uint8)

    # Tags.
    bc_mat = bcode.reshape(G, group)
    tag_off = 5 + tag_bytes * np.arange(G) + res_before[::group][:-1]
    if bits == 32:
        bc = np.zeros(G, dtype=np.uint32)
        for j in range(8):
            bc |= bc_mat[:, j].astype(np.uint32) << (3 * j)
        out[tag_off] = (bc >> 16).astype(np.uint8)
        out[tag_off + 1] = (bc >> 8).astype(np.uint8)
        out[tag_off + 2] = bc.astype(np.uint8)
    else:
        out[tag_off] = (bc_mat[:, 0] | (bc_mat[:, 1] << 4)).astype(np.uint8)

    # Residual bytes, big-endian, low `length` bytes only.
    maxb = 4 if bits == 32 else 8
    k = np.arange(maxb)
    shift = (8 * (length[:, None] - 1 - k[None, :])).clip(min=0).astype(res.dtype)
    byte_mat = ((res[:, None] >> shift) & res.dtype.type(0xFF)).astype(np.uint8)
    valid = k[None, :] < length[:, None]
    flat_pos = (data_off[:, None] + k[None, :])[valid]
    out[flat_pos] = byte_mat[valid]
    return out.tobytes()


def _parse_stream(data: np.ndarray, n: int, bits: int):
    """Parse tags + residuals into per-value ``(bcode, xor)`` arrays.

    Group-by-group loop: each group's tag determines its residual lengths, which
    locate the next tag. Vectorized within groups.
    """
    group = 8 if bits == 32 else 2
    dt = np.uint32 if bits == 32 else np.uint64
    maxb = 4 if bits == 32 else 8
    lens = _LEN32 if bits == 32 else _LEN64
    P = ((n + group - 1) // group) * group
    bcodes = np.zeros(P, dtype=np.int64)
    xors = np.zeros(P, dtype=dt)
    pos = 5
    shifts = (np.arange(maxb) * 8).astype(dt)
    for g in range(P // group):
        s = g * group
        if bits == 32:
            bc = (int(data[pos]) << 16) | (int(data[pos + 1]) << 8) | int(data[pos + 2])
            pos += 3
            b = (bc >> (3 * np.arange(8))) & 7
        else:
            bc = int(data[pos])
            pos += 1
            b = np.array([bc & 15, (bc >> 4) & 15])
        L = lens[b]
        ends = np.cumsum(L)
        total = int(ends[-1])
        chunk = data[pos : pos + total].astype(dt)
        pos += total
        # big-endian: value = sum(chunk[start+k] << 8*(L-1-k))
        for j in range(group):
            l = int(L[j])
            if l:
                seg = chunk[ends[j] - l : ends[j]]
                xors[s + j] = np.bitwise_or.reduce(seg << shifts[l - 1 :: -1])
        bcodes[s : s + group] = b
    return bcodes[:n], xors[:n]


def decompress(data: bytes | np.ndarray):
    """Decompress a reference FP substream. Returns a uint32 or uint64 array.

    The dtype is inferred from ``dtype_bits``; callers know stream width from
    the archive stream type. Mirrors ``trico_decompress`` (fps.c:212-417) /
    ``trico_decompress_double_precision`` (fps.c:803-1164).
    """
    raise NotImplementedError("use decompress_f32 / decompress_f64")


def _replay(bcodes, xors, n, bits, e1, e2):
    """Sequential predictor replay (decode is inherently serial).

    Python-int loop — oracle speed only; production decode uses the native C++
    codec or the chunk-parallel JAX path.
    """
    mask = (1 << bits) - 1
    fcm_thresh = 4 if bits == 32 else 8
    t1: dict = {}
    t2: dict = {}
    m1 = (1 << e1) - 1
    m2 = (1 << e2) - 1
    h1 = h2 = pred1 = pred2 = last = 0
    half = e2 // 2
    out = np.empty(n, dtype=np.uint32 if bits == 32 else np.uint64)
    bl = bcodes.tolist()
    xl = xors.tolist()
    for i in range(n):
        p = pred2 if bl[i] > fcm_thresh else pred1
        v = xl[i] ^ p
        t1[h1] = v
        h1 = ((h1 << e1) ^ (v >> (bits - e1))) & m1 if e1 else 0
        pred1 = t1.get(h1, 0)
        stride = (v - last) & mask
        t2[h2] = stride
        h2 = ((h2 << half) ^ (stride >> (bits - e2))) & m2 if e2 else 0
        pred2 = (v + t2.get(h2, 0)) & mask
        last = v
        out[i] = v
    return out


def _decompress_bits(data, bits):
    data = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    hash_info = int(data[0])
    e1 = (hash_info >> 4) << 1
    e2 = (hash_info & 15) << 1
    n = int.from_bytes(data[1:5].tobytes(), "big")
    bcodes, xors = _parse_stream(data, n, bits)
    return _replay(bcodes, xors, n, bits, e1, e2)


def decompress_f32(data) -> np.ndarray:
    """Decode an f32 substream → uint32 raw-bits array (view as float32)."""
    return _decompress_bits(data, 32)


def decompress_f64(data) -> np.ndarray:
    """Decode an f64 substream → uint64 raw-bits array (view as float64)."""
    return _decompress_bits(data, 64)
