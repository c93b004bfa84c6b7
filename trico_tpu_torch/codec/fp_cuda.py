"""The FP codec's device kernels: CUDA on the H100, plain PyTorch beside each.

Counterpart of ``trico_tpu/codec/fp_pallas.py``. Seven wrappers cover its
nine Pallas kernels, and two more the route that the JAX package leaves to
XLA, the predictor for tables that no kernel holds:

===================  =========================================================
wrapper              replaces (under trico_tpu/codec/)
===================  =========================================================
predict_xors         fp_pallas.py: _predict_window_kernel :85 and
                     _predict_kernel :59
fcm_multi_xors       fp_pallas.py: _fcm_multi_kernel :150
replay               fp_pallas.py: _replay_kernel :216
logshift             fp_pallas.py: _logshift_kernel :275
pair_compact_or      fp_pallas.py: _pair_compact_kernel :323
predict64_xors       fp_pallas.py: _predict64_window_kernel :493 and
                     _predict64_kernel :578
replay64             fp_pallas.py: _replay64_kernel :440
predict_sort_xors    fp_jax.py: _predict_sort :286 (XLA sorts; no Pallas)
predict64_sort_xors  fp64_jax.py: _predict_sort64 :61 (the same)
===================  =========================================================

The kernels are in ``csrc/fp_kernels.cu``. The f32 wrappers take int32
tensors holding u32 words (:mod:`trico_tpu_torch._u32`), the f64 ones int64
tensors holding u64 words (:mod:`trico_tpu_torch._u64`). For a tensor on the
CPU a wrapper runs the plain version (``*_plain``), the same function in
torch ops; for a CUDA tensor it launches the kernel and adds one to
``launches[name]``, or raises. No wrapper falls back from one to the other,
and the predictors' plain version is the twin of both of their kernels.
Whether a predictor's tables fit the window kernel is :func:`tables_fit`,
which the callers ask before they choose it or the sort kernel. A plain
version given CUDA tensors adds one to ``plain_on_card``: the codec never
does that, and ``chip_smoke.py`` holds the count at 0 on the paths it
drives in its own process.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _u32

KERNELS = ("predict_xors", "fcm_multi_xors", "replay", "logshift",
           "pair_compact_or", "predict64_xors", "replay64",
           "predict_sort_xors", "predict64_sort_xors")

# launches[name] counts the kernel launches of each wrapper.
launches = dict.fromkeys(KERNELS, 0)
# calls of a plain version with CUDA tensors (a comparison with its kernel)
plain_on_card = 0

# dynamic shared memory one H100 block can opt into (bytes)
MAX_SMEM = 232448
# exponents one fcm_multi_xors launch takes (kMaxFcm in fp_kernels.cu)
MAX_FCM = 8
# what a replay block needs beside its tables: three stages of its smallest
# tile (32 u64 words and their bcodes, each row padded by 16 bytes;
# ReplayLayout in fp_kernels.cu)
REPLAY_STAGE_BYTES = 960


def reset_launches() -> None:
    """Set every launch count and ``plain_on_card`` to 0."""
    global plain_on_card
    for k in KERNELS:
        launches[k] = 0
    plain_on_card = 0


def _count_plain(t: torch.Tensor) -> None:
    global plain_on_card
    if t.is_cuda:
        plain_on_card += 1


def _norm_exponents(e1: int, e2: int) -> tuple[int, int]:
    """Exponents as the format stores them: even, at most 30."""
    return min((e1 >> 1) << 1, 30), min((e2 >> 1) << 1, 30)


def tables_fit(exps, word_bytes: int = 4) -> bool:
    """True when hash tables of 2^e words of ``word_bytes`` each, one per
    exponent in ``exps``, fit one block's shared memory: what a predictor
    kernel holds for one chunk (a replay block needs ``REPLAY_STAGE_BYTES``
    more for its tiles)."""
    return sum(1 << e for e in exps) * word_bytes <= MAX_SMEM


def _need_fit(name: str, exps, word_bytes: int, extra: int = 0) -> None:
    if sum(1 << e for e in exps) * word_bytes + extra > MAX_SMEM:
        raise ValueError(f"{name}: tables of exponents {tuple(exps)} exceed "
                         "one block's shared memory")


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True for CPU tensors; False for CUDA tensors; raises otherwise."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, "
                     f"got {sorted(str(t.device) for t in ts)}")


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous 2-D {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _launch(name: str, fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1


def _lib():
    from . import _build

    return _build.lib()


# ---------------------------------------------------------------------------
# plain formulations, shared by the f32 and f64 twins. Words are int64: a u32
# word widened to 0..2^32-1, or a u64 word's bits; ``wrap`` masks a sum or
# difference back to the word (& -1 keeps all 64 bits, which wrap by
# themselves).
# ---------------------------------------------------------------------------


def _wrap(bits: int) -> int:
    return _u32.MASK if bits == 32 else -1


def _top(x: torch.Tensor, e: int, bits: int) -> torch.Tensor:
    """Top e bits of words of ``bits`` bits; 0 when e == 0."""
    return (x >> (bits - e)) & ((1 << e) - 1) if e else torch.zeros_like(x)


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """x moved k positions along axis 1, zero-filled at the front."""
    out = torch.zeros_like(x)
    if k < x.shape[1]:
        out[:, k:] = x[:, : x.shape[1] - k]
    return out


def _prev_occurrence(keys: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """out[c, i] = payload[c, j] for the largest j < i with keys[c, j] ==
    keys[c, i], else 0: a table read after sequential writes, from one stable
    sort per row (as ``fp_jax._prev_occurrence_multi``)."""
    sk, order = torch.sort(keys, dim=1, stable=True)
    ps = torch.gather(payload, 1, order)
    same = torch.zeros_like(sk, dtype=torch.bool)
    same[:, 1:] = sk[:, 1:] == sk[:, :-1]
    pred_s = torch.where(same, _shift_right(ps, 1), 0)
    return torch.empty_like(payload).scatter_(1, order, pred_s)


def _predict_words(v: torch.Tensor, e1: int, e2: int, bits: int):
    """(FCM xor, DFCM xor) of (C, L) words, closed-form previous occurrence.

    FCM key at i: top e1 bits of v[i-1]; DFCM key: t[i-1] ^ ((t[i-2] << e2/2)
    & m2) with t the top e2 bits of the stride (fp_pallas.py:89-100, :497-508);
    a zero exponent keeps its key at 0."""
    wrap = _wrap(bits)
    vprev = _shift_right(v, 1)
    s = (v - vprev) & wrap
    k1 = _top(vprev, e1, bits)
    t = _top(s, e2, bits)
    k2 = _shift_right(t, 1) ^ ((_shift_right(t, 2) << (e2 // 2)) & ((1 << e2) - 1))
    pred1 = _prev_occurrence(k1, v)
    pred2 = _prev_occurrence(k2, s)
    return v ^ pred1, v ^ ((vprev + pred2) & wrap)


def _replay_words(x: torch.Tensor, dfcm: torch.Tensor, e1: int, e2: int,
                  bits: int) -> torch.Tensor:
    """Decode replay of (C, L) xor words, one position per step, vectorised
    across chunks; ``dfcm`` marks the values coded against the DFCM
    prediction."""
    wrap = _wrap(bits)
    C, L = x.shape
    dev = x.device
    t1 = torch.zeros((C, 1 << e1), dtype=torch.int64, device=dev)
    t2 = torch.zeros((C, 1 << e2), dtype=torch.int64, device=dev)
    z = torch.zeros((C, 1), dtype=torch.int64, device=dev)
    h1, h2, pred1, pred2, last = z, z, z, z, z
    m2 = (1 << e2) - 1
    out = torch.empty((C, L), dtype=torch.int64, device=dev)
    for i in range(L):
        pred = torch.where(dfcm[:, i : i + 1], (last + pred2) & wrap, pred1)
        v = x[:, i : i + 1] ^ pred
        out[:, i : i + 1] = v
        t1.scatter_(1, h1, v)
        if e1:
            h1 = _top(v, e1, bits)
        pred1 = t1.gather(1, h1)
        stride = (v - last) & wrap
        t2.scatter_(1, h2, stride)
        if e2:
            h2 = ((h2 << (e2 // 2)) ^ _top(stride, e2, bits)) & m2
        pred2 = t2.gather(1, h2)
        last = v
    return out


# ---------------------------------------------------------------------------
# predict_xors and predict64_xors
# ---------------------------------------------------------------------------


def predict_xors_plain(values: torch.Tensor, e1: int, e2: int):
    """(C, L) int32 words → (FCM xor, DFCM xor), by sorts (the counterpart
    of ``fp_jax._predict_sort``)."""
    _count_plain(values)
    e1, e2 = _norm_exponents(e1, e2)
    x1, x2 = _predict_words(_u32.widen(values), e1, e2, 32)
    return _u32.narrow(x1), _u32.narrow(x2)


def predict64_xors_plain(values: torch.Tensor, e1: int, e2: int):
    """(C, L) int64 words → (FCM xor, DFCM xor), by sorts (the counterpart
    of ``fp64_jax._predict_sort64``)."""
    _count_plain(values)
    e1, e2 = _norm_exponents(e1, e2)
    return _predict_words(values, e1, e2, 64)


def _predict_launch(name: str, fn, values: torch.Tensor, e1: int, e2: int):
    C, L = values.shape
    xor1, xor2 = torch.empty_like(values), torch.empty_like(values)
    if values.numel():
        _launch(name, fn, values.data_ptr(), xor1.data_ptr(), xor2.data_ptr(),
                C, L, e1, e2, device=values.device)
    return xor1, xor2


def predict_xors(values: torch.Tensor, e1: int, e2: int):
    """(C, L) int32 words → (xor1, xor2) (C, L): each value XOR its FCM
    prediction, and XOR (previous value + its DFCM stride prediction), with
    fresh tables per chunk."""
    e1, e2 = _norm_exponents(e1, e2)
    _check(values, torch.int32, "predict_xors values")
    if _on_cpu(values):
        return predict_xors_plain(values, e1, e2)
    _need_fit("predict_xors", (e1, e2), 4)
    return _predict_launch("predict_xors", _lib().tt_predict_xors, values,
                           e1, e2)


def predict64_xors(values: torch.Tensor, e1: int, e2: int):
    """(C, L) int64 words → (xor1, xor2) (C, L): :func:`predict_xors` on
    u64 words, with u64 tables."""
    e1, e2 = _norm_exponents(e1, e2)
    _check(values, torch.int64, "predict64_xors values")
    if _on_cpu(values):
        return predict64_xors_plain(values, e1, e2)
    _need_fit("predict64_xors", (e1, e2), 8)
    return _predict_launch("predict64_xors", _lib().tt_predict64_xors, values,
                           e1, e2)


# ---------------------------------------------------------------------------
# predict_sort_xors and predict64_sort_xors
# ---------------------------------------------------------------------------


def _sort_launch(name: str, values: torch.Tensor, e1: int, e2: int):
    C, L = values.shape
    xor1, xor2 = torch.empty_like(values), torch.empty_like(values)
    if values.numel():
        lib = _lib()
        need = lib.tt_predict_sort_scratch(C, L, e1, e2, values.element_size())
        if need < 0:
            raise ValueError(f"{name}: no launch takes rows of {L} values")
        # composites of rows too long for shared memory (0 bytes otherwise);
        # freed on return, it is reused only by work queued after the kernel
        # on the same stream
        scratch = torch.empty(need, dtype=torch.uint8, device=values.device)
        _launch(name, getattr(lib, f"tt_{name}"), values.data_ptr(),
                xor1.data_ptr(), xor2.data_ptr(), C, L, e1, e2,
                scratch.data_ptr(), need, device=values.device)
    return xor1, xor2


def predict_sort_xors(values: torch.Tensor, e1: int, e2: int):
    """(C, L) int32 words → (xor1, xor2): :func:`predict_xors` for tables of
    any size, by a sort of each chunk's keys (no table is held). Its plain
    version is :func:`predict_xors_plain`."""
    e1, e2 = _norm_exponents(e1, e2)
    _check(values, torch.int32, "predict_sort_xors values")
    if _on_cpu(values):
        return predict_xors_plain(values, e1, e2)
    return _sort_launch("predict_sort_xors", values, e1, e2)


def predict64_sort_xors(values: torch.Tensor, e1: int, e2: int):
    """(C, L) int64 words → (xor1, xor2): :func:`predict_sort_xors` on u64
    words. Its plain version is :func:`predict64_xors_plain`."""
    e1, e2 = _norm_exponents(e1, e2)
    _check(values, torch.int64, "predict64_sort_xors values")
    if _on_cpu(values):
        return predict64_xors_plain(values, e1, e2)
    return _sort_launch("predict64_sort_xors", values, e1, e2)


# ---------------------------------------------------------------------------
# fcm_multi_xors
# ---------------------------------------------------------------------------


def fcm_multi_xors_plain(values: torch.Tensor, e1s: tuple):
    """One FCM xor per exponent in ``e1s``, one sort each."""
    _count_plain(values)
    v = _u32.widen(values)
    vprev = _shift_right(v, 1)
    return tuple(_u32.narrow(v ^ _prev_occurrence(_top(vprev, e, 32), v))
                 for e in e1s)


def fcm_multi_xors(values: torch.Tensor, e1s):
    """(C, L) int32 words → a tuple of (C, L) FCM xors, one per exponent in
    ``e1s``, from one pass over the chunks. Each exponent is 2..30 (e1 = 0
    is ``v ^ vprev``, which the caller computes)."""
    e1s = tuple(e1s)
    if not 0 < len(e1s) <= MAX_FCM or any(not 2 <= e <= 30 for e in e1s):
        raise ValueError(f"fcm_multi_xors: need 1..{MAX_FCM} exponents in "
                         f"2..30, got {e1s}")
    _check(values, torch.int32, "fcm_multi_xors values")
    if _on_cpu(values):
        return fcm_multi_xors_plain(values, e1s)
    _need_fit("fcm_multi_xors", e1s, 4)
    C, L = values.shape
    out = torch.empty((len(e1s), C, L), dtype=torch.int32, device=values.device)
    if values.numel():
        exps = (ctypes.c_int * len(e1s))(*e1s)
        _launch("fcm_multi_xors", _lib().tt_fcm_multi_xors, values.data_ptr(),
                out.data_ptr(), C, L, len(e1s), exps, device=values.device)
    return tuple(out.unbind(0))


# ---------------------------------------------------------------------------
# replay and replay64
# ---------------------------------------------------------------------------


def replay_plain(bcodes: torch.Tensor, xors: torch.Tensor, e1: int, e2: int):
    """f32 decode replay; bcodes above 4 are DFCM (fcm_max = 4)."""
    _count_plain(xors)
    e1, e2 = _norm_exponents(e1, e2)
    return _u32.narrow(_replay_words(_u32.widen(xors), bcodes > 4, e1, e2, 32))


def replay64_plain(bcodes: torch.Tensor, xors: torch.Tensor, e1: int, e2: int):
    """f64 decode replay; bcodes above 8 are DFCM (fcm_max = 8)."""
    _count_plain(xors)
    e1, e2 = _norm_exponents(e1, e2)
    return _replay_words(xors, bcodes > 8, e1, e2, 64)


def _replay_launch(name: str, bcodes, xors, e1, e2, dtype, word_bytes, plain,
                   G: int = 0, T: int = 0):
    e1, e2 = _norm_exponents(e1, e2)
    _check(bcodes, torch.uint8, f"{name} bcodes")
    _check(xors, dtype, f"{name} xors")
    if bcodes.shape != xors.shape:
        raise ValueError(f"{name}: bcodes and xors differ in shape")
    if _on_cpu(bcodes, xors):
        return plain(bcodes, xors, e1, e2)
    _need_fit(name, (e1, e2), word_bytes, REPLAY_STAGE_BYTES)
    C, L = xors.shape
    out = torch.empty_like(xors)
    if xors.numel():
        _launch(name, getattr(_lib(), f"tt_{name}"), bcodes.data_ptr(),
                xors.data_ptr(), out.data_ptr(), C, L, e1, e2, G, T,
                device=xors.device)
    return out


def replay(bcodes: torch.Tensor, xors: torch.Tensor, e1: int, e2: int,
           G: int = 0, T: int = 0):
    """(C, L) uint8 bcodes and int32 residual xors → (C, L) int32 values.
    ``G`` chunks per warp and tiles of ``T`` values are the kernel's to choose
    (0); a measurement may name them (G in 1..32, T a multiple of 16)."""
    return _replay_launch("replay", bcodes, xors, e1, e2, torch.int32, 4,
                          replay_plain, G, T)


def replay64(bcodes: torch.Tensor, xors: torch.Tensor, e1: int, e2: int,
             G: int = 0, T: int = 0):
    """(C, L) uint8 bcodes and int64 residual xors → (C, L) int64 values;
    ``G`` and ``T`` as in :func:`replay`."""
    return _replay_launch("replay64", bcodes, xors, e1, e2, torch.int64, 8,
                          replay64_plain, G, T)


# ---------------------------------------------------------------------------
# logshift
# ---------------------------------------------------------------------------


def _nbits(S: int) -> int:
    return max(S - 1, 1).bit_length()


def logshift_plain(word: torch.Tensor, pb: int, direction: str):
    """Move each live ``shift << pb | payload`` word (0 = dead) ``shift``
    lanes left or right; return the payloads, 0 where nothing landed."""
    _count_plain(word)
    C, S = word.shape
    w = _u32.widen(word)
    shift = (w >> pb) & ((1 << _nbits(S)) - 1)
    lanes = torch.arange(S, device=word.device)
    dest = lanes - shift if direction == "left" else lanes + shift
    ok = (w != 0) & (dest >= 0) & (dest < S)
    rows = torch.arange(C, device=word.device)[:, None].expand(C, S)
    out = torch.zeros_like(w)
    out[rows[ok], dest[ok]] = w[ok] & ((1 << pb) - 1)
    return _u32.narrow(out)


# slots of the longest row a logshift launch takes (kMaxSlots in fp_kernels.cu)
MAX_SLOTS = 1 << 30


def logshift(word: torch.Tensor, pb: int, direction: str):
    """Monotone left compaction or right expansion of (C, S) packed words;
    the caller guarantees that no two live words share a destination."""
    if direction not in ("left", "right"):
        raise ValueError(f"direction must be 'left' or 'right', got {direction!r}")
    _check(word, torch.int32, "logshift word")
    C, S = word.shape
    if pb < 1 or pb + _nbits(S) > 32:
        raise ValueError(f"logshift: {pb} payload bits + {_nbits(S)} shift "
                         f"bits do not fit a u32 word")
    if _on_cpu(word):
        return logshift_plain(word, pb, direction)
    if S > MAX_SLOTS:
        raise ValueError(f"logshift: rows of {S} slots exceed {MAX_SLOTS}")
    out = torch.empty_like(word)
    if word.numel():
        _launch("logshift", _lib().tt_logshift, word.data_ptr(),
                out.data_ptr(), C, S, pb, _nbits(S),
                int(direction == "right"), device=word.device)
    return out


# ---------------------------------------------------------------------------
# pair_compact_or
# ---------------------------------------------------------------------------


def pair_compact_or_plain(carrier: torch.Tensor, payload: torch.Tensor,
                          nbits: int):
    """Each live carrier ``disp << 1 | 1`` moves its payload to lane s - disp;
    payloads that meet are ORed (bit by bit, with a max-scatter per bit)."""
    _count_plain(carrier)
    C, S = carrier.shape
    c = _u32.widen(carrier)
    disp = c >> 1
    lanes = torch.arange(S, device=carrier.device)
    ok = ((c & 1) == 1) & ((disp >> nbits) == 0) & (disp <= lanes)
    rows = torch.arange(C, device=carrier.device)[:, None] * S
    dest = (rows + lanes - disp)[ok]
    p = _u32.widen(payload)[ok]
    out = torch.zeros(C * S, dtype=torch.int64, device=carrier.device)
    for b in range(32):
        plane = torch.zeros_like(out).scatter_reduce_(
            0, dest, (p >> b) & 1, "amax")
        out |= plane << b
    return _u32.narrow(out.view(C, S))


def pair_compact_or(carrier: torch.Tensor, payload: torch.Tensor, nbits: int):
    """Merging monotone left compaction of (C, S) (carrier, payload) rows:
    what ``pair_compact_or_pallas`` returns, ``where(carrier == 1, payload,
    0)`` after its ``nbits``-pass network."""
    _check(carrier, torch.int32, "pair_compact_or carrier")
    _check(payload, torch.int32, "pair_compact_or payload")
    if carrier.shape != payload.shape:
        raise ValueError("pair_compact_or: carrier and payload differ in shape")
    if _on_cpu(carrier, payload):
        return pair_compact_or_plain(carrier, payload, nbits)
    C, S = carrier.shape
    out = torch.empty_like(carrier)
    if carrier.numel():
        _launch("pair_compact_or", _lib().tt_pair_compact_or,
                carrier.data_ptr(), payload.data_ptr(), out.data_ptr(), C, S,
                nbits, device=carrier.device)
    return out
