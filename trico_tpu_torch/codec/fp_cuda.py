"""The f32 codec's device kernels: CUDA on the H100, plain PyTorch beside each.

Counterpart of ``trico_tpu/codec/fp_pallas.py``. Four wrappers cover the five
Pallas kernels the f32 v2 main path reaches:

==================  ==========================================================
wrapper             replaces (trico_tpu/codec/fp_pallas.py)
==================  ==========================================================
predict_xors        _predict_window_kernel :85 and _predict_kernel :59
replay              _replay_kernel :216
logshift            _logshift_kernel :275
pair_compact_or     _pair_compact_kernel :323
==================  ==========================================================

The kernels are in ``csrc/fp_kernels.cu``. Each wrapper takes int32 tensors
holding u32 words (see :mod:`trico_tpu_torch._u32`). For a tensor on the CPU
it runs the plain version (``*_plain``), the same function in torch ops; for a
CUDA tensor it launches the kernel and adds one to ``launches[name]``, or
raises. No wrapper falls back from one to the other.
"""

from __future__ import annotations

import torch

from .. import _u32

KERNELS = ("predict_xors", "replay", "logshift", "pair_compact_or")

# launches[name] counts the kernel launches of each wrapper.
launches = dict.fromkeys(KERNELS, 0)

# dynamic shared memory one H100 block can opt into (bytes)
MAX_SMEM = 232448


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def _norm_exponents(e1: int, e2: int) -> tuple[int, int]:
    """Exponents as the format stores them: even, at most 30."""
    return min((e1 >> 1) << 1, 30), min((e2 >> 1) << 1, 30)


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


def _table_bytes(e1: int, e2: int) -> int:
    return ((1 << e1) + (1 << e2)) * 4


# ---------------------------------------------------------------------------
# predict_xors
# ---------------------------------------------------------------------------


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


def predict_xors_plain(values: torch.Tensor, e1: int, e2: int):
    """(C, L) words → (FCM xor, DFCM xor), closed-form previous occurrence.

    FCM key at i: top e1 bits of v[i-1]; DFCM key: t[i-1] ^ ((t[i-2] << e2/2)
    & m2) with t the top e2 bits of the stride (fp_pallas.py:89-100); a zero
    exponent keeps its key at 0."""
    e1, e2 = _norm_exponents(e1, e2)
    v = _u32.widen(values)
    vprev = _shift_right(v, 1)
    s = (v - vprev) & _u32.MASK
    k1 = vprev >> (32 - e1) if e1 else torch.zeros_like(v)
    if e2:
        t = s >> (32 - e2)
        k2 = _shift_right(t, 1) ^ ((_shift_right(t, 2) << (e2 // 2))
                                   & ((1 << e2) - 1))
    else:
        k2 = torch.zeros_like(v)
    pred1 = _prev_occurrence(k1, v)
    pred2 = _prev_occurrence(k2, s)
    return _u32.narrow(v ^ pred1), _u32.narrow(v ^ (vprev + pred2))


def predict_xors(values: torch.Tensor, e1: int, e2: int):
    """(C, L) int32 words → (xor1, xor2) (C, L): each value XOR its FCM
    prediction, and XOR (previous value + its DFCM stride prediction), with
    fresh tables per chunk."""
    e1, e2 = _norm_exponents(e1, e2)
    _check(values, torch.int32, "predict_xors values")
    if _on_cpu(values):
        return predict_xors_plain(values, e1, e2)
    if _table_bytes(e1, e2) > MAX_SMEM:
        raise ValueError(f"predict_xors: tables of ({e1},{e2}) exceed one "
                         f"block's shared memory")
    C, L = values.shape
    xor1, xor2 = torch.empty_like(values), torch.empty_like(values)
    if values.numel():
        _launch("predict_xors", _lib().tt_predict_xors, values.data_ptr(),
                xor1.data_ptr(), xor2.data_ptr(), C, L, e1, e2,
                device=values.device)
    return xor1, xor2


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


def replay_plain(bcodes: torch.Tensor, xors: torch.Tensor, e1: int, e2: int):
    """Decode replay, one position per step, vectorised across chunks."""
    e1, e2 = _norm_exponents(e1, e2)
    C, L = xors.shape
    dev = xors.device
    x = _u32.widen(xors)
    dfcm = bcodes > 4  # fcm_max = 4
    t1 = torch.zeros((C, 1 << e1), dtype=torch.int64, device=dev)
    t2 = torch.zeros((C, 1 << e2), dtype=torch.int64, device=dev)
    z = torch.zeros((C, 1), dtype=torch.int64, device=dev)
    h1, h2, pred1, pred2, last = z, z, z, z, z
    m2 = (1 << e2) - 1
    out = torch.empty((C, L), dtype=torch.int64, device=dev)
    for i in range(L):
        pred = torch.where(dfcm[:, i : i + 1], (last + pred2) & _u32.MASK, pred1)
        v = x[:, i : i + 1] ^ pred
        out[:, i : i + 1] = v
        t1.scatter_(1, h1, v)
        if e1:
            h1 = v >> (32 - e1)
        pred1 = t1.gather(1, h1)
        stride = (v - last) & _u32.MASK
        t2.scatter_(1, h2, stride)
        if e2:
            h2 = ((h2 << (e2 // 2)) ^ (stride >> (32 - e2))) & m2
        pred2 = t2.gather(1, h2)
        last = v
    return _u32.narrow(out)


def replay(bcodes: torch.Tensor, xors: torch.Tensor, e1: int, e2: int):
    """(C, L) uint8 bcodes and int32 residual xors → (C, L) int32 values."""
    e1, e2 = _norm_exponents(e1, e2)
    _check(bcodes, torch.uint8, "replay bcodes")
    _check(xors, torch.int32, "replay xors")
    if bcodes.shape != xors.shape:
        raise ValueError("replay: bcodes and xors differ in shape")
    if _on_cpu(bcodes, xors):
        return replay_plain(bcodes, xors, e1, e2)
    if _table_bytes(e1, e2) > MAX_SMEM:
        raise ValueError(f"replay: tables of ({e1},{e2}) exceed one block's "
                         f"shared memory")
    C, L = xors.shape
    out = torch.empty_like(xors)
    if xors.numel():
        _launch("replay", _lib().tt_replay, bcodes.data_ptr(),
                xors.data_ptr(), out.data_ptr(), C, L, e1, e2,
                device=xors.device)
    return out


# ---------------------------------------------------------------------------
# logshift
# ---------------------------------------------------------------------------


def _nbits(S: int) -> int:
    return max(S - 1, 1).bit_length()


def logshift_plain(word: torch.Tensor, pb: int, direction: str):
    """Move each live ``shift << pb | payload`` word (0 = dead) ``shift``
    lanes left or right; return the payloads, 0 where nothing landed."""
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
