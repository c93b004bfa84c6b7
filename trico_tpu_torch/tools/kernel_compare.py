"""Measure the ``logshift``, ``predict_xors`` / ``predict64_xors``,
``pair_compact_or`` and ``fcm_multi_xors`` kernels on one NVIDIA GPU, beside
an earlier commit's.

    python3 -m trico_tpu_torch.tools.kernel_compare [--parent OLD/fp_kernels.cu]
                                                    [--skip-bp]

Builds the kernels and takes their inputs from the main paths, at full size:

* ``logshift``: the two calls of the f32 parse of the 8M-value stream
  ((2048, 16384): slot ids to rank order, left, then bytes to slots, right),
  the call of the reference layout's device pack ((2048, 17925), left, rows
  4 bytes off the 16-byte grid), and the three calls each of a BP32 and a
  BP64 round trip of the 88,080,384-index triangle stream ((5376, 65536) and
  (10752, 65536); ``--skip-bp`` leaves these out);
* ``predict_xors`` at (2048, 4096) u32 words and ``predict64_xors`` at
  (4096, 4096) u64 words, exponents (4,6);
* ``pair_compact_or``: the two calls of one f32 pack of the 8M-value stream
  ((2048, 4096), (4,6));
* ``fcm_multi_xors`` on the same stream at (2048, 4096), e1s = (8,) and
  (2, 6, 8).

Each kernel is held against its plain version (in blocks of rows), then
timed with CUDA events, with the share of the bytes bound (each input read
once, each output written once, at 3.35 TB/s) and, for the predictors, the
cycles one warp spends on a window of 32 values. The library fixes the
tile of ``logshift`` (2048 source slots), its choice between tiles and a
block per row, and the fetch depths of the predictors and of
``fcm_multi_xors`` (4 windows); to show what the other values cost, the
tool builds copies of ``fp_kernels.cu`` with ``-DTT_SHIFT_VEC``,
``-DTT_SHIFT_KERNEL``, ``-DTT_PREDICT_DEPTH`` and ``-DTT_FCM_DEPTH`` set
otherwise (all at once, one nvcc each), holds each against the plain
version too and times it beside the library's, each through its entry
point with the outputs allocated once (the wrapper's time, which the first
line of a kernel gives, includes its host work). With ``--parent`` the same
calls go to another ``fp_kernels.cu`` (built here with the same flags, the
same entry points), its output must be the same, and the two entry points
are timed in turns: parent, this, this, parent.

Every line names the card and its power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _u32, _u64
from ..bench import fullmesh_indices
from ..codec import _build, bp_torch, fp_cuda, fp_torch
from .replay_sweep import (EXP, HBM_BYTES_PER_S, L, _smi, finish_build,
                           load_parent, start_build, streams, time_ms)

# the entry points called in another build: those of this tree's library
ENTRIES = {name: _build._SIGNATURES["fp_kernels"][name]
           for name in ("tt_logshift", "tt_predict_xors", "tt_predict64_xors",
                        "tt_pair_compact_or", "tt_fcm_multi_xors")}
PLAIN_BLOCK = 1 << 26  # words a plain logshift call takes at once
# the library itself, called as the other builds are: its entry point with
# outputs allocated once, without the wrapper's host time
LIBRARY = "the library"
# builds of this tree's source with another fixed choice
SHIFT_VARIANTS = {"tiles of 1024": ["-DTT_SHIFT_VEC=1", "-DTT_SHIFT_KERNEL=1"],
                  "tiles of 2048": ["-DTT_SHIFT_KERNEL=1"],
                  "tiles of 4096": ["-DTT_SHIFT_VEC=4", "-DTT_SHIFT_KERNEL=1"],
                  "block per row": ["-DTT_SHIFT_KERNEL=-1"]}
PREDICT_VARIANTS = {f"depth {d}": [f"-DTT_PREDICT_DEPTH={d}"] for d in (1, 2, 8)}
FCM_VARIANTS = {f"depth {d}": [f"-DTT_FCM_DEPTH={d}"] for d in (1, 2, 8)}
FCM_E1S = ((8,), (2, 6, 8))


def calls_of(name, run) -> list:
    """The arguments of every call to ``fp_cuda.<name>`` that ``run()``
    makes."""
    seen, real = [], getattr(fp_cuda, name)

    def record(*args):
        seen.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args)

    setattr(fp_cuda, name, record)
    try:
        run()
    finally:
        setattr(fp_cuda, name, real)
    return seen


def plain_logshift(word, pb, direction):
    step = max(1, PLAIN_BLOCK // word.shape[1])
    return torch.cat([fp_cuda.logshift_plain(word[i : i + step], pb, direction)
                      for i in range(0, word.shape[0], step)])


def turns(parent, this) -> str:
    return " / ".join(f"{time_ms(f):.4f}" for f in (parent, this, this, parent))


def raw_logshift(lib, word, pb, direction):
    """``tt_logshift`` of another build on ``word``: (call, its output)."""
    C, S = word.shape
    out = torch.empty_like(word)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.tt_logshift(word.data_ptr(), out.data_ptr(), C, S, pb,
                             fp_cuda._nbits(S), int(direction == "right"),
                             stream)
        assert rc == 0, rc

    return call, (out,)


def raw_predict(lib, name, words):
    """``tt_<name>`` of another build on ``words``: (call, its outputs)."""
    x1, x2 = torch.empty_like(words), torch.empty_like(words)
    fn = getattr(lib, f"tt_{name}")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(words.data_ptr(), x1.data_ptr(), x2.data_ptr(), *words.shape,
                *EXP, stream)
        assert rc == 0, rc

    return call, (x1, x2)


def raw_pair(lib, carrier, payload, nbits):
    """``tt_pair_compact_or`` of another build: (call, its output)."""
    out = torch.empty_like(carrier)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.tt_pair_compact_or(carrier.data_ptr(), payload.data_ptr(),
                                    out.data_ptr(), *carrier.shape, nbits,
                                    stream)
        assert rc == 0, rc

    return call, (out,)


def raw_fcm(lib, words, e1s):
    """``tt_fcm_multi_xors`` of another build: (call, its output planes)."""
    out = torch.empty((len(e1s), *words.shape), dtype=words.dtype,
                      device=words.device)
    exps = (ctypes.c_int * len(e1s))(*e1s)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.tt_fcm_multi_xors(words.data_ptr(), out.data_ptr(),
                                   *words.shape, len(e1s), exps, stream)
        assert rc == 0, rc

    return call, tuple(out.unbind(0))


def others(what, want, builds, parent, card) -> bool:
    """Hold every build's (call, outputs) against ``want``, print its time,
    and time the parent's in turns with the library's: both entry points
    called directly, so that the wrapper's host work, which can outlast a
    short kernel, is in neither."""
    row = []
    for label, (call, outs) in builds.items():
        call()
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            print(f"{what}, {label}: differs from the plain version",
                  file=sys.stderr)
            return False
        row.append(f"{label}: {time_ms(call):.4f}")
    print(f"  {what} ms, entry point called directly: {', '.join(row)} [{card}]",
          flush=True)
    if parent is not None:
        call, outs = parent
        call()
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            print(f"{what}: the parent differs", file=sys.stderr)
            return False
        print(f"  {what} parent / this / this / parent: "
              + turns(call, builds[LIBRARY][0]) + f" ms [{card}]", flush=True)
    return True


def compare_logshift(what, word, pb, direction, variants, parent, card) -> bool:
    C, S = word.shape
    want = plain_logshift(word, pb, direction)
    bound = 8 * word.numel() / HBM_BYTES_PER_S * 1e3
    live = int((word != 0).sum().item())

    def this():
        return fp_cuda.logshift(word, pb, direction)

    if not torch.equal(this(), want):
        print(f"logshift {what}: differs from the plain version", file=sys.stderr)
        return False
    print(f"logshift {what} ({C}, {S}) pb={pb} {direction}, "
          f"{100 * live / word.numel():.1f}% live: exact; {time_ms(this):.4f} ms; "
          f"bytes bound {bound:.4f} ms [{card}]", flush=True)
    return others(f"logshift {what}", (want,),
                  {k: raw_logshift(v, word, pb, direction)
                   for k, v in {LIBRARY: _build.lib(), **variants}.items()},
                  raw_logshift(parent, word, pb, direction) if parent else None, card)


def compare_predict(name, words, variants, parent, card) -> bool:
    kern = getattr(fp_cuda, name)
    plain = getattr(fp_cuda, f"{name}_plain")
    C = words.shape[0]
    want = [torch.cat(p) for p in zip(*(plain(words[i : i + 512], *EXP)
                                        for i in range(0, C, 512)))]
    bound = 3 * words.numel() * words.element_size() / HBM_BYTES_PER_S * 1e3
    mhz = float(_smi("clocks.sm").split()[0])

    def this():
        return kern(words, *EXP)

    if not all(torch.equal(g, w) for g, w in zip(this(), want)):
        print(f"{name}: differs from the plain version", file=sys.stderr)
        return False
    own = time_ms(this)
    print(f"{name} at ({C}, {L}), {EXP}: exact; {own:.4f} ms; "
          f"bytes bound {bound:.4f} ms, {100 * bound / own:.1f}% of it reached; "
          f"{own * 1e-3 * mhz * 1e6 / (L // 32):.0f} cycles per window and warp at "
          f"{mhz:.0f} MHz (all {C} warps resident) [{card}]", flush=True)
    for c in (1, 64, 256):
        print(f"  {name} at ({c}, {L}): {time_ms(lambda: kern(words[:c], *EXP)):.4f} ms",
              flush=True)
    return others(name, want,
                  {k: raw_predict(v, name, words)
                   for k, v in {LIBRARY: _build.lib(), **variants}.items()},
                  raw_predict(parent, name, words) if parent else None, card)


def compare_pair(what, carrier, payload, nbits, parent, card) -> bool:
    want = fp_cuda.pair_compact_or_plain(carrier, payload, nbits)
    bound = 12 * carrier.numel() / HBM_BYTES_PER_S * 1e3
    live = int(((carrier & 1) == 1).sum().item())

    def this():
        return fp_cuda.pair_compact_or(carrier, payload, nbits)

    if not torch.equal(this(), want):
        print(f"pair_compact_or {what}: differs from the plain version",
              file=sys.stderr)
        return False
    own = time_ms(this)
    print(f"pair_compact_or {what} {tuple(carrier.shape)}, "
          f"{100 * live / carrier.numel():.1f}% live: exact; {own:.4f} ms; "
          f"bytes bound {bound:.4f} ms, {100 * bound / own:.1f}% of it reached "
          f"[{card}]", flush=True)
    return others(f"pair_compact_or {what}", (want,),
                  {LIBRARY: raw_pair(_build.lib(), carrier, payload, nbits)},
                  raw_pair(parent, carrier, payload, nbits) if parent else None,
                  card)


def compare_fcm(words, e1s, variants, parent, card) -> bool:
    C = words.shape[0]
    want = [torch.cat(p) for p in zip(*(fp_cuda.fcm_multi_xors_plain(
        words[i : i + 512], e1s) for i in range(0, C, 512)))]
    bound = (1 + len(e1s)) * words.numel() * 4 / HBM_BYTES_PER_S * 1e3

    def this():
        return fp_cuda.fcm_multi_xors(words, e1s)

    if not all(torch.equal(g, w) for g, w in zip(this(), want)):
        print(f"fcm_multi_xors {e1s}: differs from the plain version",
              file=sys.stderr)
        return False
    own = time_ms(this)
    print(f"fcm_multi_xors at ({C}, {L}), e1s={e1s}: exact; {own:.4f} ms; "
          f"bytes bound {bound:.4f} ms, {100 * bound / own:.1f}% of it reached "
          f"[{card}]", flush=True)
    return others(f"fcm_multi_xors {e1s}", want,
                  {k: raw_fcm(v, words, e1s)
                   for k, v in {LIBRARY: _build.lib(), **variants}.items()},
                  raw_fcm(parent, words, e1s) if parent else None, card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="an earlier fp_kernels.cu to time beside this one")
    ap.add_argument("--skip-bp", action="store_true",
                    help="leave out the 65536-slot calls of the BP codecs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_compare: CUDA is not available", file=sys.stderr)
        return 1
    card = _smi("name,power.limit")
    print(f"gpu: {card}", flush=True)
    report = _build.build_all()
    show = 0  # the four kernels' entries in the -Xptxas -v report
    for line in report["fp_kernels"]["log"].splitlines():
        show = 3 if any(k in line for k in ("logshift", "predict_kernel",
                                            "pair_", "fcm_multi")) else show - 1
        if show > 0:
            print(f"  ptxas: {line.strip()}")
    source = _build.SOURCES["fp_kernels"]
    started = {k: start_build(source, d)
               for k, d in {**SHIFT_VARIANTS, **PREDICT_VARIANTS,
                            **FCM_VARIANTS}.items()}
    built = {k: finish_build(b, ENTRIES) for k, b in started.items()}
    shifts = {k: built[k] for k in SHIFT_VARIANTS}
    depths = {k: built[k] for k in PREDICT_VARIANTS}
    fcm_depths = {k: built[k] for k in FCM_VARIANTS}
    lib = load_parent(args.parent, ENTRIES) if args.parent else None

    x32, x64 = streams()
    ok = compare_predict("predict_xors", x32, depths, lib, card)
    ok = compare_predict("predict64_xors", x64, depths, lib, card) and ok
    del x64
    for e1s in FCM_E1S:
        ok = compare_fcm(x32, e1s, fcm_depths, lib, card) and ok
    pair_calls = calls_of("pair_compact_or",
                          lambda: fp_torch.encode_f32_chunks_v2(x32, *EXP))
    for i, (carrier, payload, nbits) in enumerate(pair_calls):
        ok = compare_pair(f"f32 pack call {i + 1}", carrier, payload, nbits,
                          lib, card) and ok
    del pair_calls

    payloads, _ = fp_torch.encode_f32_chunks_v2(x32, *EXP)
    bcode, res = fp_torch.predict_f32_chunks(x32, *EXP)
    cases = [(f"f32 parse {i + 1}", *c) for i, c in enumerate(calls_of(
        "logshift", lambda: fp_torch.parse_f32_chunks_v2(payloads, L, *EXP)))]
    cases += [("reference-layout pack", *c) for c in calls_of(
        "logshift", lambda: fp_torch.pack_f32_chunks(bcode, res, *EXP))]
    for what, word, pb, direction in cases:
        ok = compare_logshift(what, word, pb, direction, shifts, lib, card) and ok
    del cases, payloads, bcode, res, x32
    if not args.skip_bp:
        tflat = fullmesh_indices()
        for what, words, enc, dec in (
                ("BP32", _u32.from_numpy(tflat.reshape(-1, 16384)),
                 bp_torch.encode_bp32_chunks, bp_torch.decode_bp32_chunks),
                ("BP64", _u64.from_numpy(tflat.astype(np.uint64).reshape(-1, 8192)),
                 bp_torch.encode_bp64_chunks, bp_torch.decode_bp64_chunks)):
            words = words.cuda()

            def round_trip():
                p, _ = enc(words)
                assert torch.equal(dec(p, words.shape[1]), words)

            calls = calls_of("logshift", round_trip)
            del words
            for i, (word, pb, direction) in enumerate(calls):
                ok = compare_logshift(f"{what} call {i + 1}", word, pb, direction,
                                      shifts, lib, card) and ok
            del calls
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
