#!/usr/bin/env python3
"""Drive trico_tpu_torch's f32 v2 main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``trico_tpu_torch/codec/csrc`` and print the
   seconds the build took;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (8M values, chunks of 4096, exponents
   (4,6), 16384 slots per parse row) and, for predict and replay, at
   exponents (0,6), (0,0), (4,10) and (10,10) on words that include NaN and
   inf patterns, and predict also at (14,14), whose 128 KB of tables take a
   block of one warp; tolerance: exact equality of every word. Times of both
   from CUDA events;
4. drive the main path through ``encode_chunked`` / ``decode_chunked`` on the
   bench stream (8M values; bench.py's generator), fixed (4,6) and
   ``optimize="fast"``, and on the Stanford bunny's vertex planes; every
   round trip must be bit-exact, and 16 chunks relaid out to the reference
   layout must equal ``fp_ref.compress`` of their values;
5. print device-resident encode and decode GB/s, from CUDA events;
6. print the kernels line: each kernel's launches during phase 4 (each must
   be > 0), its largest difference from the plain version and both times.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from trico_tpu.chunked import parse_validated_framing  # noqa: E402
from trico_tpu.codec import fp_ref  # noqa: E402
from trico_tpu.io.stl import read_stl  # noqa: E402
from trico_tpu_torch import _u32, chunked  # noqa: E402
from trico_tpu_torch.codec import _build, fp_cuda, fp_torch  # noqa: E402

N_VALUES = 1 << 23  # bench.py's stream: 8M f32 values
CHUNK_LEN = 4096
EXP = (4, 6)
EXTRA_EXPS = ((0, 6), (0, 0), (4, 10), (10, 10))
BIG_EXP = (14, 14)  # predict tables past 48 KB: one warp per block
SOURCE = "trico_tpu_torch/codec/csrc/fp_kernels.cu"
REPLACES = {
    "predict_xors": ("trico_tpu/codec/fp_pallas.py:85",
                     ["trico_tpu/codec/fp_pallas.py:59"]),
    "replay": ("trico_tpu/codec/fp_pallas.py:216", []),
    "logshift": ("trico_tpu/codec/fp_pallas.py:275", []),
    "pair_compact_or": ("trico_tpu/codec/fp_pallas.py:323", []),
}
PLAIN = {"predict_xors": fp_cuda.predict_xors_plain,
         "replay": fp_cuda.replay_plain,
         "logshift": fp_cuda.logshift_plain,
         "pair_compact_or": fp_cuda.pair_compact_or_plain}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bench_stream(n: int) -> np.ndarray:
    """bench.py's f32 stream (bench.py:87-90), as uint32 bits."""
    r = np.random.default_rng(0)
    t = np.linspace(0, 500 * np.pi, n)
    vals = (np.sin(t) * 10 + np.cumsum(r.normal(0, 1e-3, n))).astype(np.float32)
    return vals.view(np.uint32)


def special_words(C: int, L: int, seed: int = 1) -> np.ndarray:
    """Random words with NaN, inf, zero and constant runs mixed in."""
    r = np.random.default_rng(seed)
    w = r.integers(0, 1 << 32, size=(C, L), dtype=np.uint64).astype(np.uint32)
    pats = np.array([0x7FC00000, 0xFFC00000, 0x7F800000, 0xFF800000,
                     0x7F800001, 0x00000000, 0x80000000, 0x3F800000],
                    np.uint32)
    mask = r.random((C, L)) < 0.3
    w[mask] = pats[r.integers(0, len(pats), mask.sum())]
    w[:, : L // 8] = pats[r.integers(0, len(pats), (C, 1))]  # constant runs
    return w


def time_ms(fn, reps: int) -> float:
    """Milliseconds per call of fn, from CUDA events, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two int32 tensors of u32 words."""
    if not a.numel():
        return 0
    return int((_u32.widen(a) - _u32.widen(b)).abs().max().item())


def capture_main_path_inputs(x):
    """Run encode and decode once at the main path's shape and record what
    each kernel wrapper was given."""
    seen = {k: [] for k in fp_cuda.KERNELS}
    real = {k: getattr(fp_cuda, k) for k in fp_cuda.KERNELS}

    def recorder(name):
        def call(*args):
            seen[name].append(tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args))
            return real[name](*args)
        return call

    try:
        for k in fp_cuda.KERNELS:
            setattr(fp_cuda, k, recorder(k))
        payloads, _ = fp_torch.encode_f32_chunks_v2(x, *EXP)
        back = fp_torch.decode_f32_chunks_v2(payloads, x.shape[1], *EXP)
    finally:
        for k in fp_cuda.KERNELS:
            setattr(fp_cuda, k, real[k])
    check(torch.equal(back, x), "encode/decode round trip at the bench shape")
    return seen


def kernel_phase(x):
    """Phase 3: every kernel against its plain version on the card."""
    seen = capture_main_path_inputs(x)
    special = _u32.from_numpy(special_words(256, CHUNK_LEN)).cuda()
    mixed = torch.cat([x[:256], special])
    extra = {"predict_xors": [(special, *EXP), (mixed, *BIG_EXP)]
             + [(mixed, *e) for e in EXTRA_EXPS],
             "replay": [], "logshift": [], "pair_compact_or": []}
    for e in EXTRA_EXPS:
        bc, res = fp_torch._bcode_res_from_xors(*fp_cuda.predict_xors_plain(mixed, *e))
        extra["replay"].append((bc, res, *e))
    results = {}
    for name in fp_cuda.KERNELS:
        check(len(seen[name]) > 0, f"{name}: the main path never called it")
        kern, plain = getattr(fp_cuda, name), PLAIN[name]
        cases = seen[name] + extra[name]
        err = 0
        for i, args in enumerate(cases):
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                e = max_abs_err(g, w)
                check(e == 0, f"{name} case {i}: kernel differs from its "
                              f"plain version (max abs err {e})")
                err = max(err, e)
            if name == "replay" and i >= len(seen[name]):
                check(torch.equal(got[0], mixed), f"replay case {i}: values "
                      "not restored")
        args0 = cases[0]
        ms = time_ms(lambda: kern(*args0), 20)
        plain_ms = time_ms(lambda: plain(*args0), 1 if name == "replay" else 3)
        print(f"kernel {name}: {len(cases)} cases exact; at "
              f"{tuple(args0[0].shape)}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms", flush=True)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return results


def main_path_phase(raw):
    """Phase 4: the user-facing entry points on the card, bit-exact."""
    for opt in (False, "fast"):
        t0 = time.perf_counter()
        blob = chunked.encode_chunked(raw, CHUNK_LEN, layout="tpu",
                                      optimize=opt, device="cuda")
        t1 = time.perf_counter()
        back, bits = chunked.decode_chunked(blob, device="cuda")
        t2 = time.perf_counter()
        check(bits == 32 and back.dtype == np.uint32 and back.shape == raw.shape,
              f"decode_chunked shape/dtype (optimize={opt})")
        check(np.array_equal(back, raw), f"bench stream round trip (optimize={opt})")
        print(f"main path optimize={opt}: {len(raw)} values -> {len(blob)} B "
              f"(ratio {raw.nbytes / len(blob):.4f}), encode_chunked "
              f"{t1 - t0:.3f} s, decode_chunked {t2 - t1:.3f} s (host clock, "
              f"transfers and framing included)", flush=True)
        if opt is False:
            _, sizes, pos = parse_validated_framing(blob)
            for c in range(16):
                chunk = np.frombuffer(blob, np.uint8, sizes[c], pos)
                pos += sizes[c]
                v1 = fp_torch.relayout_f32_v2_to_v1(chunk).tobytes()
                want = fp_ref.compress(raw[c * CHUNK_LEN:(c + 1) * CHUNK_LEN], *EXP)
                check(v1 == want, f"chunk {c} differs from fp_ref.compress")
            print("main path: 16 chunks relaid out to v1 equal fp_ref.compress",
                  flush=True)
    verts, _ = read_stl(REPO / "tests" / "data" / "StanfordBunny.stl")
    for axis in range(3):
        plane = np.ascontiguousarray(verts[:, axis]).view(np.uint32)
        for opt in (False, "fast"):
            blob = chunked.encode_chunked(plane, CHUNK_LEN, optimize=opt,
                                          device="cuda")
            back, _ = chunked.decode_chunked(blob, device="cuda")
            check(np.array_equal(back, plane),
                  f"bunny axis {axis} round trip (optimize={opt})")
    print(f"main path: bunny {len(verts)} vertices, 3 planes, fixed and fast, "
          "bit-exact", flush=True)


def throughput_phase(x):
    """Phase 5: device-resident encode and decode rates."""
    payloads, sizes = fp_torch.encode_f32_chunks_v2(x, *EXP)
    back = fp_torch.decode_f32_chunks_v2(payloads, x.shape[1], *EXP)
    check(torch.equal(back, x), "device-resident round trip")
    enc_ms = time_ms(lambda: fp_torch.encode_f32_chunks_v2(x, *EXP), 10)
    dec_ms = time_ms(lambda: fp_torch.decode_f32_chunks_v2(payloads, x.shape[1],
                                                           *EXP), 10)
    nbytes = x.numel() * 4
    ratio = nbytes / float(sizes.sum().item())
    print(f"throughput (device-resident, CUDA events, {x.shape[0]} chunks x "
          f"{x.shape[1]}): encode {nbytes / enc_ms / 1e6:.3f} GB/s "
          f"({enc_ms:.3f} ms), decode {nbytes / dec_ms / 1e6:.3f} GB/s "
          f"({dec_ms:.3f} ms), ratio {ratio:.4f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"gpu: {smi[0]}", flush=True)

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    raw = bench_stream(N_VALUES)
    C = N_VALUES // CHUNK_LEN
    x = _u32.from_numpy(raw[: C * CHUNK_LEN].reshape(C, CHUNK_LEN)).cuda()
    kern = kernel_phase(x)

    fp_cuda.reset_launches()
    main_path_phase(raw)
    torch.cuda.synchronize()
    counts = dict(fp_cuda.launches)

    throughput_phase(x)

    rows = []
    for name in fp_cuda.KERNELS:
        check(counts[name] > 0, f"{name}: no launch in the main path")
        replaces, also = REPLACES[name]
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": replaces, "launches": counts[name], **kern[name]}
        if also:
            row["also_replaces"] = also
        rows.append(row)
    check(sys.modules.get("jax") is None, "JAX was imported")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
