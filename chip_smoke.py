#!/usr/bin/env python3
"""Drive trico_tpu_torch's chunked FP codec (f32 and f64) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``trico_tpu_torch/codec/csrc`` and print the
   seconds the build took;
3. hold each of the seven kernels against its plain PyTorch version on the
   card, at the shapes the main paths give it: the f32 bench stream (8M
   values, chunks of 4096, exponents (4,6), 16384 slots per parse row),
   the adaptive encode with candidates ((0,6),(4,6),(8,6),(4,10)), which
   gives ``fcm_multi_xors`` e1s=(8,), and the f64 bench stream (16M
   doubles, chunks of 4096, (4,6), 32768 slots per row); besides, predict
   and replay (both widths) at more exponents on words with NaN, inf, zero,
   subnormal and negative patterns, f32 predict also at (14,14), whose
   128 KB of tables take a block of one warp, and ``fcm_multi_xors`` at
   (2,6,8). Tolerance: exact equality of every word. Times of both from
   CUDA events;
4. drive the main paths through ``encode_chunked`` / ``decode_chunked`` and
   ``fp_torch.encode_f32_adaptive``: the f32 bench stream fixed, ``"fast"``
   and ``optimize=True``; the f64 bench stream (bench.py:290-293) at
   (4,6), ``"fast"`` and ``optimize=True``; the custom candidate set; the
   f32 stream at (16,16), whose tables no kernel holds (sort predictor);
   the Stanford bunny's vertex planes as f32 and widened to f64 through
   every profile. Every round trip must be bit-exact, and 16 chunks of
   several of them, relaid out to the reference layout, must equal
   ``fp_ref.compress`` of their values at their hash_info exponents;
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
from trico_tpu_torch import _u32, _u64, chunked  # noqa: E402
from trico_tpu_torch.codec import (_build, fp64_torch, fp_cuda,  # noqa: E402
                                   fp_torch)

N_VALUES = 1 << 23  # bench.py's f32 stream: 8M values
N_F64 = 1 << 24  # bench.py's f64 stream: 16M doubles
CHUNK_LEN = 4096
EXP = (4, 6)
EXTRA_EXPS = ((0, 6), (0, 0), (4, 10), (10, 10))
EXTRA_EXPS64 = ((0, 6), (0, 0), (4, 10), (10, 12))
BIG_EXP = (14, 14)  # predict tables past 48 KB: one warp per block
REPAIR_EXP = (16, 16)  # tables past any block: the sort predictor
# an adaptive set with a 3-member e2 group: fcm_multi_xors gets e1s=(8,)
CUSTOM_CANDIDATES = ((0, 6), (4, 6), (8, 6), (4, 10))
FCM_EXTRA_E1S = (2, 6, 8)
SOURCE = "trico_tpu_torch/codec/csrc/fp_kernels.cu"
PALLAS = "trico_tpu/codec/fp_pallas.py"
REPLACES = {
    "predict_xors": (f"{PALLAS}:85", [f"{PALLAS}:59"]),
    "fcm_multi_xors": (f"{PALLAS}:150", []),
    "replay": (f"{PALLAS}:216", []),
    "logshift": (f"{PALLAS}:275", []),
    "pair_compact_or": (f"{PALLAS}:323", []),
    "predict64_xors": (f"{PALLAS}:493", [f"{PALLAS}:578"]),
    "replay64": (f"{PALLAS}:440", []),
}
PLAIN = {name: getattr(fp_cuda, f"{name}_plain") for name in fp_cuda.KERNELS}


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


def bench_stream64(n: int) -> np.ndarray:
    """bench.py's f64 stream (bench.py:290-293), as uint64 bits."""
    r = np.random.default_rng(3)
    vals = (np.cumsum(r.normal(0, 1e-3, n))
            + np.sin(np.linspace(0., 3000., n)) * 10)
    return vals.view(np.uint64)


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


def special_words64(C: int, L: int, seed: int = 2) -> np.ndarray:
    """Double bits: random words and negative random walks (alternate rows)
    with NaN, inf, signed zeros, subnormals and constant runs mixed in."""
    r = np.random.default_rng(seed)
    w = np.frombuffer(r.bytes(C * L * 8), np.uint64).reshape(C, L).copy()
    walk = -np.abs(np.cumsum(r.normal(0, 1, (C, L)), axis=1))
    w[::2] = walk[::2].view(np.uint64)
    pats = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 5e-324,
                     -1e-310, 2.2250738585072014e-308, -1.5]).view(np.uint64)
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
    """Largest |a - b| over two tensors of u32 (int32) or u64 (int64) words."""
    if not a.numel():
        return 0
    if a.dtype == torch.int64:  # u64 words: compare the two u32 halves
        return max(max_abs_err(_u32.narrow(a >> 32), _u32.narrow(b >> 32)),
                   max_abs_err(_u32.narrow(a), _u32.narrow(b)))
    return int((_u32.widen(a) - _u32.widen(b)).abs().max().item())


def record_calls(run):
    """Run ``run()`` with every kernel wrapper recording what it was given."""
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
        run()
    finally:
        for k in fp_cuda.KERNELS:
            setattr(fp_cuda, k, real[k])
    return seen


def capture_main_path_inputs(x, x64):
    """Run the main paths once at their shapes and record what each kernel
    wrapper was given: f32 encode and decode at (4,6), the adaptive encode
    with the custom candidate set, f64 encode and decode at (4,6)."""
    def run():
        payloads, _ = fp_torch.encode_f32_chunks_v2(x, *EXP)
        back = fp_torch.decode_f32_chunks_v2(payloads, x.shape[1], *EXP)
        check(torch.equal(back, x), "f32 encode/decode round trip at the "
              "bench shape")
        fp_torch.encode_f32_chunks_v2_adaptive(x, CUSTOM_CANDIDATES)
        payloads, _ = fp64_torch.encode_f64_chunks_v2(x64, *EXP)
        back = fp64_torch.decode_f64_chunks_v2(payloads, x64.shape[1], *EXP)
        check(torch.equal(back, x64), "f64 encode/decode round trip at the "
              "bench shape")

    return record_calls(run)


def kernel_phase(x, x64):
    """Phase 3: every kernel against its plain version on the card. Extra
    replay cases must also restore the words they were predicted from."""
    seen = capture_main_path_inputs(x, x64)
    special = _u32.from_numpy(special_words(256, CHUNK_LEN)).cuda()
    mixed = torch.cat([x[:256], special])
    special64 = _u64.from_numpy(special_words64(256, CHUNK_LEN)).cuda()
    mixed64 = torch.cat([x64[:256], special64])
    extra = {"predict_xors": [((special, *EXP), None), ((mixed, *BIG_EXP), None)]
             + [((mixed, *e), None) for e in EXTRA_EXPS],
             "fcm_multi_xors": [((special, FCM_EXTRA_E1S), None)],
             "replay": [], "logshift": [], "pair_compact_or": [],
             "predict64_xors": [((special64, *EXP), None)]
             + [((mixed64, *e), None) for e in EXTRA_EXPS64],
             "replay64": []}
    for e in EXTRA_EXPS:
        bc, res = fp_torch._bcode_res_from_xors(*fp_cuda.predict_xors_plain(mixed, *e))
        extra["replay"].append(((bc, res, *e), mixed))
    for e in (EXP,) + EXTRA_EXPS64:
        bc, res = fp64_torch._bcode_res_from_xors64(
            *fp_cuda.predict64_xors_plain(mixed64, *e))
        extra["replay64"].append(((bc, res, *e), mixed64))
    results = {}
    for name in fp_cuda.KERNELS:
        check(len(seen[name]) > 0, f"{name}: the main path never called it")
        kern, plain = getattr(fp_cuda, name), PLAIN[name]
        cases = [(args, None) for args in seen[name]] + extra[name]
        err = 0
        for i, (args, restores) in enumerate(cases):
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                e = max_abs_err(g, w)
                check(e == 0, f"{name} case {i}: kernel differs from its "
                              f"plain version (max abs err {e})")
                err = max(err, e)
            if restores is not None:
                check(torch.equal(got[0], restores),
                      f"{name} case {i}: values not restored")
        args0 = cases[0][0]
        ms = time_ms(lambda: kern(*args0), 20)
        plain_ms = time_ms(lambda: plain(*args0),
                           1 if name.startswith("replay") else 3)
        print(f"kernel {name}: {len(cases)} cases exact; at "
              f"{tuple(args0[0].shape)}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms", flush=True)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return results


def check_v1_chunks(payloads, values, relayout, what: str) -> None:
    """16 chunk payloads, relaid out to the reference layout, equal
    ``fp_ref.compress`` of their values at their hash_info exponents."""
    for c, p in enumerate(payloads[:16]):
        e1, e2 = fp_torch.exponents(int(p[0]))
        want = fp_ref.compress(values[c * CHUNK_LEN:(c + 1) * CHUNK_LEN], e1, e2)
        check(relayout(p).tobytes() == want,
              f"{what}: chunk {c} differs from fp_ref.compress")


def container_chunks(blob) -> list:
    _, sizes, pos = parse_validated_framing(blob)
    out = []
    for s in sizes:
        out.append(np.frombuffer(blob, np.uint8, s, pos))
        pos += s
    return out


def round_trip(raw, what: str, *exps, optimize=False, v1_check=False) -> bytes:
    """encode_chunked then decode_chunked on the card, bit-exact."""
    t0 = time.perf_counter()
    blob = chunked.encode_chunked(raw, CHUNK_LEN, *exps, optimize=optimize,
                                  device="cuda")
    t1 = time.perf_counter()
    back, bits = chunked.decode_chunked(blob, device="cuda")
    t2 = time.perf_counter()
    check(bits == 8 * raw.itemsize and back.dtype == raw.dtype
          and back.shape == raw.shape, f"{what}: decode_chunked shape/dtype")
    check(np.array_equal(back, raw), f"{what}: round trip")
    chunks = container_chunks(blob)
    if v1_check:
        relayout = (fp_torch.relayout_f32_v2_to_v1 if raw.itemsize == 4
                    else fp64_torch.relayout_f64_v2_to_v1)
        check_v1_chunks(chunks, raw, relayout, what)
    infos = {}
    for p in chunks[: len(raw) // CHUNK_LEN]:
        e = fp_torch.exponents(int(p[0]))
        infos[e] = infos.get(e, 0) + 1
    print(f"main path {what}: {len(raw)} values -> {len(blob)} B (ratio "
          f"{raw.nbytes / len(blob):.4f}), encode_chunked {t1 - t0:.3f} s, "
          f"decode_chunked {t2 - t1:.3f} s (host clock, transfers and "
          f"framing included); chunks by exponents {sorted(infos.items())}"
          f"{'; 16 chunks equal fp_ref.compress' if v1_check else ''}",
          flush=True)
    return blob


def custom_candidates_leg(raw) -> None:
    """fp_torch.encode_f32_adaptive with CUSTOM_CANDIDATES, decoded per
    hash_info group on the card."""
    mat, sizes, tail = fp_torch.encode_f32_adaptive(raw, CHUNK_LEN,
                                                    CUSTOM_CANDIDATES,
                                                    device="cuda")
    C = len(mat)
    check(len(tail) == len(raw) - C * CHUNK_LEN, "custom candidates: tail")
    back = np.empty((C, CHUNK_LEN), np.uint32)
    for info in np.unique(mat[:, 0]):
        idx = np.nonzero(mat[:, 0] == info)[0]
        back[idx] = fp_torch.decode_f32(mat[idx], CHUNK_LEN,
                                        *fp_torch.exponents(int(info)),
                                        device="cuda").reshape(len(idx), CHUNK_LEN)
    check(np.array_equal(back.reshape(-1), raw[: C * CHUNK_LEN]),
          "custom candidates: round trip")
    check_v1_chunks([mat[c, : sizes[c]] for c in range(16)], raw,
                    fp_torch.relayout_f32_v2_to_v1, "custom candidates")
    picked = {fp_torch.exponents(int(i)): int((mat[:, 0] == i).sum())
              for i in np.unique(mat[:, 0])}
    print(f"main path custom candidates {CUSTOM_CANDIDATES}: {C} chunks "
          f"bit-exact, 16 equal fp_ref.compress; chunks by exponents "
          f"{sorted(picked.items())}", flush=True)


def main_path_phase(raw, raw64):
    """Phase 4: the user-facing entry points on the card, bit-exact."""
    round_trip(raw, "f32 (4,6)", v1_check=True)
    round_trip(raw, "f32 fast", optimize="fast")
    round_trip(raw, "f32 optimize=True", optimize=True, v1_check=True)
    custom_candidates_leg(raw)
    round_trip(raw, f"f32 {REPAIR_EXP} (sort predictor)", *REPAIR_EXP,
               v1_check=True)
    round_trip(raw64, "f64 (4,6)", *EXP, v1_check=True)
    round_trip(raw64, "f64 fast", optimize="fast")
    round_trip(raw64, "f64 optimize=True", optimize=True)
    verts, _ = read_stl(REPO / "tests" / "data" / "StanfordBunny.stl")
    for axis in range(3):
        plane = np.ascontiguousarray(verts[:, axis])
        p32, p64 = plane.view(np.uint32), plane.astype(np.float64).view(np.uint64)
        for opt in (False, "fast", True):
            for p, exps in ((p32, ()), (p64, EXP)):
                blob = chunked.encode_chunked(p, CHUNK_LEN, *exps, optimize=opt,
                                              device="cuda")
                back, _ = chunked.decode_chunked(blob, device="cuda")
                check(np.array_equal(back, p), f"bunny axis {axis} round "
                      f"trip ({p.dtype}, optimize={opt})")
        blob = chunked.encode_chunked(p64, CHUNK_LEN, device="cuda")  # (20,20)
        check(np.array_equal(chunked.decode_chunked(blob, device="cuda")[0], p64),
              f"bunny axis {axis} round trip (f64 at (20,20))")
    print(f"main path: bunny {len(verts)} vertices, 3 planes as f32 and f64, "
          "fixed, fast and optimize=True, f64 also at (20,20), bit-exact",
          flush=True)


def throughput_phase(x, x64):
    """Phase 5: device-resident encode and decode rates."""
    def report(what, words, enc, dec=None):
        """Encode (and decode) rates of (C, L) words; decode must restore."""
        nbytes = words.numel() * words.element_size()
        payloads, sizes = enc(words)
        enc_ms = time_ms(lambda: enc(words), 10)
        line = (f"throughput {what} (device-resident, CUDA events, "
                f"{words.shape[0]} chunks x {words.shape[1]}): encode "
                f"{nbytes / enc_ms / 1e6:.3f} GB/s ({enc_ms:.3f} ms)")
        if dec is not None:
            check(torch.equal(dec(payloads), words),
                  f"device-resident round trip, {what}")
            dec_ms = time_ms(lambda: dec(payloads), 10)
            line += f", decode {nbytes / dec_ms / 1e6:.3f} GB/s ({dec_ms:.3f} ms)"
        print(f"{line}, ratio {nbytes / float(sizes.sum().item()):.4f}",
              flush=True)

    L = CHUNK_LEN
    report("f32 (4,6)", x, lambda w: fp_torch.encode_f32_chunks_v2(w, *EXP),
           lambda p: fp_torch.decode_f32_chunks_v2(p, L, *EXP))
    report("f32 optimize=True", x, lambda w: fp_torch.encode_f32_chunks_v2_adaptive(
        w, fp_torch.F32_TPU_CANDIDATES))
    report("f64 (4,6)", x64, lambda w: fp64_torch.encode_f64_chunks_v2(w, *EXP),
           lambda p: fp64_torch.decode_f64_chunks_v2(p, L, *EXP))
    report("f64 optimize=True", x64,
           lambda w: fp64_torch.encode_f64_chunks_v2_adaptive(
               w, fp64_torch.F64_TPU_CANDIDATES))


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
    raw64 = bench_stream64(N_F64)
    x = _u32.from_numpy(raw.reshape(-1, CHUNK_LEN)).cuda()
    x64 = _u64.from_numpy(raw64.reshape(-1, CHUNK_LEN)).cuda()
    kern = kernel_phase(x, x64)

    fp_cuda.reset_launches()
    main_path_phase(raw, raw64)
    torch.cuda.synchronize()
    counts = dict(fp_cuda.launches)

    throughput_phase(x, x64)

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
