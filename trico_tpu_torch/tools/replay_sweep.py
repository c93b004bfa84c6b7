"""Measure the ``replay`` / ``replay64`` kernel on one NVIDIA GPU.

    python3 -m trico_tpu_torch.tools.replay_sweep [--parent OLD/fp_kernels.cu]

Builds the kernels, makes the decode replay's inputs at the main path's
shapes (the f32 stream of 8M values as (2048, 4096) u32 words, the f64
stream of 16M doubles as (4096, 4096) u64 words, exponents (4,6)), checks
that the kernel restores the words exactly, and prints, from CUDA events:

* the time at the launch's own choice of G (chunks per warp) and T (values
  per tile), with the cycles per value (time x SM clock / L) and the share
  of the bytes bound (each input read once, the output written once, at
  3.35 TB/s);
* the time at every G in 1..32 and T in 64..512: G = 1 is a warp per chunk,
  G = 32 a lane per chunk;
* the time at a few other exponents and chunk counts;
* with ``--parent``, the time of another ``fp_kernels.cu`` (an earlier
  commit's, built here with the same flags) on the same inputs, in turns:
  parent, this, this, parent.

Every line names the card and its power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from .. import _u32, _u64
from ..bench import bench_stream, bench_stream64
from ..codec import _build, fp64_torch, fp_cuda, fp_torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
EXP = (4, 6)
L = 4096


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
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


def streams():
    """The two bench streams as (C, L) words on the card."""
    return (_u32.from_numpy(bench_stream(1 << 23).reshape(-1, L)).cuda(),
            _u64.from_numpy(bench_stream64(1 << 24).reshape(-1, L)).cuda())


def replay_inputs(words, e1, e2):
    if words.dtype == torch.int32:
        return fp_torch._bcode_res_from_xors(*fp_cuda.predict_xors(words, e1, e2))
    return fp64_torch._bcode_res_from_xors64(
        *fp_cuda.predict64_xors(words, e1, e2))


def bound_ms(words) -> float:
    """Bytes bound: bcodes and xors read once, the values written once."""
    n = words.numel()
    return n * (1 + 2 * words.element_size()) / HBM_BYTES_PER_S * 1e3


def start_build(cu: Path, defines=()):
    """Start nvcc on an fp_kernels.cu with this tree's flags and ``defines``
    (``-DNAME=value`` strings); returns (process, library path)."""
    so = Path(tempfile.mkdtemp(prefix="kernels_other_")) / "libother.so"
    cmd = [_build._nvcc(), *_build.FLAGS, *defines, str(cu), "-o", str(so)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def finish_build(build, signatures: dict):
    """Wait for a build of :func:`start_build` and load it; ``signatures``
    gives the ctypes argument types of the entry points that are called."""
    proc, so = build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exited {proc.returncode}:\n{log}")
    lib = ctypes.CDLL(str(so))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_parent(cu: Path, signatures: dict):
    """Another fp_kernels.cu, built with this tree's flags."""
    return finish_build(start_build(cu), signatures)


# the replay entry points before their redesign: (bcodes, xors, out, C, L,
# e1, e2, stream)
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_REPLAY = dict.fromkeys(("tt_replay", "tt_replay64"),
                              [_P, _P, _P, _I, _I, _I, _I, _P])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="an earlier fp_kernels.cu to time beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("replay_sweep: CUDA is not available", file=sys.stderr)
        return 1
    card = _smi("name,power.limit")
    print(f"gpu: {card}", flush=True)
    report = _build.build_all()
    show = 0  # the replay kernels' entries in the -Xptxas -v report
    for line in report["fp_kernels"]["log"].splitlines():
        show = 3 if "replay_kernel" in line else show - 1
        if show > 0:
            print(f"  ptxas: {line.strip()}")

    x32, x64 = streams()
    for name, words, kern in (("replay", x32, fp_cuda.replay),
                              ("replay64", x64, fp_cuda.replay64)):
        C = words.shape[0]
        bc, res = replay_inputs(words, *EXP)
        got = kern(bc, res, *EXP)
        torch.cuda.synchronize()
        if not torch.equal(got, words):
            print(f"{name}: the kernel does not restore the words", file=sys.stderr)
            return 1
        bound = bound_ms(words)
        ms = time_ms(lambda: kern(bc, res, *EXP))
        mhz = float(_smi("clocks.sm").split()[0])
        print(f"{name} at ({C}, {L}), {EXP}, the launch's own G and T: "
              f"{ms:.4f} ms, {ms * 1e-3 * mhz * 1e6 / L:.1f} cycles per value "
              f"at {mhz:.0f} MHz; bytes bound {bound:.4f} ms, "
              f"{100 * bound / ms:.1f}% of it reached [{card}]", flush=True)
        for T in (64, 128, 256):
            row = []
            for G in (1, 2, 4, 8, 16, 32):
                try:
                    got = kern(bc, res, *EXP, G, T)
                    torch.cuda.synchronize()
                    assert torch.equal(got, words), (G, T)
                    row.append(f"G={G}: {time_ms(lambda: kern(bc, res, *EXP, G, T)):.4f}")
                except RuntimeError as e:  # more shared memory than a block has
                    row.append(f"G={G}: refused ({str(e)[-20:]})")
            print(f"  {name} T={T} ms: " + ", ".join(row), flush=True)
        for e in ((0, 0), (0, 6), (4, 10), (10, 10)):
            b2, r2 = replay_inputs(words, *e)
            got = kern(b2, r2, *e)
            torch.cuda.synchronize()
            assert torch.equal(got, words), e
            print(f"  {name} at {e}: {time_ms(lambda: kern(b2, r2, *e)):.4f} ms",
                  flush=True)
        for c in (1, 64, 256, 1024):
            print(f"  {name} at ({c}, {L}), {EXP}: "
                  f"{time_ms(lambda: kern(bc[:c], res[:c], *EXP)):.4f} ms",
                  flush=True)
        if args.parent:
            lib = load_parent(args.parent, PARENT_REPLAY)
            fn = getattr(lib, f"tt_{name}")
            out = torch.empty_like(res)
            stream = torch.cuda.current_stream().cuda_stream

            def parent():
                rc = fn(bc.data_ptr(), res.data_ptr(), out.data_ptr(), C, L,
                        *EXP, stream)
                assert rc == 0, rc

            parent()
            torch.cuda.synchronize()
            assert torch.equal(out, words)
            turns = [time_ms(parent), time_ms(lambda: kern(bc, res, *EXP)),
                     time_ms(lambda: kern(bc, res, *EXP)), time_ms(parent)]
            print(f"  {name} parent / this / this / parent: "
                  + " / ".join(f"{t:.4f}" for t in turns) + f" ms [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
