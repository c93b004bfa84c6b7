#!/usr/bin/env python3
"""Drive trico_tpu_torch on one NVIDIA GPU: the chunked FP codec (f32 and
f64, both chunk layouts, the reference layout also packed and parsed on the
card), the BP and LZ4 integer codecs, whole v1 mesh archives, the mesh codec
over a mesh of shards (``trico_tpu_torch.parallel``), the CLI, the bench,
the corpus size gate and the multi-process scaling run.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``trico_tpu_torch/codec/csrc`` and print the
   seconds the build took;
3. hold each of the nine kernels against its plain PyTorch version on the
   card (the sort kernels against the predictors' plain versions, the
   route the main paths took before them), at the shapes the main paths
   give it: the f32 bench stream (8M
   values, chunks of 4096, exponents (4,6), 16384 slots per parse row),
   the bench's second shape (its leg 3: 8M values in 8192 chunks of 1024 at
   (4,6), which gives ``replay`` 16 chunks per block), its reference-layout encode and decode through the device pack and parse
   (one ``logshift`` call at (2048, 17925), rows 4 bytes off the 16-byte
   grid), the adaptive encode with candidates ((0,6),(4,6),(8,6),(4,10)),
   which gives ``fcm_multi_xors`` e1s=(8,), and with
   ``F32_TPU_CANDIDATES`` (the bench's leg 2: ``predict_sort_xors`` at
   (2048, 4096), (14,18)), the f64 bench stream (16M
   doubles, chunks of 4096, (4,6), 32768 slots per row; at (20,20) and
   with ``F64_TPU_CANDIDATES``: ``predict64_sort_xors`` at (4096, 4096),
   (20,20) and (10,16)), the
   reference-layout f32 and f64 legs (device predict and replay around the
   host library's pack and parse) at (256, 4096), BP32 encode and decode of
   the whole fullmesh triangle stream of phase 5 at (5376, 16384) and BP64
   (bits 40-46 cycling) at (10752, 8192) (65536 slots per row, 16-bit slot
   ids in the decode: the ``logshift`` word's top bit set), and every call
   of the Lucy archive of phase 6 written and read at ``optimize=True`` in
   both layouts, and every call of the same mesh (f32 and f64 vertices)
   through ``compress_mesh`` / ``decompress_mesh`` on two shards, and
   every call of the v1 archive of each class of the corpus gate (phase 11)
   written and read (planes of 2 to 11 full chunks with tails, f64
   vertices, u64 triangles), and every call of the scaling run of phase 12
   (its 14,025,025 vertices through ``compress_mesh`` and
   ``decompress_mesh`` on 8 shards: 428 chunks per plane and shard, the
   batch each shard takes in every configuration); the plain versions run
   over blocks of rows.
   Besides,
   predict and replay (both widths) at more exponents on words with NaN,
   inf, zero, subnormal and negative patterns, f32 predict also at (14,14),
   whose 128 KB of tables take a block of one warp. ``fcm_multi_xors``
   besides at K = 1, 3 and 8 exponents ((8,), (2,6,8) and
   (2,3,4,6,8,10,12,14), whose 87 KB of tables take a block of one warp) at
   chunk lengths 8, 40 and 4104, one chunk and 1031, also on views one word
   into a larger tensor. ``pair_compact_or`` besides on merging compactions
   (runs of 1-5 live carriers with one destination and dead slots between,
   zero payloads, an all-dead row, carriers out of reach and past slot 0,
   garbage in dead slots) at 37, 4096, 4100, 58113 and 120001 slots (a merge
   run across every edge of its tiles of 2048 slots), 1031 rows, on views one
   word into a larger tensor (both
   arrays, and the carrier alone), and on the calls of a pack at chunk
   lengths 8, 40 and 4104. ``predict_xors`` and ``predict64_xors`` besides
   at chunk lengths 8, 40, 4096 and 4104, one chunk and 1031, exponents
   (0,0), (0,6),
   (4,6), (4,10), (10,12) and (14,14) or (12,12) (tables past 48 KB), also
   on views one word into a larger tensor. ``predict_sort_xors`` besides
   on the f32 stream's (2048, 4096) words and the mixed words at (14,18),
   (16,16), (12,18), (16,20) and (30,30) (u64 composite keys), on the
   special words at (14,18), and at chunk lengths 8, 40, 4104, 16384 and
   65536 (the last two past a block's shared memory: the global scratch
   form), one chunk and 1031, at (14,18) and (30,30), and on views one word
   into a larger tensor; ``predict64_sort_xors`` the same on u64 words at
   (20,20), (10,16), (16,20) and (20,22), the (4096, 4096) f64 stream
   among them. ``logshift`` besides at 17925,
   37, 2049 and 4100 slots and 1031 rows, left and right, with an all-dead
   row, words that move past either edge, on views one word into a larger
   tensor, and at 120001 slots, where a right expansion's row no longer
   fits a block's stage and goes to the tiles. ``replay`` and ``replay64``
   besides at chunk lengths off every grid of the kernel (8, 40, 4096 + 8,
   and for f64 4102 = 2 x 2051), one chunk, chunk counts that leave the last
   block partly filled, G and T named by the caller, exponents (0,0), (0,6),
   (4,10), (10,10) (2048 table words) and inputs that are views one word
   into a larger tensor (rows not 16-byte aligned); each must also restore
   the words it was predicted from. Tolerance: exact equality of every word.
   Times of both from CUDA events, ``logshift``'s also at 65536 slots, the
   redesigned kernels' beside the times of the kernels that they replace,
   and each kernel's bound: the larger of its bytes (inputs read once,
   outputs written once) over 3.35 TB/s and its integer operations over 67
   TOP/s; the sort kernels also at (2048, 4096) u32 (14,18) and (4096, 4096)
   u64 (20,20) and (10,16) beside their plain version;
4. drive the FP paths through ``encode_chunked`` / ``decode_chunked`` and
   ``fp_torch.encode_f32_adaptive``: the f32 bench stream fixed, ``"fast"``
   and ``optimize=True``; the f64 bench stream (bench.py:290-293) at
   (4,6), at the default (20,20), ``"fast"`` and ``optimize=True``; the
   custom candidate set; the f32 stream at (16,16), whose tables no window
   kernel holds (each of ``optimize=True``, (16,16), f64 (20,20) and f64
   ``optimize=True`` must launch a sort kernel);
   the f32 stream in the reference layout through the device pack and parse
   (``fp_torch.encode_f32(..., layout="ref", device_pack=True)`` and
   ``decode_f32(..., device_parse=True)``, 2048 chunks of 4096): the bytes
   of the host library's pack and of the v2 payloads relaid out, and the
   same container from ``encode_chunked(layout="ref")`` with and without
   the host library; the Stanford bunny's vertex planes as f32 and widened
   to f64 through every profile. Every round trip must be bit-exact, and 16
   chunks of several of them, relaid out to the reference layout, must
   equal ``fp_ref.compress`` of their values at their hash_info exponents;
5. drive the integer paths: the fullmesh triangle stream of
   bench.py:231-236 (88,080,384 u32 indices) through ``encode_bp_chunked``
   / ``decode_bp_chunked`` at 16384, the same indices as u64, and again
   with bits 40-46 cycling (more than 32 planes), at 8192, 16 chunks of each
   equal to ``bp_ref.encode_chunk``; its four byte planes through
   ``encode_lz4_chunked`` at 1 MiB blocks (the match search on the card)
   and the host decoder, and the card's ``find_matches`` of two blocks
   against the same function on CPU tensors. All bit-exact;
6. write whole v1 archives with ``ArchiveWriter(chunk_len=4096,
   device="cuda")``: the Lucy-class mesh of bench.py:419-432 at 2,000,000
   requested vertices with vertex normals and colors, at ``optimize=True``
   and ``"fast"``, in both chunk layouts, read back by
   ``ArchiveReader(device="cuda")`` bit-exact; and the bunny with one
   stream of every kind, whose archive must be the same bytes when written
   with ``device="cpu"``;
7. drive the mesh codec (``trico_tpu_torch.parallel``): Lucy at its
   published size (14,025,025 vertices, 28,035,072 triangles, normals and
   colors) through ``compress_mesh`` on ``make_mesh()`` (the one card),
   byte-equal to ``ArchiveWriter(chunk_len=4096)``'s archive and read back
   bit-exact by ``decompress_mesh`` with six sharded FP substreams; the
   2M-vertex mesh of phase 6, f32 and f64 vertices, ``optimize=True`` and
   ``"fast"``, on meshes of 1, 2 and 4 shards that list the card, every
   archive the writer's bytes; the same through a process group of one over
   NCCL (meshes of 1 and 4 shards: the gathers are ``dist.all_gather`` on
   the card), and ``python -m trico_tpu_torch.parallel.mp_worker
   --backend nccl`` as a world of one; two processes of the worker on the
   card over gloo (NCCL refuses two ranks on one GPU), whose bytes must
   equal the in-process archive of the same data; and a 100,000,000-point
   cloud on the fewest shards whose peak fits half the card's memory, by
   the bytes per value of a calibration run of 4,000,000 points on one
   shard. The Lucy-size and the cloud legs run twice; the second run
   records the largest call of each kernel (kept in host memory, so that
   later legs' peaks do not hold it), which is held against its plain
   version once the phase's launches are counted. One card: no scaling
   figure;
8. run ``python -m trico_tpu_torch encode`` and ``decode`` on the bunny STL
   as subprocesses, with ``--profile``: ``--chunked --device cuda`` (a v1
   archive, the in-process writer's bytes) and without ``--chunked`` (a v0
   archive written on the host, the in-process v0 writer's bytes); the
   geometry read back must equal the input and each report name its stages;
9. print device-resident encode and decode GB/s (f32 in both layouts, f64,
   BP32, BP64) and ``find_matches`` ms per 1 MiB block, from CUDA events;
10. run the port's benchmark, ``python -m trico_tpu_torch.bench``, at its
   defaults as a subprocess (bench.py's eight legs at bench.py's sizes):
   it must exit 0 with every leg bit-exact, leg 1's f32 (4,6) ratio equal
   to phase 9's on the same stream, and ``predict_xors``,
   ``pair_compact_or``, ``logshift``, ``replay``, ``predict64_xors``,
   ``replay64`` and ``predict_sort_xors`` launched, the last in its
   headline leg (leg 2); its result line is printed with the card's name;
11. run the corpus size gate, ``python -m
   trico_tpu_torch.tools.corpus_gate`` (its ``main``, in this process), on
   the card: seven classes of mesh, every stream of the v0 and v1 archives
   read back bit-exact, every archive's size that of ``CORPUS.json``, and
   ``v0 <= ref`` and ``v1 <= ref`` against the reference library's size
   (recorded in ``CORPUS.json`` unless its sources build from the
   repository's gitignored ``reference/``);
12. run ``python -m trico_tpu_torch.tools.mp_scaling`` as a subprocess at
   Lucy's published vertex count (14,025,025 f32 vertices) on a mesh of 8
   shards of the card split over 1, 2 and 4 gloo processes: the same bytes
   in every configuration, decoded bit-exact (in the tool's own process,
   its launches counted with the ranks'); prints each configuration's
   efficiency against one process and ``gather_frac`` beside the card (one
   card shared in time: overhead, not scaling);
13. print how many calls of a plain version were given tensors on the card
   in phases 4-12, in this process (``fp_cuda.plain_on_card``, read per
   phase): all must be 0 (the processes it starts run the same codec
   routes, and no codec module names a plain version, as the tests check).
   Then the kernels line: each kernel's launches during
   phases 4-7 and 10-12 (each must be > 0 in phase 4; all but
   ``fcm_multi_xors`` in phases 6, 7 and 11, and in 10 all but it and
   ``predict64_sort_xors``; ``logshift`` in phase 5; ``predict_xors``,
   ``pair_compact_or``, ``replay``, ``logshift`` and ``predict_sort_xors``
   in phase 12), by path (``launches_by_path``: the bench's and the
   scaling run's as their processes counted them), its largest difference
   from the plain version, both times and the bound (``library_ms`` is
   null: no single PyTorch call computes any of the nine functions).

Every leg prints its peak device memory, every time the card's name and
power limit. The last line is ``{"ok": true, "device": {...}}``. Without a
CUDA card, or without the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from trico_tpu_torch import (ArchiveReader, ArchiveWriter, _u32,  # noqa: E402
                             _u64, bench, chunked, native, profiling)
from trico_tpu_torch.chunked import parse_validated_framing  # noqa: E402
from trico_tpu_torch.codec import (_build, bp_ref, bp_torch,  # noqa: E402
                                   fp64_torch, fp_cuda, fp_ref, fp_torch,
                                   lz4_torch, transpose)
from trico_tpu_torch.io.stl import (compute_triangle_normals,  # noqa: E402
                                    read_stl)
from trico_tpu_torch.parallel import (make_mesh, mesh_codec,  # noqa: E402
                                      mp_worker)
# the bench's generators: bench.py's streams, triangles and Lucy-class mesh
from trico_tpu_torch.bench import (CANARY_LEN, bench_stream,  # noqa: E402
                                   bench_stream64, canary_stream,
                                   fullmesh_indices, time_ms)
from trico_tpu_torch.tools import corpus_gate  # noqa: E402
from trico_tpu_torch.tools.corpus import build_corpus  # noqa: E402
from trico_tpu_torch.tools.mp_scaling import (free_port, run_ranks,  # noqa: E402
                                              scaling_verts)

N_VALUES = 1 << 23  # bench.py's f32 stream: 8M values
N_F64 = 1 << 24  # bench.py's f64 stream: 16M doubles
CHUNK_LEN = 4096
EXP = (4, 6)
EXTRA_EXPS = ((0, 6), (0, 0), (4, 10), (10, 10))
EXTRA_EXPS64 = ((0, 6), (0, 0), (4, 10), (10, 10), (10, 12))
BIG_EXP = (14, 14)  # predict tables past 48 KB: one warp per block
BIG_EXP64 = (12, 12)  # the same for u64 words: 64 KB
REPAIR_EXP = (16, 16)  # tables past any block: the sort predictor kernel
# an adaptive set with a 3-member e2 group: fcm_multi_xors gets e1s=(8,)
CUSTOM_CANDIDATES = ((0, 6), (4, 6), (8, 6), (4, 10))
FCM_EXTRA_E1S = (2, 6, 8)
BP_CHUNK = 16384  # the BP32 default (trico_tpu/chunked.py:464)
BP64_CHUNK = 8192  # the BP64 cap (trico_tpu/chunked.py:481-484)
LZ4_BLOCK = chunked.DEFAULT_LZ4_BLOCK  # 1 MiB
LUCY_VERTS = 2_000_000  # bench.py:419-432, side 1414
# Lucy at its published size (BASELINE.md: 28,055,742 triangles): side 3745,
# 14,025,025 vertices and 28,035,072 triangles, the grid's nearest
LUCY_PUBLISHED_VERTS = 14_027_872
CLOUD_POINTS = 100_000_000  # BASELINE.json "configs": the 100M-point cloud
CLOUD_CALIBRATION = 4_000_000  # points of the run that measures bytes per value
MEMORY_SHARE = 0.5  # of the card's memory one shard of the cloud may take
SHARD_COUNTS = (1, 2, 4)  # meshes that list the one card several times
PLAIN_BLOCK = 1 << 26  # words of the first argument a plain call takes at once
REF_CHUNKS = 256  # FP chunks a reference-layout capture takes
WORK = REPO / "build" / "chip_smoke"  # the CLI's files (gitignored)
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
    # no Pallas kernel: the JAX package's XLA sorts for tables past VMEM
    "predict_sort_xors": ("trico_tpu/codec/fp_jax.py:286", []),
    "predict64_sort_xors": ("trico_tpu/codec/fp64_jax.py:61", []),
}
# the sort kernels share the predictors' plain versions
PLAIN_OF = {"predict_sort_xors": "predict_xors",
            "predict64_sort_xors": "predict64_xors"}
PLAIN = {name: getattr(fp_cuda, f"{PLAIN_OF.get(name, name)}_plain")
         for name in fp_cuda.KERNELS}
# module names bound to a kernel wrapper, which record_calls patches with it
ALIASES = {"predict_sort_xors": [(fp_torch, "_predict_sort")],
           "predict64_sort_xors": [(fp64_torch, "_predict_sort64")]}
# the redesigned kernels' times before their redesign (H100 80GB HBM3 at
# 700 W): the replays as one thread per chunk, logshift as a memset and a
# scatter of 4-byte stores, pair_compact_or as a memset and an atomicOr per
# payload in device memory, the predictors and fcm_multi_xors with one
# window's load in flight; (2048, 4096) u32 and (4096, 4096) u64 words,
# (4,6), e1s=(8,), 16384 slots
BEFORE_REDESIGN_MS = {"replay": 0.4863, "replay64": 0.8086, "logshift": 0.1730,
                      "predict_xors": 0.0901, "predict64_xors": 0.1641,
                      "pair_compact_or": 0.0655, "fcm_multi_xors": 0.0906}
# the arguments a kernel shares with its plain version; what follows them
# only steers the kernel (G and T)
PLAIN_ARGS = {"replay": 4, "replay64": 4}
PREDICT_LENS = (8, 40, CHUNK_LEN, CHUNK_LEN + 8)
PREDICT_EXPS = ((0, 0), (0, 6), (4, 6), (4, 10), (10, 12))
PACK_SLOTS = 5 + 35 * CHUNK_LEN // 8  # 17925: the reference layout's pack row
# source slots of a pair_compact_or tile (4 * kShiftVec * kShiftThreads in
# fp_kernels.cu)
TILE_SLOTS = 2048
# (rows, slots) of the merging compactions: a row shorter than a tile, the
# main path's length, one vector past it, one slot past the longest row one
# block could stage whole (232448 bytes), and a longer row
PAIR_SHAPES = ((5, 37), (1, CHUNK_LEN), (1031, CHUNK_LEN + 4), (3, 58113),
               (3, 120001))
ODD_LENS = (8, 40, CHUNK_LEN + 8)  # chunk lengths off the kernels' grids
# fcm_multi_xors at K = 1, 3 and 8 exponents; the last holds 87 KB of tables,
# so a block of one warp that opts into more shared memory
FCM_E1S = ((8,), FCM_EXTRA_E1S, (2, 3, 4, 6, 8, 10, 12, 14))
# the sort kernels: exponents on the main shapes (the first of each is the
# adaptive encode's; the last needs u64 composites at L = 4096), chunk
# lengths (the last two past one block's shared memory: the scratch form)
# at one chunk and SORT_ROWS
SORT_EXPS = ((14, 18), REPAIR_EXP, (12, 18), (16, 20), (30, 30))
SORT_EXPS64 = ((20, 20), (10, 16), (16, 20), (20, 22))
SORT_LENS = (8, 40, CHUNK_LEN + 8, 16384, 65536)
SORT_ROWS = 1031
CARD = "unknown card"  # name and power limit, set by main()
# chunk lengths off the replay kernel's grids (tile, 4-value vector, warp)
REPLAY_ODD_LENS = {"replay": (8, 40, CHUNK_LEN + 8),
                   "replay64": (2, 38, 2 * 2051)}
BENCH_TIMEOUT = 400  # seconds the bench may take (40-90 s expected)
# the scaling run at Lucy's published vertex count (LUCY_PUBLISHED_VERTS'
# grid, side 3745), over 1, 2 and 4 processes sharing 8 shards of the card
MP_SCALING_VERTS = 3745 ** 2
MP_SCALING_SHARDS = 8
MP_SCALING_PROCS = (1, 2, 4)
MP_SCALING_TIMEOUT = 420  # seconds the scaling run may take (60-120 expected)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: device memory rate
INT_OPS_PER_S = 67e12  # H100 SXM: 32-bit rate outside the tensor cores
# integer operations per element of the first argument (per output plane for
# fcm_multi_xors): hash, table access, xor and select
OPS_PER_ELEMENT = {"predict_xors": 16, "fcm_multi_xors": 8, "replay": 12,
                   "logshift": 6, "pair_compact_or": 6, "predict64_xors": 20,
                   "replay64": 16, "predict_sort_xors": 16,
                   "predict64_sort_xors": 20}
# the paths on which each kernel must launch (phases 4-7 and 10-12; the
# integer path is logshift's alone): fcm_multi_xors only with the custom
# candidate set, predict64_sort_xors nowhere in the bench (its f64 leg is
# at (4,6)), the scaling ranks compress f32 vertices
_PATHS = ("fp", "archive", "parallel", "bench", "corpus")
_SCALING = _PATHS + ("mp_scaling",)
EXPECTED_PATHS = {"predict_xors": _SCALING, "fcm_multi_xors": ("fp",),
                  "replay": _SCALING, "logshift": _SCALING,
                  "pair_compact_or": _SCALING, "predict64_xors": _PATHS,
                  "replay64": _PATHS, "predict_sort_xors": _SCALING,
                  "predict64_sort_xors": ("fp", "archive", "parallel", "corpus")}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


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


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two tensors of u32 (int32) or u64 (int64) words."""
    if torch.equal(a, b):
        return 0
    if a.dtype == torch.int64:  # u64 words: compare the two u32 halves
        return max(max_abs_err(_u32.narrow(a >> 32), _u32.narrow(b >> 32)),
                   max_abs_err(_u32.narrow(a), _u32.narrow(b)))
    return int((_u32.widen(a) - _u32.widen(b)).abs().max().item())


def bound_of(name: str, args, outs) -> tuple[float, str]:
    """(bound_ms, "bytes" or "operations") of one call: every tensor argument
    read once and every output written once at the card's memory rate, or
    the call's integer operations at the card's 32-bit rate, whichever is
    more."""
    tensors = [a for a in args if torch.is_tensor(a)] + list(outs)
    by_bytes = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S
    by_ops = (OPS_PER_ELEMENT[name] * args[0].numel() * len(outs)
              / INT_OPS_PER_S)
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """The same values as a contiguous view one element into a larger
    tensor: its rows start off the 16-byte grid."""
    big = torch.zeros(t.numel() + 3, dtype=t.dtype, device=t.device)
    big[1 : 1 + t.numel()] = t.reshape(-1)
    return big[1 : 1 + t.numel()].view(t.shape)


def replay_shape_cases(name: str, words: torch.Tensor):
    """Replay cases at shapes off the kernel's grids, cut from (C, L)
    ``words``: ((bcodes, xors, e1, e2[, G, T]), the words to restore)."""
    if name == "replay":
        predict, codes = fp_cuda.predict_xors_plain, fp_torch._bcode_res_from_xors
    else:
        predict, codes = fp_cuda.predict64_xors_plain, fp64_torch._bcode_res_from_xors64
    flat = words.reshape(-1)

    def case(C, L, exp, *tune, view=False):
        w = flat[: C * L].view(C, L).contiguous()
        bc, res = codes(*predict(w, *exp))
        if view:
            bc, res = offset_view(bc), offset_view(res)
        return (bc, res, *exp, *tune), w

    short, mid, long = REPLAY_ODD_LENS[name]
    return [case(1, short, EXP), case(1031, short, (0, 0)),
            case(7, mid, (0, 6)), case(1031, mid, EXP, view=True),
            case(13, mid, (4, 10), 8, 64),  # 8 chunks a block: 5 in the last
            case(33, long, EXP, 32, 16), case(3, long, (10, 10), view=True),
            case(64, long, EXP), case(1, CHUNK_LEN, EXP, view=True)]


def predict_shape_cases(words: torch.Tensor, big_exp):
    """Predict cases cut from (1031, 4104) ``words``: every length at one
    chunk and at 1031, every exponent pair, tables past 48 KB, and a view
    one word into a larger tensor."""
    cases = []
    for L in PREDICT_LENS:
        for C in (1, words.shape[0]):
            w = words[:C, :L].contiguous()
            cases += [((w, *e), None) for e in PREDICT_EXPS + (big_exp,)]
            cases.append(((offset_view(w), *EXP), None))
    return cases


def monotone_words(C: int, S: int, pb: int, seed: int):
    """(left, right) logshift words of C rows of S slots on the card: random
    live slots that compact to the front of the row, and the inverse; of
    several rows the middle one all dead, and in row 1 words that move past
    the row's edge."""
    r = np.random.default_rng(seed)
    live = r.random((C, S)) < 0.55
    if C > 1:
        live[C // 2] = False
    rank = np.cumsum(live, axis=1) - live
    payload = r.integers(1, 1 << pb, (C, S))
    lanes = np.arange(S)
    left = np.where(live, ((lanes - rank) << pb) | payload, 0)
    right = np.zeros((C, S), np.int64)
    rows, cols = np.nonzero(live)
    src = rank[rows, cols]
    right[rows, src] = ((cols - src) << pb) | payload[rows, cols]
    if C > 2 and S > 16:
        left[1, :6] = ((lanes[:6] + 2) << pb) | 7  # to lane -2: dropped
        right[1, S - 6:] = (9 << pb) | 7  # past lane S - 1: dropped
    return (_u32.from_numpy(left.astype(np.uint32)).cuda(),
            _u32.from_numpy(right.astype(np.uint32)).cuda())


def logshift_shape_cases():
    """logshift cases off the kernel's grids: the pack row of 17925 slots at
    1031 rows, plain and as views one word into a larger tensor; rows
    shorter than a tile, one slot past a tile, a row count of one, and rows
    too long for the stage of the kernel that takes a block per row."""
    cases = []
    for n, (C, S) in enumerate(((1031, PACK_SLOTS), (3, 37), (5, 2049), (1, 4100),
                                (3, 120001))):
        for word, direction in zip(monotone_words(C, S, 8, seed=n), ("left", "right")):
            cases.append(((word, 8, direction), None))
            cases.append(((offset_view(word), 8, direction), None))
    return cases


def merging_compaction(C: int, S: int, seed: int):
    """(carrier, payload, nbits) of a merging monotone left compaction of C
    rows of S slots, as uint32 arrays: live slots (55%) in runs of 1-5 that
    share a destination, dead slots between, destinations that never fall
    and now and then skip 1-3 words, 10% zero payloads, payload garbage and
    even (dead) carriers in dead slots, carriers out of the network's reach
    (disp >> nbits != 0) and carriers past slot 0; the middle row of several
    all dead; and a merge run across every tile edge whatever the row's
    16-byte grid: live slots at k * TILE_SLOTS - 5 and + 4, one run from the
    one to the other."""
    r = np.random.default_rng(seed)
    nbits = max(S - 1, 1).bit_length()
    live = r.random((C, S)) < 0.55
    edges = np.arange(TILE_SLOTS, S - 4, TILE_SLOTS)
    live[:, edges - 5] = live[:, edges + 4] = True
    near = np.zeros(S, bool)
    for o in range(-4, 5):
        near[edges + o] = True
    if C > 2:
        live[C // 2] = False
    rows, cols = np.nonzero(live)
    n = len(rows)
    first = np.ones(n, bool)
    first[1:] = rows[1:] != rows[:-1]
    start = np.zeros(n, bool)  # a new destination every 1st..5th live slot
    at = np.cumsum(r.integers(1, 6, n)) - 1
    start[at[at < n]] = True
    start = (start & ~near[cols]) | first
    step = start * (1 + (r.random(n) < 0.1) * r.integers(1, 4, n))
    csum = np.cumsum(step)
    row_at = np.zeros(C, np.int64)  # per row: the sum at its first live slot
    row_at[rows[first]] = csum[first]
    origin = np.zeros(C, np.int64)  # per row: its first destination
    origin[rows[first]] = r.integers(0, cols[first] + 1)
    dest = np.minimum(origin[rows] + csum - row_at[rows], cols)
    carrier = np.zeros((C, S), np.uint64)
    one = np.uint64(1)
    carrier[rows, cols] = ((cols - dest).astype(np.uint64) << one) | one
    payload = r.integers(0, 1 << 32, (C, S), dtype=np.uint64)
    payload[r.random((C, S)) < 0.1] = 0
    dead = ~live
    if C > 2:
        dead[C // 2] = False  # the all-dead row stays all zero
    junk = dead & (r.random((C, S)) < 0.05)
    carrier[junk] = r.integers(1, 1 << 31, int(junk.sum())).astype(np.uint64) << one
    lanes = np.broadcast_to(np.arange(S), (C, S))
    far = dead & (r.random((C, S)) < 0.01)
    disp = ((r.integers(1, 1 << (31 - nbits), int(far.sum())) << nbits)
            | r.integers(0, 1 << nbits, int(far.sum())))
    carrier[far] = (disp.astype(np.uint64) << one) | one
    past = dead & ~far & (lanes < 64) & (r.random((C, S)) < 0.3)
    s = lanes[past]
    disp = s + 1 + r.integers(0, np.maximum((1 << nbits) - s - 1, 1))
    carrier[past] = (disp.astype(np.uint64) << one) | one
    return carrier.astype(np.uint32), payload.astype(np.uint32), nbits


def pair_shape_cases(words: torch.Tensor):
    """pair_compact_or cases: merging compactions at every shape of
    PAIR_SHAPES, also as views one word into a larger tensor (both arrays,
    and the carrier alone: the two rows then lie on different grids), and
    the calls of a pack of (1031, L) ``words`` at each of ODD_LENS."""
    cases = []
    for n, (C, S) in enumerate(PAIR_SHAPES):
        carrier, payload, nbits = merging_compaction(C, S, seed=n)
        c = _u32.from_numpy(carrier).cuda()
        p = _u32.from_numpy(payload).cuda()
        cases += [((c, p, nbits), None),
                  ((offset_view(c), offset_view(p), nbits), None),
                  ((offset_view(c), p, nbits), None)]
    for L in ODD_LENS:
        w = words[:, :L].contiguous()
        bc, res = fp_torch._bcode_res_from_xors(*fp_cuda.predict_xors_plain(w, *EXP))
        seen = record_calls(lambda: fp_torch.pack_f32_chunks_v2(bc, res, *EXP))
        cases += [(args, None) for args in seen["pair_compact_or"]]
    return cases


def sort_shape_cases(words: torch.Tensor, exps):
    """Sort predictor cases cut from (SORT_ROWS, 65536) ``words``: every
    length of SORT_LENS at one chunk and at SORT_ROWS, at the first and the
    last exponents of ``exps``, and a view one word into a larger tensor."""
    cases = []
    for L in SORT_LENS:
        for C in (1, words.shape[0]):
            w = words[:C, :L].contiguous()
            cases += [((w, *e), None) for e in (exps[0], exps[-1])]
        cases.append(((offset_view(words[:, :L].contiguous()), *exps[0]), None))
    return cases


def fcm_shape_cases(words: torch.Tensor):
    """fcm_multi_xors cases cut from (1031, 4104) ``words``: every set of
    FCM_E1S at every length of ODD_LENS, one chunk and 1031, and views one
    word into a larger tensor."""
    cases = []
    for L in ODD_LENS:
        for C in (1, words.shape[0]):
            w = words[:C, :L].contiguous()
            cases += [((w, e1s), None) for e1s in FCM_E1S]
        cases.append(((offset_view(words[:, :L].contiguous()), FCM_EXTRA_E1S), None))
    return cases


def record_calls(run, largest=False):
    """Run ``run()`` with every kernel wrapper recording a copy (on the
    card) of what it was given: every call, or with ``largest`` only the
    call whose first argument has the most elements. Returns the calls by
    kernel."""
    seen = {k: [] for k in fp_cuda.KERNELS}
    real = {k: getattr(fp_cuda, k) for k in fp_cuda.KERNELS}
    aliases = [(k, mod, attr) for k in fp_cuda.KERNELS
               for mod, attr in ALIASES.get(k, ())]

    def recorder(name):
        def call(*args):
            if not (largest and seen[name]
                    and seen[name][0][0].numel() >= args[0].numel()):
                copy = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                seen[name] = [copy] if largest else seen[name] + [copy]
            return real[name](*args)
        return call

    try:
        for k in fp_cuda.KERNELS:
            setattr(fp_cuda, k, recorder(k))
        for k, mod, attr in aliases:
            setattr(mod, attr, getattr(fp_cuda, k))
        run()
    finally:
        for k in fp_cuda.KERNELS:
            setattr(fp_cuda, k, real[k])
        for k, mod, attr in aliases:
            setattr(mod, attr, real[k])
    return seen


def wide_indices(t: np.ndarray) -> np.ndarray:
    """The indices as u64 with bits 40-46 cycling through 0..96: zigzag
    deltas past 2^40, so every group needs more than 32 planes."""
    i = np.arange(len(t), dtype=np.uint64)
    return t.astype(np.uint64) | ((i % 97) << np.uint64(40))


def plain_by_rows(plain, args):
    """``plain(*args)`` over blocks of rows of its (C, ...) tensor arguments,
    concatenated: every kernel treats each row (chunk) alone, and a block
    keeps the plain version's int64 temporaries to a few GB."""
    C = args[0].shape[0]
    step = max(1, PLAIN_BLOCK // max(1, args[0][0].numel()))
    if step >= C:
        return plain(*args)
    parts = [plain(*(a[i : i + step] if torch.is_tensor(a) else a for a in args))
             for i in range(0, C, step)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def on_host(calls: dict) -> dict:
    """Recorded calls with their tensors moved to host memory, so that they
    take none of the card's until they are held."""
    return {k: [tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
                for args in v] for k, v in calls.items()}


def hold(name: str, args, what: str, restores=None) -> int:
    """One call of kernel ``name`` against its plain version (by blocks of
    rows) on the same inputs: fails unless they agree exactly (and, where
    ``restores`` is given, the kernel gives it back). Returns the max abs
    err, 0."""
    got = getattr(fp_cuda, name)(*args)
    want = plain_by_rows(PLAIN[name], args[:PLAIN_ARGS.get(name, len(args))])
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        err = max(err, max_abs_err(g, w))
    check(err == 0, f"{what}: kernel differs from its plain version (max abs "
          f"err {err})")
    if restores is not None:
        check(torch.equal(got[0], restores), f"{what}: values not restored")
    return err


def capture_main_path_inputs(x, x64, raw, raw64, tflat, lucy, meshes):
    """Run the main paths once at their shapes and record what each kernel
    wrapper was given: f32 encode and decode at (4,6), the same of the
    bench's second shape ((8192, 1024), its leg 3), the adaptive encode with
    the custom candidate set and with F32_TPU_CANDIDATES (the bench's leg
    2, whose (14,18) takes the sort kernel), the f32 reference layout through the
    device pack and parse, f64 encode and decode at (4,6), f64 encode at
    (20,20) and with F64_TPU_CANDIDATES (the sort kernel), the
    reference-layout f32 and f64 legs, BP32 and BP64 encode and decode of
    the whole fullmesh stream, and the Lucy archive written and read at
    ``optimize=True`` in both layouts, and the same mesh with f32 and f64
    vertices through ``compress_mesh`` / ``decompress_mesh`` on two shards
    of the card (each plane's hash_info groups split in two), and the v1
    archive of every class of the corpus gate's ``meshes`` written and read
    (planes of 2 to 11 full chunks and a tail, f64 vertices, u64
    triangles), and the scaling run's data through ``compress_mesh`` and
    ``decompress_mesh`` on its mesh of MP_SCALING_SHARDS shards (each
    shard's batch is the same chunk range however many processes hold the
    shards, so these are the calls of every configuration's ranks and of
    its decode check). Returns the calls by kernel and, apart, the BP legs'
    ``logshift`` calls."""
    bp32 = _u32.from_numpy(tflat.reshape(-1, BP_CHUNK)).cuda()
    bp64 = _u64.from_numpy(wide_indices(tflat).reshape(-1, BP64_CHUNK)).cuda()

    def run_fp():
        payloads, _ = fp_torch.encode_f32_chunks_v2(x, *EXP)
        back = fp_torch.decode_f32_chunks_v2(payloads, x.shape[1], *EXP)
        check(torch.equal(back, x), "f32 encode/decode round trip at the "
              "bench shape")
        xc = _u32.from_numpy(canary_stream(N_VALUES).reshape(
            -1, CANARY_LEN)).cuda()
        payloads, _ = fp_torch.encode_f32_chunks_v2(xc, *EXP)
        back = fp_torch.decode_f32_chunks_v2(payloads, CANARY_LEN, *EXP)
        check(torch.equal(back, xc), "f32 encode/decode round trip at the "
              "bench's second shape")
        del xc, back
        fp_torch.encode_f32_chunks_v2_adaptive(x, CUSTOM_CANDIDATES)
        # the bench's leg 2: (14,18) takes the sort kernel
        fp_torch.encode_f32_chunks_v2_adaptive(x, fp_torch.F32_TPU_CANDIDATES)
        payloads, _ = fp_torch.encode_f32_chunks(x, *EXP)
        back = fp_torch.decode_f32_chunks(payloads, x.shape[1], *EXP)
        check(torch.equal(back, x), "f32 reference-layout device pack and "
              "parse round trip at the bench shape")
        payloads, _ = fp64_torch.encode_f64_chunks_v2(x64, *EXP)
        back = fp64_torch.decode_f64_chunks_v2(payloads, x64.shape[1], *EXP)
        check(torch.equal(back, x64), "f64 encode/decode round trip at the "
              "bench shape")
        # the f64 default (20,20), then the adaptive set's (10,16), (20,20)
        fp64_torch.encode_f64_chunks_v2(x64, *SORT_EXPS64[0])
        fp64_torch.encode_f64_chunks_v2_adaptive(x64, fp64_torch.F64_TPU_CANDIDATES)
        for vals, mod in ((raw, fp_torch), (raw64, fp64_torch)):
            vals = vals[: REF_CHUNKS * CHUNK_LEN]
            enc = mod.encode_f32 if mod is fp_torch else mod.encode_f64
            dec = mod.decode_f32 if mod is fp_torch else mod.decode_f64
            mat, _, _ = enc(vals, CHUNK_LEN, *EXP, layout="ref", device="cuda")
            back = dec(mat, CHUNK_LEN, *EXP, layout="ref", device="cuda")
            check(np.array_equal(back, vals), "reference-layout round trip "
                  f"({vals.dtype})")

    def run_bp():
        for words, enc, dec in ((bp32, bp_torch.encode_bp32_chunks,
                                 bp_torch.decode_bp32_chunks),
                                (bp64, bp_torch.encode_bp64_chunks,
                                 bp_torch.decode_bp64_chunks)):
            payloads, _ = enc(words)
            check(torch.equal(dec(payloads, words.shape[1]), words),
                  f"BP round trip at {tuple(words.shape)}")

    def run_archives():
        for layout in ("tpu", "ref"):
            data = write_archive(lucy, "cuda", layout=layout)
            read_archive(data, lucy, f"Lucy archive capture, layout={layout}")

    def run_parallel():
        verts, tris, normals, colors = lucy_arrays(lucy)
        for v in (verts, verts.astype(np.float64)):
            mesh_round_trip(v, tris, normals, colors, make_mesh(2),
                            "parallel capture")

    def run_corpus():
        for name, mesh in meshes.items():
            blob = corpus_gate.our_archive(mesh, CHUNK_LEN, device="cuda")
            bad = corpus_gate.inexact_streams(blob, mesh, device="cuda")
            check(not bad, f"corpus capture, {name}: {bad} not read back bit-exact")

    def run_scaling():
        verts = scaling_verts(MP_SCALING_VERTS)
        mesh = make_mesh(MP_SCALING_SHARDS)
        blob = mesh_codec.compress_mesh(verts, chunk_len=CHUNK_LEN, mesh=mesh)
        back = mesh_codec.decompress_mesh(blob, mesh)
        check(same_bits(back["vertices"], verts), "scaling capture: vertices "
              "not read back bit-exact")

    seen = [record_calls(run) for run in (run_fp, run_bp, run_archives,
                                          run_parallel, run_corpus, run_scaling)]
    return ({k: sum((s[k] for s in seen), []) for k in fp_cuda.KERNELS},
            seen[1]["logshift"])


def kernel_phase(x, x64, raw, raw64, tflat, lucy, meshes):
    """Phase 3: every kernel against its plain version on the card. Extra
    replay cases must also restore the words they were predicted from."""
    seen, bp_calls = capture_main_path_inputs(x, x64, raw, raw64, tflat, lucy,
                                              meshes)
    special = _u32.from_numpy(special_words(256, CHUNK_LEN)).cuda()
    mixed = torch.cat([x[:256], special])
    special64 = _u64.from_numpy(special_words64(256, CHUNK_LEN)).cuda()
    mixed64 = torch.cat([x64[:256], special64])
    odd = (1031, CHUNK_LEN + 8)  # rows and lengths off every grid
    odd32 = _u32.from_numpy(special_words(*odd, seed=5)).cuda()
    extra = {"predict_xors": [((special, *EXP), None), ((mixed, *BIG_EXP), None)]
             + [((mixed, *e), None) for e in EXTRA_EXPS]
             + predict_shape_cases(odd32, BIG_EXP),
             "fcm_multi_xors": [((special, FCM_EXTRA_E1S), None)]
             + fcm_shape_cases(odd32),
             "replay": [], "logshift": logshift_shape_cases(),
             "pair_compact_or": pair_shape_cases(odd32),
             "predict64_xors": [((special64, *EXP), None)]
             + [((mixed64, *e), None) for e in EXTRA_EXPS64]
             + predict_shape_cases(
                 _u64.from_numpy(special_words64(*odd, seed=6)).cuda(), BIG_EXP64),
             "replay64": []}
    for e in EXTRA_EXPS:
        bc, res = fp_torch._bcode_res_from_xors(*fp_cuda.predict_xors_plain(mixed, *e))
        extra["replay"].append(((bc, res, *e), mixed))
    for e in (EXP,) + EXTRA_EXPS64:
        bc, res = fp64_torch._bcode_res_from_xors64(
            *fp_cuda.predict64_xors_plain(mixed64, *e))
        extra["replay64"].append(((bc, res, *e), mixed64))
    extra["replay"] += replay_shape_cases("replay", mixed)
    extra["replay64"] += replay_shape_cases("replay64", mixed64)
    long32 = _u32.from_numpy(special_words(SORT_ROWS, SORT_LENS[-1], seed=7)).cuda()
    extra["predict_sort_xors"] = (
        [((w, *e), None) for w in (x, mixed) for e in SORT_EXPS]
        + [((special, *SORT_EXPS[0]), None)] + sort_shape_cases(long32, SORT_EXPS))
    del long32
    long64 = _u64.from_numpy(special_words64(SORT_ROWS, SORT_LENS[-1], seed=8)).cuda()
    extra["predict64_sort_xors"] = (
        [((w, *e), None) for w in (x64, mixed64) for e in SORT_EXPS64]
        + [((special64, *SORT_EXPS64[0]), None)]
        + sort_shape_cases(long64, SORT_EXPS64))
    del long64
    results = {}
    for name in fp_cuda.KERNELS:
        check(len(seen[name]) > 0, f"{name}: the main path never called it")
        kern, plain = getattr(fp_cuda, name), PLAIN[name]
        cases = [(args, None) for args in seen[name]] + extra[name]
        err = max(hold(name, args, f"{name} case {i}", restores)
                  for i, (args, restores) in enumerate(cases))
        args0 = cases[0][0]
        out0 = kern(*args0)
        bound_ms, bound_by = bound_of(
            name, args0, out0 if isinstance(out0, tuple) else (out0,))
        ms = time_ms(lambda: kern(*args0), 20)
        plain_ms = time_ms(lambda: plain(*args0),
                           1 if name.startswith("replay") else 3)
        was = (f" (before its redesign: {BEFORE_REDESIGN_MS[name]} ms)"
               if name in BEFORE_REDESIGN_MS else "")
        print(f"kernel {name}: {len(cases)} cases exact; at "
              f"{tuple(args0[0].shape)}: kernel {ms:.4f} ms{was}, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.1f}% of it reached) [{CARD}]", flush=True)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None}
        extra[name] = cases = None  # the card's memory for the next kernel
    # the sort kernels at every main-path shape and exponent pair: the plain
    # version is the route the main paths took before these kernels
    for name, words, exps in (("predict_sort_xors", x, SORT_EXPS[0]),
                              ("predict64_sort_xors", x64, SORT_EXPS64[0]),
                              ("predict64_sort_xors", x64, SORT_EXPS64[1])):
        kern = getattr(fp_cuda, name)
        out = kern(words, *exps)
        bound_ms, _ = bound_of(name, (words, *exps), out)
        ms = time_ms(lambda: kern(words, *exps), 20)
        plain_ms = time_ms(lambda: PLAIN[name](words, *exps), 3)
        results[name].setdefault("timed", []).append(
            {"shape": list(words.shape), "exponents": list(exps), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms})
        print(f"kernel {name} at {tuple(words.shape)} {exps}: kernel "
              f"{ms:.4f} ms, plain (the route before it) {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of it "
              f"reached) [{CARD}]", flush=True)
    # BP32 and BP64 of the whole stream: encode bytes (pb 8), decode slot ids
    # (pb 16), bytes (pb 8); each call was among the cases held above
    shapes = [tuple(args[0].shape) for args in bp_calls]
    want = ([(len(tflat) // BP_CHUNK, 1 << 16)] * 3
            + [(len(tflat) // BP64_CHUNK, 1 << 16)] * 3)
    check(shapes == want, f"logshift: BP calls at {shapes}, want {want}")
    pack_calls = [a for a in seen["logshift"] if a[0].shape[1] == PACK_SLOTS]
    check([tuple(a[0].shape) for a in pack_calls] == [(x.shape[0], PACK_SLOTS)],
          "logshift: the reference layout's device pack is one call at "
          f"({x.shape[0]}, {PACK_SLOTS})")
    for args in pack_calls + bp_calls:
        ms = time_ms(lambda: fp_cuda.logshift(*args), 20)
        plain_ms = time_ms(lambda: plain_by_rows(PLAIN["logshift"], args), 3)
        bound_ms, _ = bound_of("logshift", args, (args[0],))
        print(f"kernel logshift at {tuple(args[0].shape)}, pb = "
              f"{args[1]}, {args[2]}: exact; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (in blocks of rows), bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f}% of it reached) [{CARD}]", flush=True)
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


def round_trip(raw, what: str, *exps, optimize=False, v1_check=False,
               kernel=None) -> bytes:
    """encode_chunked then decode_chunked on the card, bit-exact; with
    ``kernel``, the encode must have launched it."""
    before = dict(fp_cuda.launches)
    t0 = time.perf_counter()
    blob = chunked.encode_chunked(raw, CHUNK_LEN, *exps, optimize=optimize)
    t1 = time.perf_counter()
    mid = dict(fp_cuda.launches)
    back, bits = chunked.decode_chunked(blob)
    t2 = time.perf_counter()
    after = dict(fp_cuda.launches)

    def launched(a, b):
        return {k: b[k] - a[k] for k in fp_cuda.KERNELS if b[k] != a[k]}
    check(bits == 8 * raw.itemsize and back.dtype == raw.dtype
          and back.shape == raw.shape, f"{what}: decode_chunked shape/dtype")
    check(np.array_equal(back, raw), f"{what}: round trip")
    check(kernel is None or mid[kernel] > before[kernel],
          f"{what}: the encode launched no {kernel}")
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
          f"framing included); kernel launches of the encode call "
          f"{launched(before, mid)}, of the decode call {launched(mid, after)}; "
          f"chunks by exponents {sorted(infos.items())}"
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


def ref_device_leg(raw) -> None:
    """The f32 stream in the reference layout, packed and parsed on the
    card: bit-exact, the bytes of the host library's pack, of the v2
    payloads relaid out and of ``fp_ref.compress``; and the container of
    ``encode_chunked(layout="ref")`` with the host library hidden, which
    takes the same path, equal to the one written with it."""
    L = CHUNK_LEN
    before = dict(fp_cuda.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mat, sizes, tail = fp_torch.encode_f32(raw, L, *EXP, layout="ref",
                                           device_pack=True, device="cuda")
    t1 = time.perf_counter()
    mid = dict(fp_cuda.launches)
    back = fp_torch.decode_f32(mat, L, *EXP, layout="ref", device_parse=True,
                               device="cuda")
    t2 = time.perf_counter()
    after = dict(fp_cuda.launches)
    C = len(raw) // L
    check(mat.shape == (C, fp_torch.f32_max_chunk_bytes(L)) and len(tail) == 0,
          "reference layout on the device: payload shape")
    check(np.array_equal(back, raw), "reference layout on the device: round trip")
    check(mid["logshift"] - before["logshift"] == 1
          and mid["predict_xors"] - before["predict_xors"] == 1,
          "reference layout on the device: the encode is one predict_xors and "
          "one logshift launch")
    check(after["replay"] - mid["replay"] == 1
          and after["logshift"] == mid["logshift"],
          "reference layout on the device: the decode is one replay launch")
    host, host_sizes, _ = fp_torch.encode_f32(raw, L, *EXP, layout="ref",
                                              device="cuda")
    check(np.array_equal(mat, host) and np.array_equal(sizes, host_sizes),
          "reference layout on the device: bytes differ from the host "
          "library's pack")
    v2, v2_sizes, _ = fp_torch.encode_f32(raw, L, *EXP, device="cuda")
    check(np.array_equal(sizes, v2_sizes) and np.array_equal(
        mat, native.relayout_chunks(v2, L, 32, to_v2=False)),
        "reference layout on the device: bytes differ from the v2 payloads "
        "relaid out")
    check_v1_chunks([mat[c, : sizes[c]] for c in range(16)], raw, lambda p: p,
                    "reference layout on the device")
    with_lib = chunked.encode_chunked(raw, L, layout="ref", device="cuda")
    real = native.available
    native.available = lambda: False  # as on a host without a C++ toolchain
    try:
        blob = chunked.encode_chunked(raw, L, layout="ref", device="cuda")
        got, _ = chunked.decode_chunked(blob, device="cuda")
    finally:
        native.available = real
    check(blob == with_lib, "reference layout: the container differs without "
          "the host library")
    check(np.array_equal(got, raw), "reference layout without the host "
          "library: round trip")
    print(f"main path f32 {EXP} reference layout, device pack and parse: "
          f"{len(raw)} values -> {int(sizes.sum())} B in {C} chunks, encode_f32 "
          f"{t1 - t0:.3f} s, decode_f32 {t2 - t1:.3f} s (host clock, transfers "
          "included); bit-exact; bytes equal to the host library's pack, to "
          "the v2 payloads relaid out and (16 chunks) to fp_ref.compress; "
          "encode_chunked(layout='ref') without the host library writes the "
          f"same {len(blob)} B container and decode_chunked reads it back "
          f"[{CARD}]", flush=True)


def main_path_phase(raw, raw64):
    """Phase 4: the FP entry points on the card, bit-exact."""
    round_trip(raw, "f32 (4,6)", v1_check=True)
    round_trip(raw, "f32 fast", optimize="fast")
    round_trip(raw, "f32 optimize=True", optimize=True, v1_check=True,
               kernel="predict_sort_xors")
    custom_candidates_leg(raw)
    round_trip(raw, f"f32 {REPAIR_EXP} (sort predictor)", *REPAIR_EXP,
               v1_check=True, kernel="predict_sort_xors")
    ref_device_leg(raw)
    round_trip(raw64, "f64 (4,6)", *EXP, v1_check=True)
    round_trip(raw64, "f64 (20,20), the default", v1_check=True,
               kernel="predict64_sort_xors")
    round_trip(raw64, "f64 fast", optimize="fast")
    round_trip(raw64, "f64 optimize=True", optimize=True,
               kernel="predict64_sort_xors")
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


def peak_mib() -> str:
    """The card's peak allocated memory since the last reset, then reset."""
    peak = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    return f"peak device memory {peak:.0f} MiB"


def bp_leg(values: np.ndarray, chunk_len: int, what: str) -> None:
    """encode_bp_chunked then decode_bp_chunked on the card, bit-exact, and
    16 chunks equal to bp_ref.encode_chunk."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    blob = chunked.encode_bp_chunked(values, chunk_len, device="cuda")
    t1 = time.perf_counter()
    back = chunked.decode_bp_chunked(blob, device="cuda")
    t2 = time.perf_counter()
    check(back.dtype == values.dtype and np.array_equal(back, values),
          f"{what}: round trip")
    L = parse_validated_framing(blob)[0].chunk_len
    check(L == chunk_len, f"{what}: chunk length {L}")
    for c, p in enumerate(container_chunks(blob)[:16]):
        check(p.tobytes() == bp_ref.encode_chunk(values[c * L : (c + 1) * L]),
              f"{what}: chunk {c} differs from bp_ref.encode_chunk")
    print(f"main path {what}: {len(values)} values -> {len(blob)} B (ratio "
          f"{values.nbytes / len(blob):.4f}), encode_bp_chunked {t1 - t0:.3f} s, "
          f"decode_bp_chunked {t2 - t1:.3f} s (host clock); bit-exact, 16 "
          f"chunks equal bp_ref.encode_chunk; {peak_mib()}", flush=True)


def lz4_leg(tflat: np.ndarray) -> None:
    """The four byte planes of the triangle stream through
    encode_lz4_chunked on the card and the host decoder, bit-exact; the
    card's find_matches of two blocks equals the CPU's."""
    device_calls = []
    real = lz4_torch.find_matches

    def counted(blocks):
        if blocks.is_cuda:
            device_calls.append(tuple(blocks.shape))
        return real(blocks)

    planes = transpose.byte_planes(tflat)
    lz4_torch.find_matches = counted
    try:
        for k, plane in enumerate(planes):
            check(bool(np.any(plane != plane[0])), f"byte plane {k} is constant")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            blob = chunked.encode_lz4_chunked(plane, device="cuda")
            t1 = time.perf_counter()
            back = chunked.decode_lz4_chunked(blob)
            t2 = time.perf_counter()
            check(np.array_equal(back, plane), f"LZ4 byte plane {k}: round trip")
            print(f"main path LZ4 byte plane {k} of the triangle stream: "
                  f"{len(plane)} B -> {len(blob)} B (ratio "
                  f"{len(plane) / len(blob):.4f}), encode_lz4_chunked "
                  f"{t1 - t0:.3f} s, decode_lz4_chunked {t2 - t1:.3f} s (host "
                  f"clock); bit-exact; {peak_mib()}", flush=True)
    finally:
        lz4_torch.find_matches = real
    full_blocks = len(tflat) // LZ4_BLOCK
    check(device_calls == [(full_blocks, LZ4_BLOCK)] * 4,
          f"find_matches on the card: {device_calls}")
    blocks = torch.from_numpy(planes[0][: 2 * LZ4_BLOCK].reshape(2, LZ4_BLOCK))
    got = lz4_torch.find_matches(blocks.cuda())
    want = lz4_torch.find_matches(blocks)
    for g, w in zip(got, want):
        check(torch.equal(g.cpu(), w), "find_matches: card differs from CPU")
    print(f"main path LZ4: {len(device_calls)} find_matches calls on the card "
          f"({full_blocks} blocks of {LZ4_BLOCK} B each); the card's "
          "find_matches of 2 blocks equals the CPU's", flush=True)


def integer_phase(tflat: np.ndarray) -> None:
    """Phase 5: BP32, BP64 and LZ4 through the container entry points."""
    bp_leg(tflat, BP_CHUNK, "BP32 fullmesh triangles")
    t64 = tflat.astype(np.uint64)
    bp_leg(t64, BP64_CHUNK, "BP64 fullmesh triangles")
    bp_leg(wide_indices(tflat), BP64_CHUNK, "BP64 fullmesh triangles, bits "
           "40-46 cycling")
    del t64
    lz4_leg(tflat)


def lucy_mesh(n_verts: int):
    """bench.py:419-432's synthetic Lucy-class mesh (``bench.lucy_mesh``),
    with vertex normals and u32 colors quantised from the positions (alpha
    0xFF)."""
    verts, tris = bench.lucy_mesh(n_verts)
    normals = (verts / np.linalg.norm(verts, axis=1, keepdims=True)).astype(np.float32)
    return [("write_vertices", verts), ("write_triangles", tris),
            ("write_vertex_normals", normals),
            ("write_vertex_colors", quantised_colors(verts))]


def quantised_colors(xyz: np.ndarray) -> np.ndarray:
    lo, hi = xyz.min(axis=0), xyz.max(axis=0)
    q = ((xyz - lo) / (hi - lo) * 255).astype(np.uint32)
    return 0xFF000000 | q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)


def bunny_every_kind(verts: np.ndarray, tris: np.ndarray):
    """One stream of each of the 20 kinds, from the bunny."""
    v64 = verts.astype(np.float64)
    tn = compute_triangle_normals(verts, tris)
    vn = (verts / np.linalg.norm(verts, axis=1, keepdims=True)).astype(np.float32)
    uvt = verts[tris][:, :, :2].reshape(-1, 6)
    q = quantised_colors(verts)
    streams = []
    for sfx, cast in (("", np.float32), ("_double", np.float64)):
        streams += [(f"write_vertices{sfx}", verts.astype(cast)),
                    (f"write_vertex_normals{sfx}", vn.astype(cast)),
                    (f"write_triangle_normals{sfx}", tn.astype(cast)),
                    (f"write_uv_per_vertex{sfx}", verts[:, :2].astype(cast)),
                    (f"write_uv_per_triangle{sfx}", uvt.astype(cast))]
    return streams + [
        ("write_attributes_float", verts[:, 2].copy()),
        ("write_attributes_double", v64[:, 2].copy()),
        ("write_triangles", tris), ("write_triangles_long", tris.astype(np.uint64)),
        ("write_vertex_colors", q),
        ("write_triangle_colors", quantised_colors(tn)),
        ("write_attributes_uint8", (q & 0xFF).astype(np.uint8)),
        ("write_attributes_uint16", (q & 0xFFFF).astype(np.uint16)),
        ("write_attributes_uint32", q ^ 0xFF000000),
        ("write_attributes_uint64", q.astype(np.uint64) << np.uint64(30))]


def write_archive(streams, device: str, **kw) -> bytes:
    w = ArchiveWriter(chunk_len=CHUNK_LEN, device=device, **kw)
    for method, arr in streams:
        getattr(w, method)(arr)
    return w.tobytes()


def read_archive(data: bytes, streams, what: str) -> None:
    got = list(ArchiveReader(data, device="cuda").streams())
    check(len(got) == len(streams), f"{what}: {len(got)} streams read")
    for (method, want), (_, arr) in zip(streams, got):
        check(arr.dtype == want.dtype and np.array_equal(arr.reshape(want.shape), want),
              f"{what}: {method} not read back bit-exact")


def archive_phase(lucy, bunny_verts, bunny_tris) -> None:
    """Phase 6: whole v1 archives through ArchiveWriter / ArchiveReader."""
    raw = sum(a.nbytes for _, a in lucy)
    print(f"archive Lucy-class mesh: {len(lucy[0][1])} vertices, "
          f"{len(lucy[1][1])} triangles, normals and colors, {raw} B raw",
          flush=True)
    for layout in ("tpu", "ref"):
        for opt in (True, "fast"):
            what = f"Lucy archive layout={layout} optimize={opt}"
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            data = write_archive(lucy, "cuda", layout=layout, optimize=opt)
            t1 = time.perf_counter()
            read_archive(data, lucy, what)
            t2 = time.perf_counter()
            print(f"main path {what}: {len(data)} B (ratio {raw / len(data):.4f}), "
                  f"write {t1 - t0:.3f} s, read {t2 - t1:.3f} s (host clock); "
                  f"every stream bit-exact; {peak_mib()}", flush=True)
    every = bunny_every_kind(bunny_verts, bunny_tris)
    for layout in ("tpu", "ref"):
        data = write_archive(every, "cuda", layout=layout)
        read_archive(data, every, f"bunny every kind, layout={layout}")
        check(data == write_archive(every, "cpu", layout=layout),
              f"bunny every kind, layout={layout}: cuda and cpu bytes differ")
    print(f"main path bunny archive with all {len(every)} stream kinds, both "
          "layouts: bit-exact, the same bytes from device cuda and cpu",
          flush=True)


def lucy_arrays(streams):
    """(vertices, triangles, vertex normals, colors) of lucy_mesh's streams."""
    d = dict(streams)
    return (d["write_vertices"], d["write_triangles"], d["write_vertex_normals"],
            d["write_vertex_colors"])


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).reshape(-1).view(np.uint8),
        np.ascontiguousarray(b).reshape(-1).view(np.uint8)))


def mesh_round_trip(verts, tris, normals, colors, mesh, what, optimize=True,
                    profile=None):
    """``compress_mesh`` then ``decompress_mesh`` over ``mesh``: every
    stream back bit-exact. Returns (archive, route_stats, compress s,
    decompress s), host clock."""
    t0 = time.perf_counter()
    blob = mesh_codec.compress_mesh(verts, tris, vertex_normals=normals,
                                    vertex_colors=colors, chunk_len=CHUNK_LEN,
                                    mesh=mesh, optimize=optimize, profile=profile)
    t1 = time.perf_counter()
    stats = {}
    out = mesh_codec.decompress_mesh(blob, mesh, route_stats=stats)
    t2 = time.perf_counter()
    for name, want in (("vertices", verts), ("triangles", tris),
                       ("vertex_normals", normals), ("vertex_colors", colors)):
        if want is not None:
            check(same_bits(out[name], want), f"{what}: {name} not read back "
                  "bit-exact by decompress_mesh")
    return blob, stats, t1 - t0, t2 - t1


def device_seconds(trace) -> float:
    """Seconds of device time (kernels and copies) in a torch.profiler
    trace: the self time of its CUDA events."""
    total = 0
    for e in trace.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
    return total / 1e6


def point_cloud(n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) float32 points of a smooth seeded curve with a random walk on
    each axis, like a scanner's sweep."""
    r = np.random.default_rng(seed)
    t = np.linspace(0.0, 2000 * np.pi, n)
    pts = np.empty((n, 3), np.float32)
    for k in range(3):
        pts[:, k] = np.sin(t * (1 + 0.25 * k)) * 10 + np.cumsum(
            r.standard_normal(n, dtype=np.float32) * np.float32(1e-3))
    return pts


def lucy_published_leg() -> dict:
    """Leg 1: Lucy at its published size through ``compress_mesh`` on
    ``make_mesh()`` (the one card), byte-equal to ``ArchiveWriter``'s
    archive, every stream back bit-exact, six sharded FP substreams. A
    second round trip records the largest call of each kernel, which it
    returns."""
    lucy = lucy_mesh(LUCY_PUBLISHED_VERTS)
    verts, tris, normals, colors = lucy_arrays(lucy)
    raw = sum(a.nbytes for _, a in lucy)
    mesh = make_mesh()
    check(mesh.size == torch.cuda.device_count() and mesh.group is None,
          f"make_mesh(): {mesh}")
    torch.cuda.reset_peak_memory_stats()
    prof = profiling.StageTimer()
    blob, stats, enc_s, dec_s = mesh_round_trip(
        verts, tris, normals, colors, mesh, "Lucy at its published size",
        profile=prof)
    peak = peak_mib()
    t0 = time.perf_counter()
    want = write_archive(lucy, "cuda")
    writer_s = time.perf_counter() - t0
    check(blob == want, "Lucy at its published size: compress_mesh's archive "
          "differs from ArchiveWriter's")
    check(stats["sharded_fp"] == 6 and stats["host_other"] == 0,
          f"Lucy route_stats {stats}")
    print(f"parallel Lucy at its published size: {len(verts)} vertices, "
          f"{len(tris)} triangles, normals and colors, {raw} B raw -> "
          f"{len(blob)} B (ratio {raw / len(blob):.4f}) on {mesh}: "
          f"compress_mesh {enc_s:.3f} s, decompress_mesh {dec_s:.3f} s (host "
          f"clock; ArchiveWriter {writer_s:.3f} s), the bytes of ArchiveWriter, "
          f"every stream bit-exact, route_stats {stats}; {peak} [{CARD}]",
          flush=True)
    print("  compress_mesh stages (host clock):\n  "
          + prof.report().replace("\n", "\n  "), flush=True)
    again = []
    calls = record_calls(lambda: again.append(mesh_round_trip(
        verts, tris, normals, colors, mesh, "Lucy at its published size, "
        "recorded")[0]), largest=True)
    check(again == [blob], "Lucy at its published size: the recorded round "
          "trip's archive differs")
    return on_host(calls)


def shard_count_leg(lucy) -> dict:
    """Leg 2: the 2M-vertex Lucy on meshes of 1, 2 and 4 shards of the one
    card, f32 and f64 vertices, optimize=True and "fast": the same bytes
    (those of ArchiveWriter) whatever the shard count, bit-exact. Returns
    the archives by (dtype, optimize)."""
    verts, tris, normals, colors = lucy_arrays(lucy)
    check(make_mesh(2, device="cuda:0").shards == (torch.device("cuda", 0),) * 2,
          "make_mesh(2, device='cuda:0') lists cuda:0 twice")
    blobs = {}
    for dt in (np.float32, np.float64):
        v = verts.astype(dt)
        streams = [("write_vertices" if dt == np.float32 else "write_vertices_double", v),
                   *lucy[1:]]
        for opt in (True, "fast"):
            want = write_archive(streams, "cuda", optimize=opt)
            for n in SHARD_COUNTS:
                mesh = make_mesh(n)
                check(mesh.shards == (torch.device("cuda", 0),) * n,
                      f"make_mesh({n}) on one card: {mesh}")
                torch.cuda.reset_peak_memory_stats()
                what = f"Lucy {len(v)} vertices {np.dtype(dt).name} optimize={opt} on {n} shards"
                blob, stats, enc_s, dec_s = mesh_round_trip(
                    v, tris, normals, colors, mesh, what, optimize=opt)
                check(blob == want, f"{what}: the bytes differ from ArchiveWriter's")
                print(f"parallel {what}: {len(blob)} B, the bytes of ArchiveWriter; "
                      f"compress_mesh {enc_s:.3f} s, decompress_mesh {dec_s:.3f} s "
                      f"(host clock), bit-exact, route_stats {stats}; "
                      f"{peak_mib()} [{CARD}]", flush=True)
            blobs[dt, opt] = want
    flat = tris.reshape(-1)
    for words, chunk_len in ((flat, BP_CHUNK), (wide_indices(flat), BP64_CHUNK)):
        cont = chunked.encode_bp_chunked(words, chunk_len)
        for n in SHARD_COUNTS:
            t0 = time.perf_counter()
            back = mesh_codec.decode_bp_sharded(cont, make_mesh(n))
            check(back.dtype == words.dtype and np.array_equal(back, words),
                  f"decode_bp_sharded {words.dtype} on {n} shards")
            print(f"parallel decode_bp_sharded: {len(words)} {words.dtype} "
                  f"triangle indices in chunks of {chunk_len} on {n} shards, "
                  f"{time.perf_counter() - t0:.3f} s (host clock), bit-exact "
                  f"[{CARD}]", flush=True)
    return blobs


def run_workers(argvs) -> tuple[list[bytes], float]:
    """One process of ``python -m trico_tpu_torch.parallel.mp_worker`` per
    argument list (RANK NPROC PORT OUT, flags), all at once; fails unless
    each exits 0. Returns the archive each wrote (``OUT.rank<RANK>``) and
    the host-clock seconds for all of them, start-up included."""
    WORK.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    done = run_ranks([[sys.executable, "-m", "trico_tpu_torch.parallel.mp_worker",
                       *map(str, argv)] for argv in argvs], timeout=300)
    seconds = time.perf_counter() - t0
    for argv, (rc, text) in zip(argvs, done):
        check(rc == 0, f"mp_worker {argv} failed:\n{text[-3000:]}")
    return [Path(f"{argv[3]}.rank{argv[0]}").read_bytes() for argv in argvs], seconds


def nccl_leg(lucy, want: bytes) -> None:
    """Leg 3: a process group of one over NCCL in this process; meshes of 1
    and 4 shards then run the collectives (dist.all_gather on the card)
    and must give leg 2's bytes. Then ``mp_worker --backend nccl`` as a
    world of one, four shards, must give the in-process archive of its
    data."""
    verts, tris, normals, colors = lucy_arrays(lucy)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        for n in (1, 4):
            mesh = make_mesh(n)
            check(mesh.group is not None and mesh.world_size == 1
                  and mesh.size == n, f"make_mesh({n}) under NCCL: {mesh}")
            torch.cuda.reset_peak_memory_stats()
            blob, stats, enc_s, dec_s = mesh_round_trip(
                verts, tris, normals, colors, mesh, f"NCCL group of one, {n} shards")
            check(blob == want, f"NCCL group of one, {n} shards: the bytes differ")
            print(f"parallel NCCL process group of one, {n} shards on "
                  f"cuda:0 (sizes and payload rows through dist.all_gather on "
                  f"the card): {len(blob)} B, leg 2's bytes; compress_mesh "
                  f"{enc_s:.3f} s, decompress_mesh {dec_s:.3f} s (host clock), "
                  f"bit-exact; {peak_mib()} [{CARD}]", flush=True)
    finally:
        dist.destroy_process_group()
    (blob,), seconds = run_workers([[0, 1, free_port(), WORK / "nccl_blob",
                                     "--backend", "nccl", "--shards-per-rank", 4]])
    check(blob == mp_worker.worker_blobs(make_mesh(4)),
          "mp_worker --backend nccl: its bytes differ from the in-process archive")
    print(f"parallel mp_worker --backend nccl, a world of one, four shards on "
          f"cuda:0: {len(blob)} B, the bytes of the in-process mesh of four "
          f"shards; {seconds:.1f} s (host clock, start-up included) [{CARD}]",
          flush=True)


def two_process_leg() -> None:
    """Leg 4: two processes of ``python -m trico_tpu_torch.parallel.
    mp_worker`` on the one card (its default device), two shards each, over
    gloo (NCCL refuses two ranks on one GPU): both ranks' bytes equal the
    in-process archive of the same data on a mesh of four shards."""
    port = free_port()
    blobs, seconds = run_workers([[rank, 2, port, WORK / "mp_blob",
                                   "--shards-per-rank", 2] for rank in (0, 1)])
    torch.cuda.reset_peak_memory_stats()
    want = mp_worker.worker_blobs(make_mesh(4))
    check(blobs[0] == blobs[1] == want, "two processes on the card: the ranks' "
          "bytes differ from each other or from the in-process archive")
    print(f"parallel two processes on cuda:0 over gloo (NCCL refuses two ranks "
          f"on one GPU), two shards each: {len(want)} B from each rank, the "
          f"bytes of the in-process mesh of four shards; {seconds:.1f} s for "
          f"both processes (host clock, start-up included); in-process "
          f"{peak_mib()} [{CARD}]", flush=True)


def cloud_leg() -> dict:
    """Leg 5: the 100M-point cloud, compress_mesh then decompress_mesh,
    bit-exact, on the fewest shards of the one card whose peak fits
    MEMORY_SHARE of its memory, by the bytes per value of a calibration run
    of CLOUD_CALIBRATION points on one shard. A second round trip, under
    the profiler, records the largest call of each kernel, which it
    returns."""
    t0 = time.perf_counter()
    pts = point_cloud(CLOUD_POINTS)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    mesh_round_trip(pts[:CLOUD_CALIBRATION], None, None, None, make_mesh(1),
                    "point cloud calibration")
    per_value = torch.cuda.max_memory_allocated() / (3 * CLOUD_CALIBRATION)
    total = torch.cuda.get_device_properties(0).total_memory
    shards = max(1, math.ceil(pts.size * per_value / (MEMORY_SHARE * total)))
    mesh = make_mesh(shards)
    torch.cuda.reset_peak_memory_stats()
    prof = profiling.StageTimer()
    blob, stats, enc_s, dec_s = mesh_round_trip(
        pts, None, None, None, mesh, "point cloud", profile=prof)
    check(stats["sharded_fp"] == 3, f"point cloud route_stats {stats}")
    peak = peak_mib()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    runs = []
    with torch.profiler.profile(activities=acts) as trace:
        calls = record_calls(lambda: runs.append(mesh_round_trip(
            pts, None, None, None, mesh, "point cloud under the profiler")),
            largest=True)
    again, _, enc2_s, dec2_s = runs[0]
    check(again == blob, "point cloud: the second archive differs")
    busy = device_seconds(trace)
    print(f"parallel point cloud: {len(pts)} xyz f32 points ({pts.nbytes} B; "
          f"generated in {gen_s:.1f} s) -> {len(blob)} B (ratio "
          f"{pts.nbytes / len(blob):.4f}) on {shards} shards of cuda:0 (the "
          f"calibration of {CLOUD_CALIBRATION} points on one shard peaked at "
          f"{per_value:.1f} B per value; a shard may take {MEMORY_SHARE} of "
          f"{total / 2**20:.0f} MiB): compress_mesh {enc_s:.3f} s, "
          f"decompress_mesh {dec_s:.3f} s (host clock), bit-exact, route_stats "
          f"{stats}; {peak} [{CARD}]", flush=True)
    print("  compress_mesh stages (host clock):\n  "
          + prof.report().replace("\n", "\n  "), flush=True)
    print(f"  again under torch.profiler, recording the largest call of each "
          f"kernel (a copy on the card): compress_mesh {enc2_s:.3f} s, "
          f"decompress_mesh {dec2_s:.3f} s; the card busy (kernels and copies) "
          f"{busy:.3f} s of them, a share of {busy / (enc2_s + dec2_s):.3f} "
          f"[{CARD}]", flush=True)
    return on_host(calls)


def parallel_phase(lucy) -> dict:
    """Phase 7: the mesh codec of ``trico_tpu_torch.parallel``. Returns
    the largest call of each kernel in the Lucy-size and the cloud legs."""
    lucy_calls = lucy_published_leg()
    blobs = shard_count_leg(lucy)
    nccl_leg(lucy, blobs[np.float32, True])
    two_process_leg()
    return {"Lucy at its published size": lucy_calls, "point cloud": cloud_leg()}


def hold_leg_calls(legs: dict, results: dict) -> None:
    """The largest call of each kernel in the parallel phase's big legs
    (kept in host memory) against its plain version on the card, by blocks
    of rows: exact; each kernel's max abs err takes them in."""
    for leg, calls in legs.items():
        for name, cases in calls.items():
            for args in cases:
                args = tuple(a.cuda() if torch.is_tensor(a) else a for a in args)
                t0 = time.perf_counter()
                err = hold(name, args, f"{name}, the {leg}'s largest call")
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
                print(f"kernel {name} at {tuple(args[0].shape)}, the largest "
                      f"call of the parallel {leg}: exact against its plain "
                      f"version ({time.perf_counter() - t0:.1f} s) [{CARD}]",
                      flush=True)
    legs.clear()


def cli_phase(bunny_verts, bunny_tris) -> None:
    """Phase 7: the CLI as subprocesses, a v1 archive on the card (the
    default, and with --chunked) and a v0 archive on the host (--backend),
    each with --profile."""
    WORK.mkdir(parents=True, exist_ok=True)
    src = REPO / "tests" / "data" / "StanfordBunny.stl"
    streams = [("write_vertices", bunny_verts), ("write_triangles", bunny_tris)]
    v0 = ArchiveWriter(device="cpu")
    for method, arr in streams:
        getattr(v0, method)(arr)
    v1 = write_archive(streams, "cuda")
    for what, flags, want in (
            ("(the default: version 1 on the card)", [], v1),
            ("--chunked --device cuda", ["--chunked", "--device", "cuda"], v1),
            ("--backend auto (version 0, on the host)", ["--backend", "auto"],
             v0.tobytes())):
        trc, back = WORK / "bunny.trc", WORK / "bunny_back.stl"
        reported = []
        t0 = time.perf_counter()
        for args, stages in ((["encode", "-i", src, "-o", trc, *flags],
                              ("read_stl", "encode_vertices", "encode_triangles",
                               "write_archive")),
                             (["decode", "-i", trc, "-o", back, "--device", "cuda"],
                              ("decode_vertex_float", "decode_triangle_uint32",
                               "write_mesh"))):
            res = subprocess.run([sys.executable, "-m", "trico_tpu_torch",
                                  *map(str, args), "--profile"], cwd=REPO,
                                 capture_output=True, text=True, timeout=600)
            check(res.returncode == 0,
                  f"CLI {args[0]} {what} failed:\n{res.stderr[-3000:]}")
            rows = [ln.split()[0] for ln in res.stderr.splitlines()
                    if " ms " in ln]
            check(rows == list(stages),
                  f"CLI {args[0]} {what}: --profile reported {rows}")
            reported += rows
        v, t = read_stl(back)
        check(np.array_equal(v.view(np.uint32), bunny_verts.view(np.uint32))
              and np.array_equal(t, bunny_tris),
              f"CLI {what}: geometry read back differs")
        check(trc.read_bytes() == want,
              f"CLI {what}: archive differs from ArchiveWriter's")
        print(f"CLI: python -m trico_tpu_torch encode {what} and decode on the "
              f"bunny STL ({time.perf_counter() - t0:.1f} s for both "
              f"processes): geometry equal, {len(want)} B archive equal to "
              f"ArchiveWriter's, --profile reports {', '.join(reported)}",
              flush=True)


def throughput_phase(x, x64, tflat) -> float:
    """Phase 9: device-resident encode and decode rates. Returns the f32
    (4,6) ratio."""
    def report(what, words, enc, dec=None) -> float:
        """Encode (and decode) rates of (C, L) words; decode must restore.
        Returns the ratio."""
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
        ratio = nbytes / float(sizes.sum().item())
        print(f"{line}, ratio {ratio:.4f} [{CARD}]", flush=True)
        return ratio

    L = CHUNK_LEN
    ratio = report("f32 (4,6)", x, lambda w: fp_torch.encode_f32_chunks_v2(w, *EXP),
           lambda p: fp_torch.decode_f32_chunks_v2(p, L, *EXP))
    report("f32 (4,6), reference layout packed and parsed on the device", x,
           lambda w: fp_torch.encode_f32_chunks(w, *EXP),
           lambda p: fp_torch.decode_f32_chunks(p, L, *EXP))
    report("f32 optimize=True", x, lambda w: fp_torch.encode_f32_chunks_v2_adaptive(
        w, fp_torch.F32_TPU_CANDIDATES))
    report("f64 (4,6)", x64, lambda w: fp64_torch.encode_f64_chunks_v2(w, *EXP),
           lambda p: fp64_torch.decode_f64_chunks_v2(p, L, *EXP))
    report("f64 optimize=True", x64,
           lambda w: fp64_torch.encode_f64_chunks_v2_adaptive(
               w, fp64_torch.F64_TPU_CANDIDATES))
    torch.cuda.reset_peak_memory_stats()
    t32 = _u32.from_numpy(tflat.reshape(-1, BP_CHUNK)).cuda()
    report("BP32 fullmesh triangles", t32, bp_torch.encode_bp32_chunks,
           lambda p: bp_torch.decode_bp32_chunks(p, BP_CHUNK))
    print(f"  BP32: {peak_mib()}", flush=True)
    del t32
    t64 = _u64.from_numpy(tflat.astype(np.uint64).reshape(-1, BP64_CHUNK)).cuda()
    report("BP64 fullmesh triangles", t64, bp_torch.encode_bp64_chunks,
           lambda p: bp_torch.decode_bp64_chunks(p, BP64_CHUNK))
    print(f"  BP64: {peak_mib()}", flush=True)
    del t64
    plane = transpose.byte_planes(tflat)[0]
    blocks = torch.from_numpy(plane[: len(plane) // LZ4_BLOCK * LZ4_BLOCK]
                              .reshape(-1, LZ4_BLOCK)).cuda()
    all_ms = time_ms(lambda: lz4_torch.find_matches(blocks), 3)
    one_ms = time_ms(lambda: lz4_torch.find_matches(blocks[:1]), 10)
    print(f"throughput find_matches (device-resident, CUDA events): "
          f"{blocks.shape[0]} blocks of {LZ4_BLOCK} B in {all_ms:.3f} ms, "
          f"{all_ms / blocks.shape[0]:.4f} ms per block; one block alone "
          f"{one_ms:.4f} ms; {peak_mib()}", flush=True)
    return ratio


def bench_phase(f32_ratio: float) -> tuple[dict, dict]:
    """Phase 10: ``python -m trico_tpu_torch.bench`` at its defaults, alone
    in a process: every leg exact, leg 1's ratio that of phase 9 on the
    same stream. Returns the bench's launches by kernel (counted from 0 in
    its process) and the launches of its headline leg (legs 1-2)."""
    torch.cuda.empty_cache()  # the card's memory is the bench's
    env = {k: v for k, v in os.environ.items() if not k.startswith("TRICO_BENCH_")}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "trico_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT)
    seconds = time.perf_counter() - t0
    for log in out.stderr.splitlines()[-20:]:
        print(f"  {log}")
    check(out.returncode == 0, f"the bench exited {out.returncode}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    e = line["extra"]
    exact = {"headline": e["exact"], "miscompile_canary": e["miscompile_canary"],
             "scale": e["scale"]["lucy42M"]["exact"],
             "fullmesh": e["fullmesh"]["exact"], "f64": e["f64"]["exact"],
             "bunny": e["bunny_exact"], "bunny_v1": e["bunny_v1_exact"],
             "fullmesh_archive": e["fullmesh_archive"]["exact"]}
    check(all(exact.values()) and "inexact_roundtrip" not in e,
          f"the bench's round trips: {exact}")
    check(e["ratio"] == f32_ratio,
          f"the bench's f32 ratio {e['ratio']} is not phase 9's {f32_ratio}")
    check(e["backend"] == "cuda", f"the bench ran on {e['backend']}")
    print(f"bench ({seconds:.1f} s in all) [{CARD}]: {json.dumps(line)}",
          flush=True)
    return e["kernel_launches"], e["legs"]["headline"]["kernel_launches"]


def corpus_phase() -> None:
    """Phase 11: ``python -m trico_tpu_torch.tools.corpus_gate`` in this
    process, on the card: seven classes, every stream of both archives back
    bit-exact, every v0 and v1 size that of CORPUS.json, and the gate
    passed against the reference's size (recorded unless the reference
    builds)."""
    WORK.mkdir(parents=True, exist_ok=True)
    out = WORK / "corpus_gate.json"
    t0 = time.perf_counter()
    rc = corpus_gate.main(["--json", str(out)])
    seconds = time.perf_counter() - t0
    result = json.loads(out.read_text())
    recorded = json.loads(corpus_gate.RECORDED.read_text())
    rows = result["rows"]
    check(result["backend"] == "cuda", f"the corpus gate ran on {result['backend']}")
    check(sorted(rows) == sorted(recorded) and len(rows) == 7,
          f"the corpus gate's classes {sorted(rows)}")
    for name, row in rows.items():
        check(row["exact"], f"corpus {name}: a round trip is not bit-exact")
        for k in ("v0_bytes", "v1_bytes"):
            check(row[k] == recorded[name][k], f"corpus {name}: {k} {row[k]}, "
                  f"CORPUS.json's {recorded[name][k]}")
        print(f"corpus {name}: raw {row['raw_bytes']} B, ref {row['ref_bytes']} B "
              f"({row['ref_source']}), v0 {row['v0_bytes']} B ({row['v0_vs_ref']} "
              f"of ref), v1 {row['v1_bytes']} B ({row['v1_vs_ref']}), the sizes "
              f"of CORPUS.json; v1 written in {row['t_v1_s']} s (host clock), "
              f"every stream bit-exact", flush=True)
    check(rc == 0 and result["ok"], f"the corpus gate failed: {result['failures']}")
    print(f"corpus gate passed in {seconds:.1f} s [{CARD}]", flush=True)


def mp_scaling_phase() -> dict:
    """Phase 12: ``python -m trico_tpu_torch.tools.mp_scaling`` as a
    subprocess at MP_SCALING_VERTS on MP_SCALING_SHARDS shards over
    MP_SCALING_PROCS processes: the same bytes in every configuration,
    decoded bit-exact. Returns the kernel launches of its ranks and of its
    decode check, summed."""
    torch.cuda.empty_cache()  # the card's memory is the ranks'
    procs = ",".join(map(str, MP_SCALING_PROCS))
    t0 = time.perf_counter()
    # a session of its own, so that a run cut by the time limit is stopped
    # with every rank it started
    proc = subprocess.Popen([sys.executable, "-m", "trico_tpu_torch.tools.mp_scaling",
                             "--verts", str(MP_SCALING_VERTS), "--procs", procs,
                             "--shards", str(MP_SCALING_SHARDS)],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=MP_SCALING_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    seconds = time.perf_counter() - t0
    for log in stderr.splitlines()[-20:]:
        print(f"  {log}")
    check(proc.returncode == 0, f"mp_scaling exited {proc.returncode}")
    line = json.loads(stdout.strip().splitlines()[-1])
    rows = line["configs"]
    check(line["backend"] == "cuda", f"mp_scaling ran on {line['backend']}")
    check([r["n_processes"] for r in rows] == list(MP_SCALING_PROCS),
          f"mp_scaling ran {[r['n_processes'] for r in rows]} processes")
    check(line["byte_identical_across_configs"] and line["exact"] and line["ok"],
          "mp_scaling: the archives differ between configurations or do not "
          "decode bit-exact")
    print(f"mp_scaling ({seconds:.1f} s in all): compress_mesh of {MP_SCALING_VERTS} "
          f"f32 vertices on {MP_SCALING_SHARDS} shards of cuda:0, "
          f"{rows[0]['archive_bytes']} B in every configuration, decoded "
          "bit-exact; " + "; ".join(
              f"{r['n_processes']} processes: wall {r['wall_s']:.4f} s, efficiency "
              f"{r['efficiency_vs_1proc']:.4f}, gather_frac {r['gather_frac']:.4f}"
              for r in rows) + f" (one card shared in time: overhead, not scaling) "
          f"[{CARD}]", flush=True)
    print(f"mp_scaling line: {json.dumps(line)}", flush=True)
    return {k: sum(r["kernel_launches"][k] for r in rows)
            + line["decode_kernel_launches"][k] for k in fp_cuda.KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    global CARD
    CARD = ", ".join(bench.card(torch.device("cuda", 0)).values())
    print(f"gpu: {CARD}", flush=True)

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    raw = bench_stream(N_VALUES)
    raw64 = bench_stream64(N_F64)
    tflat = fullmesh_indices()
    x = _u32.from_numpy(raw.reshape(-1, CHUNK_LEN)).cuda()
    x64 = _u64.from_numpy(raw64.reshape(-1, CHUNK_LEN)).cuda()
    lucy = lucy_mesh(LUCY_VERTS)
    meshes = build_corpus()
    t0 = time.perf_counter()
    kern = kernel_phase(x, x64, raw, raw64, tflat, lucy, meshes)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s; {peak_mib()}",
          flush=True)

    bunny_verts, bunny_tris = read_stl(REPO / "tests" / "data" / "StanfordBunny.stl")
    # each path runs with the launch counts at 0 and is read just after
    paths = {"fp": lambda: main_path_phase(raw, raw64),
             "integer": lambda: integer_phase(tflat),
             "archive": lambda: archive_phase(lucy, bunny_verts, bunny_tris),
             "parallel": lambda: parallel_phase(lucy)}
    # calls of a plain version with tensors on the card, by phase (phase 3
    # holds the kernels against them; no other phase may make one)
    plain = {}
    by_path, returned = {}, {}
    for path, run in paths.items():
        fp_cuda.reset_launches()
        returned[path] = run()
        torch.cuda.synchronize()
        by_path[path] = dict(fp_cuda.launches)
        plain[path] = fp_cuda.plain_on_card
    # the parallel path's largest calls, held once its count is read
    hold_leg_calls(returned["parallel"], kern)
    fp_cuda.reset_launches()
    cli_phase(bunny_verts, bunny_tris)

    f32_ratio = throughput_phase(x, x64, tflat)
    plain["throughput"] = fp_cuda.plain_on_card
    by_path["bench"], headline = bench_phase(f32_ratio)
    fp_cuda.reset_launches()
    corpus_phase()
    torch.cuda.synchronize()
    by_path["corpus"] = dict(fp_cuda.launches)
    plain["corpus"] = fp_cuda.plain_on_card
    by_path["mp_scaling"] = mp_scaling_phase()
    print(f"plain versions given tensors on the card in phases 4-12: {plain}",
          flush=True)
    check(not any(plain.values()), "a plain version ran on the card outside "
          "phase 3")

    check(by_path["integer"]["logshift"] > 0, "logshift: no launch in the "
          "integer path")
    check(headline["predict_sort_xors"] > 0, "predict_sort_xors: no launch in "
          "the bench's headline leg (leg 2, the adaptive encode)")
    rows = []
    for name in fp_cuda.KERNELS:
        for path in EXPECTED_PATHS[name]:
            check(by_path[path][name] > 0, f"{name}: no launch in the {path} path")
        replaces, also = REPLACES[name]
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": replaces,
               "launches": sum(c[name] for c in by_path.values()), **kern[name],
               "launches_by_path": {p: c[name] for p, c in by_path.items()}}
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
