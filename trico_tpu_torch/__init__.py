"""trico_tpu_torch: trico-tpu's device codecs in PyTorch, with CUDA kernels
written for the NVIDIA H100 (sm_90a).

A second package beside :mod:`trico_tpu`, which stays the reference: the same
inputs give the same bytes. Ported is every module of ``trico_tpu``: every
path of a v1 mesh archive, on one device or over several:

* :mod:`trico_tpu_torch.archive` — ``ArchiveWriter`` / ``ArchiveReader`` (v1
  substreams on a torch device, v0 on the host);
* :mod:`trico_tpu_torch.cli` — ``python -m trico_tpu_torch encode|decode``;
* :mod:`trico_tpu_torch.chunked` — the v1 containers: FP
  (``encode_fp_planes`` / ``encode_chunked`` / ``decode_chunked``, both
  chunk layouts, every ``optimize`` profile), BP (``encode_bp_chunked`` /
  ``decode_bp_chunked``), LZ4 byte planes (``encode_lz4_chunked``) and
  ``encode_int_best``; every ``device=`` takes a device or a mesh;
* :mod:`trico_tpu_torch.shards` — ``Mesh`` and ``make_mesh``, and the
  shard runner under every codec: a device is the mesh of one shard;
* :mod:`trico_tpu_torch.codec.fp_torch` and
  :mod:`trico_tpu_torch.codec.fp64_torch` — the f32 and f64 chunk codecs
  (counterparts of ``trico_tpu.codec.fp_jax`` and ``fp64_jax``);
* :mod:`trico_tpu_torch.codec.bp_torch` — BP32 / BP64 (``bp_jax``);
* :mod:`trico_tpu_torch.codec.lz4_torch` — the LZ4 match search
  (``lz4_jax``);
* :mod:`trico_tpu_torch.codec.pack_funnel` — f32 residual region packing;
* :mod:`trico_tpu_torch.codec.fp_cuda` — the nine CUDA kernels (source in
  ``codec/csrc/``) that replace the nine Pallas kernels and the sort
  predictor that ``fp_jax`` runs through XLA for big tables, each beside
  its plain PyTorch version;
* :mod:`trico_tpu_torch.native` — the C++ host library (tails, big-table
  chunks, v0 archives, reference-layout pack and parse, LZ4 emit), with the
  NumPy oracles ``codec.fp_ref``, ``bp_ref``, ``lz4_ref`` and
  ``codec.transpose`` as its fallback;
* :mod:`trico_tpu_torch.parallel` — ``make_mesh``, ``compress_mesh`` and
  ``decompress_mesh``: the archive writer and reader on a mesh of
  devices, across processes by ``torch.distributed``
  (``trico_tpu.parallel.mesh_codec``);
* :mod:`trico_tpu_torch.io` — the STL and PLY readers and writers;
* :mod:`trico_tpu_torch.profiling` — ``StageTimer``, ``trace``, ``annotate``;
* :mod:`trico_tpu_torch.staging` — the reused page-locked host buffers that
  the integer encode's copies from the card land in.

The package stands alone: it imports neither JAX nor anything of
``trico_tpu``, and keeps its own copy of every host part. Every entry point
runs on ``device="cuda"`` unless the caller asks for ``"cpu"``, and raises
where there is no card.
"""

from . import _u32, _u64, archive, chunked, native, parallel, shards
from .archive import ArchiveReader, ArchiveWriter, StreamType
from .chunked import (decode_bp_chunked, decode_chunked, decode_lz4_chunked,
                      encode_bp_chunked, encode_chunked, encode_fp_planes,
                      encode_int_best, encode_lz4_chunked)
from .codec import bp_torch, fp64_torch, fp_cuda, fp_torch, lz4_torch, pack_funnel
from .io.ply import PlyMesh, read_ply, write_ply
from .io.stl import compute_triangle_normals, read_stl, write_stl

__version__ = "0.5.0"

__all__ = ["ArchiveReader", "ArchiveWriter", "PlyMesh", "StreamType", "_u32",
           "_u64", "archive", "bp_torch", "chunked", "compute_triangle_normals",
           "decode_bp_chunked", "decode_chunked", "decode_lz4_chunked",
           "encode_bp_chunked", "encode_chunked", "encode_fp_planes",
           "encode_int_best", "encode_lz4_chunked", "fp64_torch", "fp_cuda",
           "fp_torch", "lz4_torch", "native", "pack_funnel", "parallel",
           "read_ply", "read_stl", "shards", "write_ply", "write_stl",
           "__version__"]
