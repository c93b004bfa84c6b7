"""trico_tpu_torch: trico-tpu's device codecs in PyTorch, with CUDA kernels
written for the NVIDIA H100 (sm_90a).

A second package beside :mod:`trico_tpu`, which stays the reference: the same
inputs give the same bytes. Ported so far is every path of a single-device
v1 mesh archive:

* :mod:`trico_tpu_torch.archive` — ``ArchiveWriter`` / ``ArchiveReader`` (v1
  substreams on a torch device, v0 on the shared host path);
* :mod:`trico_tpu_torch.cli` — ``python -m trico_tpu_torch encode|decode``;
* :mod:`trico_tpu_torch.chunked` — the v1 containers: FP
  (``encode_chunked`` / ``decode_chunked``, both chunk layouts, every
  ``optimize`` profile), BP (``encode_bp_chunked`` / ``decode_bp_chunked``),
  LZ4 byte planes (``encode_lz4_chunked``) and ``encode_int_best``;
* :mod:`trico_tpu_torch.codec.fp_torch` and
  :mod:`trico_tpu_torch.codec.fp64_torch` — the f32 and f64 chunk codecs
  (counterparts of ``trico_tpu.codec.fp_jax`` and ``fp64_jax``);
* :mod:`trico_tpu_torch.codec.bp_torch` — BP32 / BP64 (``bp_jax``);
* :mod:`trico_tpu_torch.codec.lz4_torch` — the LZ4 match search
  (``lz4_jax``);
* :mod:`trico_tpu_torch.codec.pack_funnel` — f32 residual region packing;
* :mod:`trico_tpu_torch.codec.fp_cuda` — the seven CUDA kernels (source in
  ``codec/csrc/``) that replace the nine Pallas kernels, each beside its
  plain PyTorch version.

The package imports no JAX. It shares ``trico_tpu``'s host-only modules (the
archive classes it extends, the container framing, the NumPy oracles, the
mesh readers and the C++ host library), and every entry point takes an
explicit ``device``.
"""

from . import _u32, _u64, archive, chunked
from .archive import ArchiveReader, ArchiveWriter, StreamType
from .chunked import (decode_bp_chunked, decode_chunked, decode_lz4_chunked,
                      encode_bp_chunked, encode_chunked, encode_int_best,
                      encode_lz4_chunked)
from .codec import bp_torch, fp64_torch, fp_cuda, fp_torch, lz4_torch, pack_funnel

__version__ = "0.3.0"

__all__ = ["ArchiveReader", "ArchiveWriter", "StreamType", "_u32", "_u64",
           "archive", "bp_torch", "chunked", "decode_bp_chunked",
           "decode_chunked", "decode_lz4_chunked", "encode_bp_chunked",
           "encode_chunked", "encode_int_best", "encode_lz4_chunked",
           "fp64_torch", "fp_cuda", "fp_torch", "lz4_torch", "pack_funnel",
           "__version__"]
