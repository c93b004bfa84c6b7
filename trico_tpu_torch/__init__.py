"""trico_tpu_torch: trico-tpu's device codecs in PyTorch, with CUDA kernels
written for the NVIDIA H100 (sm_90a).

A second package beside :mod:`trico_tpu`, which stays the reference: the same
inputs give the same bytes. Ported so far is the chunked FP codec in the v2
"tpu" layout, for f32 and f64 streams, at fixed exponents and with every
``optimize`` profile (the full adaptive search and ``"fast"``):

* :mod:`trico_tpu_torch.chunked` — ``encode_chunked`` / ``decode_chunked``,
  the v1 container entry points;
* :mod:`trico_tpu_torch.codec.fp_torch` and
  :mod:`trico_tpu_torch.codec.fp64_torch` — the f32 and f64 chunk codecs
  (counterparts of ``trico_tpu.codec.fp_jax`` and ``fp64_jax``);
* :mod:`trico_tpu_torch.codec.pack_funnel` — f32 residual region packing;
* :mod:`trico_tpu_torch.codec.fp_cuda` — the seven CUDA kernels (source in
  ``codec/csrc/``) that replace the nine Pallas kernels, each beside its
  plain PyTorch version.

The package imports no JAX. It shares ``trico_tpu``'s host-only modules (the
container framing, the NumPy oracle ``fp_ref`` and the C++ host library), and
every entry point takes an explicit ``device``.
"""

from . import _u32, _u64, chunked
from .chunked import decode_chunked, encode_chunked
from .codec import fp64_torch, fp_cuda, fp_torch, pack_funnel

__version__ = "0.2.0"

__all__ = ["_u32", "_u64", "chunked", "decode_chunked", "encode_chunked",
           "fp64_torch", "fp_cuda", "fp_torch", "pack_funnel", "__version__"]
