"""Data-parallel mesh compression over several devices (counterpart of
``trico_tpu.parallel``): :mod:`trico_tpu_torch.parallel.mesh_codec`."""

from . import mesh_codec
from .mesh_codec import Mesh, compress_mesh, decompress_mesh, make_mesh

__all__ = ["Mesh", "compress_mesh", "decompress_mesh", "make_mesh", "mesh_codec"]
