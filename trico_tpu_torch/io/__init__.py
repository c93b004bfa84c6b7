"""Mesh file readers and writers (binary STL, PLY): the port's own copy of
``trico_tpu/io``."""
