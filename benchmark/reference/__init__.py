"""The plain reference: a NumPy decoder of version-1 trico archives that
imports nothing of the program, and the comparison that decides
``correct``."""

from .archive import decode_archive, decode_archives

__all__ = ["decode_archive", "decode_archives"]
