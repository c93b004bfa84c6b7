"""The trico archive writer and reader, with v1 substreams through the port.

Counterpart of ``trico_tpu/archive.py``. :class:`ArchiveWriter` and
:class:`ArchiveReader` are ``trico_tpu``'s classes with every path that
reaches a device sent to the port on the ``device`` the caller names:

* the FP substreams of a v1 archive (``chunk_len`` set) through
  :func:`trico_tpu_torch.chunked.encode_chunked` /
  :func:`~trico_tpu_torch.chunked.decode_chunked`, in either chunk layout;
* its integer streams through :func:`~trico_tpu_torch.chunked.encode_int_best`
  (BP container or LZ4 byte planes, fill containers for constant planes) and
  :func:`~trico_tpu_torch.chunked.decode_bp_chunked`; the LZ4 decoder is the
  host's;
* ``attribute_uint8`` streams through
  :func:`~trico_tpu_torch.chunked.encode_lz4_chunked`.

A v1 archive written here is byte for byte the one ``trico_tpu`` writes on a
device host: the chunk layout defaults to "tpu" (archive.py:151-152 picks it
when a device is up), the v0 f32 default exponents (4,10) map to the chunked
default (4,6), and chunks adapt their exponents inside ``encode_chunked``.
v0 archives (no ``chunk_len``) stay on ``trico_tpu``'s host path, in both
directions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from trico_tpu import archive as _archive
from trico_tpu.archive import F32_EXP, StreamType
from trico_tpu.chunked import decode_lz4_chunked, parse_container_header
from trico_tpu.codec import transpose

from . import chunked

__all__ = ["ArchiveReader", "ArchiveWriter", "StreamType"]


class ArchiveWriter(_archive.ArchiveWriter):
    """Builds a trico archive in memory; see ``trico_tpu.archive.ArchiveWriter``.

    With ``chunk_len`` set, writes a version-1 archive whose substreams are
    encoded on ``device`` (``"cuda"`` or ``"cpu"``) in the ``layout`` given
    ("tpu" by default, or "ref"); ``optimize`` is the chunked profile
    (True, ``"fast"`` or False). Without it, a reference-compatible v0
    archive on the host."""

    def __init__(self, use_native: bool = True, chunk_len: int | None = None,
                 layout: str | None = None, optimize: bool | str = True, *,
                 device):
        self._device = chunked._resolve_device(device)
        if chunk_len and layout is None:
            layout = "tpu"
        super().__init__(use_native, chunk_len, layout, optimize)
        if not chunk_len:
            return
        dev = self._device

        def _enc(vals, e1, e2):
            if (e1, e2) == F32_EXP and vals.dtype == np.uint32:
                e1, e2 = chunked.F32_TPU_EXP
            return chunked.encode_chunked(vals, chunk_len, e1, e2,
                                          layout=layout, optimize=optimize,
                                          device=dev)

        self._fp_enc = _enc
        self._lz4_c = lambda plane: chunked.encode_lz4_chunked(plane, device=dev)

    def _write_lz4_planes(self, st: StreamType, arr: np.ndarray, count: int):
        if not self._chunk_len:
            return super()._write_lz4_planes(st, arr, count)
        self._begin(st, count)
        for payload in chunked.encode_int_best(arr, device=self._device):
            self._sub(payload)


class ArchiveReader(_archive.ArchiveReader):
    """Reads a trico archive (v0 or v1, any writer); see
    ``trico_tpu.archive.ArchiveReader``. The FP and BP substreams of a v1
    archive decode on ``device``."""

    def __init__(self, data, use_native: bool = True, *, device):
        self._device = chunked._resolve_device(device)
        super().__init__(data, use_native)
        if self.version != 1:
            return
        dev = self._device

        def _dec(payload, bits):
            vals, got_bits = chunked.decode_chunked(payload, device=dev)
            if got_bits != bits:
                raise ValueError("chunked container width mismatch")
            return vals

        self._fp_dec = _dec

    def read_stream(self, expect: Optional[StreamType] = None):
        """Read the next stream generically → ``(stream_type, array)``, as
        ``trico_tpu.archive.ArchiveReader.read_stream``."""
        st = self._next
        if self.version != 1 or st not in _archive._LZ4_STREAMS:
            return super().read_stream(expect)
        if expect is not None and st != expect:
            raise ValueError(f"expected {expect.name} stream, found {st.name}")
        count = self._read_u32()
        nplanes, dtype, mult = _archive._LZ4_STREAMS[st]
        n_elem = count * mult
        subs = [np.frombuffer(self._read_sub(), dtype=np.uint8)
                for _ in range(nplanes)]
        hdr = parse_container_header(subs[0])
        if hdr is not None and hdr.kind == "bp":
            # a BP stream: the values in substream 0, empty placeholders after
            arr = chunked.decode_bp_chunked(subs[0], device=self._device)
            arr = arr.astype(dtype, copy=False)
            if len(arr) != n_elem:
                raise ValueError("BP32 substream count mismatch")
        else:
            planes = [decode_lz4_chunked(s) for s in subs]
            arr = (planes[0].view(dtype) if nplanes == 1
                   else transpose.from_byte_planes(planes, dtype))
        if mult == 3:
            arr = arr.reshape(-1, 3)
        self._advance_stream_type()
        return st, arr
