"""Binary STL reader/writer with vectorized vertex dedup.

Equivalent of the reference ``trico_io/iostl.c`` but NumPy-vectorized: the
50-byte triangle records are parsed with one strided view, and the
quicksort-based duplicate-vertex removal (iostl.c:61-138) becomes a lexsort +
run-length uniquification. Semantics match the reference: output vertices are
in (x, y, z) sorted order, triangle indices are rewritten onto the deduped
set, and equality is float equality (so +0.0 == -0.0 collapse).
"""

from __future__ import annotations

import numpy as np

_HEADER_TEXT = b"Binary STL written by trico-tpu lossless mesh compression framework"


def _parse_records(raw: bytes):
    ntri = int.from_bytes(raw[80:84], "little")
    need = 84 + 50 * ntri
    if len(raw) < need:
        raise ValueError(f"truncated STL: {len(raw)} bytes, need {need}")
    rec = np.frombuffer(raw, dtype=np.uint8, count=50 * ntri, offset=84).reshape(ntri, 50)
    return ntri, rec


def dedup_vertices(soup: np.ndarray):
    """Map a vertex soup (3T, 3) to (unique_vertices, triangle_indices).

    Replaces iostl.c's recursive quicksort + linear uniquify with a lexsort.
    Output vertex order is the sorted order (x primary), as in the reference.
    """
    soup = np.ascontiguousarray(soup, dtype=np.float32)
    n = len(soup)
    if n == 0:
        return soup.reshape(0, 3), np.zeros((0, 3), np.uint32)
    order = np.lexsort((soup[:, 2], soup[:, 1], soup[:, 0]))
    sv = soup[order]
    new_run = np.empty(n, dtype=bool)
    new_run[0] = True
    new_run[1:] = np.any(sv[1:] != sv[:-1], axis=1)
    run_id = np.cumsum(new_run) - 1
    uniq = sv[new_run]
    inv = np.empty(n, dtype=np.uint32)
    inv[order] = run_id.astype(np.uint32)
    return uniq, inv.reshape(-1, 3)


def read_stl(path, full: bool = False):
    """Read a binary STL.

    Returns ``(vertices, triangles)`` or, with ``full=True``,
    ``(vertices, triangles, triangle_normals, attributes_u16)`` — the
    equivalent of ``trico_read_stl`` / ``trico_read_stl_full``
    (iostl.c:141-259). ASCII STL ("solid" prefix) is rejected like the
    reference.
    """
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 84:
        raise ValueError("truncated STL header")
    if raw[:5] == b"solid":
        raise ValueError("ASCII STL not supported (reference parity, iostl.c:157-161)")
    ntri, rec = _parse_records(raw)
    vert_bytes = rec[:, 12:48].reshape(-1)  # 9 floats per record
    soup = np.ascontiguousarray(vert_bytes).view("<f4").reshape(ntri * 3, 3).astype(np.float32)
    verts, tris = dedup_vertices(soup)
    if not full:
        return verts, tris
    normals = np.ascontiguousarray(rec[:, 0:12].reshape(-1)).view("<f4").reshape(ntri, 3).astype(np.float32)
    attrs = np.ascontiguousarray(rec[:, 48:50].reshape(-1)).view("<u2").reshape(ntri).astype(np.uint16)
    return verts, tris, normals, attrs


def write_stl(path, vertices, triangles, triangle_normals=None, attributes=None):
    """Write a binary STL (iostl.c:261-321 equivalent), fully vectorized."""
    vertices = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 3)
    triangles = np.ascontiguousarray(triangles, dtype=np.uint32).reshape(-1, 3)
    ntri = len(triangles)
    rec = np.zeros((ntri, 50), dtype=np.uint8)
    if triangle_normals is not None:
        nrm = np.ascontiguousarray(triangle_normals, dtype=np.float32).reshape(ntri, 3)
        rec[:, 0:12] = nrm.view(np.uint8).reshape(ntri, 12)
    corners = vertices[triangles.reshape(-1)].reshape(ntri, 9)
    rec[:, 12:48] = np.ascontiguousarray(corners).view(np.uint8).reshape(ntri, 36)
    if attributes is not None:
        at = np.ascontiguousarray(attributes, dtype=np.uint16).reshape(ntri)
        rec[:, 48:50] = at.view(np.uint8).reshape(ntri, 2)
    with open(path, "wb") as f:
        f.write(_HEADER_TEXT.ljust(80, b" ")[:80])
        f.write(int(ntri).to_bytes(4, "little"))
        f.write(rec.tobytes())


def compute_triangle_normals(vertices, triangles):
    """Cross-product triangle normals, normalized (decoder parity:
    tools/trico_decoder/main.c:439-470 computes these when writing STL
    without stored normals)."""
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    triangles = np.asarray(triangles).reshape(-1, 3)
    v0 = vertices[triangles[:, 0]]
    e1 = vertices[triangles[:, 1]] - v0
    e2 = vertices[triangles[:, 2]] - v0
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        n = np.where(norm > 0, n / norm, n)
    return n.astype(np.float32)
