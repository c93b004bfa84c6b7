"""The mesh corpus of the size gate (:mod:`.corpus_gate`).

The port's own copy of ``tests/corpus.py``: the same generators, seeds and
arrays, so that each class's archive sizes can be held against the sizes
recorded in ``CORPUS.json``. Seven structural classes of mesh:

* ``grid``    a heightfield on exact lattice strides (DFCM-friendly);
* ``scan``    a smooth scan-like surface with correlated radial noise;
* ``cad``     quantized axis-aligned boxes (heavy value reuse, FCM-friendly);
* ``attrib``  a scan with vertex normals, rgba colors and per-vertex uvs;
* ``double``  f64 vertices (the reference's (20,20) f64 codec path);
* ``longidx`` u64 triangle indices (the 8-plane integer path);
* ``bunny``   the Stanford bunny, read from ``tests/data/StanfordBunny.stl``
              of the repository unless another path is given.

Every mesh is a dict of the encoder tool's stream set: ``vertices``,
``triangles`` and optionally ``vertex_normals``, ``vertex_colors`` and
``uv_per_vertex``, in the reference encoder's order.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..io.stl import read_stl

BUNNY = Path(__file__).resolve().parents[2] / "tests" / "data" / "StanfordBunny.stl"


def _tri_grid(nu: int, nv: int) -> np.ndarray:
    """Triangulate a (nu, nv) vertex lattice: 2 triangles per cell."""
    i, j = np.meshgrid(np.arange(nu - 1), np.arange(nv - 1), indexing="ij")
    v00 = (i * nv + j).ravel()
    v01 = v00 + 1
    v10 = v00 + nv
    v11 = v10 + 1
    t1 = np.stack([v00, v10, v01], axis=1)
    t2 = np.stack([v01, v10, v11], axis=1)
    return np.concatenate([t1, t2]).astype(np.uint32)


def make_grid(n: int = 192) -> dict:
    """Regular heightfield: x/y are exact lattice strides, z smooth."""
    i, j = np.meshgrid(np.arange(n, dtype=np.float32),
                       np.arange(n, dtype=np.float32), indexing="ij")
    x = i * np.float32(0.125)
    y = j * np.float32(0.125)
    z = (np.sin(i * 0.07) * np.cos(j * 0.05) * 3.0).astype(np.float32)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    return {"vertices": verts, "triangles": _tri_grid(n, n)}


def _smooth_noise(shape, seed, passes=8):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):
        r = (r + np.roll(r, 1, 0) + np.roll(r, -1, 0)
             + np.roll(r, 1, -1) + np.roll(r, -1, -1)) / 5.0
    return r


def make_scan(nu: int = 220, nv: int = 220, seed: int = 11) -> dict:
    """Scan-like: a sphere section sampled on an angle grid with correlated
    radial noise, in coherent row-major vertex order."""
    th = np.linspace(0.2, np.pi - 0.2, nu, dtype=np.float32)[:, None]
    ph = np.linspace(0.0, 1.7 * np.pi, nv, dtype=np.float32)[None, :]
    r = 10.0 + 2.0 * _smooth_noise((nu, nv), seed)
    x = (r * np.sin(th) * np.cos(ph)).astype(np.float32)
    y = (r * np.sin(th) * np.sin(ph)).astype(np.float32)
    z = (r * np.cos(th) * np.ones_like(ph)).astype(np.float32)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    return {"vertices": verts, "triangles": _tri_grid(nu, nv)}


def make_cad(n_boxes: int = 1500, seed: int = 5) -> dict:
    """Quantized axis-aligned boxes: every coordinate a multiple of 1/8."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 256, (n_boxes, 3)).astype(np.float32) * 0.125
    sz = rng.integers(1, 32, (n_boxes, 3)).astype(np.float32) * 0.125
    corners = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                        [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
                       np.float32)
    verts = (lo[:, None, :] + corners[None] * sz[:, None, :]).reshape(-1, 3)
    box_tris = np.array([[0, 1, 3], [0, 3, 2], [4, 7, 5], [4, 6, 7],
                         [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                         [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                        np.uint32)
    tris = (box_tris[None] + (np.arange(n_boxes, dtype=np.uint32) * 8)
            [:, None, None]).reshape(-1, 3)
    return {"vertices": verts.astype(np.float32), "triangles": tris}


def make_attrib(seed: int = 23) -> dict:
    """Attribute-heavy scan: normals, colors and uvs."""
    base = make_scan(160, 160, seed)
    verts = base["vertices"]
    n = len(verts)
    norm = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    # low-entropy rgba colors from the quantized height
    q = np.clip((verts[:, 2] * 8).astype(np.int64) + 128, 0, 255)
    colors = (0xFF000000 | (q << 16) | (q << 8) | q).astype(np.uint32)
    # per-vertex uvs: the lattice's parameter coordinates
    i = np.arange(n, dtype=np.float32)
    uv = np.stack([(i % 160) / 160.0, (i // 160) / 160.0],
                  axis=1).astype(np.float32)
    return {"vertices": verts, "triangles": base["triangles"],
            "vertex_normals": norm.astype(np.float32),
            "vertex_colors": colors, "uv_per_vertex": uv}


def make_double(n: int = 160, seed: int = 31) -> dict:
    """f64 vertices: a smooth surface with full-mantissa amplitudes."""
    i, j = np.meshgrid(np.arange(n, dtype=np.float64),
                       np.arange(n, dtype=np.float64), indexing="ij")
    noise = _smooth_noise((n, n), seed).astype(np.float64)
    x = i * (np.pi / 25.0)
    y = j * (np.e / 21.0)
    z = np.sin(i * 0.083) * np.cos(j * 0.047) * np.sqrt(2) * 3 + noise
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    return {"vertices": verts.astype(np.float64),
            "triangles": _tri_grid(n, n)}


def make_longidx(seed: int = 41) -> dict:
    """u64 triangle indices on a scan base."""
    base = make_scan(140, 140, seed)
    return {"vertices": base["vertices"],
            "triangles": base["triangles"].astype(np.uint64)}


def generators() -> dict:
    return {
        "grid": make_grid,
        "scan": make_scan,
        "cad": make_cad,
        "attrib": make_attrib,
        "double": make_double,
        "longidx": make_longidx,
    }


def build_corpus(bunny: str | Path | None = BUNNY) -> dict[str, dict]:
    """Every class by name; the bunny from the binary STL ``bunny`` (left
    out where ``bunny`` is None)."""
    out = {name: gen() for name, gen in generators().items()}
    if bunny is not None:
        verts, tris = read_stl(bunny)
        out["bunny"] = {"vertices": verts, "triangles": tris}
    return out
