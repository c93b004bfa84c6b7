"""The one generator of every cell's input: meshes made on the host from
the seed or read from a file, as users hand host arrays to the codec.

A configuration is one mesh (its top level gives ``grid_side``,
``vertices`` and ``triangles``) or several (``meshes``: a list whose
entries give their ``name`` and ``published`` counts, and either those
three keys or a ``file`` in the benchmark's folder with its ``sha256``
and counts). A traffic mix's ``pool`` is the number of draws of each
mesh: the pool holds ``pool`` x (number of meshes) entries, draw-major
(mesh 0 draw 0, mesh 1 draw 0, ..., mesh 0 draw 1, ...), so consecutive
requests change size. Entry ``k`` draws from its own generator,
:func:`rng` (seed, k); every draw of a file mesh is the same arrays.

A grid mesh is the synthetic scan of ``trico_tpu_torch/bench.py``'s
``lucy_mesh`` (copied here, so the yardstick does not change with the
program): a grid of ``grid_side`` x ``grid_side`` vertices on a sphere
section whose radius is a random walk along each row, and two triangles
per grid cell in row order. The walk is drawn from the generator. A file
mesh is a binary STL read by :func:`read_stl`.

It makes the streams of ``STREAMS``, each in one of the dtypes listed
there: ``vertices`` (float32, or float64 computed in float64: the same
surface and walk, not widened), ``triangles`` (uint32 or uint64, the same
indices), ``vertex_colors`` (RGBA8 packed in uint32: RGB quantised from
the position, plus seeded noise of ``color_noise`` levels per channel,
alpha 0xFF) and ``vertex_normals`` (float32: each vertex over its length).
A configuration whose ``streams`` declares another stream, or another
dtype (the first word of a declaration), is refused, never made in
another type; so are float64 vertices of a file, which holds float32.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

SEED_MASK = (1 << 64) - 1
STREAMS = {"vertices": ("float32", "float64"), "triangles": ("uint32", "uint64"),
           "vertex_colors": ("uint32",), "vertex_normals": ("float32",)}
HERE = Path(__file__).resolve().parent


def rng(seed: int, k: int) -> np.random.Generator:
    """The generator of pool entry ``k`` of a run with ``seed`` (any whole
    number; negative ones are taken modulo 2**64)."""
    return np.random.default_rng([seed & SEED_MASK, k])


def meshes(config: dict) -> list[dict]:
    """The configuration's meshes: its ``meshes``, or itself as its one."""
    return config.get("meshes", [config])


def pool_size(config: dict, traffic: dict) -> int:
    return traffic["pool"] * len(meshes(config))


def scan_surface(side: int, gen: np.random.Generator, dtype=np.float32):
    """(vertices (side², 3) of ``dtype``, triangles (2 (side-1)², 3) uint32)."""
    th = np.linspace(0.2, np.pi - 0.2, side, dtype=dtype)[:, None]
    ph = np.linspace(0.0, 1.7 * np.pi, side, dtype=dtype)[None, :]
    r = 10.0 + np.cumsum(gen.normal(0, 1e-3, (side, side)).astype(dtype), axis=1)
    verts = np.stack([(r * np.sin(th) * np.cos(ph)).ravel(),
                      (r * np.sin(th) * np.sin(ph)).ravel(),
                      (r * np.cos(th) * np.ones_like(ph)).ravel()],
                     axis=1).astype(dtype)
    i, j = np.meshgrid(np.arange(side - 1), np.arange(side - 1), indexing="ij")
    v00 = (i * side + j).ravel()
    v01, v10 = v00 + 1, v00 + side
    tris = np.concatenate([np.stack([v00, v10, v01], 1),
                           np.stack([v01, v10, v10 + 1], 1)]).astype(np.uint32)
    return verts, tris


def read_stl(path) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) float32, triangles (T, 3) uint32) of a binary STL.

    The triangles' corners are merged where their coordinates are equal as
    floats, and the vertices come out sorted by (x, y, z), as trico's own
    reader (``iostl.c``) gives them; every triangle of the file is kept."""
    raw = Path(path).read_bytes()
    if len(raw) < 84:
        raise ValueError(f"{path}: truncated STL header")
    n = int.from_bytes(raw[80:84], "little")
    if len(raw) != 84 + 50 * n:
        raise ValueError(f"{path}: {len(raw)} bytes for {n} triangles, not {84 + 50 * n}")
    rec = np.frombuffer(raw, np.uint8, 50 * n, 84).reshape(n, 50)
    soup = np.ascontiguousarray(rec[:, 12:48]).view("<f4").reshape(3 * n, 3)
    if not np.isfinite(soup).all():
        raise ValueError(f"{path}: a corner that is not a finite number")
    order = np.lexsort((soup[:, 2], soup[:, 1], soup[:, 0]))
    ordered = soup[order]
    first = np.concatenate([[True], np.any(ordered[1:] != ordered[:-1], axis=1)])
    index = np.empty(3 * n, np.uint32)
    index[order] = np.cumsum(first) - 1
    return ordered[first].astype(np.float32), index.reshape(n, 3)


def file_mesh(mesh: dict, folder: Path) -> tuple[np.ndarray, np.ndarray]:
    """The arrays of a mesh read from its file in ``folder``, held to the
    configuration's sha256 and counts."""
    path = folder / mesh["file"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != mesh["sha256"]:
        raise ValueError(f"{mesh['name']}: {mesh['file']} has sha256 {digest}")
    verts, tris = read_stl(path)
    if (len(verts), len(tris)) != (mesh["vertices"], mesh["triangles"]):
        raise ValueError(f"{mesh['name']}: the file gives {len(verts)} vertices and "
                         f"{len(tris)} triangles")
    return verts, tris


def vertex_colors(verts: np.ndarray, noise: int, gen: np.random.Generator) -> np.ndarray:
    """RGBA8 colours packed in u32 (R in the low byte)."""
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    q = ((verts - lo) / (hi - lo) * 255).astype(np.int64)
    q = np.clip(q + gen.integers(-noise, noise + 1, q.shape), 0, 255).astype(np.uint32)
    return (np.uint32(0xFF000000) | q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)).astype(np.uint32)


def _dtype(config: dict, stream: str, default: str) -> np.dtype:
    spec = config["streams"].get(stream)
    return np.dtype(spec.split()[0] if spec else default)


def check_declared(config: dict) -> None:
    """Raise where the configuration declares a stream, or a dtype of one,
    that this generator does not make."""
    for name, spec in config["streams"].items():
        if spec.split()[0] not in STREAMS.get(name, ()):
            raise ValueError(f"{config['name']}: cannot make stream {name!r} as {spec!r}")
    vdtype = _dtype(config, "vertices", "float32")
    for mesh in meshes(config):
        if "file" in mesh and vdtype != np.float32:
            raise ValueError(f"{config['name']}: cannot make {vdtype} vertices of "
                             f"{mesh['file']}, which holds float32")


def make_streams(config: dict, streams: list[str], seed: int, k: int,
                 folder: Path = HERE) -> dict:
    """The host arrays of pool entry ``k``: the configuration's streams
    named in ``streams`` (all of them for ``["all"]``), by the names
    ``compress_mesh`` takes. A mesh's ``file`` lies in ``folder``, the
    benchmark's."""
    group = meshes(config)
    mesh = group[k % len(group)]
    if "file" not in mesh:
        side = mesh["grid_side"]
        if mesh["vertices"] != side * side or mesh["triangles"] != 2 * (side - 1) ** 2:
            raise ValueError(f"{mesh['name']}: counts do not match a grid of side {side}")
    check_declared(config)
    want = list(config["streams"]) if streams == ["all"] else streams
    unknown = set(want) - set(config["streams"])
    if unknown:
        raise ValueError(f"{config['name']} has no stream {sorted(unknown)}")
    gen = rng(seed, k)
    if "file" in mesh:
        verts, tris = file_mesh(mesh, folder)
    else:
        verts, tris = scan_surface(mesh["grid_side"], gen, _dtype(config, "vertices", "float32"))
    tdtype = _dtype(config, "triangles", "uint32")
    out = {"vertices": verts, "triangles": tris if tris.dtype == tdtype else tris.astype(tdtype)}
    if "vertex_colors" in config["streams"]:
        out["vertex_colors"] = vertex_colors(verts, config["color_noise"], gen)
    if "vertex_normals" in config["streams"]:
        out["vertex_normals"] = (verts / np.linalg.norm(verts, axis=1, keepdims=True)).astype(
            np.float32)
    return {name: out[name] for name in want}
