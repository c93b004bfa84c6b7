"""The one generator of every cell's input: a mesh made on the host from
the seed, as users hand host arrays to the codec.

The surface is the synthetic scan of ``trico_tpu_torch/bench.py``'s
``lucy_mesh`` (copied here, so the yardstick does not change with the
program): a grid of ``grid_side`` x ``grid_side`` vertices on a sphere
section whose radius is a random walk along each row, and two triangles
per grid cell in row order. The walk is drawn from the seed.

It makes the streams of ``STREAMS``, each in the one dtype listed there:
``vertices`` (float32), ``triangles`` (uint32) and ``vertex_colors``
(RGBA8 packed in uint32: RGB quantised from the position, plus seeded
noise of ``color_noise`` levels per channel, alpha 0xFF). A configuration
whose ``streams`` declares another stream, or another dtype (the first
word of a declaration), is refused, never made in another type.
"""

from __future__ import annotations

import numpy as np

SEED_MASK = (1 << 64) - 1
STREAMS = {"vertices": "float32", "triangles": "uint32", "vertex_colors": "uint32"}


def rng(seed: int, k: int) -> np.random.Generator:
    """The generator of pool entry ``k`` of a run with ``seed`` (any whole
    number; negative ones are taken modulo 2**64)."""
    return np.random.default_rng([seed & SEED_MASK, k])


def scan_surface(side: int, gen: np.random.Generator):
    """(vertices (side², 3) float32, triangles (2 (side-1)², 3) uint32)."""
    th = np.linspace(0.2, np.pi - 0.2, side, dtype=np.float32)[:, None]
    ph = np.linspace(0.0, 1.7 * np.pi, side, dtype=np.float32)[None, :]
    r = 10.0 + np.cumsum(gen.normal(0, 1e-3, (side, side)).astype(np.float32), axis=1)
    verts = np.stack([(r * np.sin(th) * np.cos(ph)).ravel(),
                      (r * np.sin(th) * np.sin(ph)).ravel(),
                      (r * np.cos(th) * np.ones_like(ph)).ravel()],
                     axis=1).astype(np.float32)
    i, j = np.meshgrid(np.arange(side - 1), np.arange(side - 1), indexing="ij")
    v00 = (i * side + j).ravel()
    v01, v10 = v00 + 1, v00 + side
    tris = np.concatenate([np.stack([v00, v10, v01], 1),
                           np.stack([v01, v10, v10 + 1], 1)]).astype(np.uint32)
    return verts, tris


def vertex_colors(verts: np.ndarray, noise: int, gen: np.random.Generator) -> np.ndarray:
    """RGBA8 colours packed in u32 (R in the low byte)."""
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    q = ((verts - lo) / (hi - lo) * 255).astype(np.int64)
    q = np.clip(q + gen.integers(-noise, noise + 1, q.shape), 0, 255).astype(np.uint32)
    return (np.uint32(0xFF000000) | q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)).astype(np.uint32)


def check_declared(config: dict) -> None:
    """Raise where the configuration declares a stream, or a dtype of one,
    that this generator does not make."""
    for name, spec in config["streams"].items():
        if STREAMS.get(name) != spec.split()[0]:
            raise ValueError(f"{config['name']}: cannot make stream {name!r} as {spec!r}")


def make_streams(config: dict, streams: list[str], seed: int, k: int) -> dict:
    """The host arrays of pool entry ``k``: the configuration's streams
    named in ``streams`` (all of them for ``["all"]``), by the names
    ``compress_mesh`` takes."""
    side = config["grid_side"]
    if config["vertices"] != side * side or config["triangles"] != 2 * (side - 1) ** 2:
        raise ValueError(f"{config['name']}: counts do not match a grid of side {side}")
    check_declared(config)
    want = list(config["streams"]) if streams == ["all"] else streams
    unknown = set(want) - set(config["streams"])
    if unknown:
        raise ValueError(f"{config['name']} has no stream {sorted(unknown)}")
    gen = rng(seed, k)
    verts, tris = scan_surface(side, gen)
    out = {"vertices": verts, "triangles": tris}
    if "vertex_colors" in config["streams"]:
        out["vertex_colors"] = vertex_colors(verts, config["color_noise"], gen)
    return {name: out[name] for name in want}
