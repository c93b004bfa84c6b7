"""PLY reader/writer (ascii, binary little/big endian), NumPy-vectorized.

Replaces the reference's vendored rply + ``trico_io/ioply.c`` adapter with a
header-driven parser. Extraction semantics follow ioply.c:

* vertex x/y/z → float32 vertices (doubles truncated to float by design,
  reference README "Tools"); nx/ny/nz → normals
* colors from red/green/blue/alpha with r/g/b/a and diffuse_* aliases
  (ioply.c:143-164); missing channels default to 255 (0xffffffff init,
  ioply.c:183-184); packed little-endian as r | g<<8 | b<<16 | a<<24
* face vertex_indices / vertex_index lists: first 3 indices (ioply.c:29-42)
* face texcoord lists: first 6 floats, short lists zero-padded (ioply.c:44-65)

Fast path: elements whose properties are fixed-width (and list elements whose
counts are uniform — the overwhelmingly common case) parse with a single
``np.frombuffer``; anything else falls back to a per-element loop.
"""

from __future__ import annotations

import dataclasses
import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclasses.dataclass
class _Prop:
    name: str
    dtype: str  # numpy type char e.g. 'f4'
    is_list: bool = False
    count_dtype: str = "u1"


@dataclasses.dataclass
class _Element:
    name: str
    count: int
    props: list


@dataclasses.dataclass
class PlyMesh:
    """In-memory mesh as the trico tools consume it."""

    vertices: np.ndarray | None = None          # (n, 3) float32 (float64
    #                                             with read_ply keep_doubles)
    vertex_normals: np.ndarray | None = None    # (n, 3) float32
    vertex_colors: np.ndarray | None = None     # (n,) uint32 rgba little-endian
    triangles: np.ndarray | None = None         # (m, 3) uint32
    texcoords: np.ndarray | None = None         # (m, 6) float32


def _parse_header(raw: bytes):
    end = raw.find(b"end_header")
    if raw[:3] != b"ply" or end < 0:
        raise ValueError("not a PLY file")
    end = raw.find(b"\n", end) + 1
    lines = raw[:end].decode("ascii", "replace").splitlines()
    fmt = None
    elements: list[_Element] = []
    for ln in lines:
        parts = ln.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append(_Element(parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1].props.append(
                    _Prop(parts[4], _TYPES[parts[3]], True, _TYPES[parts[2]])
                )
            else:
                elements[-1].props.append(_Prop(parts[2], _TYPES[parts[1]]))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt}")
    return fmt, elements, end


def _read_binary_element(buf: memoryview, off: int, el: _Element, bo: str):
    """Parse one element section. Returns (dict name->array, new offset)."""
    if not any(p.is_list for p in el.props):
        dt = np.dtype([(p.name, bo + p.dtype) for p in el.props])
        arr = np.frombuffer(buf, dtype=dt, count=el.count, offset=off)
        return {p.name: arr[p.name] for p in el.props}, off + dt.itemsize * el.count

    # list properties: try uniform-count fast path
    if el.count == 0:
        return {p.name: np.zeros((0,)) for p in el.props}, off
    pos = off
    counts = {}
    for p in el.props:
        if p.is_list:
            c = int(np.frombuffer(buf, dtype=bo + p.count_dtype, count=1, offset=pos)[0])
            counts[p.name] = c
            pos += np.dtype(p.count_dtype).itemsize + c * np.dtype(p.dtype).itemsize
        else:
            pos += np.dtype(p.dtype).itemsize
    row_size = pos - off
    total = row_size * el.count
    uniform = off + total <= len(buf)
    if uniform:
        fields = []
        for p in el.props:
            if p.is_list:
                fields.append((p.name + "__n", bo + p.count_dtype))
                fields.append((p.name, bo + p.dtype, (counts[p.name],)))
            else:
                fields.append((p.name, bo + p.dtype))
        dt = np.dtype(fields)
        arr = np.frombuffer(buf, dtype=dt, count=el.count, offset=off)
        ok = all(
            np.all(arr[p.name + "__n"] == counts[p.name]) for p in el.props if p.is_list
        )
        if ok:
            return {p.name: arr[p.name] for p in el.props}, off + total

    # fallback: per-element loop (ragged lists)
    out = {p.name: [] for p in el.props}
    pos = off
    for _ in range(el.count):
        for p in el.props:
            if p.is_list:
                cdt = np.dtype(bo + p.count_dtype)
                c = int(np.frombuffer(buf, dtype=cdt, count=1, offset=pos)[0])
                pos += cdt.itemsize
                vdt = np.dtype(bo + p.dtype)
                out[p.name].append(np.frombuffer(buf, dtype=vdt, count=c, offset=pos))
                pos += vdt.itemsize * c
            else:
                vdt = np.dtype(bo + p.dtype)
                out[p.name].append(np.frombuffer(buf, dtype=vdt, count=1, offset=pos)[0])
                pos += vdt.itemsize
    return out, pos


def _read_ascii_elements(raw_body: bytes, elements):
    tokens = raw_body.split()
    ti = 0
    result = {}
    for el in elements:
        out = {p.name: [] for p in el.props}
        for _ in range(el.count):
            for p in el.props:
                if p.is_list:
                    c = int(tokens[ti]); ti += 1
                    vals = [float(tokens[ti + k]) for k in range(c)]
                    ti += c
                    out[p.name].append(np.array(vals))
                else:
                    out[p.name].append(float(tokens[ti])); ti += 1
        result[el.name] = out
    return result


def _stack_list(values, width, pad=0.0, dtype=np.float32):
    """Stack possibly-ragged list values to (n, width), truncating/padding."""
    if isinstance(values, np.ndarray) and values.ndim == 2:
        arr = values[:, :width].astype(dtype)
        if arr.shape[1] < width:
            arr = np.pad(arr, ((0, 0), (0, width - arr.shape[1])), constant_values=pad)
        return arr
    out = np.full((len(values), width), pad, dtype=dtype)
    for i, row in enumerate(values):
        k = min(len(row), width)
        out[i, :k] = row[:k]
    return out


def read_ply(path, keep_doubles: bool = False) -> PlyMesh:
    """Read a PLY mesh. ``keep_doubles=True`` preserves float64 vertex
    coordinates when the file declares ``double`` x/y/z properties — a
    capability superset of the reference adapter, which always truncates to
    float (ioply.c / README "Tools"); the archive layer carries f64 streams
    end-to-end (vertex_double, trico.c:380-427)."""
    with open(path, "rb") as f:
        raw = f.read()
    fmt, elements, body_off = _parse_header(raw)
    data: dict[str, dict] = {}
    if fmt == "ascii":
        data = _read_ascii_elements(raw[body_off:], elements)
    else:
        bo = "<" if fmt == "binary_little_endian" else ">"
        buf = memoryview(raw)
        off = body_off
        for el in elements:
            data[el.name], off = _read_binary_element(buf, off, el, bo)

    mesh = PlyMesh()
    v = data.get("vertex", {})
    if "x" in v and "y" in v and "z" in v:
        vdt = np.float32
        if keep_doubles:
            vel = next((e for e in elements if e.name == "vertex"), None)
            src = {p.name: p.dtype for p in vel.props} if vel else {}
            if all(src.get(k) == "f8" for k in ("x", "y", "z")):
                vdt = np.float64
        mesh.vertices = np.stack(
            [np.asarray(v["x"], vdt), np.asarray(v["y"], vdt),
             np.asarray(v["z"], vdt)],
            axis=1,
        )
    if all(k in v for k in ("nx", "ny", "nz")):
        mesh.vertex_normals = np.stack(
            [np.asarray(v["nx"], np.float32), np.asarray(v["ny"], np.float32), np.asarray(v["nz"], np.float32)],
            axis=1,
        )
    chan = {}
    for base, aliases in {
        "red": ("red", "r", "diffuse_red"),
        "green": ("green", "g", "diffuse_green"),
        "blue": ("blue", "b", "diffuse_blue"),
        "alpha": ("alpha", "a", "diffuse_alpha"),
    }.items():
        for a in aliases:
            if a in v:
                chan[base] = np.asarray(v[a]).astype(np.uint32) & 0xFF
                break
    if chan and mesh.vertices is not None:
        n = len(mesh.vertices)
        full = np.full(n, 0xFF, dtype=np.uint32)
        r = chan.get("red", full)
        g = chan.get("green", full)
        b = chan.get("blue", full)
        a = chan.get("alpha", full)
        mesh.vertex_colors = (r | (g << 8) | (b << 16) | (a << 24)).astype(np.uint32)

    fdata = data.get("face", {})
    idx = fdata.get("vertex_indices", fdata.get("vertex_index"))
    if idx is not None and len(idx):
        mesh.triangles = _stack_list(idx, 3, dtype=np.int64).astype(np.uint32)
    if "texcoord" in fdata and len(fdata["texcoord"]):
        mesh.texcoords = _stack_list(fdata["texcoord"], 6, dtype=np.float32)
    return mesh


def write_ply(path, vertices, vertex_normals=None, vertex_colors=None,
              triangles=None, texcoords=None, storage: str = "binary_le"):
    """PLY writer (layout parity with ioply.c:244-314).

    ``storage`` selects the PLY storage mode, matching rply's writer
    generality (rply.h:247-340 — the reference *tools* only ever write
    binary-LE, ioply.c:244): ``"binary_le"`` (default, fast path),
    ``"binary_be"``, or ``"ascii"``.
    """
    if storage not in ("binary_le", "binary_be", "ascii"):
        raise ValueError(f"unknown PLY storage mode {storage!r}")
    fmt_name = {"binary_le": "binary_little_endian",
                "binary_be": "binary_big_endian",
                "ascii": "ascii"}[storage]
    fe = ">" if storage == "binary_be" else "<"
    # float64 input writes double x/y/z properties (keep_doubles round-trip);
    # anything else truncates to float like the reference adapter
    as_double = np.asarray(vertices).dtype == np.float64
    vdt = np.float64 if as_double else np.float32
    vertices = np.ascontiguousarray(vertices, dtype=vdt).reshape(-1, 3)
    n = len(vertices)
    if n == 0:
        raise ValueError("PLY requires at least one vertex")
    ctype = "double" if as_double else "float"
    hdr = ["ply", f"format {fmt_name} 1.0",
           f"element vertex {n}",
           f"property {ctype} x", f"property {ctype} y",
           f"property {ctype} z"]
    vert_fields = [("xyz", f"{fe}{'f8' if as_double else 'f4'}", (3,))]
    if vertex_normals is not None:
        hdr += ["property float nx", "property float ny", "property float nz"]
        vert_fields.append(("n", f"{fe}f4", (3,)))
    if vertex_colors is not None:
        hdr += ["property uchar red", "property uchar green",
                "property uchar blue", "property uchar alpha"]
        # rgba bytes stay byte-ordered regardless of endianness
        vert_fields.append(("c", "u1", (4,)))
    ntri = 0 if triangles is None else len(np.asarray(triangles).reshape(-1, 3))
    if ntri:
        hdr.append(f"element face {ntri}")
        hdr.append("property list uchar int vertex_indices")
        if texcoords is not None:
            hdr.append("property list uchar float texcoord")
    hdr.append("end_header")

    vrec = np.zeros(n, dtype=np.dtype(vert_fields))
    vrec["xyz"] = vertices
    if vertex_normals is not None:
        vrec["n"] = np.ascontiguousarray(vertex_normals, dtype=np.float32).reshape(n, 3)
    if vertex_colors is not None:
        vrec["c"] = np.ascontiguousarray(vertex_colors, dtype=np.uint32) \
            .reshape(n).view(np.uint8).reshape(n, 4)

    tri = uv = None
    if ntri:
        tri = np.ascontiguousarray(triangles, dtype=np.int32).reshape(-1, 3)
        if texcoords is not None:
            uv = np.ascontiguousarray(texcoords, dtype=np.float32).reshape(ntri, 6)

    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        if storage == "ascii":
            _write_ascii_body(f, vrec, vert_fields, tri, uv)
            return
        f.write(vrec.tobytes())
        if ntri:
            if uv is not None:
                frec = np.zeros(ntri, dtype=np.dtype(
                    [("c3", "u1"), ("idx", f"{fe}i4", (3,)), ("c6", "u1"),
                     ("uv", f"{fe}f4", (6,))]))
                frec["c3"] = 3
                frec["idx"] = tri
                frec["c6"] = 6
                frec["uv"] = uv
            else:
                frec = np.zeros(ntri, dtype=np.dtype(
                    [("c3", "u1"), ("idx", f"{fe}i4", (3,))]))
                frec["c3"] = 3
                frec["idx"] = tri
            f.write(frec.tobytes())


def _fmt_f32(a):
    """repr-roundtrip float formatting column-wise (value-lossless ascii).
    %.9g for f32, %.17g for f64 — enough digits to reproduce the bits."""
    fmt = "%.17g" if a.dtype.kind == "f" and a.dtype.itemsize == 8 else "%.9g"
    return np.char.mod(fmt, a.astype(np.float64))


def _write_ascii_body(f, vrec, vert_fields, tri, uv):
    """Ascii PLY body: vectorized row formatting (no per-value Python loop)."""
    cols = [_fmt_f32(vrec["xyz"][:, i]) for i in range(3)]
    for name, *_ in vert_fields:
        if name == "n":
            cols += [_fmt_f32(vrec["n"][:, i]) for i in range(3)]
        elif name == "c":
            cols += [np.char.mod("%d", vrec["c"][:, i]) for i in range(4)]
    body = cols[0]
    for c in cols[1:]:
        body = np.char.add(np.char.add(body, " "), c)
    f.write(("\n".join(body) + "\n").encode("ascii"))
    if tri is not None:
        tcols = [np.full(len(tri), "3")]
        tcols += [np.char.mod("%d", tri[:, i]) for i in range(3)]
        if uv is not None:
            tcols.append(np.full(len(tri), "6"))
            tcols += [_fmt_f32(uv[:, i]) for i in range(6)]
        trow = tcols[0]
        for c in tcols[1:]:
            trow = np.char.add(np.char.add(trow, " "), c)
        f.write(("\n".join(trow) + "\n").encode("ascii"))
