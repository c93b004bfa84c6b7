"""The pool: a configuration of one mesh makes the same arrays as the
generator did before pools of several meshes (pinned by their hashes), a
pool of several meshes is draw-major with a generator per entry, and
set-up writes and reads one entry of each distinct mesh (``pool[0]``
alone where there is one mesh) before the window."""

import hashlib
import json

import numpy as np
import pytest

from benchmark import harness, meshgen
from conftest import REPO, grid

# sha256 of each pool entry's arrays (name, dtype, shape and bytes of each
# stream, by name), as the generator made them for lucy at side 48 and
# vellum at side 40, entries 0 and 1
PINNED = {
    ("lucy", 2**33 + 5, "all"): (
        "2118b9a1ba530323ced41e522c6e126bc232933f14150218b856250d2a306c28",
        "9934ba76875ad985d9a871136037396c648388494a71b7e9b4c778dfefb63969"),
    ("lucy", 2**33 + 5, "vertices"): (
        "31e2852b018b066106550e00c4f4e474f2490b7bd81e526f16579f11c64fdf1f",
        "c9283401cc1c0b64719e57a449c73015a2c876489867a78996e9e6cb5047117e"),
    ("lucy", -7, "all"): (
        "3bae914d060f867d954b563194fc43314aeef23c92c0f7c64758a47be8f900a5",
        "671ea1d8b21841066cd3066205f987733797318f1987f276d6f970b5f6277b1f"),
    ("lucy", -7, "vertices"): (
        "f5b0d6531f46fec7e3da260b60fa3367069e6b09b42221372a719c184614d8bc",
        "2cb1818a0a917bd22980062f29ea8059b09f3a23eeff1fa06a8d434908b00c71"),
    ("vellum", 2**33 + 5, "all"): (
        "4e4c6b25c7749c4d98ed6ae01bf051d9e4eadd75b1eafc28e201e6e52996385e",
        "59010e0fbdf8a82598b8cf7481a7f7005bf1cf436bcaf5f04b8b81b1b7f47c46"),
    ("vellum", 2**33 + 5, "vertices"): (
        "01682755bb36654acd43f6a11f7325e34fee746f0039b51c7260ea4b93691745",
        "1ac3f2e51f2f2791ec4b5bbd49de2e16ff4f037601613b5fcd1938eb7bc3432f"),
    ("vellum", -7, "all"): (
        "8e9daa9ec64af36ae96821de1a4464801719bed0c2aba33b86748d75cfb50d43",
        "99c0fc6a7cbbb1b11591e5273b78230f2229335625be647408295ad37dcfec00"),
    ("vellum", -7, "vertices"): (
        "f6edb022e5aa61a3d329edae1915a703826437570ed6cb9494e42acd31ab050e",
        "c1244ca28268c854bea42ab267e10865601667982d2fd776ca87bbb025f60d48"),
}
SIDES = {"lucy": 48, "vellum": 40}


def config(name: str) -> dict:
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = arrays[name]
        h.update(f"{name} {a.dtype.str} {a.shape};".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed,streams", sorted(PINNED, key=str))
def test_a_one_mesh_pool_is_the_arrays_it_was(name, seed, streams):
    c = config(name)
    grid(c, SIDES[name])
    traffic = {"pool": 2, "streams": [streams]}
    assert meshgen.pool_size(c, traffic) == 2
    got = tuple(digest(meshgen.make_streams(c, traffic["streams"], seed, k)) for k in range(2))
    assert got == PINNED[(name, seed, streams)]


def test_a_pool_of_several_meshes_is_draw_major_with_a_generator_an_entry():
    c = config("assets")
    sides = {"armadillo": 10, "dragon": 14, "happy_buddha": 18}
    for mesh in c["meshes"]:
        if mesh["name"] in sides:
            grid(mesh, sides[mesh["name"]])
    group = meshgen.meshes(c)
    assert [m["name"] for m in group] == ["bunny", "armadillo", "dragon", "happy_buddha"]
    traffic = {"pool": 2, "streams": ["all"]}
    n = meshgen.pool_size(c, traffic)
    assert n == 8
    seed = 2**40 + 17
    pool = [meshgen.make_streams(c, ["all"], seed, k) for k in range(n)]
    for k, entry in enumerate(pool):
        mesh = group[k % 4]
        assert len(entry["vertices"]) == mesh["vertices"]
        assert len(entry["triangles"]) == mesh["triangles"]
        if "file" in mesh:
            want = meshgen.file_mesh(mesh, meshgen.HERE)
        else:
            want = meshgen.scan_surface(mesh["grid_side"], meshgen.rng(seed, k))
        assert np.array_equal(entry["vertices"], want[0])
        assert np.array_equal(entry["triangles"], want[1])
    sizes = [len(p["vertices"]) for p in pool]
    assert all(a != b for a, b in zip(sizes, sizes[1:]))  # consecutive requests change size
    assert digest(pool[0]) == digest(pool[4])  # every draw of a file is the same
    for k in (1, 2, 3):  # two draws of a grid differ
        assert not np.array_equal(pool[k]["vertices"], pool[k + 4]["vertices"])


class Recording(harness.Program):
    """The program as it is, recording the pool entry of every call."""

    calls: list = []

    def write(self, streams):
        self.calls.append(("write", len(streams["vertices"])))
        return super().write(streams)

    def read(self, blob):
        out = super().read(blob)
        self.calls.append(("read", len(out["vertices"])))
        return out


@pytest.mark.parametrize("cell", ["lucy.mesh", "vellum.mesh", "lucy.points", "assets.mesh"])
def test_set_up_writes_and_reads_one_entry_of_each_mesh(tiny_root, cell):
    Recording.calls = []
    res = harness.run_cell(tiny_root, cell, 2**31 + 19, 0.3, False, device="cpu",
                           program_cls=Recording)
    assert res["correct"]
    manifest = harness.load_json(tiny_root / "BENCHMARK.json")
    w = next(w for w in manifest["workloads"] if w["name"] == cell)
    c = harness.load_json(tiny_root / "benchmark" / "configs" / f"{w['config']}.json")
    group = meshgen.meshes(c)
    setup = Recording.calls[: len(Recording.calls) - res["attempted"]]
    want = [(kind, m["vertices"]) for m in group for kind in ("write", "read")]
    assert setup == want
    if len(group) == 1:
        assert len(setup) == 2  # pool[0] alone
    window = Recording.calls[len(setup):]
    n = len(group) * 2  # the mix's pool: two draws of each mesh
    assert [v for kind, v in window if kind == "write"] == [
        group[i % n % len(group)]["vertices"] for i in range(res["attempted"] // 2)]
