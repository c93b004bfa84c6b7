"""The port's C++ host library (trico_tpu_torch/native) held against
trico_tpu.native entry by entry on the same inputs made from a seed with
numpy: the same bytes and arrays from every Python entry point and from the
raw pack, parse and row-mover entry points. Tolerance: exact. The library
has a file name of its own and is built race-free. These cases need g++ and
skip without it; the fallbacks they stand in for are held in
test_torch_framing.py and test_torch_refs.py."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import trico_tpu.native as jn
import trico_tpu_torch.native as tn
from conftest import mesh_like_floats

from torch_cases import require_native, words, words64

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _needs_both_libraries():
    require_native()


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert bytes(a) == bytes(b)


def _planes(bits, n=700, k=3):
    w = words(5, n, seed=bits) if bits == 32 else words64(6, n, seed=bits)
    return [np.ascontiguousarray(w[i]) for i in range(k)]


def test_trico_tpu_library_is_asked_again_after_a_lost_build(monkeypatch):
    """A worker that lost the race for trico_tpu's shared temporary file
    holds that library unavailable; the port's tests ask once more and find
    it built."""
    import torch_cases

    monkeypatch.setattr(jn, "_LIB", None)
    monkeypatch.setattr(jn, "_LOAD_ERROR", "the temporary file was renamed")
    monkeypatch.setattr(torch_cases, "_TPU_NATIVE_ASKED_AGAIN", [])
    assert not jn.available()
    assert torch_cases.tpu_native_available()
    assert jn.get_lib() is not None


def test_the_library_is_the_ports_own():
    ours, theirs = Path(tn.get_lib()._name), Path(jn.get_lib()._name)
    assert ours.name != theirs.name and ours.name.startswith("libtrico_torch_native_")
    assert (Path(tn.__file__).parent / "codec.cpp").exists()


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("e", [(4, 10), (0, 0), (20, 20), (14, 18)])
@pytest.mark.parametrize("n", [0, 1, 9, 1003])
def test_fp_encode_decode(bits, e, n):
    vals = _planes(bits, max(n, 1), 1)[0][:n]
    got = tn.fp_encode(vals, *e)
    assert got == jn.fp_encode(vals, *e)
    _same(tn.fp_decode(got, bits), jn.fp_decode(got, bits))
    _same(tn.fp_decode(got, bits), vals)


@pytest.mark.parametrize("bits", [32, 64])
def test_fp_decode_rejects_alike(bits):
    good = tn.fp_encode(_planes(bits, 100, 1)[0], 4, 10)
    for bad in (b"", good[:4], good[:-7], good[:1] + b"\xff\xff\xff\xff" + good[5:]):
        outcomes = []
        for mod in (tn, jn):
            with pytest.raises(ValueError) as err:
                mod.fp_decode(bad, bits)
            outcomes.append(str(err.value))
        assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("bits", [32, 64])
def test_fp_batch_entry_points(bits):
    planes = _planes(bits)
    exps = [(4, 10), (2, 8), (8, 14)] if bits == 32 else [(20, 20), (10, 16), (4, 6)]
    _same(tn.fp_encode_jobs(planes, exps), jn.fp_encode_jobs(planes, exps))
    assert tn.fp_encode_sizes(planes, exps) == jn.fp_encode_sizes(planes, exps)
    _same(tn.fp_encode_each(planes, exps), jn.fp_encode_each(planes, exps))
    for prefix in (64, 4096):
        _same([bytes(p) for p in tn.fp_search_encode(planes, exps, prefix_n=prefix)],
              [bytes(p) for p in jn.fp_search_encode(planes, exps, prefix_n=prefix)])
    soa = np.stack(planes)
    _same([bytes(p) for p in tn.fp_search_encode(soa, exps)],
          [bytes(p) for p in jn.fp_search_encode(soa, exps)])
    payloads = tn.fp_encode_each(planes, exps)
    sizes = np.array([len(p) for p in payloads])
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    counts = np.array([len(p) for p in planes])
    blob = np.frombuffer(b"".join(payloads), np.uint8)
    got = tn.fp_decode_blocks(blob, offs, sizes, counts, bits)
    _same(got, jn.fp_decode_blocks(blob, offs, sizes, counts, bits))
    _same(got, np.concatenate(planes))
    for mod in (tn, jn):  # a chunk that declares more values than it holds
        with pytest.raises(ValueError, match="corrupt FP chunk"):
            mod.fp_decode_blocks(blob, offs, sizes // 4, counts, bits)


@pytest.mark.parametrize("bits,L", [(32, 64), (32, 256), (64, 64), (64, 130)])
def test_pack_parse_and_relayout_chunks(bits, L):
    """The reference-layout pack and parse and the v1/v2 relayout, through
    the raw entry points that fp_torch and fp64_torch call."""
    C = 6
    r = np.random.default_rng(L)
    word = np.uint32 if bits == 32 else np.uint64
    nb = 4 if bits == 32 else 8
    codes = r.integers(0, 8 if bits == 32 else 16, (C, L)).astype(np.uint8)
    res = r.integers(0, 1 << 62, (C, L), dtype=np.uint64).astype(word)
    if bits == 32:
        n_bytes = np.where(codes > 4, codes - 4, codes)
    else:
        n_bytes = np.where(codes > 8, codes - 8, codes)
    res &= ((np.uint64(1) << (8 * n_bytes).astype(np.uint64)) - np.uint64(1)).astype(word) \
        if bits == 32 else np.where(n_bytes == 8, np.uint64(2**64 - 1),
                                    (np.uint64(1) << (8 * n_bytes).astype(np.uint64))
                                    - np.uint64(1))
    B = 5 + L * (nb + 1) + 8
    outs = []
    for mod in (tn, jn):
        lib = mod.get_lib()
        pack = lib.tt_fp32_pack_chunks if bits == 32 else lib.tt_fp64_pack_chunks
        parse = lib.tt_fp32_parse_chunks if bits == 32 else lib.tt_fp64_parse_chunks
        out = np.zeros((C, B), np.uint8)
        sizes = np.zeros(C, np.int64)
        assert pack(mod._ptr(codes), mod._ptr(res), C, L, 4, 6, mod._ptr(out), B,
                    mod._ptr(sizes)) == 0
        bc, xo = np.zeros((C, L), np.uint8), np.zeros((C, L), word)
        assert parse(mod._ptr(out), C, B, L, mod._ptr(bc), mod._ptr(xo)) == 0
        v2 = mod.relayout_chunks(out, L, bits, to_v2=True)
        v1 = mod.relayout_chunks(v2, L, bits, to_v2=False)
        outs.append((out, sizes, bc, xo, v2, v1))
    _same(outs[0], outs[1])
    out, sizes, bc, xo, v2, v1 = outs[0]
    _same(bc, codes)
    _same(xo, res)
    _same(v1, out)


@pytest.mark.parametrize("kind", ["empty", "zeros", "text", "random", "runs"])
def test_lz4_entry_points(kind):
    r = np.random.default_rng(3)
    data = {"empty": np.zeros(0, np.uint8), "zeros": np.zeros(9000, np.uint8),
            "text": np.frombuffer(b"the quick brown fox " * 500, np.uint8),
            "random": r.integers(0, 256, 5000).astype(np.uint8),
            "runs": np.repeat(r.integers(0, 9, 700), 13).astype(np.uint8)}[kind]
    got = tn.lz4_compress(data)
    assert got == jn.lz4_compress(data)
    _same(tn.lz4_decompress(got, len(data)), jn.lz4_decompress(got, len(data)))
    blocks = tn.lz4_compress_blocks(data, 1024)
    _same(blocks, jn.lz4_compress_blocks(data, 1024))
    _same(tn.lz4_compress_jobs([data, data[::2]]), jn.lz4_compress_jobs([data, data[::2]]))
    if len(data):
        sizes = np.array([len(b) for b in blocks])
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        dst = np.minimum(1024, len(data) - 1024 * np.arange(len(blocks)))
        blob = b"".join(blocks)
        back = tn.lz4_decompress_blocks(blob, offs, sizes, dst)
        _same(back, jn.lz4_decompress_blocks(blob, offs, sizes, dst))
        _same(back, np.ascontiguousarray(data))
        for mod in (tn, jn):
            with pytest.raises(ValueError):
                mod.lz4_decompress(got[:-2], len(data) + 5)


@pytest.mark.parametrize("dt", [np.uint16, np.uint32, np.uint64])
def test_lz4_shuffle_entry_points(dt):
    arr = (np.arange(3000) // 3 * 7).astype(dt)
    ours, theirs = tn.lz4_shuffle_compress(arr), jn.lz4_shuffle_compress(arr)
    _same([bytes(p) for p in ours], [bytes(p) for p in theirs])
    sizes = np.array([len(p) for p in ours])
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    blob = np.concatenate(ours)
    back = tn.lz4_decompress_unshuffle(blob, offs, sizes, len(arr), dt)
    _same(back, jn.lz4_decompress_unshuffle(blob, offs, sizes, len(arr), dt))
    _same(back, arr)


def test_lz4_emit_blocks():
    """The emitter behind the device match search, on candidates from the
    port's search run on CPU tensors."""
    import torch

    from trico_tpu_torch.codec import lz4_torch

    r = np.random.default_rng(9)
    blocks = np.repeat(r.integers(0, 6, (3, 512)), 8, axis=1).astype(np.uint8)
    off, rle = (t.numpy() for t in lz4_torch.find_matches(torch.from_numpy(blocks)))
    tail = blocks[0, :100].copy()
    got = tn.lz4_emit_blocks(blocks, off, rle, tail)
    _same(got, jn.lz4_emit_blocks(blocks, off, rle, tail))
    for c in range(3):
        _same(tn.lz4_decompress(got[c], blocks.shape[1]), blocks[c])


@pytest.mark.parametrize("dt", [np.uint32, np.uint64])
@pytest.mark.parametrize("n,L", [(1, 64), (64, 64), (1000, 64), (5000, 4096)])
def test_bp_entry_points(dt, n, L):
    r = np.random.default_rng(n)
    v = (np.cumsum(r.integers(0, 9, n)) + r.integers(0, 50, n)).astype(dt)
    got = tn.bp_encode_blocks(v, L)
    _same(got, jn.bp_encode_blocks(v, L))
    sizes = np.array([len(p) for p in got])
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    counts = np.minimum(L, n - L * np.arange(len(got)))
    eb = np.dtype(dt).itemsize
    back = tn.bp_decode_blocks(b"".join(got), offs, sizes, counts, eb)
    _same(back, jn.bp_decode_blocks(b"".join(got), offs, sizes, counts, eb))
    _same(back, v)
    bad = bytearray(b"".join(got))
    bad[0] = 99
    for mod in (tn, jn):
        with pytest.raises(ValueError):
            mod.bp_decode_blocks(bytes(bad), offs, sizes, counts, eb)


def test_row_movers_and_byte_shuffles():
    r = np.random.default_rng(1)
    mat = r.integers(0, 256, (40, 100)).astype(np.uint8)
    sizes = r.integers(0, 101, 40).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    arr = r.integers(0, 1 << 62, 777, dtype=np.uint64)
    outs = []
    for mod in (tn, jn):
        lib = mod.get_lib()
        flat = np.empty(int(sizes.sum()), np.uint8)
        lib.tt_rows_to_bytes(mod._ptr(mat), 40, 100, mod._ptr(sizes), mod._ptr(off),
                             mod._ptr(flat))
        back = np.empty((40, 100), np.uint8)
        lib.tt_bytes_to_rows(mod._ptr(flat), mod._ptr(off), mod._ptr(sizes), 40, 100,
                             mod._ptr(back))
        outs.append((flat, back))
    _same(outs[0], outs[1])
    # the port's shuffles take a fill flag out and the planes as separate
    # buffers: the same bytes as trico_tpu's
    lib = jn.get_lib()
    soa = np.empty(8 * len(arr), np.uint8)
    lib.tt_shuffle_bytes(jn._ptr(arr.view(np.uint8)), len(arr), 8, jn._ptr(soa))
    planes, fills = tn.split_bytes(arr)
    _same(planes.reshape(-1), soa)
    assert not fills.any()
    aos = np.empty(8 * len(arr), np.uint8)
    lib.tt_unshuffle_bytes(jn._ptr(soa), len(arr), 8, jn._ptr(aos))
    _same(tn.join_bytes(list(planes), np.uint64).view(np.uint8), aos)
    _same(aos.view(np.uint64), arr)


def test_concurrent_first_builds_do_not_collide(tmp_path):
    """Four processes build the library at once into an empty directory: each
    writes a temporary file of its own and renames it into place, so every
    one of them loads a whole library."""
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "import numpy as np, trico_tpu_torch.native as n\n"
            "assert n.available(), n._LOAD_ERROR\n"
            "v = np.arange(100, dtype=np.uint32)\n"
            "assert np.array_equal(n.fp_decode(n.fp_encode(v, 4, 10), 32), v)\n"
            "print('ok')\n")
    env = dict(os.environ, TRICO_TPU_BUILD_DIR=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(REPO)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0 and out.strip() == "ok", err
    built = sorted(f.name for f in tmp_path.iterdir())
    assert len(built) == 1 and built[0].startswith("libtrico_torch_native_"), built
