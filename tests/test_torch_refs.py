"""The port's NumPy oracles (trico_tpu_torch/codec/fp_ref.py, bp_ref.py,
lz4_ref.py, transpose.py) held against trico_tpu's, function by function, on
the same inputs made from a seed with numpy, at the shapes of
tests/test_fp_ref.py and tests/test_bp.py. Tolerance: exact (the same bytes,
the same arrays). None of these cases needs the C++ toolchain or a card."""

import numpy as np
import pytest

from conftest import mesh_like_floats
from trico_tpu.codec import bp_ref as j_bp
from trico_tpu.codec import fp_ref as j_fp
from trico_tpu.codec import lz4_ref as j_lz4
from trico_tpu.codec import transpose as j_tr
from trico_tpu_torch.codec import bp_ref, fp_ref, lz4_ref, transpose

from torch_cases import words, words64


@pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 9, 16, 1000, 1003])
@pytest.mark.parametrize("e", [(4, 10), (0, 0), (2, 4), (10, 20), (30, 30), (5, 7)])
def test_fp_ref_f32_bytes(n, e):
    vals = mesh_like_floats(n, seed=n)
    got = fp_ref.compress(vals, *e)
    assert got == j_fp.compress(vals, *e)
    back = fp_ref.decompress_f32(got)
    np.testing.assert_array_equal(back, j_fp.decompress_f32(got))
    np.testing.assert_array_equal(back, vals.view(np.uint32))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 8, 999, 1000])
@pytest.mark.parametrize("e", [(20, 20), (0, 0), (4, 10), (30, 30)])
def test_fp_ref_f64_bytes(n, e):
    vals = mesh_like_floats(n, seed=n, dtype=np.float64)
    got = fp_ref.compress(vals, *e)
    assert got == j_fp.compress(vals, *e)
    back = fp_ref.decompress_f64(got)
    np.testing.assert_array_equal(back, j_fp.decompress_f64(got))
    np.testing.assert_array_equal(back, vals.view(np.uint64))


@pytest.mark.parametrize("bits", [32, 64])
def test_fp_ref_special_words_and_defaults(bits):
    """NaN, inf, signed zero and subnormal patterns at the default
    exponents; the width-less decompress is a stub in both."""
    vals = (words(5, 300, seed=2) if bits == 32 else words64(6, 300, seed=2)).reshape(-1)
    got = fp_ref.compress(vals)
    assert got == j_fp.compress(vals)
    for mod in (fp_ref, j_fp):
        with pytest.raises(NotImplementedError):
            mod.decompress(got)
    assert fp_ref.compressed_bound(len(vals), bits) == \
        j_fp.compressed_bound(len(vals), bits)


@pytest.mark.parametrize("e", [(4, 6), (0, 0), (0, 6), (6, 0), (10, 12), (30, 30)])
@pytest.mark.parametrize("bits", [32, 64])
def test_fp_ref_keys_and_predictions(e, bits):
    vals = (words(5, 200, seed=e[0]) if bits == 32
            else words64(6, 200, seed=e[1])).reshape(-1)
    for fn in ("fcm_dfcm_keys", "predictions"):
        for g, w in zip(getattr(fp_ref, fn)(vals, *e), getattr(j_fp, fn)(vals, *e)):
            np.testing.assert_array_equal(g, w)
    assert fp_ref._norm_exponents(e[0] + 1, 40) == j_fp._norm_exponents(e[0] + 1, 40)


def test_fp_ref_prev_occurrence():
    r = np.random.default_rng(0)
    keys = r.integers(0, 9, 700).astype(np.uint32)
    vals = r.integers(0, 1 << 32, 700, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(fp_ref.prev_occurrence(keys, vals),
                                  j_fp.prev_occurrence(keys, vals))


@pytest.mark.parametrize("data", [b"", b"\x00", b"\x25\x00\x00"])
def test_fp_ref_treats_truncated_streams_alike(data):
    outcomes = []
    for mod in (fp_ref, j_fp):
        try:
            outcomes.append(mod.decompress_f32(data).tolist())
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            outcomes.append(type(e))
    assert outcomes[0] == outcomes[1]


def _index_like(n, seed=0):
    r = np.random.default_rng(seed)
    return (np.cumsum(r.integers(0, 5, n)) + r.integers(0, 64, n)).astype(np.uint64)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4096, 10001])
@pytest.mark.parametrize("dt", [np.uint32, np.uint64])
def test_bp_ref_bytes(n, dt):
    r = np.random.default_rng(n)
    for v in (_index_like(n, seed=n).astype(dt),
              r.integers(0, np.iinfo(dt).max, n, dtype=np.uint64).astype(dt),
              np.zeros(n, dt)):
        got = bp_ref.encode_chunk(v)
        assert got == j_bp.encode_chunk(v)
        assert bp_ref.chunk_payload_size(v) == j_bp.chunk_payload_size(v) == len(got)
        bits = 8 * np.dtype(dt).itemsize
        back = bp_ref.decode_chunk(got, n, bits)
        np.testing.assert_array_equal(back, j_bp.decode_chunk(got, n, bits))
        np.testing.assert_array_equal(back, v)


@pytest.mark.parametrize("case", ["width", "short"])
def test_bp_ref_rejects_corrupt_chunks_alike(case):
    payload = bytearray(bp_ref.encode_chunk(_index_like(64).astype(np.uint32)))
    if case == "width":
        payload[0] = 40
    else:
        payload = payload[:-3]
    for mod in (bp_ref, j_bp):
        with pytest.raises(ValueError):
            mod.decode_chunk(bytes(payload), 64, 32)


def _lz4_inputs():
    r = np.random.default_rng(5)
    text = b"the quick brown fox jumps over the lazy dog; "
    return {"empty": b"", "one": b"a", "short": b"abcabcabcabc",
            "zeros": bytes(5000), "text": text * 120,
            "alphabet": r.integers(0, 5, 6000).astype(np.uint8).tobytes(),
            "random": r.integers(0, 256, 3000).astype(np.uint8).tobytes(),
            "long_run": b"x" * 70000 + b"tail"}


@pytest.mark.parametrize("name", list(_lz4_inputs()))
def test_lz4_ref_bytes(name):
    data = _lz4_inputs()[name]
    got = lz4_ref.compress(data)
    assert got == j_lz4.compress(data)
    assert lz4_ref.decompress(got, len(data)) == j_lz4.decompress(got, len(data)) == data


@pytest.mark.parametrize("cut", [1, 5, 17])
def test_lz4_ref_rejects_truncated_blocks_alike(cut):
    data = _lz4_inputs()["text"]
    block = lz4_ref.compress(data)[:-cut]
    outcomes = []
    for mod in (lz4_ref, j_lz4):
        try:
            outcomes.append(mod.decompress(block, len(data)))
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            outcomes.append(type(e))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.uint32, np.uint64])
@pytest.mark.parametrize("n", [0, 1, 999])
def test_transpose_byte_planes(dt, n):
    r = np.random.default_rng(n)
    arr = r.integers(0, np.iinfo(dt).max, n, dtype=np.uint64).astype(dt)
    got, want = transpose.byte_planes(arr), j_tr.byte_planes(arr)
    assert len(got) == len(want) == np.dtype(dt).itemsize
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(transpose.from_byte_planes(got, dt),
                                  j_tr.from_byte_planes(want, dt))
    np.testing.assert_array_equal(transpose.from_byte_planes(got, dt), arr)


@pytest.mark.parametrize("width", [1, 2, 3])
@pytest.mark.parametrize("dt", [np.uint32, np.uint64])
def test_transpose_aos_soa(width, dt):
    arr = np.arange(width * 101, dtype=dt) * 977
    got, want = transpose.aos_to_soa(arr, width), j_tr.aos_to_soa(arr, width)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(transpose.soa_to_aos(got), j_tr.soa_to_aos(want))
    np.testing.assert_array_equal(transpose.soa_to_aos(got).reshape(-1), arr)
