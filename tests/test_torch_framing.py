"""The host side of trico_tpu_torch.chunked (its own framing, row movers,
fill and LZ4 containers, BP header check and host codecs) held against
trico_tpu.chunked's, function by function, on the same inputs made from a
seed with numpy: well-formed containers give the same values, truncated or
corrupt ones the same exception type and message. Tolerance: exact.

Every case runs twice: with the NumPy fallbacks (``native=False``: both
packages' C++ libraries switched off, so no toolchain is needed) and with
the C++ host libraries (``native=True``, skipped where g++ is missing)."""

import struct

import numpy as np
import pytest

import trico_tpu.chunked as jc
import trico_tpu_torch.chunked as tc
from conftest import mesh_like_floats

from torch_cases import no_native, require_native, words, words64


@pytest.fixture(params=[False, True], ids=["numpy", "native"])
def host(request, monkeypatch):
    """Which host codec both packages run in this case."""
    if request.param:
        require_native()
    else:
        no_native(monkeypatch)
    return request.param


def _both(fn, *args):
    """(kind, value) of ``tc.fn(*args)`` and ``jc.fn(*args)``: the result, or
    the exception's type and message."""
    out = []
    for mod in (tc, jc):
        try:
            out.append(("ok", getattr(mod, fn)(*args)))
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            out.append(("raised", type(e), str(e)))
    return out


def _header_fields(h):
    return None if h is None else tuple(getattr(h, k) for k in tc.ContainerHeader.__slots__)


def _containers():
    """One well-formed container of every kind, made by trico_tpu's host
    encoders."""
    f32 = mesh_like_floats(2 * 64 + 9, seed=1).view(np.uint32)
    f64 = mesh_like_floats(3 * 32 + 1, seed=2, dtype=np.float64).view(np.uint64)
    idx = (np.arange(200) // 3).astype(np.uint32)
    plane = (np.arange(700) // 9 % 5).astype(np.uint8)
    return {
        "fp32_ref": jc.encode_chunked(f32, 64, use_tpu=False, layout="ref"),
        "fp32_tpu": jc.encode_chunked(f32, 64, use_tpu=False, layout="tpu"),
        "fp64_ref": jc.encode_chunked(f64, 32, use_tpu=False, layout="ref"),
        "fp64_tpu": jc.encode_chunked(f64, 32, use_tpu=False, layout="tpu"),
        "fp_empty": jc.encode_chunked(f32[:0], 64, use_tpu=False),
        "bp32": jc.encode_bp_chunked(idx, 64, use_tpu=False),
        "bp64": jc.encode_bp_chunked(idx.astype(np.uint64) << np.uint64(33), 64,
                                     use_tpu=False),
        "bp_empty": jc.encode_bp_chunked(idx[:0], 64, use_tpu=False),
        "lz4": jc.encode_lz4_chunked(plane, 256, use_tpu=False),
        "lz4_empty": jc.encode_lz4_chunked(plane[:0], 256, use_tpu=False),
        "fill": jc.encode_fill(0xAB, 12345),
    }


def _damaged(blob: bytes):
    """Truncated and corrupt variants of one container."""
    b = bytearray(blob)
    out = {"empty": b"", "prefix": blob[:13], "sizes": blob[:15],
           "payload": blob[:-1], "version": bytes([2]) + blob[1:],
           "flags": blob[:1] + bytes([0x40]) + blob[2:],
           "both_kinds": blob[:1] + bytes([2 | 8 | 1]) + blob[2:],
           "zero_chunk_len": blob[:2] + struct.pack("<I", 0) + blob[6:],
           "count": blob[:10] + struct.pack("<I", struct.unpack_from("<I", blob, 10)[0] + 1)
           + blob[14:]}
    if len(b) > 20:
        b[14] ^= 0xFF  # the first chunk size
        out["size_table"] = bytes(b)
    return out


@pytest.mark.parametrize("name", list(_containers()))
def test_headers_of_well_formed_containers(name):
    blob = _containers()[name]
    got, want = tc.parse_container_header(blob), jc.parse_container_header(blob)
    assert _header_fields(got) == _header_fields(want) and got is not None
    (_, (h1, s1, o1)), (_, (h2, s2, o2)) = _both("parse_validated_framing", blob)
    assert (_header_fields(h1), s1, o1) == (_header_fields(h2), s2, o2)


@pytest.mark.parametrize("name", ["fp32_ref", "fp64_tpu", "bp32", "lz4", "fill",
                                  "lz4_empty"])
def test_damaged_framing_raises_alike(name):
    for what, blob in _damaged(_containers()[name]).items():
        got, want = (_header_fields(m.parse_container_header(blob)) for m in (tc, jc))
        assert got == want, what
        ours, theirs = _both("parse_validated_framing", blob)
        assert ours[0] == theirs[0], what
        if ours[0] == "raised":
            assert ours[1:] == theirs[1:] and ours[1] is ValueError, what
        else:
            assert _header_fields(ours[1][0]) == _header_fields(theirs[1][0]), what


@pytest.mark.parametrize("payload", [b"", b"\x01" * 13, b"\x00" * 20, b"\x02" + b"\x00" * 19])
def test_not_a_container(payload):
    assert tc.parse_container_header(payload) is None
    assert jc.parse_container_header(payload) is None


def test_constants():
    for k in ("DEFAULT_CHUNK_LEN", "DEFAULT_BP_CHUNK", "DEFAULT_LZ4_BLOCK",
              "F32_TPU_EXP"):
        assert getattr(tc, k) == getattr(jc, k), k


@pytest.mark.parametrize("C,B", [(0, 16), (1, 1), (5, 40), (64, 300)])
def test_rows_to_bytes_and_back(host, C, B):
    r = np.random.default_rng(C + B)
    mat = r.integers(0, 256, (C, B)).astype(np.uint8)
    sizes = r.integers(0, B + 1, C)
    got = tc.rows_to_bytes(mat, sizes)
    np.testing.assert_array_equal(got, jc.rows_to_bytes(mat, sizes))
    assert len(got) == sizes.sum()
    back = tc.bytes_to_rows(got, sizes, B)
    np.testing.assert_array_equal(back, jc.bytes_to_rows(got, sizes, B))
    live = np.arange(B)[None, :] < sizes[:, None]
    np.testing.assert_array_equal(back[live], mat[live])


@pytest.mark.parametrize("case", ["too_wide", "negative", "short_buffer", "long_buffer"])
def test_bytes_to_rows_rejects_alike(host, case):
    buf = np.arange(20, dtype=np.uint8)
    sizes = {"too_wide": [9, 11], "negative": [-1, 21], "short_buffer": [8, 8, 8],
             "long_buffer": [8, 8]}[case]
    ours, theirs = _both("bytes_to_rows", buf, np.array(sizes), 10)
    assert ours == theirs and ours[0] == "raised" and ours[1] is ValueError


@pytest.mark.parametrize("bits,n", [(32, 0), (32, 1), (32, 8), (32, 9), (64, 3), (64, 4)])
def test_payload_count(bits, n):
    buf = np.frombuffer(bytes([0x25]) + n.to_bytes(4, "big") + b"\0" * 4, np.uint8)
    assert tc._payload_count(buf, bits) == jc._payload_count(buf, bits)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("e", [(4, 6), (0, 0), (10, 12), (20, 20)])
@pytest.mark.parametrize("n", [0, 1, 9, 500])
def test_host_fp_codecs(host, bits, e, n):
    vals = (words(5, max(n, 1), seed=n) if bits == 32
            else words64(6, max(n, 1), seed=n)).T.reshape(-1)[:n].copy()
    got = bytes(tc._host_fp_encode(vals, *e))
    assert got == bytes(jc._host_fp_encode(vals, *e))
    np.testing.assert_array_equal(tc._host_fp_decode(got, bits),
                                  jc._host_fp_decode(got, bits))
    np.testing.assert_array_equal(tc._host_fp_decode(got, bits), vals)
    cands = ((4, 6), (0, 6), e)
    assert bytes(tc._host_fp_encode_best(vals, cands)) == \
        bytes(jc._host_fp_encode_best(vals, cands))


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("layout", ["ref", "tpu"])
def test_host_decode_full_chunks(host, bits, layout):
    L, C = 64, 5
    vals = (words(5, C * L, seed=3) if bits == 32
            else words64(6, C * L, seed=3)).T.reshape(-1)[: C * L].copy()
    blob = jc.encode_chunked(vals, L, 14, 18, use_tpu=False, layout=layout)
    hdr, sizes, off = tc.parse_validated_framing(blob)
    B = max(sizes) + 3
    mat = tc.bytes_to_rows(np.frombuffer(blob, np.uint8)[off:], np.array(sizes), B)
    idx = np.array([4, 0, 2])
    got = tc.host_decode_full_chunks(mat, sizes, idx, L, bits, layout)
    np.testing.assert_array_equal(
        got, jc.host_decode_full_chunks(mat, sizes, idx, L, bits, layout))
    np.testing.assert_array_equal(got, vals.reshape(C, L)[idx])


@pytest.mark.parametrize("total", [1, 19, 255, 100000])
def test_fill_containers(total):
    got = tc.encode_fill(0x5A, total)
    assert got == jc.encode_fill(0x5A, total) and len(got) == 19
    np.testing.assert_array_equal(tc.decode_fill(got), jc.decode_fill(got))
    np.testing.assert_array_equal(tc.decode_lz4_chunked(got), np.full(total, 0x5A, np.uint8))


@pytest.mark.parametrize("case", ["not_fill", "two_sizes", "chunk_len"])
def test_decode_fill_rejects_alike(case):
    good = bytearray(tc.encode_fill(1, 50))
    if case == "not_fill":
        blob = _containers()["lz4"]
    elif case == "two_sizes":
        blob = bytes(good[:14]) + struct.pack("<I", 2) + bytes(good[18:]) + b"\0"
    else:
        blob = bytes(good[:2]) + struct.pack("<I", 25) + bytes(good[6:])
    ours, theirs = _both("decode_fill", blob)
    assert ours == theirs and ours[0] == "raised"


@pytest.mark.parametrize("n,block", [(0, 256), (1, 256), (255, 256), (256, 256),
                                     (700, 256), (5000, 1024)])
def test_lz4_containers_on_the_host(host, n, block):
    """Planes shorter than a block, and every plane where the C++ emitter is
    missing, are the host codec's in both packages; the others take the
    device search in both (trico_tpu's as a device host runs it)."""
    r = np.random.default_rng(n)
    plane = (np.repeat(r.integers(0, 7, n // 5 + 1), 5)[:n]).astype(np.uint8)
    got = tc.encode_lz4_chunked(plane, block, device="cpu")
    assert got == jc.encode_lz4_chunked(plane, block, use_tpu=True)
    np.testing.assert_array_equal(tc.decode_lz4_chunked(got), jc.decode_lz4_chunked(got))
    np.testing.assert_array_equal(tc.decode_lz4_chunked(got), plane)


@pytest.mark.parametrize("case", ["bp", "fp", "truncated", "bad_block"])
def test_decode_lz4_rejects_alike(host, case):
    c = _containers()
    blob = {"bp": c["bp32"], "fp": c["fp32_ref"], "truncated": c["lz4"][:-5],
            "bad_block": c["lz4"][:-8] + b"\xff" * 8}[case]
    ours, theirs = _both("decode_lz4_chunked", blob)
    assert ours[:2] == theirs[:2] and ours[0] == "raised"


@pytest.mark.parametrize("dt", [np.uint32, np.uint64])
@pytest.mark.parametrize("n,L", [(0, 64), (40, 64), (63, 64), (200, 64), (70, 32)])
def test_bp_containers_on_the_host(host, dt, n, L):
    """Streams with no full chunk stay on the host in both packages, and the
    host decodes every container alike."""
    v = ((np.arange(n) // 3) * 5).astype(dt)
    got = tc.encode_bp_chunked(v, L, device="cpu")
    assert got == jc.encode_bp_chunked(v, L, use_tpu=n >= L)
    np.testing.assert_array_equal(tc.decode_bp_chunked(got, device="cpu"),
                                  jc.decode_bp_chunked(got, use_tpu=False))
    np.testing.assert_array_equal(tc.decode_bp_chunked(got, device="cpu"), v)
    if n:  # the first chunk's payload alone, through the host chunk decoder
        sizes, off = tc.parse_validated_framing(got)[1:]
        first = min(n, L)
        np.testing.assert_array_equal(
            tc._bp_host_decode(np.frombuffer(got, np.uint8)[off : off + sizes[0]],
                               first, np.dtype(dt).itemsize), v[:first])


@pytest.mark.parametrize("case", ["ok", "width", "size"])
@pytest.mark.parametrize("bits", [32, 64])
def test_validate_bp_chunk_headers(case, bits):
    L, C = 64, 3
    mat = np.zeros((C, 2 + 4 * 2 * bits), np.uint8)
    mat[:, :2] = [[3, 5], [0, 0], [bits, 1]]
    sizes = 2 + 4 * mat[:, :2].astype(np.int64).sum(axis=1)
    if case == "width":
        mat[1, 0] = bits + 1
    elif case == "size":
        sizes[2] += 4
    ours, theirs = _both("validate_bp_chunk_headers", mat, sizes, L, bits)
    assert ours == theirs and (ours[0] == "ok") == (case == "ok")


@pytest.mark.parametrize("name", ["bp32", "lz4", "fill"])
def test_decode_chunked_refuses_other_kinds_alike(name):
    blob = _containers()[name]
    for mod, kw in ((tc, {"device": "cpu"}), (jc, {"use_tpu": False})):
        with pytest.raises(ValueError, match="FP containers only"):
            mod.decode_chunked(blob, **kw)
    with pytest.raises(ValueError, match="not a BP32 container"):
        tc.decode_bp_chunked(_containers()["fp32_ref"], device="cpu")
