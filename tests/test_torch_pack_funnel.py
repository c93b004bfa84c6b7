"""trico_tpu_torch.codec.pack_funnel held against trico_tpu's pack_funnel on
JAX's CPU backend (its XLA network) and its Pallas kernel in interpret mode.
Tolerance: every word and byte equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trico_tpu.codec import fp_pallas
from trico_tpu.codec import pack_funnel as jpf
from trico_tpu_torch import _u32
from trico_tpu_torch.codec import fp_cuda
from trico_tpu_torch.codec import pack_funnel as tpf

from torch_cases import recording


def _inputs(C, L, seed):
    """Random (length, res) rows, plus an all-empty and an all-full row."""
    r = np.random.default_rng(seed)
    length = r.integers(0, 5, (C, L)).astype(np.int32)
    length[0] = 0
    length[1] = 4
    length[2] = np.where(r.random(L) < 0.9, 0, length[2])  # sparse
    res = r.integers(0, 1 << 32, (C, L), dtype=np.uint64).astype(np.uint32)
    return length, res


@pytest.mark.parametrize("L", [64, 256, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_region_bytes_match_jax(L, seed):
    length, res = _inputs(5, L, seed)
    got, n_got = tpf.region_bytes_f32(torch.from_numpy(length),
                                      _u32.from_numpy(res))
    want, n_want = jpf.region_bytes_f32(jnp.asarray(length), jnp.asarray(res))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(n_got.numpy(), np.asarray(n_want))


@pytest.mark.parametrize("seed", [0, 1])
def test_region_words_match_jax(seed):
    length, res = _inputs(4, 512, seed)
    got, n_got = tpf.region_words_f32(torch.from_numpy(length),
                                      _u32.from_numpy(res))
    want, n_want = jpf.region_words_f32(jnp.asarray(length), jnp.asarray(res))
    np.testing.assert_array_equal(_u32.to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(n_got.numpy(), np.asarray(n_want))


def _funnel_items(C, L, seed):
    """(dest, payload, live) of a word-funnel compaction: nondecreasing
    destinations (merges allowed) with nondecreasing displacements."""
    r = np.random.default_rng(seed)
    gsize = r.integers(0, 17, (C, L // 4))
    og = np.cumsum(gsize, axis=1) - gsize
    k4 = np.arange(4)
    dest = ((og[:, :, None] + 4 * k4) >> 2).reshape(C, L).astype(np.int32)
    live = (4 * k4[None, None, :] < gsize[:, :, None]).reshape(C, L)
    payload = r.integers(0, 1 << 32, (C, L), dtype=np.uint64).astype(np.uint32)
    return dest, payload, live


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_compact_or_matches_xla_network(seed):
    dest, payload, live = _funnel_items(4, 256, seed)
    got = tpf._pair_compact_or(torch.from_numpy(dest), _u32.from_numpy(payload),
                               torch.from_numpy(live), 256)
    want = jpf._pair_compact_or_xla(
        jnp.where(jnp.asarray(live),
                  ((jnp.arange(256, dtype=jnp.int32)[None, :]
                    - jnp.asarray(dest)).astype(jnp.uint32) << 1) | 1, 0),
        jnp.where(jnp.asarray(live), jnp.asarray(payload), 0), 8)
    np.testing.assert_array_equal(_u32.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("seed", [3, 4])
def test_pair_compact_or_matches_pallas(seed):
    dest, payload, live = _funnel_items(4, 512, seed)
    disp = np.arange(512, dtype=np.int32)[None, :] - dest
    carrier = np.where(live, (disp.astype(np.uint32) << 1) | 1, 0).astype(np.uint32)
    payload = np.where(live, payload, 0).astype(np.uint32)
    got = tpf.fp_cuda.pair_compact_or(_u32.from_numpy(carrier),
                                      _u32.from_numpy(payload), 9)
    want = fp_pallas.pair_compact_or_pallas(jnp.asarray(carrier),
                                            jnp.asarray(payload), 9, True)
    np.testing.assert_array_equal(_u32.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("L", [4, 8, 40, 260, 4104])
@pytest.mark.parametrize("which", [0, 1], ids=["c0", "c1"])
def test_pair_compact_or_at_pack_lengths_matches_pallas(L, which):
    """The two compactions of the word funnel at chunk lengths off the
    kernels' grids (8, 40 and 4104 are those chip_smoke.py gives them on the
    card): each call's (carrier, payload) through the plain version and the
    Pallas kernel in interpret mode."""
    length, res = _inputs(4, L, seed=L)
    with recording(fp_cuda, "pair_compact_or") as calls:
        tpf.region_words_f32(torch.from_numpy(length), _u32.from_numpy(res))
    assert len(calls) == 2
    carrier, payload, nbits = calls[which]
    got = fp_cuda.pair_compact_or(carrier, payload, nbits)
    want = fp_pallas.pair_compact_or_pallas(
        jnp.asarray(_u32.to_numpy(carrier)), jnp.asarray(_u32.to_numpy(payload)),
        nbits, True)
    np.testing.assert_array_equal(_u32.to_numpy(got), np.asarray(want))


def test_region_rejects_lengths_not_multiple_of_4():
    with pytest.raises(ValueError):
        tpf.region_words_f32(torch.zeros((1, 6), dtype=torch.int32),
                             torch.zeros((1, 6), dtype=torch.int32))
