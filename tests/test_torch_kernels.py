"""Kernels of the PyTorch port against the reference package, on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those versions (and the wrappers' padding, permutation and top-k
logic around them) against the reference's Pallas kernels in interpret
mode and its jnp oracles, on the same numpy inputs. Tolerances are fp32
reassociation bounds (stated per assertion). The CUDA kernels themselves
run only on the card (``tests/test_torch_gpu.py``, marked ``gpu``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as JP
from repro.core import token_pruning as JTP
from repro.kernels.sbmm import sbmm as j_sbmm
from repro.kernels.sbmm import sbmm_ref as j_sbmm_ref
from repro.models import attention as JA

from repro_torch import convert
from repro_torch.core import packing as TPK
from repro_torch.core import token_pruning as TTP
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention)
from repro_torch.kernels.sbmm import pad_input, sbmm, sbmm_raw
from repro_torch.kernels.token_drop import token_drop

FP32_TOL = 1e-5  # per-op fp32 bound (sums of <= a few hundred terms)


def _mask(counts_per_col, n_row_blocks, rng):
    """Block mask with the given kept-block count per column (distinct
    counts -> a non-identity col_perm and -1 header padding)."""
    m = np.zeros((n_row_blocks, len(counts_per_col)), np.float32)
    for c, n in enumerate(counts_per_col):
        m[rng.choice(n_row_blocks, n, replace=False), c] = 1.0
    return m


# ---------------------------------------------------------------------------
# K1 sbmm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N,counts", [
    (1, 64, 48, (1, 3, 2)),
    (5, 40, 48, (3, 1, 2)),        # K not a multiple of 16: padding path
    (70, 64, 64, (0, 4, 2, 1)),    # an empty column, M > one 64-row tile
])
def test_sbmm_plain_matches_reference(M, K, N, counts):
    rng = np.random.default_rng(M * 1000 + K)
    w = rng.standard_normal((K, N)).astype(np.float32)
    mask = _mask(counts, -(-K // 16), rng)
    pk_j = JP.pack_weight(w, mask, 16)
    pk_t = convert.packed_from_jax(pk_j)
    assert not np.array_equal(pk_t.col_perm, np.arange(pk_t.n_cols))
    assert (pk_t.header == -1).any()
    x = rng.standard_normal((M, K)).astype(np.float32)

    y_t = sbmm(torch.from_numpy(x), pk_t).numpy()
    y_j = np.asarray(j_sbmm(jnp.asarray(x), pk_j, tm=64, interpret=True))
    np.testing.assert_allclose(y_t, y_j, atol=FP32_TOL, rtol=FP32_TOL)

    # raw (stored column order) against the reference's scatter oracle
    xp = pad_input(torch.from_numpy(x), pk_t)
    raw_t = sbmm_raw(xp, pk_t.blocks, pk_t.header).numpy()
    raw_j = np.asarray(j_sbmm_ref(jnp.asarray(xp.numpy()), pk_j.blocks,
                                  pk_j.header))
    np.testing.assert_allclose(raw_t, raw_j, atol=FP32_TOL, rtol=FP32_TOL)

    # the port packs identically on its own
    pk_o = TPK.pack_weight(w, mask, 16)
    assert np.array_equal(pk_o.col_perm, pk_j.col_perm)
    assert np.array_equal(pk_o.header.numpy(), np.asarray(pk_j.header))
    assert np.array_equal(pk_o.blocks.numpy(), np.asarray(pk_j.blocks))
    assert np.array_equal(pk_o.to_dense().numpy(), np.asarray(pk_j.to_dense()))


def test_sbmm_rejects_wrong_input_width():
    pk = TPK.pack_weight(np.ones((32, 16), np.float32),
                         np.ones((2, 1), np.float32), 16)
    with pytest.raises(ValueError, match="input features"):
        sbmm(torch.ones((2, 16)), pk)


def test_sbmm_rejects_half_blocks():
    pk = TPK.pack_weight(np.ones((16, 16), np.float16),
                         np.ones((1, 1), np.float32), 16)
    with pytest.raises(NotImplementedError, match="int8"):
        sbmm(torch.ones((2, 16)), pk)


# ---------------------------------------------------------------------------
# K2 flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,N,H,Dh,lens", [
    (1, 17, 4, 16, None),
    (4, 33, 4, 16, (33, 20, 9, 1)),
    (2, 50, 2, 32, (50, 13)),
])
def test_flash_attention_plain_matches_reference(B, N, H, Dh, lens):
    rng = np.random.default_rng(N * 7 + B)
    q, k, v = (rng.standard_normal((B, N, H, Dh)).astype(np.float32)
               for _ in range(3))
    kv = None if lens is None else np.asarray(lens, np.int32)
    o_t, s_t = flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        kv_len=None if kv is None else torch.from_numpy(kv),
        collect_scores=True)
    jkv = None if kv is None else jnp.asarray(kv)
    o_j = JA.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False, kv_len=jkv)
    s_j = JA.attention_probs_row(jnp.asarray(q)[:, 0], jnp.asarray(k),
                                 kv_len=jkv).mean(axis=1)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                               atol=FP32_TOL, rtol=FP32_TOL)
    if lens is not None:
        for b, L in enumerate(lens):
            # zero mass at masked keys, exactly
            assert (s_t[b, L:] == 0).all()
            _, probs = attention_plain(*(torch.from_numpy(a)
                                         for a in (q, k, v)),
                                       torch.from_numpy(kv))
            assert (probs[b, :, L:] == 0).all()
    # without collect_scores the wrapper returns the output alone
    o_only = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert o_only.shape == (B, N, H, Dh)


# ---------------------------------------------------------------------------
# K3 token drop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,N,D,k,n_valid", [
    (1, 17, 64, 8, (17,)),
    (3, 33, 64, 10, (33, 20, 12)),   # token-padded rows score exactly 0
    (2, 9, 32, 7, (9, 9)),
])
def test_token_drop_plain_matches_tdm(B, N, D, k, n_valid):
    rng = np.random.default_rng(N * 3 + k)
    z = rng.standard_normal((B, N, D)).astype(np.float32)
    s = rng.random((B, N)).astype(np.float32)
    for b, nv in enumerate(n_valid):
        s[b, nv:] = 0.0
    s /= s.sum(axis=1, keepdims=True)
    out_t = token_drop(torch.from_numpy(z), torch.from_numpy(s), k).numpy()
    out_j, _ = JTP.tdm(jnp.asarray(z), jnp.asarray(s), None, k=k)
    out_j = np.asarray(out_j)
    assert out_t.shape == (B, k + 2, D)
    # CLS and kept rows are copies: bitwise; the fused row is a weighted sum
    np.testing.assert_array_equal(out_t[:, :k + 1], out_j[:, :k + 1])
    np.testing.assert_allclose(out_t[:, k + 1], out_j[:, k + 1],
                               atol=FP32_TOL, rtol=FP32_TOL)


# ---------------------------------------------------------------------------
# stable top-k
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,levels,k", [(0, 3, 5), (1, 2, 9), (2, 5, 1),
                                           (3, 1, 4)])
def test_stable_topk_breaks_ties_like_lax_top_k(seed, levels, k):
    rng = np.random.default_rng(seed)
    # few distinct values -> many ties; zeros model token padding
    x = rng.integers(0, levels, size=(4, 12)).astype(np.float32) / 8.0
    vals_t, idx_t = TTP.stable_topk(torch.from_numpy(x), k)
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))


# ---------------------------------------------------------------------------
# no fallback on the card
# ---------------------------------------------------------------------------
def test_card_tensors_never_take_the_plain_path(monkeypatch):
    """A wrapper that believes its inputs lie on the card launches the
    kernel or raises — here the launch fails, and the plain version must
    not stand in."""
    def no_library(name):
        raise RuntimeError(f"no {name} kernel here")

    monkeypatch.setattr(backend, "on_card", lambda *ts: True)
    monkeypatch.setattr(backend, "library", no_library)
    x = torch.zeros((4, 16))
    pk = TPK.pack_weight(np.ones((16, 16), np.float32),
                         np.ones((1, 1), np.float32), 16)
    with pytest.raises(RuntimeError, match="no sbmm kernel"):
        sbmm(x, pk)
    q = torch.zeros((1, 5, 2, 16))
    with pytest.raises(RuntimeError, match="no flash_attention kernel"):
        flash_attention(q, q, q, torch.tensor([5], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no token_drop kernel"):
        token_drop(torch.zeros((1, 5, 8)), torch.rand((1, 5)), 2)
    assert backend.launches() == {n: 0 for n in backend.KERNELS}


def test_mixed_or_unknown_devices_raise():
    with pytest.raises(ValueError, match="all on"):
        backend.on_card(torch.zeros(1), torch.zeros(1, device="meta"))
