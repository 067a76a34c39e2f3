"""Kernels of the PyTorch port against the reference package, on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those versions (and the wrappers' padding, permutation and top-k
logic around them) against the reference's Pallas kernels in interpret
mode and its jnp oracles, on the same numpy inputs. Tolerances are fp32
reassociation bounds (stated per assertion); int8 blocks and scales, and
every gathered row, must be equal. The reference's Pallas
``token_package_pallas`` raises under the installed jax (``pl.store``), so
the soft TDM is held against ``token_pruning.tdm_soft``. The CUDA kernels
themselves run only on the card (``tests/test_torch_gpu.py``, marked
``gpu``)."""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as JP
from repro.core import quant as JQ
from repro.core import token_pruning as JTP
from repro.kernels.sbmm import sbmm as j_sbmm
from repro.kernels.sbmm import sbmm_quant_ref as j_sbmm_quant_ref
from repro.kernels.sbmm import sbmm_ref as j_sbmm_ref
from repro.models import attention as JA

from repro_torch import convert
from repro_torch.core import packing as TPK
from repro_torch.core import quant as TQ
from repro_torch.core import token_pruning as TTP
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention)
from repro_torch.kernels.sbmm import (pad_input, sbmm, sbmm_plain,
                                      sbmm_quant_plain, sbmm_quant_raw,
                                      sbmm_raw)
from repro_torch.kernels.token_drop import token_drop
from repro_torch.kernels.token_drop.ops import MAX_TOKENS
from repro_torch.kernels.token_package import token_package
from repro_torch.models.attention import flash_attention_torch

FP32_TOL = 1e-5  # per-op fp32 bound (sums of <= a few hundred terms)
FP16_ATTN_TOL = 2e-3  # fp16 attention output: one fp16 rounding of values
# whose fp32 sums differ in order (the reference's own fp16 test bound)


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
SBMM_KINDS = ("fp32", "fp16", "int8-block", "int8-channel")


def _weights(kind, w, mask):
    """The reference's packed weight of ``kind`` and the port's conversion
    of it, after checking that the port packs and quantizes the same
    weight identically on its own."""
    pk_j = JP.pack_weight(w, mask, 16)
    own = TPK.pack_weight(w, mask, 16)
    assert np.array_equal(own.col_perm, pk_j.col_perm)
    assert np.array_equal(own.header.numpy(), np.asarray(pk_j.header))
    assert np.array_equal(own.counts.numpy(), np.asarray(pk_j.counts))
    assert np.array_equal(own.blocks.numpy(), np.asarray(pk_j.blocks))
    assert np.array_equal(own.to_dense().numpy(), np.asarray(pk_j.to_dense()))
    if kind == "fp32":
        return pk_j, convert.packed_from_jax(pk_j)
    if kind == "fp16":
        q_j = JQ.quantize_packed(pk_j, "fp16")
        q_t = convert.packed_from_jax(q_j)
        assert q_t.blocks.dtype == torch.float16
        assert torch.equal(TQ.quantize_packed(own, "fp16").blocks, q_t.blocks)
        return q_j, q_t
    granularity = kind.split("-")[1]
    q_j = JQ.quantize_packed(pk_j, "int8", granularity)
    q_t = convert.packed_dict_from_jax({"w": q_j})["w"]
    q_o = TQ.quantize_packed(own, "int8", granularity)
    assert isinstance(q_t, TQ.QuantizedPackedWeight)
    for q in (q_t, q_o):
        assert q.granularity == granularity and q.blocks.dtype == torch.int8
        np.testing.assert_array_equal(q.blocks.numpy(), np.asarray(q_j.blocks))
        np.testing.assert_array_equal(q.scales.numpy(), np.asarray(q_j.scales))
        np.testing.assert_array_equal(q.header.numpy(), np.asarray(q_j.header))
        assert q.nbytes() == q_j.nbytes()
        np.testing.assert_array_equal(q.to_dense().numpy(),
                                      np.asarray(q_j.to_dense()))
    assert TQ.quantization_error(own, q_o) == \
        JQ.quantization_error(pk_j, q_j)
    return q_j, q_t


@pytest.mark.parametrize("M,K,N,counts", [
    (1, 64, 48, (1, 3, 2)),
    (33, 40, 40, (3, 1, 2)),       # K padding; N = 40: padded last column
    (70, 64, 64, (0, 4, 2, 1)),    # an empty column, M > one 64-row tile
])
@pytest.mark.parametrize("kind", SBMM_KINDS)
def test_sbmm_plain_matches_reference(kind, M, K, N, counts):
    """Each block kind (fp32, fp16, int8 with per-block or per-column
    scales): the port packs and quantizes as the reference does, and the
    plain versions agree with the reference in both contracts — with the
    weight's ``col_map`` and logical width, against its Pallas ``sbmm``
    (interpret mode: un-permuted and sliced); with ``arange(C)`` and
    ``C·16`` (``sbmm_raw`` / ``sbmm_quant_raw``), against its stored-order
    oracle ``sbmm_ref`` / ``sbmm_quant_ref``. fp32 arithmetic throughout
    (the fp16 block is widened, as the reference's ``jnp.dot`` does)."""
    rng = np.random.default_rng(M * 1000 + K * 10 + SBMM_KINDS.index(kind))
    w = rng.standard_normal((K, N)).astype(np.float32)
    q_j, q_t = _weights(kind, w, _mask(counts, -(-K // 16), rng))
    assert not np.array_equal(q_t.col_perm, np.arange(q_t.n_cols))
    assert (q_t.header == -1).any()
    assert q_t.col_map.dtype == torch.int32
    assert np.array_equal(q_t.col_map.numpy(), q_t.col_perm)
    quant = isinstance(q_t, TQ.QuantizedPackedWeight)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xp = pad_input(torch.from_numpy(x), q_t)
    C = q_t.n_cols

    y_j = np.asarray(j_sbmm(jnp.asarray(x), q_j, tm=64, interpret=True))
    y_plain = (sbmm_quant_plain(xp, q_t.blocks, q_t.header, q_t.scales,
                                q_t.col_map, N) if quant
               else sbmm_plain(xp, q_t.blocks, q_t.header, q_t.col_map, N))
    assert y_plain.shape == (M, N)
    np.testing.assert_allclose(y_plain.numpy(), y_j, atol=FP32_TOL,
                               rtol=FP32_TOL)
    np.testing.assert_array_equal(sbmm(torch.from_numpy(x), q_t).numpy(),
                                  y_plain.numpy())

    raw_t = (sbmm_quant_raw(xp, q_t.blocks, q_t.header, q_t.scales) if quant
             else sbmm_raw(xp, q_t.blocks, q_t.header)).numpy()
    raw_j = np.asarray(
        j_sbmm_quant_ref(jnp.asarray(xp.numpy()), q_j.blocks, q_j.header,
                         q_j.scales) if quant
        else j_sbmm_ref(jnp.asarray(xp.numpy()), q_j.blocks, q_j.header))
    assert raw_t.shape == (M, C * 16)
    np.testing.assert_allclose(raw_t, raw_j, atol=FP32_TOL, rtol=FP32_TOL)


def _interleave_padding(header, *per_slot, rng):
    """Move each header row's -1 padding in among its live slots, which
    keep their order, and each per-slot tensor (blocks, scales) with it."""
    C, S = header.shape
    order = np.empty((C, S), np.int64)
    for c in range(C):
        n = int((header[c] >= 0).sum())
        at = np.sort(rng.choice(S, n, replace=False))
        order[c, at] = np.arange(n)
        order[c, np.setdiff1d(np.arange(S), at)] = np.arange(n, S)
    idx = torch.from_numpy(order)
    return [torch.stack([t[c][idx[c]] for c in range(C)])
            for t in (header, *per_slot)]


@pytest.mark.parametrize("kind", SBMM_KINDS)
def test_sbmm_raw_skips_padding_between_live_slots(kind):
    """The raw wrappers take a header whose -1 padding sits anywhere, not
    only after the live slots as ``pack_weight`` lays it out: the result
    equals the reference's ``sbmm_ref`` / ``sbmm_quant_ref`` on the same
    header (fp32 reassociation bound) and, bitwise, the wrapper's own
    result on the packed order, whose live slots come in the same order."""
    rng = np.random.default_rng(11 + SBMM_KINDS.index(kind))
    K, N, M = 128, 64, 9
    w = rng.standard_normal((K, N)).astype(np.float32)
    pk = TPK.pack_weight(w, _mask((2, 5, 0, 3), K // 16, rng), 16)
    q = (pk if kind == "fp32" else
         TQ.quantize_packed(pk, "fp16") if kind == "fp16" else
         TQ.quantize_packed(pk, "int8", kind.split("-")[1]))
    quant = isinstance(q, TQ.QuantizedPackedWeight)
    header, blocks, *scales = _interleave_padding(
        q.header, q.blocks, *([q.scales] if quant else []), rng=rng)
    hdr = header.numpy()
    assert ((hdr[:, :-1] < 0) & (hdr[:, 1:] >= 0)).any()
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))

    y = (sbmm_quant_raw(x, blocks, header, scales[0]) if quant
         else sbmm_raw(x, blocks, header))
    ref = np.asarray(
        j_sbmm_quant_ref(jnp.asarray(x.numpy()), blocks.numpy(), hdr,
                         scales[0].numpy()) if quant
        else j_sbmm_ref(jnp.asarray(x.numpy()), blocks.numpy(), hdr))
    np.testing.assert_allclose(y.numpy(), ref, atol=FP32_TOL, rtol=FP32_TOL)
    packed_order = (sbmm_quant_raw(x, q.blocks, q.header, q.scales) if quant
                    else sbmm_raw(x, q.blocks, q.header))
    assert torch.equal(y, packed_order)


def test_sbmm_rejects_wrong_input_width():
    pk = TPK.pack_weight(np.ones((32, 16), np.float32),
                         np.ones((2, 1), np.float32), 16)
    with pytest.raises(ValueError, match="input features"):
        sbmm(torch.ones((2, 16)), pk)


def test_sbmm_rejects_half_blocks():
    """fp16 blocks are taken now (the fp16 tier); blocks no kernel takes —
    int8 without scales, bf16 — are rejected."""
    w = np.arange(256, dtype=np.float32).reshape(16, 16) / 64
    pk = TPK.pack_weight(w.astype(np.float16), np.ones((1, 1), np.float32),
                         16)
    x = torch.ones((2, 16))
    np.testing.assert_array_equal(sbmm(x, pk).numpy(),
                                  (x @ torch.from_numpy(w)).numpy())
    for dtype in (torch.int8, torch.bfloat16):
        with pytest.raises(TypeError, match="fp16 blocks"):
            sbmm_raw(x, pk.blocks.to(dtype), pk.header)
    with pytest.raises(TypeError, match="int8 blocks"):
        sbmm_quant_raw(x, pk.blocks, pk.header, torch.ones((1, 1)))


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


@pytest.mark.parametrize("B,N,H,Dh,lens", [
    (2, 33, 4, 16, None),
    (4, 33, 4, 16, (33, 20, 9, 1)),
    (3, 65, 6, 64, (65, 40, 17)),
])
def test_flash_attention_fp16_matches_reference(B, N, H, Dh, lens):
    """fp16 operands (the fp16 tier): against ``flash_attention_jnp`` and
    ``attention_probs_row`` on the same fp16-cast q, k, v. The output is
    fp16, as the reference's (it returns ``q.dtype``); the scores fp32."""
    rng = np.random.default_rng(N * 11 + B)
    q, k, v = (rng.standard_normal((B, N, H, Dh)).astype(np.float16)
               for _ in range(3))
    kv = None if lens is None else np.asarray(lens, np.int32)
    o_t, s_t = flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        kv_len=None if kv is None else torch.from_numpy(kv),
        collect_scores=True)
    assert o_t.dtype == torch.float16 and s_t.dtype == torch.float32
    jkv = None if kv is None else jnp.asarray(kv)
    o_j = JA.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False, kv_len=jkv)
    assert o_j.dtype == jnp.float16
    s_j = JA.attention_probs_row(jnp.asarray(q)[:, 0], jnp.asarray(k),
                                 kv_len=jkv).mean(axis=1)
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j, np.float32),
                               atol=FP16_ATTN_TOL, rtol=FP16_ATTN_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                               atol=FP32_TOL, rtol=FP32_TOL)
    if lens is not None:
        for b, L in enumerate(lens):
            assert (s_t[b, L:] == 0).all()


@pytest.mark.parametrize("dtype", ["fp32", "fp16"])
def test_flash_attention_row_without_key_matches_reference(dtype):
    """Rows without a valid key (``kv_len`` 0 and -3) beside a one-key row
    and a row whose ``kv_len`` passes N: the reference masks with the
    finite ``NEG_INF``, so an empty row attends to all N keys alike (the
    mean of V, probabilities 1/N). The wrapper on CPU tensors is held
    against ``flash_attention_jnp`` and ``attention_probs_row`` at the
    fp32 or fp16 output bound; the card's kernels take the same rule
    (``tests/test_torch_gpu.py``)."""
    B, N, H, Dh = 4, 17, 4, 16
    lens = np.asarray((0, -3, 1, N + 4), np.int32)
    rng = np.random.default_rng(17)
    np_dt = np.float32 if dtype == "fp32" else np.float16
    q, k, v = (rng.standard_normal((B, N, H, Dh)).astype(np_dt)
               for _ in range(3))
    o_t, s_t = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               kv_len=torch.from_numpy(lens),
                               collect_scores=True)
    jkv = jnp.asarray(lens)
    o_j = JA.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False, kv_len=jkv)
    s_j = JA.attention_probs_row(jnp.asarray(q)[:, 0], jnp.asarray(k),
                                 kv_len=jkv).mean(axis=1)
    tol = FP32_TOL if dtype == "fp32" else FP16_ATTN_TOL
    assert o_t.dtype == torch.from_numpy(q).dtype
    assert bool(torch.isfinite(o_t.float()).all())
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                               atol=FP32_TOL, rtol=FP32_TOL)
    for b in (0, 1):  # the empty rows: uniform over all N keys
        np.testing.assert_allclose(s_t[b].numpy(), np.full(N, 1.0 / N),
                                   rtol=1e-6, atol=0)
        mean_v = v[b].astype(np.float32).mean(axis=0)
        np.testing.assert_allclose(
            o_t[b].float().numpy(),
            np.broadcast_to(mean_v, (N, H, Dh)), atol=tol, rtol=tol)
    assert bool((s_t[2, 1:] == 0).all()) and float(s_t[2, 0]) == 1.0


def test_causal_attention_runs_plain_on_cpu_tensors():
    """Causal mode is ported (the LM path's kernel; its parity tests are in
    ``test_torch_lm.py``): on CPU tensors it runs the plain causal
    version."""
    q = torch.randn((1, 4, 2, 16), generator=torch.Generator().manual_seed(0))
    o = flash_attention(q, q, q, causal=True)
    assert torch.equal(o, flash_attention_torch(q, q, q, causal=True))
    assert torch.equal(o[:, 0], q[:, 0])  # the first row sees only itself


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
# K4 token package (soft TDM)
# ---------------------------------------------------------------------------
def _soft_scores(rng, B, N, n_valid):
    s = rng.random((B, N)).astype(np.float32)
    for b, nv in enumerate(n_valid):
        s[b, nv:] = 0.0  # token-padded rows score exactly 0
    return s / s.sum(axis=1, keepdims=True)


def _assert_soft_equal(out_t, mass_t, out_j, mass_j, k):
    out_j = np.asarray(out_j)
    assert out_t.shape == out_j.shape
    # CLS and kept rows are copies: bitwise; the package is a weighted mean
    np.testing.assert_array_equal(out_t[:, :k + 1], out_j[:, :k + 1])
    np.testing.assert_allclose(out_t[:, k + 1], out_j[:, k + 1],
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(mass_t, np.asarray(mass_j), atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("B,N,D,k1,ks2,n_valid", [
    (1, 17, 32, 8, (5,), (17,)),
    (3, 33, 64, 12, (9, 7, 4), (33, 25, 17)),
    (2, 9, 16, 7, (7, 3), (9, 9)),   # k = N - 2: everything but one kept
])
def test_token_package_matches_reference_tdm_soft(B, N, D, k1, ks2, n_valid):
    """Two chained soft TDMs. The first (no package) on a token-padded
    batch; the second on a token-padded tile built from each row's first
    output at its own keep count ``ks2[b]``, so every row's package sits at
    its own body index ``n_valid - 2`` (``pkg_pos``), as in the engine.
    Both packages' ``token_package`` (and the port's ``tdm_soft``) against
    the reference's ``token_pruning.tdm_soft``."""
    rng = np.random.default_rng(N * 5 + D)
    z = rng.standard_normal((B, N, D)).astype(np.float32)
    s = _soft_scores(rng, B, N, n_valid)
    out_t, mass_t = token_package(torch.from_numpy(z), torch.from_numpy(s),
                                  k1)
    out_j, mass_j = JTP.tdm_soft(jnp.asarray(z), jnp.asarray(s), k=k1)
    _assert_soft_equal(out_t.numpy(), mass_t.numpy(), out_j, mass_j, k1)

    # second TDM: row b carries ks2[b] + 2 real tokens (its package last)
    rows = [JTP.tdm_soft(jnp.asarray(z[b:b + 1]), jnp.asarray(s[b:b + 1]),
                         k=kb) for b, kb in enumerate(ks2)]
    n2 = np.array([kb + 2 for kb in ks2], np.int32)
    width = int(n2.max())
    z2 = np.zeros((B, width, D), np.float32)
    mass = np.zeros(B, np.float32)
    for b, (zb, mb) in enumerate(rows):
        z2[b, :n2[b]] = np.asarray(zb)[0]
        mass[b] = float(np.asarray(mb)[0])
    s2 = _soft_scores(rng, B, width, n2)
    k2 = int(n2.min()) - 2
    pkg_pos = n2 - 2
    out_t, mass_t = token_package(
        torch.from_numpy(z2), torch.from_numpy(s2), k2,
        pkg_mass=torch.from_numpy(mass), pkg_pos=torch.from_numpy(pkg_pos))
    out_j, mass_j = JTP.tdm_soft(jnp.asarray(z2), jnp.asarray(s2), k=k2,
                                 pkg_mass=jnp.asarray(mass),
                                 pkg_pos=jnp.asarray(pkg_pos))
    _assert_soft_equal(out_t.numpy(), mass_t.numpy(), out_j, mass_j, k2)
    # the package is never kept, and carries its old mass forward
    kept_idx, w = TTP.package_weights(torch.from_numpy(s2[:, 1:]), k2,
                                      torch.from_numpy(mass),
                                      torch.from_numpy(pkg_pos))
    for b in range(B):
        assert int(pkg_pos[b]) not in kept_idx[b].tolist()
        assert float(w[b, pkg_pos[b]]) == float(mass[b])
    # the port's tdm_soft derives k from r_t with the reference's clamp
    for r_t in (0.5, 1.0):
        o_t, m_t = TTP.tdm_soft(torch.from_numpy(z2), torch.from_numpy(s2),
                                r_t, pkg_mass=torch.from_numpy(mass))
        o_j, m_j = JTP.tdm_soft(jnp.asarray(z2), jnp.asarray(s2), r_t,
                                pkg_mass=jnp.asarray(mass))
        _assert_soft_equal(o_t.numpy(), m_t.numpy(), o_j, m_j,
                           o_t.shape[1] - 2)


def test_token_package_rejects_k_past_the_package():
    z, s = torch.zeros((1, 6, 8)), torch.rand((1, 6))
    token_package(z, s, 5)  # no package yet: every body row may be kept
    with pytest.raises(ValueError, match="outside"):
        token_package(z, s, 5, pkg_mass=torch.ones(1))
    with pytest.raises(ValueError, match="k must be"):
        TTP.tdm_soft(z, s, k=5, pkg_mass=torch.ones(1))


@pytest.mark.parametrize("soft", [False, True],
                         ids=["token_drop", "token_package"])
@pytest.mark.parametrize("B,N,D,k,n_valid,levels", [
    (3, 33, 32, 10, (33, 20, 12), 3),
    (4, 9, 16, 1, (9, 5, 3, 9), 3),     # k = 1
    (2, 17, 16, 14, (17, 17), 2),       # the largest k with a package
])
def test_tdm_tie_heavy_matches_reference(soft, B, N, D, k, n_valid, levels):
    """The selection the kernels must reproduce, on scores with a few
    distinct levels (most rows tie) and token-padded rows scoring 0: the
    port's token_drop / token_package (the plain path on the CPU) against
    the reference's tdm / tdm_soft, the soft TDM with each row's package
    pinned mid-row. Kept rows bitwise; fused row and mass at FP32_TOL."""
    rng = np.random.default_rng(N * 7 + k + levels)
    z = rng.standard_normal((B, N, D)).astype(np.float32)
    s = rng.integers(0, levels, (B, N)).astype(np.float32) / 8
    for b, nv in enumerate(n_valid):
        s[b, nv:] = 0.0
    if not soft:
        out_t = token_drop(torch.from_numpy(z), torch.from_numpy(s), k)
        out_j, _ = JTP.tdm(jnp.asarray(z), jnp.asarray(s), None, k=k)
        out_j = np.asarray(out_j)
        np.testing.assert_array_equal(out_t.numpy()[:, :k + 1],
                                      out_j[:, :k + 1])
        np.testing.assert_allclose(out_t.numpy()[:, k + 1], out_j[:, k + 1],
                                   atol=FP32_TOL, rtol=FP32_TOL)
        return
    mass = rng.random(B).astype(np.float32)
    pos = np.array([nv // 2 for nv in n_valid], np.int32)  # mid-row
    out_t, mass_t = token_package(
        torch.from_numpy(z), torch.from_numpy(s), k,
        pkg_mass=torch.from_numpy(mass), pkg_pos=torch.from_numpy(pos))
    out_j, mass_j = JTP.tdm_soft(jnp.asarray(z), jnp.asarray(s), k=k,
                                 pkg_mass=jnp.asarray(mass),
                                 pkg_pos=jnp.asarray(pos))
    _assert_soft_equal(out_t.numpy(), mass_t.numpy(), out_j, mass_j, k)


TDM_CARD_CALLS = {  # name: (entry point, call, ints after the pointers)
    "token_drop": ("token_drop_f32",
                   lambda z, s, m, p: token_drop(z, s, 4), (3, 9, 8, 4, 12)),
    "token_package-first": ("token_package_f32",
                            lambda z, s, m, p: token_package(z, s, 4),
                            (3, 9, 8, 4, 12, 0)),
    "token_package-last-row": ("token_package_f32",
                               lambda z, s, m, p: token_package(z, s, 4, m),
                               (3, 9, 8, 4, 12, 0)),
    "token_package-int32": ("token_package_f32",
                            lambda z, s, m, p: token_package(z, s, 4, m, p),
                            (3, 9, 8, 4, 12, 0)),
    "token_package-int64": ("token_package_f32",
                            lambda z, s, m, p: token_package(z, s, 4, m,
                                                             p.long()),
                            (3, 9, 8, 4, 12, 1)),
}


@pytest.mark.parametrize("name", list(TDM_CARD_CALLS))
def test_tdm_card_path_is_one_launch(monkeypatch, name):
    """On the card a token_drop / token_package call is exactly one launch,
    with the argument list ``backend.py`` declares for its entry point: the
    tokens and the scores read in place (rows 12 apart here), the package
    mass and position as given (no pointer without a package, int64 flagged)
    and the outputs; the top-k and the weights are the kernel's, so the
    wrapper never reaches ``drop_weights``, ``package_weights`` or
    ``torch.sort``."""
    entry, call, ints = TDM_CARD_CALLS[name]
    launches = []

    def unreachable(*args, **kwargs):
        raise AssertionError("the card path ran the top-k or the weights")

    monkeypatch.setattr(backend, "on_card", lambda *ts: True)
    monkeypatch.setattr(backend, "launch",
                        lambda lib, fn, dev, *args: launches.append(
                            (lib, fn, args)))
    monkeypatch.setattr(TTP, "drop_weights", unreachable)
    monkeypatch.setattr(TTP, "package_weights", unreachable)
    monkeypatch.setattr(torch, "sort", unreachable)
    z = torch.zeros((3, 9, 8))
    s = torch.rand((3, 12))[:, :9]  # a view: read in place
    m = torch.ones(3)
    p = torch.tensor([7, 2, 0], dtype=torch.int32)
    res = call(z, s, m, p)
    assert len(launches) == 1
    lib, fn, args = launches[0]
    assert fn == entry
    argtypes = backend._ENTRY_POINTS[lib][fn]
    assert len(args) + 1 == len(argtypes)  # launch() appends the stream
    n_ptr = argtypes.index(ctypes.c_int)
    assert all(t is ctypes.c_void_p for t in argtypes[:n_ptr])
    assert all(t is ctypes.c_int for t in argtypes[n_ptr:-1])
    assert args[:2] == (z.data_ptr(), s.data_ptr())
    assert args[n_ptr:] == ints
    out, mass = res if isinstance(res, tuple) else (res, None)
    assert out.shape == (3, 6, 8) and out.data_ptr() in args[:n_ptr]
    if entry == "token_package_f32":
        with_mass = "first" not in name
        with_pos = with_mass and "last-row" not in name
        assert args[2] == (m.data_ptr() if with_mass else None)
        assert (args[3] is not None) == with_pos
        assert mass.shape == (3,) and args[5] == mass.data_ptr()


@pytest.mark.parametrize("what", ["above-max-tokens", "d-not-multiple-of-4",
                                  "z-not-contiguous", "scores-strided",
                                  "pos-float", "mass-shape"])
def test_tdm_card_path_rejects_what_the_kernel_cannot_take(monkeypatch,
                                                           what):
    """On the card path the TDM wrappers raise, before any launch, on what
    the kernel does not take; the plain version does not stand in, and
    nothing is copied to make it fit."""
    def no_launch(*args):
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(backend, "on_card", lambda *ts: True)
    monkeypatch.setattr(backend, "launch", no_launch)
    N = MAX_TOKENS + 1 if what == "above-max-tokens" else 9
    D = 6 if what == "d-not-multiple-of-4" else 8
    z = torch.zeros((2, N, D))
    if what == "z-not-contiguous":
        z = torch.zeros((2, D, N)).transpose(1, 2)
    s = torch.rand((2, N))
    if what == "scores-strided":
        s = torch.rand((2, 2 * N))[:, ::2]
    m, p = torch.ones(2), torch.tensor([3, 4])
    if what == "pos-float":
        p = p.float()
    if what == "mass-shape":
        m = torch.ones((2, 1))
    err = TypeError if what == "pos-float" else ValueError
    if what not in ("pos-float", "mass-shape"):
        with pytest.raises(err):
            token_drop(z, s, 3)
    with pytest.raises(err):
        token_package(z, s, 3, m, p)


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
    with pytest.raises(RuntimeError, match="no flash_attention kernel"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(RuntimeError, match="no flash_prefill kernel"):
        flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                        causal=True)
    with pytest.raises(RuntimeError, match="no token_drop kernel"):
        token_drop(torch.zeros((1, 5, 8)), torch.rand((1, 5)), 2)
    with pytest.raises(RuntimeError, match="no token_package kernel"):
        token_package(torch.zeros((1, 5, 8)), torch.rand((1, 5)), 2,
                      pkg_mass=torch.ones(1))
    q8 = TQ.quantize_packed(pk, "int8", "channel")
    with pytest.raises(RuntimeError, match="no sbmm_quant kernel"):
        sbmm(x, q8)
    with pytest.raises(RuntimeError, match="no sbmm kernel"):
        sbmm(x, TQ.quantize_packed(pk, "fp16"))
    assert backend.launches() == {n: 0 for n in backend.ENTRY_POINTS}


def test_sbmm_kernel_path_rejects_what_the_kernel_cannot_take(monkeypatch):
    """On the card path the SBMM wrappers raise, before any launch, on an
    x that does not start 16-byte aligned (the kernel copies it 16 bytes
    at a time) or is not contiguous; they copy nothing to make it fit."""
    def no_library(name):
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(backend, "on_card", lambda *ts: True)
    monkeypatch.setattr(backend, "library", no_library)
    pk = TPK.pack_weight(np.ones((16, 16), np.float32),
                         np.ones((1, 1), np.float32), 16)
    for q in (pk, TQ.quantize_packed(pk, "fp16"),
              TQ.quantize_packed(pk, "int8", "block"),
              TQ.quantize_packed(pk, "int8", "channel")):
        misaligned = torch.zeros(4 * 16 + 1)[1:].view(4, 16)
        assert misaligned.is_contiguous() and misaligned.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            sbmm(misaligned, q)
        with pytest.raises(ValueError, match="contiguous"):
            sbmm(torch.zeros((16, 4)).t(), q)
    assert backend.launches() == {n: 0 for n in backend.ENTRY_POINTS}


def test_mixed_or_unknown_devices_raise():
    with pytest.raises(ValueError, match="all on"):
        backend.on_card(torch.zeros(1), torch.zeros(1, device="meta"))
