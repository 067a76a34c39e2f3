"""The port's dense-LM serving path against the reference package, on the
CPU, at the reduced dense configs (3 layers, D=64, head_dim 16, vocab 256;
Minitron-4B and Qwen3-14B reduce to GQA 4:1, StableLM-1.6B to MHA).

Weights come from the reference's seeded init, converted by
``convert.lm_params_from_jax``; inputs are numpy arrays from a seed.
Tolerances:

* layers and attention at fp32: 1e-5 absolute and relative (``OP_TOL``;
  another summation order between XLA and PyTorch). At bf16 one bf16 ulp
  of the largest reference element (2^-7 x max|ref|, ``BF16_ULP``): both
  round fp32 results to bf16, and a difference of summation order can
  flip one rounding.
* caches written by ``attention_block``: one bf16 ulp (the cache is bf16).
* ``forward_lm`` with ``dtype="float32"``: logits within 1e-3
  (``LOGIT_TOL``; the bf16 cache can flip one rounding, which later
  layers carry) and greedy tokens equal. At the default bf16: logits
  within 0.05 (``BF16_LOGIT_TOL``, about three bf16 ulps at |logit| ~ 2).
  Measured: 0.024 at most over the three configs. The witness test shows
  the reference alone moving by 0.023-0.039 when a random half of its
  embedded input moves by one bf16 ulp: XLA keeps excess precision inside
  its bf16 fusions where PyTorch rounds after each operation, a
  difference of that size.
* KV pruning (scores, selection, compaction), per-slot against
  whole-batch prefill within the port, and the engines' tokens, event
  streams and shape ledgers: EQUAL.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import token_pruning as JTP
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import steps as JST
from repro.serving import EngineConfig as JEC
from repro.serving import Request as JReq
from repro.serving import ServeEngine as JEngine
from repro.serving.cache_manager import prune_kv_caches as j_prune

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import token_pruning as TP
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as FA_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.serving import (EngineConfig, Request, ServeEngine,
                                 bucket_length, prune_kv_caches)

OP_TOL = 1e-5
LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 0.05
BF16_ULP = 2.0 ** -7
ARCHS = ("minitron-4b", "qwen3-14b", "stablelm-1.6b")
_MODELS = {}


def _model(arch):
    """(reference cfg, port cfg, reference params, port params) at the
    reduced config, built once per module."""
    if arch not in _MODELS:
        jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp))
        _MODELS[arch] = (jcfg, tcfg, jp, tp)
    return _MODELS[arch]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=OP_TOL, rtol=OP_TOL)
    else:
        assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max()


def _arr(x, dtype):
    """A numpy fp32 array as (jax array, torch tensor) of ``dtype``."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------
def test_dense_configs_match_reference():
    for arch in ARCHS + ("command-r-plus-104b",):
        j, t = j_get_config(arch), get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(t.reduced()) == \
            dataclasses.asdict(j.reduced())
    red = get_config("minitron-4b").reduced()
    assert (red.num_heads, red.num_kv_heads) == (4, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_glu_match_reference(dtype):
    _, _, jp, tp = _model("minitron-4b")
    rng = np.random.default_rng(0)
    jx, tx = _arr(rng.standard_normal((2, 5, 64)), dtype)
    scale = rng.standard_normal(64).astype(np.float32)
    _close(L.rms_norm(tx, torch.from_numpy(scale)),
           JL.rms_norm(jx, jnp.asarray(scale)), dtype)
    jq, tq = _arr(rng.standard_normal((2, 5, 4, 16)), dtype)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)  # per-row phases
    _close(L.apply_rope(tq, torch.from_numpy(pos), 1e4),
           JL.apply_rope(jq, jnp.asarray(pos), 1e4), dtype)
    out = L.glu_mlp(tx, tp["layers"][0]["mlp"])
    ref = JL.glu_mlp(jx, jax.tree_util.tree_map(lambda a: a[0],
                                                jp["layers"])["mlp"])
    assert out.dtype == getattr(torch, dtype)
    _close(out, ref, dtype)


# ---------------------------------------------------------------------------
# causal attention
# ---------------------------------------------------------------------------
# per-row windows: prefill row 1 has 3 left-pad rows (no valid key), row 2
# sits at offset 4 behind a compacted-cache prefix of 6; decode row 2 has
# no valid key at all (kv_start past kv_len)
_WINDOWS = {
    "prefill": dict(Nq=8, q_offset=[0, 0, 4], kv_start=[0, 3, 6]),
    "decode": dict(Nq=1, q_offset=[7, 12, 13], kv_start=[0, 5, 16]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("heads", [(4, 1), (2, 2)], ids=["gqa4", "mha"])
def test_causal_attention_matches_reference(heads, mode, dtype):
    """The causal wrapper (plain version on the CPU) against
    ``flash_attention_jnp`` with per-row ``q_offset``, ``kv_len`` and
    ``kv_start``; rows with no valid key come out finite (the reference's
    finite NEG_INF averages V there, and so does the plain version). In
    decode, the by-product scores against ``attention_probs_row``."""
    Hq, KV = heads
    w = _WINDOWS[mode]
    B, S, Dh, Nq = 3, 20, 16, w["Nq"]
    rng = np.random.default_rng(1)
    jq, tq = _arr(rng.standard_normal((B, Nq, Hq, Dh)), dtype)
    jk, tk = _arr(rng.standard_normal((B, S, KV, Dh)), dtype)
    jv, tv = _arr(rng.standard_normal((B, S, KV, Dh)), dtype)
    off = np.array(w["q_offset"], np.int32)
    kv_len = off + Nq
    start = np.array(w["kv_start"], np.int32)
    res = flash_attention(tq, tk, tv, causal=True,
                          q_offset=torch.from_numpy(off),
                          kv_len=torch.from_numpy(kv_len),
                          kv_start=torch.from_numpy(start),
                          collect_scores=mode == "decode")
    o = res[0] if mode == "decode" else res
    ref = JA.flash_attention_jnp(jq, jk, jv, causal=True,
                                 q_offset=jnp.asarray(off),
                                 kv_len=jnp.asarray(kv_len),
                                 kv_start=jnp.asarray(start))
    assert o.dtype == tq.dtype and o.shape == tq.shape
    assert bool(torch.isfinite(o.float()).all())
    _close(o, ref, dtype)
    if mode == "decode":
        s_ref = JA.attention_probs_row(jq[:, 0], jk, kv_len=jnp.asarray(
            kv_len), kv_start=jnp.asarray(start)).mean(axis=1)
        np.testing.assert_allclose(res[1].numpy(), np.asarray(s_ref),
                                   atol=1e-6, rtol=OP_TOL)
        for b in range(2):  # rows with a valid key: 0 outside the window
            assert (res[1][b, :start[b]] == 0).all()
            assert (res[1][b, kv_len[b]:] == 0).all()


def test_attention_probs_row_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 6, 16)).astype(np.float32)
    k = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    kv_len, start = np.array([12, 7, 9], np.int32), np.array([0, 2, 8],
                                                             np.int32)
    got = A.attention_probs_row(torch.from_numpy(q), torch.from_numpy(k),
                                kv_len=torch.from_numpy(kv_len),
                                kv_start=torch.from_numpy(start))
    ref = JA.attention_probs_row(jnp.asarray(q), jnp.asarray(k),
                                 kv_len=jnp.asarray(kv_len),
                                 kv_start=jnp.asarray(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=OP_TOL)
    assert (got[1, :, 7:] == 0).all() and (got[2, :, :8] == 0).all()


def _torch_cache(jc):
    return A.KVCache(*(torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                       .to(torch.bfloat16) if a.dtype == jnp.bfloat16
                       else torch.from_numpy(np.array(a)) for a in jc))


def _cache_close(tc, jc):
    for got, ref in ((tc.k, jc.k), (tc.v, jc.v)):
        _close(got, ref, "bfloat16")
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_allclose(tc.attn_mass.numpy(), np.asarray(jc.attn_mass),
                               atol=1e-6, rtol=OP_TOL)


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen3-14b"])
def test_attention_block_with_cache_matches_reference(arch):
    """Prefill of left-padded rows, two decodes, then a decode whose rows
    sit at and past the cache end (the write clamps to S - 1, as
    ``dynamic_update_slice`` does; the length runs on unclamped)."""
    jcfg, tcfg, jp, tp = _model(arch)
    jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])["attn"]
    tattn = tp["layers"][0]["attn"]
    B, S = 3, 16
    rng = np.random.default_rng(3)
    start = np.array([0, 2, 5], np.int32)
    jc = JA.init_kv_cache(B, S, jcfg.num_kv_heads, jcfg.head_dim)
    tc = A.init_kv_cache(B, S, tcfg.num_kv_heads, tcfg.head_dim,
                         device="cpu")
    for n in (6, 1, 1):
        x = rng.standard_normal((B, n, 64)).astype(np.float32)
        jo, jc, _ = JA.attention_block(
            jnp.asarray(x), jattn, jcfg, causal=True, cache=jc,
            valid_start=jnp.asarray(start))
        to, tc = A.attention_block(torch.from_numpy(x), tattn, tcfg,
                                   cache=tc,
                                   valid_start=torch.from_numpy(start))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OP_TOL,
                                   rtol=OP_TOL)
        _cache_close(tc, jc)
    assert tc.attn_mass.abs().sum() > 0  # the decodes accumulated mass
    # rows at the end of the buffer and past it
    lens = np.array([S - 1, S, S + 3], np.int32)
    jc = jc._replace(length=jnp.asarray(lens))
    tc = tc._replace(length=torch.from_numpy(lens))
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    jo, jc, _ = JA.attention_block(jnp.asarray(x), jattn, jcfg, causal=True,
                                   cache=jc, valid_start=jnp.asarray(start))
    to, tc = A.attention_block(torch.from_numpy(x), tattn, tcfg, cache=tc,
                               valid_start=torch.from_numpy(start))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OP_TOL,
                               rtol=OP_TOL)
    _cache_close(tc, jc)
    np.testing.assert_array_equal(tc.length.numpy(), lens + 1)


# ---------------------------------------------------------------------------
# forward_lm
# ---------------------------------------------------------------------------
def _prefill_decode(arch, dtype, embed=None):
    """Left-padded prefill of 3 rows plus 4 teacher-forced decodes, in both
    packages. Returns (reference logits, port logits), one pair per step."""
    jcfg, tcfg, jp, tp = _model(arch)
    jcfg, tcfg = (c.replace(dtype=dtype) for c in (jcfg, tcfg))
    if embed is not None:
        jp = dict(jp, embed=embed)
    rng = np.random.default_rng(1)
    B, Lp, S = 3, 12, 24
    toks = rng.integers(0, 256, (B, Lp)).astype(np.int32)
    start = np.array([0, 5, 9], np.int32)
    dec = rng.integers(0, 256, (4, B)).astype(np.int32)
    jc = JST.init_caches(jcfg, B, S)
    tc = ST.init_caches(tcfg, B, S, device="cpu")
    jo = JM.forward_lm(jcfg, jp, jnp.asarray(toks), mode="prefill",
                       caches=jc, logits_for="last",
                       valid_start=jnp.asarray(start))
    to = M.forward_lm(tcfg, tp, torch.from_numpy(toks), mode="prefill",
                      caches=tc, logits_for="last",
                      valid_start=torch.from_numpy(start))
    steps = [(np.asarray(jo.logits), to.logits.numpy())]
    for t in dec:
        jo = JM.forward_lm(jcfg, jp, jnp.asarray(t)[:, None], mode="decode",
                           caches=jo.caches, valid_start=jnp.asarray(start))
        to = M.forward_lm(tcfg, tp, torch.from_numpy(t)[:, None],
                          mode="decode", caches=to.caches,
                          valid_start=torch.from_numpy(start))
        steps.append((np.asarray(jo.logits), to.logits.numpy()))
    return steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_prefill_decode_matches_reference(arch, dtype):
    steps = _prefill_decode(arch, dtype)
    for ref, got in steps:
        assert got.dtype == np.float32 and got.shape == ref.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=0)
            np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        else:
            assert np.abs(got - ref).max() <= BF16_LOGIT_TOL


def test_forward_lm_bf16_bound_witness():
    """The bf16 bound is of the size of the reference's own sensitivity:
    moving a random half of the reference's embedding rows' bf16 values by
    one bf16 ulp moves its logits by more than a fifth of the bound, and
    the port stays within the bound."""
    _, _, jp, _ = _model("minitron-4b")
    emb = jnp.asarray(jp["embed"]).astype(jnp.bfloat16)
    up = jnp.nextafter(emb, jnp.full(emb.shape, jnp.inf, emb.dtype))
    half = np.random.default_rng(2).random(emb.shape) < 0.5
    moved = jnp.where(half, up, emb).astype(jnp.float32)
    base = _prefill_decode("minitron-4b", "bfloat16")
    shifted = _prefill_decode("minitron-4b", "bfloat16", embed=moved)
    witness = max(np.abs(a[0] - b[0]).max() for a, b in zip(base, shifted))
    port = max(np.abs(r - g).max() for r, g in base)
    assert witness > BF16_LOGIT_TOL / 5
    assert port <= BF16_LOGIT_TOL


def test_forward_lm_train_mode_and_logits_for():
    """No cache: the full causal forward; "last" and "none" agree with
    "all" and the reference's train mode."""
    jcfg, tcfg, jp, tp = _model("qwen3-14b")
    jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
    toks = np.random.default_rng(4).integers(0, 256, (2, 9)).astype(np.int32)
    ref = JM.forward_lm(jcfg, jp, jnp.asarray(toks), mode="train",
                        remat=False).logits
    out = M.forward_lm(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref),
                               atol=LOGIT_TOL, rtol=0)
    last = M.forward_lm(tcfg, tp, torch.from_numpy(toks), logits_for="last")
    np.testing.assert_array_equal(last.logits.numpy(),
                                  out.logits[:, -1:].numpy())
    none = M.forward_lm(tcfg, tp, torch.from_numpy(toks), logits_for="none")
    assert none.logits is None and none.hidden.shape == (2, 9, 64)


# ---------------------------------------------------------------------------
# KV pruning
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("invalid_first", [False, True])
def test_kv_prune_helpers_match_reference(invalid_first):
    """Scores masked to the per-slot window (-inf outside), then the
    top-``keep`` selection — with ties (a row of zero mass, as right after
    a prune) and more picks than valid slots — and the compaction."""
    rng = np.random.default_rng(5)
    mass = rng.random((4, 16)).astype(np.float32)
    mass[1] = 0.0            # all ties
    mass[2, 3:9] = 0.25      # a run of ties inside the window
    lens = np.array([10, 16, 12, 4], np.int32)
    start = np.array([0, 3, 2, 1], np.int32)
    s_j = JTP.kv_prune_scores(jnp.asarray(mass), jnp.asarray(lens),
                              start=jnp.asarray(start))
    s_t = TP.kv_prune_scores(torch.from_numpy(mass), torch.from_numpy(lens),
                             start=torch.from_numpy(start))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    for keep in (6, 8, 40):
        i_j = JTP.select_kv_keep(s_j, keep, invalid_first=invalid_first)
        i_t = TP.select_kv_keep(s_t, keep, invalid_first=invalid_first)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    kv = rng.standard_normal((2, 4, 16, 2, 8)).astype(np.float32)
    k_j, v_j = JTP.compact_kv_cache(jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                                    i_j)
    k_t, v_t = TP.compact_kv_cache(torch.from_numpy(kv[0]),
                                   torch.from_numpy(kv[1]), i_t)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_prune_kv_caches_matches_reference():
    """Every layer compacted alike and the same ``new_starts``: garbage
    prefixes zeroed and masked, lengths set to the keep count, mass reset.
    Layer 1 carries zero mass (ties everywhere)."""
    rng = np.random.default_rng(6)
    Lyr, B, S = 2, 3, 20
    mass = rng.random((Lyr, B, S)).astype(np.float32)
    mass[1] = 0.0
    jc = JA.KVCache(
        k=jnp.asarray(rng.standard_normal((Lyr, B, S, 1, 8)), jnp.bfloat16),
        v=jnp.asarray(rng.standard_normal((Lyr, B, S, 1, 8)), jnp.bfloat16),
        length=jnp.asarray(np.tile([[17, 9, 20]], (Lyr, 1)), jnp.int32),
        attn_mass=jnp.asarray(mass))
    starts = np.array([2, 4, 0], np.int32)
    pj, ns_j = j_prune(jc, 0.5, starts=jnp.asarray(starts))
    tc = convert.kv_caches_from_jax(jc)
    pt, ns_t = prune_kv_caches(tc, 0.5, starts=torch.from_numpy(starts))
    np.testing.assert_array_equal(ns_t.numpy(), np.asarray(ns_j))
    for i, c in enumerate(pt):
        ref = convert.kv_caches_from_jax(pj)[i]
        for got, want in zip(c, ref):
            assert torch.equal(got, want)
    # the input caches are not written
    assert torch.equal(tc[0].k, convert.kv_caches_from_jax(jc)[0].k)


# ---------------------------------------------------------------------------
# per-slot prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_prefill_equals_batch_prefill_bitwise(dtype):
    """Prompts prefilled one slot at a time (each padded to its own
    bucket) and together (left-padded to the longest): the same next
    tokens and, at every real token, bitwise the same K and V in every
    layer — RoPE phases count real tokens, not cache slots."""
    _, tcfg, _, tp = _model("minitron-4b")
    tcfg = tcfg.replace(dtype=dtype)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 13, 9)]
    S = 40
    toks = np.zeros((3, 13), np.int32)
    for i, p in enumerate(prompts):
        toks[i, 13 - len(p):] = p
    start = np.array([13 - len(p) for p in prompts], np.int32)
    t_all, c_all = ST.make_prefill(tcfg)(
        tp, {"tokens": torch.from_numpy(toks),
             "valid_start": torch.from_numpy(start)},
        ST.init_caches(tcfg, 3, S, device="cpu"))
    live = ST.init_caches(tcfg, 3, S, device="cpu")
    prefill_slot = ST.make_prefill_slot(tcfg)
    for i, p in enumerate(prompts):
        lb = bucket_length(len(p), S)
        row = np.zeros((1, lb), np.int32)
        row[0, lb - len(p):] = p
        t1, live = prefill_slot(
            tp, {"tokens": torch.from_numpy(row),
                 "valid_start": torch.tensor([lb - len(p)],
                                             dtype=torch.int32)}, live, i)
        assert int(t1[0]) == int(t_all[i])
        for lyr in range(tcfg.num_layers):
            for a, b in ((c_all[lyr].k, live[lyr].k),
                         (c_all[lyr].v, live[lyr].v)):
                assert torch.equal(a[i, 13 - len(p):13],
                                   b[i, lb - len(p):lb])
            assert int(live[lyr].length[i]) == lb


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------
_SERVES = {  # name: (continuous, EngineConfig overrides)
    "static": (False, {}),
    "static-prune": (False, dict(kv_prune_keep=0.5, kv_prune_interval=2)),
    "continuous-d1": (True, {}),
    "continuous-d2": (True, dict(pipeline_depth=2)),
    "continuous-prune-d1": (True, dict(kv_prune_keep=0.5,
                                       kv_prune_interval=2)),
    "continuous-prune-d2": (True, dict(kv_prune_keep=0.5,
                                       kv_prune_interval=2,
                                       pipeline_depth=2)),
    "continuous-batch-prefill": (True, dict(per_slot_prefill=False)),
}


def _requests(cls, vocab):
    rng = np.random.default_rng(8)
    return [cls(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=m)
            for i, (n, m) in enumerate(((5, 6), (11, 4), (3, 8), (17, 9),
                                        (8, 7)))]


_ENGINE_STATS = ("admissions", "admission_prefill_tokens", "prune_events",
                 "compile_count")


def _assert_same_serve(a_eng, a_out, b_eng, b_out):
    """Two serves equal on tokens, event stream, shape ledger and the four
    ``_ENGINE_STATS``."""
    assert a_out == b_out and sorted(a_out) == list(range(5))
    assert list(a_eng.events) == list(b_eng.events)
    assert a_eng.runner.compiled_shapes() == b_eng.runner.compiled_shapes()
    a_st, b_st = a_eng.stats(), b_eng.stats()
    for key in _ENGINE_STATS:
        assert a_st[key] == b_st[key], key


@pytest.mark.parametrize("name", list(_SERVES))
def test_engine_matches_reference_engine(name):
    """Reduced Minitron-4B at fp32 activations, 5 requests over 3 slots:
    the same tokens, the same admit/retire stream, the same shape ledger,
    admission prefill tokens and KV prunes (which fire in the pruned
    serves).

    The port's depth-2 serves are held to the reference's depth-1 serve
    with the same other settings, whose contract is tokens identical at
    every pipeline depth: the reference at ``pipeline_depth=2`` is not
    deterministic on a loaded CPU (six parallel processes, four serves
    each: uid 1's last token 54 in 2 of 12 serves, 141 in the rest; 141
    in 12 of 12 at depth 1 and in every port serve at both depths). A
    port-only check holds its depth-2 serve equal to its depth-1 serve."""
    continuous, kw = _SERVES[name]
    jcfg, tcfg, jp, tp = _model("minitron-4b")
    jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
    j_kw = {k: v for k, v in kw.items() if k != "pipeline_depth"}
    jeng = JEngine(jcfg, jp, JEC(max_batch=3, max_len=40, **j_kw))
    teng = ServeEngine(tcfg, tp, EngineConfig(max_batch=3, max_len=40, **kw),
                       device="cpu")
    j_out = jeng.serve(_requests(JReq, 256), continuous=continuous)
    t_out = teng.serve(_requests(Request, 256), continuous=continuous)
    _assert_same_serve(teng, t_out, jeng, j_out)
    ts = teng.stats()
    assert (ts["prune_events"] > 0) == ("prune" in name)
    assert ts["jit_compile_count"] == ts["compile_count"]
    if kw.get("pipeline_depth", 1) != 1:
        t1 = ServeEngine(tcfg, tp, EngineConfig(max_batch=3, max_len=40,
                                                **j_kw), device="cpu")
        _assert_same_serve(teng, t_out, t1,
                           t1.serve(_requests(Request, 256),
                                    continuous=continuous))


def test_engine_depth2_stages_ahead_without_changing_tokens():
    _, tcfg, _, tp = _model("stablelm-1.6b")
    outs = []
    for depth in (1, 2):
        eng = ServeEngine(tcfg, tp, EngineConfig(max_batch=2, max_len=40,
                                                 pipeline_depth=depth),
                          device="cpu")
        outs.append(eng.serve(_requests(Request, 256), continuous=True))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# launcher and device rules
# ---------------------------------------------------------------------------
def test_launcher_serves_on_cpu(monkeypatch, capsys):
    res = tserve.serve("minitron-4b", num_requests=3, prompt_len=8,
                       max_new=4, kv_prune=0.5, continuous=True,
                       device="cpu")
    assert sorted(res["outputs"]) == [0, 1, 2]
    assert all(len(v) == 4 for v in res["outputs"].values())
    assert res["device"] == "cpu"
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "stablelm-1.6b", "--device", "cpu",
        "--requests", "2", "--max-new", "3", "--json"])
    tserve.main()
    out = capsys.readouterr().out
    assert '"device": "cpu"' in out and '"outputs"' in out


def test_entry_points_default_to_the_card():
    """Called without ``device``, every LM entry point asks for the card
    and raises where there is none; ``elastic=`` raises and names the
    ROADMAP item."""
    _, tcfg, _, tp = _model("minitron-4b")
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        M.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        ServeEngine(tcfg, tp, EngineConfig())
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        ST.init_caches(tcfg, 2, 16)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        tserve.serve("minitron-4b")
    with pytest.raises(NotImplementedError, match="item 9"):
        ServeEngine(tcfg, tp, EngineConfig(), elastic=object(),
                    device="cpu")


def test_causal_kernel_wrapper_checks_on_card(monkeypatch):
    """On the card the causal wrapper launches its kernel or raises: the
    prefill kernel for several query rows, the decode kernel for one; fp32
    operands and head widths they are not built for are refused before
    any launch, and no plain version stands in."""
    def no_library(name):
        raise RuntimeError(f"no {name} kernel here")
    monkeypatch.setattr(backend, "on_card", lambda *ts: True)
    monkeypatch.setattr(backend, "library", no_library)
    monkeypatch.setattr(FA_ops, "_arrivals",
                        lambda dev, n: torch.zeros(n, dtype=torch.int32))
    q = torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 1, 16), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no flash_prefill kernel"):
        flash_attention(q, kv, kv, causal=True)
    with pytest.raises(RuntimeError, match="no flash_decode kernel"):
        flash_attention(q[:, :1].contiguous(), kv, kv, causal=True,
                        collect_scores=True)
    with pytest.raises(TypeError, match="bf16"):
        flash_attention(q.float(), kv.float(), kv.float(), causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :8].contiguous(), kv[..., :8].contiguous(),
                        kv[..., :8].contiguous(), causal=True)
    with pytest.raises(ValueError, match="decode row"):
        flash_attention(q, kv, kv, causal=True, collect_scores=True)
