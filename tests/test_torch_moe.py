"""The port's MoE family (``models/moe.py``, ``forward_lm`` and the serve
steps for ``moe``, ``ServeEngine`` and the launchers) against the reference
package, on the CPU, at the reduced MoE configs (3 layers, D=64, head_dim
16, vocab 256, 4 experts top-2, a 128-wide shared expert, capacity factor
8.0; Granite-MoE-3B-A800M reduces to GQA 4:1, Qwen2-MoE-A2.7B to MHA).

Weights come from the reference's seeded init, converted by
``convert.lm_params_from_jax``; inputs are numpy arrays from a seed.
Tolerances:

* ``moe_ffn`` at fp32: y within 1e-5 absolute and relative (``OP_TOL``;
  another summation order between XLA and PyTorch), aux within 1e-5, and
  the routing EQUAL: every token's experts, and which (token, expert) pairs
  the capacity keeps.
* ``moe_ffn`` at bf16: y within ``MOE_BF16_ULPS`` = 2 bf16 ulps of
  max|ref| (2 x 2^-7 x max|ref|). The router, the dispatch and the grouped
  products give the reference's bf16 values exactly (measured: 0
  elements differ), and the combine adds in the reference's order. What
  differs is SiLU: XLA's bf16 ``logistic`` on the CPU differs from
  PyTorch's sigmoid in about 30% of elements (by up to one bf16 ulp of
  the sigmoid), and the reference rounds the sigmoid and then the product
  where ``F.silu`` rounds once; the difference passes through the ``wo``
  product and the K-way combine. Measured: 1.0-1.13 ulps of max|ref| over
  these cases.
* ``forward_lm``: logits within 0.05 at bf16 (``BF16_LOGIT_TOL``, the
  dense LM's bound, ``test_torch_lm.py``) and 1e-3 at fp32 with greedy
  tokens equal; aux within 1e-5 at fp32 and 1e-2 at bf16: there the
  router's input carries the hidden states' bf16 roundings, the origin of
  the logits' bound, and a decode step averages its router probabilities
  over only B = 3 tokens (measured: 4.7e-3 at most, aux ~3.3).
* ``ServeEngine`` at fp32 activations, and the launchers: tokens, event
  streams, shape ledgers and lifecycles EQUAL.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as jserve
from repro.launch import serve_trace as JSTL
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import steps as JST
from repro.serving import EngineConfig as JEC
from repro.serving import Request as JReq
from repro.serving import ServeEngine as JEngine
from repro import traffic as JT

from repro_torch import convert
from repro_torch import traffic as T
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_trace as TSTL
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import steps as ST
from repro_torch.serving import EngineConfig, Request, ServeEngine
from repro_torch.tree import leaves, unflatten

OP_TOL = 1e-5
LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 0.05
BF16_ULP = 2.0 ** -7
MOE_BF16_ULPS = 2
ARCHS = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b")
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


# the reference's functions jitted (cfg static): one compile a shape, where
# op-by-op dispatch compiles every primitive. At bf16 ``moe_ffn`` runs op by
# op, as its source reads: under jit XLA fuses the router's bf16 product
# with the fp32 cast and skips the bf16 rounding of the router logits,
# which moves near-tied expert choices (measured: 0.336 apart at max|ref|
# 2.1).
_ref_moe_ffn = {"float32": jax.jit(JMOE.moe_ffn, static_argnums=(2, 3)),
                "bfloat16": JMOE.moe_ffn}
_ref_forward = jax.jit(JM.forward_lm, static_argnums=(0,),
                       static_argnames=("mode", "logits_for"))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


# ---------------------------------------------------------------------------
# configs and capacity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_match_reference(arch):
    for reduce in (False, True):
        j, t = j_get_config(arch), get_config(arch)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.moe_num_experts_padded == j.moe_num_experts_padded
        assert t.param_count() == j.param_count()


@pytest.mark.parametrize("T_,E,K,cf", [(1, 40, 8, 1.25), (4, 40, 8, 1.25),
                                       (512, 40, 8, 1.25), (2048, 40, 8, 1.0),
                                       (37, 4, 2, 8.0), (600, 60, 4, 15.0)])
def test_moe_capacity_matches_reference(T_, E, K, cf):
    assert MOE.moe_capacity(T_, E, K, cf) == JMOE.moe_capacity(T_, E, K, cf)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------
def _ref_routing(x, p, cfg, cf):
    """The reference's routing (``moe.py:74-96``, the same jnp calls):
    ``(expert_idx [T, K], kept [T, K])`` with kept mapped from the
    expert-sorted order back to (token, k)."""
    T_, D = x.shape[0] * x.shape[1], x.shape[2]
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    logits = JL.linear(x.reshape(T_, D), p["router"]).astype(jnp.float32)
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    flat = expert_idx.reshape(-1)
    order = jnp.argsort(flat, stable=True)
    counts = jnp.zeros((E,), jnp.int32).at[flat[order]].add(1)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(T_ * K) - starts[flat[order]]
    kept = np.zeros(T_ * K, bool)
    kept[np.asarray(order)] = np.asarray(rank < JMOE.moe_capacity(
        T_, E, K, cf))
    return np.asarray(expert_idx), kept.reshape(T_, K)


_NO_SHARED = dict(moe_shared_d_ff=0, moe_num_shared=0)
# name: (arch, config overrides, capacity factor, pad depth per row)
_FFN_CASES = {
    "granite": ("granite-moe-3b-a800m", _NO_SHARED, None, None),
    "shared-expert": ("qwen2-moe-a2.7b", {}, None, None),
    "padded-banks": ("granite-moe-3b-a800m",
                     dict(_NO_SHARED, moe_expert_pad_to=16), None, None),
    "ties": ("granite-moe-3b-a800m", _NO_SHARED, 1.0, None),
    "drops-left-padded": ("granite-moe-3b-a800m", _NO_SHARED, 1.0,
                          (0, 20, 27)),
}


def _ffn_inputs(name, dtype):
    arch, over, cf, pads = _FFN_CASES[name]
    jcfg = j_get_config(arch).reduced().replace(dtype=dtype, **over)
    tcfg = get_config(arch).reduced().replace(dtype=dtype, **over)
    jp = JMOE.init_moe_params(jax.random.PRNGKey(1), jcfg)
    if name == "ties":  # every expert ties: the lower indices win
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 32, jcfg.d_model)).astype(np.float32)
    if pads is not None:  # left padding: one shared pad state per row
        for b, n in enumerate(pads):
            x[b, :n] = x[b, 0]
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jcfg, tcfg, jp, tp, jx, tx, cf


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(_FFN_CASES))
def test_moe_ffn_matches_reference(name, dtype):
    jcfg, tcfg, jp, tp, jx, tx, cf = _ffn_inputs(name, dtype)
    jy, jaux = _ref_moe_ffn[dtype](jx, jp, jcfg, cf)
    ty, taux = MOE.moe_ffn(tx, tp, tcfg, capacity_factor=cf)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == jy.shape
    ref, got = _np(jy), _np(ty)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=OP_TOL, rtol=OP_TOL)
    else:
        assert (np.abs(got - ref).max()
                <= MOE_BF16_ULPS * BF16_ULP * np.abs(ref).max())
    assert abs(float(taux) - float(jaux)) <= 1e-5
    expert, kept = _ref_routing(jx, jp, jcfg,
                                cf or jcfg.moe_capacity_factor)
    r = MOE.route(tx.reshape(-1, tcfg.d_model), tp, tcfg, cf)
    np.testing.assert_array_equal(r.expert.numpy(), expert)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    E_pad, C = tcfg.moe_num_experts_padded, r.capacity
    slots = r.slot[r.kept]
    assert len(set(slots.tolist())) == len(slots)  # unique buffer rows
    assert bool((r.slot[~r.kept] == E_pad * C).all())
    if name == "ties":
        assert (expert == np.arange(tcfg.moe_top_k)).all()
    if name in ("ties", "drops-left-padded"):
        assert not kept.all()
    if name == "drops-left-padded":
        # a row's pads share one state, so one expert set: they come
        # first in token order and fill those experts before real tokens
        for b, n in enumerate(_FFN_CASES[name][3]):
            row = expert.reshape(3, 32, -1)[b, :max(n, 1)]
            assert (row == row[0]).all()
    if name == "padded-banks":
        assert tcfg.moe_num_experts_padded == 16 > tcfg.moe_num_experts
        assert tp["wg"].shape[0] == 16 and tp["router"].shape[1] == 4


def test_moe_ffn_is_deterministic_and_drops_pass_zero():
    """Two calls agree bitwise; a token whose every pair is dropped gets the
    shared expert's output alone (here: none, so 0)."""
    jcfg, tcfg, jp, tp, jx, tx, _ = _ffn_inputs("ties", "bfloat16")
    a, _ = MOE.moe_ffn(tx, tp, tcfg, capacity_factor=1.0)
    b, _ = MOE.moe_ffn(tx, tp, tcfg, capacity_factor=1.0)
    assert torch.equal(a, b)
    r = MOE.route(tx.reshape(-1, tcfg.d_model), tp, tcfg, 1.0)
    gone = ~r.kept.any(dim=1)
    assert gone.any() and bool((a.reshape(-1, tcfg.d_model)[gone] == 0).all())


# ---------------------------------------------------------------------------
# forward_lm, prefill and decode
# ---------------------------------------------------------------------------
def _prefill_decode(arch, dtype):
    """Left-padded prefill of 3 rows plus 4 teacher-forced decodes, in both
    packages. Returns one (reference Output, port Output) per step."""
    jcfg, tcfg, jp, tp = _model(arch)
    jcfg, tcfg = (c.replace(dtype=dtype) for c in (jcfg, tcfg))
    rng = np.random.default_rng(1)
    B, Lp, S = 3, 12, 24
    toks = rng.integers(0, 256, (B, Lp)).astype(np.int32)
    start = np.array([0, 5, 9], np.int32)
    dec = rng.integers(0, 256, (4, B)).astype(np.int32)
    jc = JST.init_caches(jcfg, B, S)
    tc = ST.init_caches(tcfg, B, S, device="cpu")
    jo = _ref_forward(jcfg, jp, jnp.asarray(toks), mode="prefill",
                      caches=jc, logits_for="last",
                      valid_start=jnp.asarray(start))
    to = M.forward_lm(tcfg, tp, torch.from_numpy(toks), mode="prefill",
                      caches=tc, logits_for="last",
                      valid_start=torch.from_numpy(start))
    steps = [(jo, to)]
    for t in dec:
        jo = _ref_forward(jcfg, jp, jnp.asarray(t)[:, None], mode="decode",
                          caches=jo.caches, valid_start=jnp.asarray(start))
        to = M.forward_lm(tcfg, tp, torch.from_numpy(t)[:, None],
                          mode="decode", caches=to.caches,
                          valid_start=torch.from_numpy(start))
        steps.append((jo, to))
    return steps


def _assert_logits(ref, got, dtype):
    ref, got = np.asarray(ref), got.numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    else:
        assert np.abs(got - ref).max() <= BF16_LOGIT_TOL


def _aux_tol(dtype):
    return 1e-5 if dtype == "float32" else 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_matches_reference(arch, dtype):
    """Train mode (no cache, under no_grad): logits and the aux summed over
    layers; then the train-mode forward with grad enabled gives the same
    logits and aux, and a finite, nonzero gradient for every param
    (``tests/test_torch_moe_train.py`` holds it against the reference)."""
    jcfg, tcfg, jp, tp = _model(arch)
    jcfg, tcfg = (c.replace(dtype=dtype) for c in (jcfg, tcfg))
    toks = np.random.default_rng(2).integers(0, 256, (2, 20)).astype(
        np.int32)
    jo = _ref_forward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        to = M.forward_lm(tcfg, tp, torch.from_numpy(toks))
    _assert_logits(jo.logits, to.logits, dtype)
    assert abs(float(to.aux_loss) - float(jo.aux_loss)) <= _aux_tol(dtype)
    flat = [t.detach().requires_grad_(True) for t in leaves(tp)]
    go = M.forward_lm(tcfg, unflatten(tp, flat), torch.from_numpy(toks))
    assert torch.equal(go.logits.detach(), to.logits)
    assert torch.equal(go.aux_loss.detach(), to.aux_loss)
    grads = torch.autograd.grad(go.logits.sum() + go.aux_loss, flat,
                                allow_unused=True)
    for g in grads:
        assert g is not None and bool(torch.isfinite(g).all())
        assert bool((g != 0).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_prefill_decode_matches_reference(arch, dtype):
    for jo, to in _prefill_decode(arch, dtype):
        _assert_logits(jo.logits, to.logits, dtype)
        assert abs(float(to.aux_loss) - float(jo.aux_loss)) <= _aux_tol(
            dtype)


def test_pad_rows_route_together_whatever_the_kernel_writes(monkeypatch):
    """A left-padded prefill: at every layer a row's pads share one hidden
    state, so one expert set. The causal kernels write 0 where a row has
    no key and the plain version the mean of V (the reference's value);
    ``attention_block`` gives such rows the mean either way, so the
    routing, logits and caches are the same when the plain version is
    made to write 0 as the kernels do."""
    _, tcfg, _, tp = _model("granite-moe-3b-a800m")
    toks = np.random.default_rng(5).integers(0, 256, (3, 16)).astype(
        np.int32)
    start = np.array([0, 6, 11], np.int32)
    toks[np.arange(16)[None] < start[:, None]] = 0

    def prefill():
        seen = []
        route = MOE.route

        def recorded(*a, **kw):
            r = route(*a, **kw)
            seen.append(r.expert.reshape(3, 16, -1))
            return r
        monkeypatch.setattr(MOE, "route", recorded)
        out = M.forward_lm(tcfg, tp, torch.from_numpy(toks), mode="prefill",
                           caches=ST.init_caches(tcfg, 3, 24, device="cpu"),
                           valid_start=torch.from_numpy(start))
        monkeypatch.setattr(MOE, "route", route)
        return out, seen

    base, seen = prefill()
    assert len(seen) == tcfg.num_layers
    for experts in seen:
        for b, n in enumerate(start):
            assert (experts[b, :n] == experts[b, :1]).all()
    attend = A.FA.flash_attention

    def zero_keyless(q, k, v, causal=False, q_offset=None, kv_len=None,
                     kv_start=None, collect_scores=False):
        o = attend(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                   kv_start=kv_start, collect_scores=collect_scores)
        rows = q_offset[:, None] + torch.arange(q.shape[1])
        return torch.where((rows < kv_start[:, None])[:, :, None, None],
                           torch.zeros_like(o), o)
    monkeypatch.setattr(A.FA, "flash_attention", zero_keyless)
    zeroed, seen_z = prefill()
    assert all(torch.equal(a, b) for a, b in zip(seen, seen_z))
    assert torch.equal(zeroed.logits, base.logits)
    for a, b in zip(zeroed.caches, base.caches):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_lm_loss_carries_the_aux():
    jcfg, tcfg, jp, tp = _model("qwen2-moe-a2.7b")
    jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
    toks = np.random.default_rng(4).integers(0, 256, (2, 16)).astype(
        np.int32)
    jt, jparts = JM.lm_loss(jcfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tt, tparts = M.lm_loss(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert float(tparts["aux"]) > 0
    for k in ("ce", "aux"):
        assert abs(float(tparts[k]) - float(jparts[k])) <= 1e-5
    assert abs(float(tt) - float(jt)) <= 1e-5


def test_slot_prefill_equals_reference():
    """The per-slot prefill (a B=1 prefill written into one row of the
    live cache) at fp32: the next token and the written cache row equal
    the reference's."""
    jcfg, tcfg, jp, tp = _model("granite-moe-3b-a800m")
    jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
    row = np.zeros((1, 16), np.int32)
    row[0, 5:] = np.random.default_rng(6).integers(0, 256, 11)
    batch = {"tokens": row, "valid_start": np.array([5], np.int32)}
    jtok, jc = JST.make_prefill_slot(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()},
        JST.init_caches(jcfg, 3, 24), 1)
    ttok, tc = ST.make_prefill_slot(tcfg)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()},
        ST.init_caches(tcfg, 3, 24, device="cpu"), 1)
    assert int(ttok[0]) == int(jtok[0])
    ref = convert.kv_caches_from_jax(jc)
    for lyr in range(tcfg.num_layers):
        assert torch.equal(tc[lyr].length, ref[lyr].length)
        assert (tc[lyr].k.float() - ref[lyr].k.float()).abs().max() <= (
            BF16_ULP * ref[lyr].k.float().abs().max())


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------
_SERVES = {  # name: (continuous, EngineConfig overrides)
    "static": (False, {}),
    "continuous-d1": (True, {}),
    "continuous-d2": (True, dict(pipeline_depth=2)),
    "continuous-prune": (True, dict(kv_prune_keep=0.5, kv_prune_interval=2)),
}
_REF_SERVES = {}


def _requests(cls, lengths=((5, 6), (11, 4), (3, 8), (17, 9), (8, 7))):
    rng = np.random.default_rng(8)
    return [cls(uid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                max_new_tokens=m)
            for i, (n, m) in enumerate(lengths)]


# prompts of 33-40 tokens in 64-token buckets: 24-31 pads each, all in the
# same two experts, against C = 40 in a per-slot prefill
_PADDED = ((33, 5), (35, 4), (40, 6), (34, 3))


def _ref_serve(arch, continuous, kw, cf=None, lengths=None):
    """The reference engine's serve at fp32 activations, once per module.
    Depth 2 is held to the reference's depth 1 (its contract: the same
    tokens at every depth; ``test_torch_lm.py`` on why)."""
    key = (arch, continuous, tuple(sorted(kw.items())), cf, lengths)
    if key not in _REF_SERVES:
        jcfg = _model(arch)[0].replace(dtype="float32")
        if cf is not None:
            jcfg = jcfg.replace(moe_capacity_factor=cf)
        eng = JEngine(jcfg, _model(arch)[2], JEC(
            max_batch=3, max_len=80 if lengths else 40, **kw))
        out = eng.serve(_requests(JReq, *([lengths] if lengths else [])),
                        continuous=continuous)
        _REF_SERVES[key] = (eng, out)
    return _REF_SERVES[key]


def _assert_same_serve(t_eng, t_out, j_eng, j_out, n):
    assert t_out == j_out and sorted(t_out) == list(range(n))
    assert list(t_eng.events) == list(j_eng.events)
    assert t_eng.runner.compiled_shapes() == j_eng.runner.compiled_shapes()
    t_st, j_st = t_eng.stats(), j_eng.stats()
    for key in ("admissions", "admission_prefill_tokens", "prune_events",
                "compile_count"):
        assert t_st[key] == j_st[key], key


@pytest.mark.parametrize("name", list(_SERVES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(arch, name):
    """Reduced MoE at fp32 activations, 5 requests over 3 slots: the same
    tokens, admit/retire stream, shape ledger, admission prefill tokens and
    KV prunes (which fire in the pruned serve)."""
    continuous, kw = _SERVES[name]
    tcfg, tp = _model(arch)[1].replace(dtype="float32"), _model(arch)[3]
    j_kw = {k: v for k, v in kw.items() if k != "pipeline_depth"}
    j_eng, j_out = _ref_serve(arch, continuous, j_kw)
    t_eng = ServeEngine(tcfg, tp, EngineConfig(max_batch=3, max_len=40,
                                               **kw), device="cpu")
    t_out = t_eng.serve(_requests(Request), continuous=continuous)
    _assert_same_serve(t_eng, t_out, j_eng, j_out, 5)
    assert (t_eng.stats()["prune_events"] > 0) == ("prune" in name)


@pytest.mark.parametrize("continuous", [True, False],
                         ids=["continuous", "static"])
def test_engine_with_drops_matches_reference_engine(monkeypatch, continuous):
    """Capacity factor 1.25 and prompts padded 24-31 deep: pads take
    capacity and real (token, expert) pairs are dropped in the prefills,
    as in the reference, whose tokens the port gives."""
    arch = "granite-moe-3b-a800m"
    tcfg = _model(arch)[1].replace(dtype="float32", moe_capacity_factor=1.25)
    j_eng, j_out = _ref_serve(arch, continuous, {}, cf=1.25, lengths=_PADDED)
    dropped = []
    route = MOE.route

    def counted(*a, **kw):
        r = route(*a, **kw)
        dropped.append(int((~r.kept).sum()))
        return r
    monkeypatch.setattr(MOE, "route", counted)
    t_eng = ServeEngine(tcfg, _model(arch)[3], EngineConfig(
        max_batch=3, max_len=80), device="cpu")
    t_out = t_eng.serve(_requests(Request, _PADDED), continuous=continuous)
    _assert_same_serve(t_eng, t_out, j_eng, j_out, len(_PADDED))
    assert sum(dropped) > 0


# ---------------------------------------------------------------------------
# launchers and refusals
# ---------------------------------------------------------------------------
def test_launcher_serves_moe_like_the_reference(monkeypatch, capsys):
    """``launch/serve`` at reduced Granite-MoE: the reference's admit /
    retire stream, ledger and token counts (the weights differ: each
    package draws its own from the seed)."""
    kw = dict(num_requests=3, prompt_len=8, max_new=4, kv_prune=0.5,
              continuous=True)
    ref = jserve.serve("granite-moe-3b-a800m", **kw)
    res = tserve.serve("granite-moe-3b-a800m", device="cpu", **kw)
    assert res["events"] == ref["events"]
    assert {k: len(v) for k, v in res["outputs"].items()} == {
        k: len(v) for k, v in ref["outputs"].items()}
    for key in ("admissions", "admission_prefill_tokens", "prune_events",
                "compile_count"):
        assert res["stats"][key] == ref["stats"][key], key
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "qwen2-moe-a2.7b", "--device", "cpu",
        "--requests", "2", "--max-new", "3", "--json"])
    tserve.main()
    out = capsys.readouterr().out
    assert '"device": "cpu"' in out and '"outputs"' in out


def test_serve_trace_replays_moe_like_the_reference():
    """``launch/serve_trace --engine lm --arch granite-moe-3b-a800m``: the
    reference's lifecycle and report but the outputs' digest (the weights
    differ), every request completed with its tokens."""
    reps = []
    for pkg, driver in (
            (JT, JSTL.build_driver("lm", "granite-moe-3b-a800m", 2, 0, 1,
                                   "strict", 0.4, 1.0)),
            (T, TSTL.build_driver("lm", "granite-moe-3b-a800m", 2, 0, 1,
                                  "strict", 0.4, 1.0, device="cpu"))):
        trace = pkg.make_trace(pkg.TraceSpec(
            n=5, rate_rps=400.0, process="bursty", kind="lm",
            prompt_sizes=(8, 16), max_new_tokens=4), seed=3)
        h = pkg.TrafficHarness(driver)
        rep = h.run(trace)
        assert rep["completed"] == 5
        assert all(len(t) == 4 for t in h.outputs.values())
        rep.pop("outputs_digest")
        reps.append((h.lifecycle(), rep))
    assert reps[0] == reps[1]


def test_moe_entry_points_default_to_the_card():
    """Without ``device``, every MoE serving entry point asks for the card
    and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    _, tcfg, _, tp = _model("granite-moe-3b-a800m")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        M.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        ServeEngine(tcfg, tp, EngineConfig())
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        ST.init_caches(tcfg, 2, 16)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        tserve.serve("granite-moe-3b-a800m")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        TSTL.build_driver("lm", "qwen2-moe-a2.7b", 2, 0, 1, "strict", 0.4,
                          1.0)


def test_init_params_draws_the_moe_tree():
    """``init_params`` for ``moe``: the reference's tree, layers as a list,
    in ``cfg.param_dtype`` with the reference's shapes."""
    for arch in ARCHS:
        jcfg, tcfg, jp, _ = _model(arch)
        tcfg = tcfg.replace(moe_expert_pad_to=8)
        jcfg = jcfg.replace(moe_expert_pad_to=8)
        tp = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
        jshapes = jax.tree_util.tree_map(
            lambda a: tuple(a.shape[1:]),
            jax.eval_shape(lambda: JM.init_params(
                jcfg, jax.random.PRNGKey(0)))["layers"])
        assert len(tp["layers"]) == tcfg.num_layers
        tshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                         tp["layers"][0])
        assert tshapes == jshapes
        assert all(t.dtype == torch.float32
                   for t in jax.tree_util.tree_leaves(tp["layers"][0]))
        assert tp["layers"][0]["moe"]["wg"].shape[0] == 8
