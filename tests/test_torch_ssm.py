"""The port's SSM and hybrid families (``models/ssm.py``, the
``kernels/ssm_scan`` wrappers, ``forward_lm`` and the serve steps for
``hybrid`` and ``ssm``, ``ServeEngine`` and the launcher) against the
reference package, on the CPU, at the reduced configs: Zamba2-1.2B reduces
to 4 Mamba2 layers (D=64, 2 heads of dh 64, state 8) in 2 stages with a
shared block of 4 MHA heads of dh 16, and to 2 stages plus a tail at 5
layers; RWKV6-1.6B to 3 layers of 4 WKV heads of dh 16, vocab 256.

Weights come from the reference's seeded init, converted by
``convert.lm_params_from_jax``; inputs and incoming states are numpy arrays
from a seed. Tolerances:

* ``mamba_block``, ``rwkv_block`` (sequential and chunked) at fp32: output
  and new state within 1e-5 absolute and relative (``OP_TOL``; another
  summation order between XLA and PyTorch in the projections and the
  scans' sums).
* the scan wrappers routed as on the card (``backend.on_card`` true, the
  CUDA launch replaced by the plain version, which the wrapper itself must
  not call): EQUAL to the CPU route.
* ``forward_lm`` at fp32 activations (train, prefill, decode): logits
  within 1e-3 (``LOGIT_TOL``, the dense LM's bound: the serve caches hold
  the conv buffer, shifts and KV in bf16, which can flip a rounding later
  layers carry) and greedy tokens equal; at bf16 within 0.15
  (``BF16_LOGIT_TOL``, the bound ``tests/test_models_smoke.py:53`` holds
  the reference's own prefill and decode to against its full forward).
  These families round far more often in bf16 than the dense LM (the
  conv sum, gates, token mixes, squared ReLU), where XLA keeps excess
  precision inside its fusions and PyTorch rounds after each operation:
  measured 0.049-0.092 for the port, and the witness test shows the
  reference alone moving by 0.066-0.144 when a random half of its
  embedding moves by one bf16 ulp. The port's own prefill followed by
  decode against its full forward at bf16 within that test's bound (0.15
  absolute, 0.05 relative).
* states carried from the reference's prefill through three decodes:
  fp32 leaves within 1e-4, bf16 leaves (conv buffer, KV) within one bf16
  ulp (an fp32 difference of 1e-7 can flip the rounding).
* caches, states, KV pruning and the engines' tokens, event streams and
  shape ledgers: EQUAL.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.models import steps as JST
from repro.serving import EngineConfig as JEC
from repro.serving import Request as JReq
from repro.serving import ServeEngine as JEngine
from repro.serving.cache_manager import prune_kv_caches as j_prune

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import backend
from repro_torch.kernels.ssm_scan import mamba_scan, ops as SS, wkv6
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.models import steps as ST
from repro_torch.serving import (EngineConfig, Request, ServeEngine,
                                 prune_kv_caches)
from repro_torch.serving.runner import serving_params

OP_TOL = 1e-5
LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 0.15
BF16_ULP = 2.0 ** -7
# (arch, layers): the reduced configs, and Zamba2 at 5 layers (2 stages of
# 2 and a tail of 1)
VARIANTS = {"zamba2": ("zamba2-1.2b", None), "zamba2-tail": ("zamba2-1.2b", 5),
            "rwkv6": ("rwkv6-1.6b", None)}
_MODELS = {}


def _model(name):
    """(reference cfg, port cfg, reference params, port params), built
    once per module."""
    if name not in _MODELS:
        arch, layers = VARIANTS[name]
        jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
        if layers:
            jcfg, tcfg = (c.replace(num_layers=layers) for c in (jcfg, tcfg))
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp))
        _MODELS[name] = (jcfg, tcfg, jp, tp)
    return _MODELS[name]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, ref, tol=OP_TOL):
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)


def _layer(tree, *idx):
    for i in idx:
        tree = jax.tree_util.tree_map(lambda a: a[i], tree)
    return tree


# ---------------------------------------------------------------------------
# configs and blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b"])
def test_ssm_configs_match_reference(arch):
    j, t = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.family in ST.SERVE_FAMILIES


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "carried"])
def test_mamba_block_matches_reference(with_state):
    """A 7-token sequence through the first Mamba2 layer, from a zero
    state or from a random one (the conv buffer's 3 rows and h carried)."""
    jcfg, tcfg, jp, tp = _model("zamba2")
    jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    j_state = t_state = None
    if with_state:
        h = rng.standard_normal((2, 2, 64, 8)).astype(np.float32)
        conv = rng.standard_normal((2, 3, 128)).astype(np.float32)
        j_state = JSSM.MambaState(jnp.asarray(h), jnp.asarray(conv))
        t_state = SSM.MambaState(torch.from_numpy(h), torch.from_numpy(conv))
    jo, js = JSSM.mamba_block(jnp.asarray(x),
                              _layer(jp["stages"], 0, 0)["mamba"], jcfg,
                              j_state)
    to, ts = SSM.mamba_block(torch.from_numpy(x),
                             tp["stages"][0][0]["mamba"], tcfg, t_state)
    _close(to, jo)
    _close(ts.h, js.h)
    assert ts.conv.dtype == torch.float32
    _close(ts.conv, js.conv, 0.0)  # the last 3 conv inputs, copied
    if with_state:  # the incoming state is not written
        assert torch.equal(t_state.h, torch.from_numpy(h))


@pytest.mark.parametrize("chunk", [0, 8], ids=["sequential", "chunk8"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "carried"])
def test_rwkv_block_matches_reference(chunk, with_state):
    """A 16-token sequence through the first RWKV6 layer, the WKV
    sequential or chunked by 8, from a zero state or from a random one (wkv
    and both token shifts carried)."""
    jcfg, tcfg, jp, tp = _model("rwkv6")
    jcfg, tcfg = (c.replace(dtype="float32", rwkv_chunk=chunk)
                  for c in (jcfg, tcfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    j_state = t_state = None
    if with_state:
        arrs = (0.3 * rng.standard_normal((2, 4, 16, 16)),
                rng.standard_normal((2, 64)), rng.standard_normal((2, 64)))
        arrs = [a.astype(np.float32) for a in arrs]
        j_state = JSSM.RWKVState(*(jnp.asarray(a) for a in arrs))
        t_state = SSM.RWKVState(*(torch.from_numpy(a) for a in arrs))
    jo, js = JSSM.rwkv_block(jnp.asarray(x), _layer(jp["layers"], 0), jcfg,
                             j_state)
    to, ts = SSM.rwkv_block(torch.from_numpy(x), tp["layers"][0], tcfg,
                            t_state)
    _close(to, jo)
    for got, ref in zip(ts, js):
        _close(got, ref)


# ---------------------------------------------------------------------------
# the scan wrappers
# ---------------------------------------------------------------------------
def _scan_inputs(dtype=torch.float32, B=2, S=5, H=3, dh=16, N=8):
    g = torch.Generator().manual_seed(2)
    rand = lambda *s: torch.randn(s, generator=g)
    mamba = (rand(B, S, H, dh).to(dtype), rand(B, S, H).abs(),
             torch.rand((B, S, H), generator=g), rand(B, S, N),
             rand(B, S, N), rand(B, H, dh, N))
    wkv = (rand(B, S, H, dh).to(dtype), rand(B, S, H, dh).to(dtype),
           rand(B, S, H, dh).to(dtype), torch.rand((B, S, H, dh), generator=g),
           rand(H, dh), rand(B, H, dh, dh))
    return mamba, wkv


def _as_on_card(monkeypatch):
    """Route the scan wrappers as on the card (their module alone sees
    ``on_card`` true: attention keeps its CPU route): the CUDA launch
    replaced by the plain version, which the wrappers themselves must not
    call. Returns the launch counts."""
    launched = {"mamba_scan": 0, "wkv6": 0}
    plain = {"mamba_scan": SS.mamba_scan_plain, "wkv6": SS.wkv6_plain}

    def cuda(name):
        def run(*a):
            launched[name] += 1
            return plain[name](*a)
        return run

    def refused(*a, **k):
        raise AssertionError("a plain scan ran on a card tensor")
    monkeypatch.setattr(SS, "backend", types.SimpleNamespace(
        on_card=lambda *t: True, launch=refused))
    monkeypatch.setattr(SS, "_mamba_scan_cuda", cuda("mamba_scan"))
    monkeypatch.setattr(SS, "_wkv6_cuda", cuda("wkv6"))
    monkeypatch.setattr(SS, "mamba_scan_plain", refused)
    monkeypatch.setattr(SS, "wkv6_plain", refused)
    return launched


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_lm_routes_scans_as_on_card(monkeypatch, name):
    """Prefill then two decodes with the wrappers routed as on the card:
    one launch per Mamba2 or RWKV6 layer and call, no plain scan, and the
    CPU route's logits and states exactly."""
    _, tcfg, _, tp = _model(name)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 9)).astype(np.int64))

    def run():
        caches = ST.init_caches(tcfg, 2, 16, device="cpu")
        outs = []
        for sl in (slice(0, 7), slice(7, 8), slice(8, 9)):
            o = M.forward_lm(tcfg, tp, toks[:, sl],
                             mode="prefill" if sl.start == 0 else "decode",
                             caches=caches, logits_for="last")
            caches = o.caches
            outs.append(o.logits)
        return outs, caches
    ref_logits, ref_caches = run()
    launched = _as_on_card(monkeypatch)
    logits, caches = run()
    kernel = "wkv6" if tcfg.family == "ssm" else "mamba_scan"
    assert launched[kernel] == 3 * tcfg.num_layers
    assert sum(launched.values()) == launched[kernel]
    for a, b in zip(logits, ref_logits):
        assert torch.equal(a, b)
    for a, b in zip(caches, ref_caches):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_scan_wrappers_raise():
    """Both paths: a wrong dtype, a wrong shape, inputs on two devices. On
    the card only: non-contiguous operands, a width over 64. A gradient on
    a card tensor does not raise: it routes to the autograd Function, whose
    backward launches the backward kernel."""
    mamba, wkv = _scan_inputs()
    with pytest.raises(TypeError, match="fp32"):
        mamba_scan(*mamba[:5], mamba[5].double())
    with pytest.raises(TypeError, match="all bf16 or all fp32"):
        wkv6(wkv[0].bfloat16(), *wkv[1:])
    with pytest.raises(ValueError, match="h0"):
        mamba_scan(*mamba[:5], mamba[5][:, :, :4])
    with pytest.raises(ValueError, match="u \\[H, dh\\]"):
        wkv6(*wkv[:4], wkv[4][:2], wkv[5])
    with pytest.raises(ValueError, match="all on the CPU"):
        wkv6(*wkv[:5], torch.empty(wkv[5].shape, device="meta"))
    ok = (mamba, wkv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(backend, "on_card", lambda *t: True)
        mp.setattr(backend, "launch", lambda *a: pytest.fail("launched"))
        with pytest.raises(ValueError, match="contiguous"):
            mamba_scan(ok[0][0].transpose(0, 1).contiguous().transpose(0, 1),
                       *ok[0][1:])
        wide = _scan_inputs(dh=80)
        with pytest.raises(ValueError, match="widths of 1 to 64"):
            wkv6(*wide[1])
        with pytest.raises(ValueError, match="widths of 1 to 64"):
            mamba_scan(*_scan_inputs(N=72)[0])
        launched = []
        mp.setattr(backend, "launch",
                   lambda lib, entry, *a, **k: launched.append(entry))
        mp.setattr(SS, "bwd_slots", lambda dev, items: 1)
        y, s = wkv6(ok[1][0].clone().requires_grad_(), *ok[1][1:])
        assert type(y.grad_fn).__name__ == "WKV6Backward"
        y.sum().backward()
        y, s = mamba_scan(ok[0][0].clone().requires_grad_(), *ok[0][1:])
        assert type(y.grad_fn).__name__ == "MambaScanBackward"
        y.sum().backward()
        assert launched == ["wkv6_f32", "wkv6_bwd_f32", "mamba_scan_f32",
                            "mamba_scan_bwd_f32"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_scans_split_and_bf16(dtype):
    """The plain versions continue: S split as 3 + 4 with the state carried
    equals one pass; bf16 activations read as their fp32 values."""
    mamba, wkv = _scan_inputs(dtype, S=7)
    for fn, ins in ((mamba_scan, mamba), (wkv6, wkv)):
        y, s = fn(*ins)
        first = [t[:, :3] if t.dim() >= 3 and t.shape[1] == 7 else t
                 for t in ins[:-1]]
        rest = [t[:, 3:] if t.dim() >= 3 and t.shape[1] == 7 else t
                for t in ins[:-1]]
        y1, s1 = fn(*first, ins[-1])
        y2, s2 = fn(*rest, s1)
        torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=0)
        assert torch.equal(s2, s)
        f32 = fn(*(t.float() for t in ins))
        assert torch.equal(f32[0], y) and torch.equal(f32[1], s)


# ---------------------------------------------------------------------------
# forward_lm
# ---------------------------------------------------------------------------
_SERVE_TOKS = np.random.default_rng(4).integers(0, 256, (3, 9)).astype(
    np.int32)
_TRAIN_TOKS = np.random.default_rng(5).integers(0, 256, (2, 9)).astype(
    np.int32)
_REF = {}


def _ref_train(name, dtype, embed=None):
    """The reference's train-mode logits over ``_TRAIN_TOKS`` (memoized
    for its own embedding)."""
    key = ("train", name, dtype)
    if embed is None and key in _REF:
        return _REF[key]
    jcfg, _, jp, _ = _model(name)
    out = np.asarray(JM.forward_lm(
        jcfg.replace(dtype=dtype), jp if embed is None else dict(
            jp, embed=embed), jnp.asarray(_TRAIN_TOKS), mode="train",
        remat=False).logits)
    if embed is None:
        _REF[key] = out
    return out


def _ref_serve(name, dtype):
    """The reference's prefill of 6 of ``_SERVE_TOKS`` and 3 teacher-forced
    decodes (memoized): ([logits per call], [caches after each call])."""
    key = ("serve", name, dtype)
    if key not in _REF:
        jcfg, _, jp, _ = _model(name)
        jcfg = jcfg.replace(dtype=dtype)
        jo = JM.forward_lm(jcfg, jp, jnp.asarray(_SERVE_TOKS[:, :6]),
                           mode="prefill", caches=JST.init_caches(jcfg, 3, 16),
                           logits_for="last")
        logits, caches = [np.asarray(jo.logits)], [jo.caches]
        for t in range(6, 9):
            jo = JM.forward_lm(jcfg, jp, jnp.asarray(_SERVE_TOKS[:, t:t + 1]),
                               mode="decode", caches=jo.caches)
            logits.append(np.asarray(jo.logits))
            caches.append(jo.caches)
        _REF[key] = (logits, caches)
    return _REF[key]


def _serve_calls(name, dtype, states_from_reference=False):
    """The port's prefill and decodes of ``_ref_serve``, from its own
    prefill or (``states_from_reference``) from the reference's prefill
    states. Returns [(reference logits, port logits)] per call, and the
    last caches of each."""
    _, tcfg, _, tp = _model(name)
    tcfg = tcfg.replace(dtype=dtype)
    ref_logits, ref_caches = _ref_serve(name, dtype)
    to = M.forward_lm(tcfg, tp, torch.from_numpy(_SERVE_TOKS[:, :6]),
                      mode="prefill",
                      caches=ST.init_caches(tcfg, 3, 16, device="cpu"),
                      logits_for="last")
    got = [to.logits.numpy()]
    t_caches = (convert.states_from_jax(ref_caches[0])
                if states_from_reference else to.caches)
    for t in range(6, 9):
        to = M.forward_lm(tcfg, tp, torch.from_numpy(_SERVE_TOKS[:, t:t + 1]),
                          mode="decode", caches=t_caches)
        t_caches = to.caches
        got.append(to.logits.numpy())
    return list(zip(ref_logits, got)), ref_caches[-1], t_caches


def _assert_logits(got, ref, dtype):
    assert got.dtype == np.float32 and got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    else:
        assert np.abs(got - ref).max() <= BF16_LOGIT_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_lm_matches_reference(name, dtype):
    """Train mode over 9 tokens, then prefill and decode calls, against the
    reference's logits."""
    tcfg, tp = _model(name)[1].replace(dtype=dtype), _model(name)[3]
    got = M.forward_lm(tcfg, tp, torch.from_numpy(_TRAIN_TOKS)).logits
    _assert_logits(got.numpy(), _ref_train(name, dtype), dtype)
    for ref, got in _serve_calls(name, dtype)[0]:
        _assert_logits(got, ref, dtype)


def test_forward_lm_bf16_bound_witness():
    """The bf16 bound is of the size of the reference's own sensitivity:
    moving a random half of the reference's embedding's bf16 values by one
    bf16 ulp moves its train-mode logits by more than a fifth of the
    bound in every variant, and the port stays within the bound."""
    for name in VARIANTS:
        _, tcfg, jp, tp = _model(name)
        emb = jnp.asarray(jp["embed"]).astype(jnp.bfloat16)
        up = jnp.nextafter(emb, jnp.full(emb.shape, jnp.inf, emb.dtype))
        half = np.random.default_rng(2).random(emb.shape) < 0.5
        moved = jnp.where(half, up, emb).astype(jnp.float32)
        ref = _ref_train(name, "bfloat16")
        shifted = _ref_train(name, "bfloat16", embed=moved)
        got = M.forward_lm(tcfg, tp,
                           torch.from_numpy(_TRAIN_TOKS)).logits.numpy()
        assert np.abs(shifted - ref).max() > BF16_LOGIT_TOL / 5
        assert np.abs(got - ref).max() <= BF16_LOGIT_TOL


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_decode_matches_full_forward(name):
    """The port's own prefill of 8 tokens and a decode against its full
    forward over 9, at bf16 (``tests/test_models_smoke.py:53`` holds the
    reference so)."""
    _, tcfg, _, tp = _model(name)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (1, 9)).astype(np.int64))
    full = M.forward_lm(tcfg, tp, toks).logits[:, -1]
    out = M.forward_lm(tcfg, tp, toks[:, :8], mode="prefill",
                       caches=ST.init_caches(tcfg, 1, 32, device="cpu"))
    dec = M.forward_lm(tcfg, tp, toks[:, 8:], mode="decode",
                       caches=out.caches).logits[:, -1]
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=0.15,
                               rtol=0.05)


def test_forward_lm_refuses_valid_start():
    _, tcfg, _, tp = _model("rwkv6")
    with pytest.raises(ValueError, match="no valid_start"):
        M.forward_lm(tcfg, tp, torch.zeros((1, 4), dtype=torch.int64),
                     valid_start=torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# caches, states, pruning
# ---------------------------------------------------------------------------
def _tree_sig(caches):
    return [(type(c).__name__,
             [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
              for t in c]) for c in caches]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_init_caches_and_states_from_jax_match_reference(name):
    """``init_caches`` is the reference's tree flattened in execution
    order (types, shapes, dtypes, zeros); after a reference prefill,
    ``states_from_jax`` carries its states over exactly, and the port's
    decodes from them give the reference's logits."""
    jcfg, tcfg, _, _ = _model(name)
    conv = convert.states_from_jax(JST.init_caches(jcfg, 3, 16))
    mine = ST.init_caches(tcfg, 3, 16, device="cpu")
    assert len(mine) == M.num_caches(tcfg)
    assert _tree_sig(mine) == _tree_sig(conv)
    assert all(not t.any() for c in mine for t in c)
    calls, j_caches, t_caches = _serve_calls(name, "float32",
                                             states_from_reference=True)
    for ref, got in calls[1:]:
        _assert_logits(got, ref, "float32")
    # the states the port carried from the reference's prefill, three
    # decodes on, against the reference's own
    for got, ref in zip(t_caches, convert.states_from_jax(j_caches)):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            bf16 = a.dtype == torch.bfloat16  # one rounding may flip
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-4,
                                       rtol=BF16_ULP if bf16 else 1e-4)


def test_prune_kv_caches_on_recurrent_trees():
    """``tests/test_serving.py``'s passthrough, and the hybrid's pruned
    shared-block caches against the reference's: RWKV states come back as
    they went in with starts None; the hybrid's Mamba states are the same
    tensors, its KV caches compacted as the reference compacts them."""
    tcfg = get_config("rwkv6-1.6b").reduced()
    states = ST.init_caches(tcfg, 2, 16, device="cpu")
    pruned, starts = prune_kv_caches(states, 0.5)
    assert starts is None
    assert all(a is b for a, b in zip(pruned, states))

    jcfg, tcfg, _, _ = _model("zamba2-tail")
    jc = JST.set_cache_length(jcfg, JST.init_caches(jcfg, 2, 16), 8)
    rng = np.random.default_rng(7)
    mamba, tail, attn = jc
    attn = attn._replace(
        k=jnp.asarray(rng.standard_normal(attn.k.shape), jnp.bfloat16),
        attn_mass=jnp.asarray(rng.random(attn.attn_mass.shape), jnp.float32))
    jc = (mamba, tail, attn)
    j_pruned, j_starts = j_prune(jc, 0.5)
    tc = convert.states_from_jax(jc)
    t_pruned, t_starts = prune_kv_caches(tc, 0.5)
    np.testing.assert_array_equal(t_starts.numpy(), np.asarray(j_starts))
    for got, was, ref in zip(t_pruned, tc,
                             convert.states_from_jax(j_pruned)):
        if isinstance(got, A.KVCache):
            assert int(got.length.max()) <= 8
        else:
            assert got is was
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_serving_params_keep_u_in_fp32():
    """The serving copy casts RWKV6's and Mamba2's matrices to the
    activation dtype but keeps ``u`` in fp32, which the reference reads
    in fp32 at any activation dtype; vectors stay as they were."""
    tp = _model("rwkv6")[3]
    sp = serving_params(_model("rwkv6")[1], tp)["layers"][0]
    assert sp["u"].dtype == torch.float32 and torch.equal(
        sp["u"], tp["layers"][0]["u"])
    assert sp["wr"].dtype == torch.bfloat16
    assert sp["w_bias"].dtype == torch.float32
    hp = serving_params(_model("zamba2")[1], _model("zamba2")[3])
    m = hp["stages"][0][0]["mamba"]
    assert m["conv_w"].dtype == m["in_proj"].dtype == torch.bfloat16
    assert m["A_log"].dtype == m["D"].dtype == torch.float32


def test_init_params_draws_the_reference_trees():
    """``init_params`` for ``hybrid`` and ``ssm``: the reference's trees
    (stacked axes as lists) with its shapes, in ``cfg.param_dtype``."""
    for name in VARIANTS:
        jcfg, tcfg, _, conv = _model(name)
        tp = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
        shape = lambda t: (tuple(t.shape), t.dtype)
        assert jax.tree_util.tree_map(shape, tp) == \
            jax.tree_util.tree_map(shape, conv)
        assert tp["embed"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------
_SERVES = {  # name: (continuous, EngineConfig overrides)
    "static": (False, {}),
    "continuous-d1": (True, {}),
    "continuous-d2": (True, dict(pipeline_depth=2)),
    "continuous-prune": (True, dict(kv_prune_keep=0.5, kv_prune_interval=2)),
}
_ENGINE_CASES = [("zamba2", s) for s in _SERVES] + [
    ("rwkv6", s) for s in ("static", "continuous-d1", "continuous-d2")]


def _requests(cls):
    rng = np.random.default_rng(8)
    return [cls(uid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                max_new_tokens=m)
            for i, (n, m) in enumerate(((5, 6), (11, 4), (3, 8), (17, 9),
                                        (8, 7)))]


@pytest.mark.parametrize("name,serve", _ENGINE_CASES)
def test_engine_matches_reference_engine(name, serve):
    """Reduced Zamba2 / RWKV6 at fp32 activations, 5 requests over 3
    slots, every admission a whole-batch re-prefill: the same tokens,
    admit/retire stream, shape ledger, admission prefill tokens and KV
    prunes (which fire in the pruned serve). Depth 2 is held to the
    reference's depth 1 and to the port's depth 1 (``test_torch_lm.py`` on
    why)."""
    continuous, kw = _SERVES[serve]
    jcfg, tcfg, jp, tp = _model(name)
    jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
    j_kw = {k: v for k, v in kw.items() if k != "pipeline_depth"}
    j_eng = JEngine(jcfg, jp, JEC(max_batch=3, max_len=40, **j_kw))
    j_out = j_eng.serve(_requests(JReq), continuous=continuous)
    engines = [ServeEngine(tcfg, tp, EngineConfig(max_batch=3, max_len=40,
                                                  **kw), device="cpu")]
    if "pipeline_depth" in kw:
        engines.append(ServeEngine(tcfg, tp, EngineConfig(
            max_batch=3, max_len=40, **j_kw), device="cpu"))
    for t_eng in engines:
        t_out = t_eng.serve(_requests(Request), continuous=continuous)
        assert t_out == j_out and sorted(t_out) == list(range(5))
        assert list(t_eng.events) == list(j_eng.events)
        assert t_eng.runner.compiled_shapes() == \
            j_eng.runner.compiled_shapes()
        t_st, j_st = t_eng.stats(), j_eng.stats()
        for key in ("admissions", "admission_prefill_tokens", "prune_events",
                    "compile_count", "runner_prefill_slot_calls"):
            assert t_st.get(key, 0) == j_st.get(key, 0), key
        assert (t_st["prune_events"] > 0) == ("prune" in serve)
        assert t_st["runner_prefill_slot_calls"] == 0


def test_launcher_serves_rwkv6_like_the_reference(monkeypatch, capsys):
    """``launch/serve --arch rwkv6-1.6b --device cpu``: the reference's
    admit / retire stream and token counts (the weights differ: each
    package draws its own from the seed); the command line too."""
    kw = dict(num_requests=3, prompt_len=8, max_new=4, continuous=True)
    ref = jserve.serve("rwkv6-1.6b", **kw)
    res = tserve.serve("rwkv6-1.6b", device="cpu", **kw)
    assert res["events"] == ref["events"]
    assert {k: len(v) for k, v in res["outputs"].items()} == {
        k: len(v) for k, v in ref["outputs"].items()}
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "rwkv6-1.6b", "--device", "cpu", "--requests",
        "2", "--max-new", "3", "--continuous", "--json"])
    tserve.main()
    out = capsys.readouterr().out
    assert '"device": "cpu"' in out and '"outputs"' in out


def test_training_still_raises():
    """Every LM family trains now: the SSM and hybrid
    (``test_torch_ssm_train``), the VLM and audio families
    (``test_torch_mm_train``), whose ``make_train_step`` builds. The LM
    step still raises for a family that is no LM: the ViT trains through
    ``make_vit_train_step``."""
    for arch in ("whisper-base", "llama-3.2-vision-90b"):
        tcfg = get_config(arch).reduced()
        assert tcfg.family in ST.TRAIN_FAMILIES
        assert callable(ST.make_train_step(tcfg))
    with pytest.raises(NotImplementedError, match="no LM training step"):
        ST.make_train_step(get_config("deit-small").reduced())
    for name in ("zamba2", "rwkv6"):
        assert _model(name)[1].family in ST.TRAIN_FAMILIES
