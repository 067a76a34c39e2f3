"""The port's VLM and audio families against the reference package, on the
CPU, at the reduced configs: Llama-3.2-Vision-90B reduces to one stage (one
self-attention layer and one gated cross layer, GQA 4:1, Dh 16, 8 vision
tokens), Whisper-base to 2 encoder and 3 decoder layers (4 MHA heads of Dh
16, 32 audio frames, biases).

Weights come from the reference's seeded init, converted by
``convert.lm_params_from_jax``, after two changes to the reference's
params that both sides then share: every cross layer's ``gate`` is set to
1.0 (the reference initializes it to 0, and tanh(0) = 0 would hide the
cross-attention from the logits), and every bias (initialized to 0) is
drawn nonzero (a ``bk``/``bv`` wrongly added to the cross K/V would then
show). Inputs are numpy arrays from a seed. Tolerances are
``tests/test_torch_lm.py``'s: 1e-5 (``OP_TOL``) for attention at fp32,
logits within 1e-3 (``LOGIT_TOL``) at fp32 and 0.05 (``BF16_LOGIT_TOL``)
at bf16, greedy tokens equal at fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import steps as JST

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.optim import AdamW
from repro_torch.serving import EngineConfig, ServeEngine
from repro_torch.tree import flatten_with_path, path_str

OP_TOL = 1e-5
LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 0.05
ARCHS = ("llama-3.2-vision-90b", "whisper-base")
BIASES = ("bq", "bk", "bv", "bo", "bi")
_MODELS = {}
# the reference's forward, compiled once per config, mode and shape
j_forward_lm = jax.jit(JM.forward_lm,
                       static_argnames=("cfg", "mode", "logits_for", "remat"))


def _visible(jp, seed=5):
    """The reference's params with every ``gate`` at 1.0 and every bias
    drawn from N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fix(path, a):
        key = path[-1].key
        if key == "gate":
            return jnp.ones_like(a)
        if key in BIASES:
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fix, jp)


def _model(arch, **changes):
    """(reference cfg, port cfg, reference params, port params) at the
    reduced config (with ``changes``), gates and biases made visible."""
    key = (arch, tuple(sorted(changes.items())))
    if key not in _MODELS:
        jcfg = j_get_config(arch).reduced().replace(**changes)
        tcfg = get_config(arch).reduced().replace(**changes)
        jp = _visible(jax.jit(JM.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0)))
        tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp))
        _MODELS[key] = (jcfg, tcfg, jp, tp)
    return _MODELS[key]


def _modality(cfg, B, rng, n_frames=None):
    """The family's input as a numpy array: vision embeddings [B, Nv, D]
    or audio frames [B, F, D]."""
    n = (cfg.num_vision_tokens if cfg.family == "vlm"
         else n_frames or cfg.num_audio_frames)
    return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)


def _kw(cfg, x, torch_side):
    """``forward_lm``'s modality keyword for ``x`` (numpy)."""
    name = "vision_embeds" if cfg.family == "vlm" else "audio_frames"
    return {name: torch.from_numpy(x) if torch_side else jnp.asarray(x)}


# ---------------------------------------------------------------------------
# configs and converters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_multimodal_configs_match_reference(arch):
    j, t = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())


def _layout(tree):
    return [(path_str(p), tuple(t.shape), t.dtype)
            for p, t in flatten_with_path(tree)]


@pytest.mark.parametrize("arch,changes", [
    ("llama-3.2-vision-90b", {}),
    ("llama-3.2-vision-90b", {"num_layers": 6, "cross_attn_period": 3}),
    ("whisper-base", {})], ids=["vlm", "vlm-2-stages", "audio"])
def test_converter_gives_the_port_layout(arch, changes):
    """``lm_params_from_jax`` gives ``init_params``' tree (paths, shapes,
    dtypes), the gate and the biases as set; ``kv_caches_from_jax`` gives
    ``init_caches``' list (the VLM's [n_stages, n_self] stack stage by
    stage), and for the audio family prefill's pair."""
    jcfg, tcfg, jp, tp = _model(arch, **changes)
    own = M.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert _layout(tp) == _layout(own)
    if arch == "whisper-base":
        assert len(tp["enc_layers"]) == 2 and len(tp["layers"]) == \
            tcfg.num_layers
        np.testing.assert_array_equal(
            tp["layers"][0]["xattn"]["bk"].numpy(),
            np.asarray(jp["layers"]["xattn"]["bk"][0]))
    else:
        n_stages, n_self = M.vlm_layout(tcfg)
        assert [len(s) for s in tp["stages"]["self"]] == [n_self] * n_stages
        assert all(float(c["gate"]) == 1.0 for c in tp["stages"]["cross"])
        np.testing.assert_array_equal(
            tp["stages"]["self"][-1][-1]["attn"]["wq"].numpy(),
            np.asarray(jp["stages"]["self"]["attn"]["wq"][-1, -1]))
    B, S = 2, 12
    jc = jax.jit(JST.init_caches, static_argnums=(0, 1, 2))(jcfg, B, S)
    tc = convert.kv_caches_from_jax(jc)
    assert [_layout(c) for c in tc] == [
        _layout(c) for c in ST.init_caches(tcfg, B, S, device="cpu")]
    if arch == "whisper-base":
        rng = np.random.default_rng(0)
        toks = rng.integers(0, 256, (B, 4)).astype(np.int32)
        x = _modality(jcfg, B, rng)
        out = j_forward_lm(jcfg, jp, jnp.asarray(toks), mode="prefill",
                            caches=jc, **_kw(jcfg, x, False))
        kv, enc = convert.kv_caches_from_jax(out.caches)
        assert len(kv) == tcfg.num_layers
        assert enc.shape == (B, jcfg.num_audio_frames, jcfg.d_model)
        np.testing.assert_array_equal(kv[1].length.numpy(), [4, 4])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def test_noncausal_attention_torch_matches_reference():
    """``flash_attention_torch(causal=False)`` against
    ``flash_attention_jnp(causal=False)`` at Nq != Nk with GQA 4:1, and the
    wrapper's non-causal form on the CPU (bf16 and fp32) equal to it."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 11, 1, 16)).astype(np.float32)
            for _ in range(2))
    ref = JA.flash_attention_jnp(*map(jnp.asarray, (q, k, v)), causal=False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = A.flash_attention_torch(tq, tk, tv, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OP_TOL,
                               rtol=OP_TOL)
    assert torch.equal(flash_attention(tq, tk, tv), got)
    bf = [t.bfloat16() for t in (tq, tk, tv)]
    assert torch.equal(flash_attention(*bf),
                       A.flash_attention_torch(*bf, causal=False))


@pytest.mark.parametrize("kind", ["cross", "encoder"])
def test_attention_block_noncausal_matches_reference(kind):
    """``attention_block`` at fp32: a cross call (``kv_override``, no RoPE,
    Nq = 5 against Nk = 8 vision tokens, GQA 4:1) with the VLM's cross
    layer, and a non-causal self call (RoPE applied, biases) with
    Whisper's first encoder layer."""
    arch = "llama-3.2-vision-90b" if kind == "cross" else "whisper-base"
    jcfg, tcfg, jp, tp = _model(arch)
    jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5 if kind == "cross" else 9, 64)).astype(
        np.float32)
    if kind == "cross":
        jattn = jax.tree_util.tree_map(lambda a: a[0],
                                       jp["stages"]["cross"])["attn"]
        tattn = tp["stages"]["cross"][0]["attn"]
        kv = [rng.standard_normal((2, 8, 1, 16)).astype(np.float32)
              for _ in range(2)]
        ref, _, _ = JA.attention_block(
            jnp.asarray(x), jattn, jcfg, causal=False, use_rope=False,
            kv_override=tuple(map(jnp.asarray, kv)))
        got, cache = A.attention_block(
            torch.from_numpy(x), tattn, tcfg, causal=False, use_rope=False,
            kv_override=tuple(map(torch.from_numpy, kv)))
    else:
        jattn = jax.tree_util.tree_map(lambda a: a[0],
                                       jp["enc_layers"])["attn"]
        tattn = tp["enc_layers"][0]["attn"]
        ref, _, _ = JA.attention_block(jnp.asarray(x), jattn, jcfg,
                                       causal=False)
        got, cache = A.attention_block(torch.from_numpy(x), tattn, tcfg,
                                       causal=False)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OP_TOL,
                               rtol=OP_TOL)


# ---------------------------------------------------------------------------
# forward_lm
# ---------------------------------------------------------------------------
def _forward_steps(arch, dtype):
    """Train-mode logits of 2 rows, then a left-padded prefill of 3 rows
    and 3 teacher-forced decodes, in both packages. Returns (reference
    logits, port logits), one pair per step."""
    jcfg, tcfg, jp, tp = _model(arch)
    jcfg, tcfg = (c.replace(dtype=dtype) for c in (jcfg, tcfg))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (2, 7)).astype(np.int32)
    x = _modality(jcfg, 2, rng)
    jo = j_forward_lm(jcfg, jp, jnp.asarray(toks), mode="train",
                       remat=False, **_kw(jcfg, x, False))
    to = M.forward_lm(tcfg, tp, torch.from_numpy(toks), **_kw(tcfg, x, True))
    steps = [(np.asarray(jo.logits), to.logits.numpy())]
    B, Lp, S = 3, 10, 16
    toks = rng.integers(0, 256, (B, Lp)).astype(np.int32)
    start = np.array([0, 4, 7], np.int32)
    x = _modality(jcfg, B, rng)
    dec = rng.integers(0, 256, (3, B)).astype(np.int32)
    vis = jcfg.family == "vlm"
    jo = j_forward_lm(jcfg, jp, jnp.asarray(toks), mode="prefill",
                       caches=JST.init_caches(jcfg, B, S), logits_for="last",
                       valid_start=jnp.asarray(start), **_kw(jcfg, x, False))
    to = M.forward_lm(tcfg, tp, torch.from_numpy(toks), mode="prefill",
                      caches=ST.init_caches(tcfg, B, S, device="cpu"),
                      logits_for="last", valid_start=torch.from_numpy(start),
                      **_kw(tcfg, x, True))
    steps.append((np.asarray(jo.logits), to.logits.numpy()))
    for t in dec:
        jo = j_forward_lm(jcfg, jp, jnp.asarray(t)[:, None], mode="decode",
                           caches=jo.caches, valid_start=jnp.asarray(start),
                           **(_kw(jcfg, x, False) if vis else {}))
        to = M.forward_lm(tcfg, tp, torch.from_numpy(t)[:, None],
                          mode="decode", caches=to.caches,
                          valid_start=torch.from_numpy(start),
                          **(_kw(tcfg, x, True) if vis else {}))
        steps.append((np.asarray(jo.logits), to.logits.numpy()))
    return steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_matches_reference(arch, dtype):
    """``forward_lm`` in train, prefill and decode modes."""
    for ref, got in _forward_steps(arch, dtype):
        assert got.dtype == np.float32 and got.shape == ref.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=0)
            np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        else:
            assert np.abs(got - ref).max() <= BF16_LOGIT_TOL


def test_audio_frames_past_the_table_and_gate_matter():
    """More audio frames than ``enc_pos`` holds tile the table, as in the
    reference; the cross-attention reaches the logits (a gate of 0 or
    other frames change them)."""
    jcfg, tcfg, jp, tp = _model("whisper-base")
    jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (1, 6)).astype(np.int32)
    x = _modality(jcfg, 1, rng, n_frames=45)
    ref = j_forward_lm(jcfg, jp, jnp.asarray(toks), remat=False,
                        **_kw(jcfg, x, False)).logits
    got = M.forward_lm(tcfg, tp, torch.from_numpy(toks),
                       **_kw(tcfg, x, True)).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_TOL,
                               rtol=0)
    other = M.forward_lm(tcfg, tp, torch.from_numpy(toks),
                         **_kw(tcfg, x[:, ::-1].copy(), True)).logits
    assert (other - got).abs().max() > 10 * LOGIT_TOL
    vcfg, vp = _model("llama-3.2-vision-90b")[1::2]
    vcfg = vcfg.replace(dtype="float32")
    v = _modality(vcfg, 1, rng)
    on = M.forward_lm(vcfg, vp, torch.from_numpy(toks), **_kw(vcfg, v, True))
    shut = dict(vp, stages=dict(vp["stages"], cross=[
        dict(c, gate=torch.zeros(())) for c in vp["stages"]["cross"]]))
    off = M.forward_lm(vcfg, shut, torch.from_numpy(toks),
                       **_kw(vcfg, v, True))
    assert (on.logits - off.logits).abs().max() > 10 * LOGIT_TOL


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_greedy_tokens_match_reference(arch):
    """``make_prefill`` over left-padded prompts (``valid_start``) with the
    modality input, then ``make_decode_step`` greedily: 8 tokens per row
    equal to the reference's steps at fp32."""
    jcfg, tcfg, jp, tp = _model(arch)
    jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
    rng = np.random.default_rng(4)
    lens = (3, 6, 9)
    B, Lp, S, n_new = len(lens), max(lens), max(lens) + 8, 8
    toks = np.zeros((B, Lp), np.int32)
    for b, n in enumerate(lens):
        toks[b, Lp - n:] = rng.integers(0, 256, n)
    start = np.array([Lp - n for n in lens], np.int32)
    x = _modality(jcfg, B, rng)
    name = "vision_embeds" if arch != "whisper-base" else "audio_frames"
    vis = arch != "whisper-base"
    j_pre = jax.jit(JST.make_prefill(jcfg))
    j_dec = jax.jit(JST.make_decode_step(jcfg))
    t_pre, t_dec = ST.make_prefill(tcfg), ST.make_decode_step(tcfg)
    jt, jc = j_pre(jp, {"tokens": jnp.asarray(toks),
                        "valid_start": jnp.asarray(start),
                        name: jnp.asarray(x)}, JST.init_caches(jcfg, B, S))
    tt, tc = t_pre(tp, {"tokens": torch.from_numpy(toks),
                        "valid_start": torch.from_numpy(start),
                        name: torch.from_numpy(x)},
                   ST.init_caches(tcfg, B, S, device="cpu"))
    if not vis:
        assert isinstance(tc, tuple) and len(tc[0]) == tcfg.num_layers
    j_out, t_out = [np.asarray(jt)], [tt.numpy()]
    for _ in range(n_new - 1):
        jt, jc = j_dec(jp, jnp.asarray(j_out[-1])[:, None], jc,
                       vision_embeds=jnp.asarray(x) if vis else None,
                       valid_start=jnp.asarray(start))
        tt, tc = t_dec(tp, torch.from_numpy(t_out[-1])[:, None], tc,
                       vision_embeds=torch.from_numpy(x) if vis else None,
                       valid_start=torch.from_numpy(start))
        j_out.append(np.asarray(jt))
        t_out.append(tt.numpy())
    np.testing.assert_array_equal(np.stack(t_out), np.stack(j_out))
    assert len({tuple(r) for r in np.stack(t_out).T}) > 1


# ---------------------------------------------------------------------------
# the wrapper's routing on the card, and refusals
# ---------------------------------------------------------------------------
class _FakeLibrary:
    """Stands in for a kernel library: records each entry point's call."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("Nq", [1, 7])
def test_bf16_noncausal_routes_to_the_causal_kernels(monkeypatch, Nq):
    """With ``backend.on_card`` patched true, a bf16 non-causal call
    launches the decode entry point (one query row) or the prefill entry
    point (more) with its ``causal`` argument 0, no probabilities, no
    bounds and the host's split of the keys, and counts under
    the entry point and under its non-causal form; the plain version never
    stands in."""
    def refused(*a, **kw):
        raise AssertionError("the plain version ran on the card")
    calls = []
    monkeypatch.setattr(backend, "on_card", lambda *ts: True)
    monkeypatch.setattr(backend, "library", lambda name: _FakeLibrary(calls))
    monkeypatch.setattr(backend, "_FNS", {})
    monkeypatch.setattr(backend, "current_stream", lambda dev: 0)
    monkeypatch.setattr(FA, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(FA, "attention_noncausal_plain", refused)
    monkeypatch.setattr(A, "flash_attention_torch", refused)
    backend.reset_launches()
    q = torch.zeros((2, Nq, 8, 16), dtype=torch.bfloat16)
    kv = torch.zeros((2, 70, 2, 16), dtype=torch.bfloat16)
    o = flash_attention(q, kv, kv)
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    (entry, args), = calls
    assert args[3:6] == (None, None, None)  # q_offset, kv_len, kv_start
    assert args[7] is None  # the decode row's probs, the prefill's lse
    assert args[-1] == 0  # the stream
    if Nq == 1:  # ..., part, arrivals, B, S, Hq, KV, Dh, n_split, causal,
        # scale (no scratch: the splits combine in a cluster)
        assert entry == "flash_decode_bf16"
        assert args[8:10] == (None, None)
        assert args[10:18] == (2, 70, 8, 2, 16, 2, 0, 0.25)
    else:  # ..., B, Nq, S, Hq, KV, Dh, causal, warpgroups, key chunks
        # (28 rows a (b, g) on 132 SMs: one warpgroup, the 2 key tiles in
        # 2 chunks), scale
        assert entry == "flash_prefill_bf16"
        assert args[8:18] == (2, Nq, 70, 8, 2, 16, 0, 1, 2, 0.25)
    form = "flash_decode_bf16/noncausal" if Nq == 1 else \
        "flash_prefill_bf16/noncausal"
    assert backend.launches()[entry] == 1
    assert backend.form_launches() == {f: int(f == form)
                                       for f in backend.FORMS}
    backend.reset_launches()
    assert not any(backend.form_launches().values())


@pytest.mark.parametrize("what", ["grad_decode", "grad_kv_len", "head_dim",
                                  "fp32", "kv_len", "scores"])
def test_bf16_noncausal_raises_before_any_launch(monkeypatch, what):
    """On the card the non-causal GQA form raises, before any launch and
    without the plain version, on what its kernels do not take: a gradient
    of the decode form (one query row: no training path decodes), a
    gradient with a ``kv_len``, a head width the kernels are not built
    for, fp32 operands, a ``kv_len`` or scores."""
    def refused(*a, **kw):
        raise AssertionError("launched or fell back")
    monkeypatch.setattr(backend, "on_card", lambda *ts: True)
    monkeypatch.setattr(backend, "launch", refused)
    monkeypatch.setattr(FA, "attention_noncausal_plain", refused)
    Dh = 32 if what == "head_dim" else 16
    dt = torch.float32 if what == "fp32" else torch.bfloat16
    q = torch.zeros((1, 1 if what == "grad_decode" else 3, 4, Dh), dtype=dt,
                    requires_grad=what.startswith("grad"))
    kv = torch.zeros((1, 9, 1, Dh), dtype=dt)
    kw = {"kv_len": torch.tensor([5], dtype=torch.int32)} \
        if what.endswith("kv_len") else {"collect_scores": what == "scores"}
    err = {"grad_decode": "Nq > 1", "grad_kv_len": "no kv_len",
           "head_dim": "head_dim", "fp32": "bf16", "kv_len": "no kv_len",
           "scores": "no kv_len"}[what]
    with pytest.raises((ValueError, TypeError), match=err):
        flash_attention(q, kv, kv, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_and_training_still_raises(arch):
    """``ServeEngine`` (whose runner feeds prefill tokens only, as the
    reference's does) and ``launch/serve`` refuse the two families up front;
    their training now runs: ``make_train_step`` builds a step that takes
    one on the CPU with the batch's modality input, and ``launch/train``
    trains a step."""
    _, tcfg, _, tp = _model(arch)
    need = "vision_embeds" if arch != "whisper-base" else "audio_frames"
    with pytest.raises(NotImplementedError, match=need):
        ServeEngine(tcfg, tp, EngineConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match=need):
        tserve.serve(arch, device="cpu")
    opt = AdamW(lr=1e-3)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, tcfg.vocab_size, (2, 8))), need: torch.from_numpy(
        _modality(tcfg, 2, rng))}
    params, _, _, metrics = ST.make_train_step(tcfg, opt)(
        tp, opt.init(tp), batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    out = ttrain.train(arch, steps=1, batch=2, seq=16, device="cpu")
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
