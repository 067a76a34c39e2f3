"""Training the VLM and audio families in the port, against the reference
package on the CPU, at the reduced configs with fp32 activations:
Llama-3.2-Vision-90B reduces to one stage (one self-attention layer and one
gated cross layer, GQA 4:1, Dh 16, 8 vision tokens), Whisper-base to 2
encoder and 3 decoder layers (4 MHA heads of Dh 16, 32 audio frames,
biases).

Weights come from the reference's seeded init, converted by
``convert.lm_params_from_jax``, with every cross layer's ``gate`` set to
``GATE`` (1.0; the reference initializes it to 0, where tanh(0) = 0 keeps
the cross-attention's gradient at exactly zero) or left at 0; batches are
``synthetic_lm_batch`` (bit-identical in both packages, the modality input
included). Tolerances:

* the plain non-causal backward (``attention_noncausal_bwd_plain``) and
  log-sum-exp against ``torch.autograd`` of ``attention_noncausal_plain``
  and ``torch.logsumexp`` over the GQA-repeated keys, at fp32: within 1e-5
  of max(1, max|autograd|) (fp32 sums in another order).
* ``lm_loss`` within 1e-5 of max(1, |ref|); each gradient leaf of
  ``make_grad_fn`` within 1e-4 of its largest |jax.grad| element, where
  that element is at least 1e-3 of the largest of any leaf, else within
  1e-4 of that floor (fp32 sums over layers in other orders), the bounds
  of ``tests/test_torch_ssm_train.py``.
* params after two ``make_train_step`` steps within 0.25 x lr of max(1,
  |ref|), those of the dense LM, except where a
  step's gradient lies within the gradient bound of zero (the test's
  docstring says why).
* the routing as on the card and a resumed launcher run: EQUAL.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import DataConfig as JDataConfig
from repro.data import pipeline as JDP
from repro.models import model as JM
from repro.models import steps as JST
from repro.optim import AdamW as JAdamW

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, synthetic_lm_batch
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import (
    attention_noncausal_bwd_plain,
    attention_noncausal_lse_plain, attention_noncausal_plain,
    flash_attention)
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch import train as LT
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.optim import AdamW
from repro_torch.tree import flatten_with_path, leaves

OP_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 0.25  # x lr
NOISE_TOL = 6.0  # x lr, at elements whose gradient is within GRAD_TOL of 0
GATE = 1.0
ARCHS = ("llama-3.2-vision-90b", "whisper-base")
_MODELS = {}


def _model(arch, gate):
    """(reference cfg, port cfg, reference params) at the reduced config,
    fp32 activations, every cross layer's gate at ``gate``; built once."""
    key = (arch, gate)
    if key not in _MODELS:
        jcfg = j_get_config(arch).reduced().replace(dtype="float32")
        tcfg = get_config(arch).reduced().replace(dtype="float32")
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        if jcfg.family == "vlm":
            cross = dict(jp["stages"]["cross"])
            cross["gate"] = jnp.full_like(cross["gate"], gate)
            jp = {**jp, "stages": {**jp["stages"], "cross": cross}}
        _MODELS[key] = (jcfg, tcfg, jp)
    return _MODELS[key]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tparams(jp):
    return convert.lm_params_from_jax(_np(jp))


def _batch(jcfg, batch=2, seq=16, step=0):
    """``synthetic_lm_batch`` as numpy: tokens and the family's input (the
    audio family's tokens are seq / 8, at least 8)."""
    shape = JShapeConfig("t", seq, batch, "train")
    return JDP.synthetic_lm_batch(jcfg, shape, JDataConfig(seed=0), step)


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(1.0, np.abs(ref).max()))


def _pairs(t_tree, ref_tree):
    ref = dict(flatten_with_path(ref_tree))
    out = [(path, a, ref[path]) for path, a in flatten_with_path(t_tree)]
    assert len(out) == len(ref)
    return out


# ---------------------------------------------------------------------------
# the plain non-causal log-sum-exp and backward
# ---------------------------------------------------------------------------
PLAIN_CASES = [  # B, Nq, Nk, Hq, KV, Dh: Nq != Nk, GQA 8:1, ragged lengths
    (2, 5, 33, 8, 1, 16), (1, 70, 65, 8, 1, 16), (2, 9, 130, 16, 2, 64),
    (1, 64, 17, 4, 4, 64), (1, 3, 100, 8, 1, 128), (2, 66, 40, 16, 2, 128)]


@pytest.mark.parametrize("case", PLAIN_CASES,
                         ids=lambda c: "B{}-Nq{}-Nk{}-{}x{}-Dh{}".format(*c))
def test_plain_noncausal_lse_and_bwd_match_autograd(case):
    """``attention_noncausal_lse_plain`` against ``torch.logsumexp`` over
    the keys repeated to every query head, and
    ``attention_noncausal_bwd_plain`` against autograd of
    ``attention_noncausal_plain``, on the same o, dO and lse."""
    B, Nq, Nk, Hq, KV, Dh = case
    rng = np.random.default_rng(sum(case))
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    q, k, v = t(B, Nq, Hq, Dh), t(B, Nk, KV, Dh), t(B, Nk, KV, Dh)
    do = t(B, Nq, Hq, Dh)
    leaves_ = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = attention_noncausal_plain(*leaves_)
    want = torch.autograd.grad(o, leaves_, do)
    kr = k.repeat_interleave(Hq // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) * Dh ** -0.5
    lse = attention_noncausal_lse_plain(q, k)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Nq)
    assert _rel(lse.numpy(), torch.logsumexp(s, dim=-1).numpy()) <= OP_TOL
    got = attention_noncausal_bwd_plain(q, k, v, o.detach(), do, lse)
    for a, w, x in zip(got, want, (q, k, v)):
        assert a.dtype == x.dtype and a.shape == x.shape
        assert _rel(a.numpy(), w.numpy()) <= OP_TOL


# ---------------------------------------------------------------------------
# the loss and its gradients, and the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gate", [GATE, 0.0], ids=["gate1", "gate0"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_reference(arch, gate):
    """``jax.grad`` of the reference's ``lm_loss`` (its remat on) against
    ``make_grad_fn`` (full remat: the VLM's stages, Whisper's decoder
    layers), with the modality input from the batch. At gate 0 the cross
    layers' attention gets exactly zero gradient in both."""
    jcfg, tcfg, jp = _model(arch, gate)
    b = _batch(jcfg)
    ref_loss, jg = jax.value_and_grad(
        lambda p: JM.lm_loss(jcfg, p, {k: jnp.asarray(v)
                                        for k, v in b.items()})[0])(jp)
    loss, parts, g = ST.make_grad_fn(tcfg)(
        _tparams(jp), {k: torch.from_numpy(v) for k, v in b.items()})
    assert sorted(parts) == ["aux", "ce"] and float(parts["aux"]) == 0.0
    assert abs(float(loss) - float(ref_loss)) <= \
        LOSS_TOL * max(1.0, abs(float(ref_loss)))
    pairs = _pairs(g, _tparams(jg))
    floor = 1e-3 * max(np.abs(r.numpy()).max() for _, _, r in pairs)
    for path, a, r in pairs:
        r = r.numpy()
        assert np.abs(a.numpy() - r).max() <= \
            GRAD_TOL * max(np.abs(r).max(), floor), path
    if arch != "whisper-base":
        cross = g["stages"]["cross"][0]["attn"]
        assert bool((cross["wk"] == 0).all()) == (gate == 0.0)
        assert float(g["stages"]["cross"][0]["gate"]) != 0.0


@pytest.mark.parametrize("arch", ARCHS + ("stablelm-1.6b",))
def test_grad_fn_zero_fills_only_the_cross_kv_biases(arch):
    """``make_grad_fn`` gives the cross layers' ``bk`` / ``bv``, which the
    loss never reaches (Whisper's; Llama-Vision has no biases), a zero
    gradient, as ``jax.grad`` does, and raises on any other leaf the loss
    does not reach, in every family."""
    cfg = get_config(arch).reduced().replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    host = synthetic_lm_batch(cfg, ShapeConfig("t", 16, 2, "train"),
                              DataConfig(), 0)
    b = {k: torch.from_numpy(v) for k, v in host.items()}
    grad_fn = ST.make_grad_fn(cfg)
    _, _, g = grad_fn(params, b)
    unused = [(path, d) for path, d in flatten_with_path(g)
              if path[-1] in ("bk", "bv")
              and ("xattn" in path or "cross" in path)]
    assert len(unused) == (2 * cfg.num_layers if arch == "whisper-base"
                           else 0)
    assert all(not d.any() for _, d in unused)
    with pytest.raises(RuntimeError):
        grad_fn({**params, "stray": torch.zeros(3)}, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_over_two_steps(arch):
    """Two ``make_train_step`` steps from the same state (no pruning: both
    families' configs have none) against the reference's jitted step:
    metrics per step, then every param. At lr 1e-3 an element moves by
    about lr whatever its gradient's size, so where the
    reference's gradient at a step lies within the gradient test's bound of
    zero (``GRAD_TOL`` x its leaf's largest) its sign, and the direction of
    that step, is the sums' rounding: such elements are held to
    ``NOISE_TOL`` x lr (each of the two steps moving up to lr the other
    way, with AdamW's second step up to twice that), the rest to
    ``ADAM_TOL`` x lr."""
    lr = 1e-3
    jcfg, tcfg, jp = _model(arch, GATE)
    jopt, topt = JAdamW(lr=lr), AdamW(lr=lr)
    jstep = jax.jit(JST.make_train_step(jcfg, jopt))
    tstep = ST.make_train_step(tcfg, topt)
    rp, rst = jp, jopt.init(jp)
    tp = _tparams(jp)
    tst = topt.init(tp)
    noise = None
    for step in range(2):
        b = _batch(jcfg, step=step)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g = _tparams(jax.grad(lambda p: JM.lm_loss(jcfg, p, jb)[0])(rp))
        small = {path: np.abs(r.numpy()) <= GRAD_TOL * np.abs(r.numpy()).max()
                 for path, r in flatten_with_path(g)}
        noise = small if noise is None else {
            p: noise[p] | small[p] for p in small}
        rp, _, rst, rm = jstep(rp, rst, jb, None)
        tp, ts, tst, tm = tstep(tp, tst, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        assert ts is None
        for k in ("loss", "ce", "aux"):
            assert abs(float(tm[k]) - float(rm[k])) <= \
                LOSS_TOL * max(1.0, abs(float(rm[k]))), (step, k)
    assert int(tst.step) == 2
    for path, a, r in _pairs(tp, _tparams(rp)):
        a, r = a.numpy(), r.numpy()
        quiet = ~noise[path]
        if quiet.any():
            assert _rel(a[quiet], r[quiet]) <= ADAM_TOL * lr, path
        assert _rel(a, r) <= NOISE_TOL * lr, path


def test_vlm_stage_is_one_checkpoint(monkeypatch):
    """In train mode with grad the VLM checkpoints each whole stage (its
    self-attention layers and its cross layer), as the reference's remat
    does; without grad, and at prefill, it runs the stage as it is."""
    _, tcfg, jp = _model("llama-3.2-vision-90b", GATE)
    b = _batch(tcfg)
    calls = []
    real = M.checkpoint

    def spy(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)
    tp = _tparams(jp)
    tokens = torch.from_numpy(b["tokens"])
    vis = torch.from_numpy(b["vision_embeds"])
    monkeypatch.setattr(M, "checkpoint", spy)
    with torch.no_grad():
        M.forward_lm(tcfg, tp, tokens, vision_embeds=vis)
    assert calls == []
    M.lm_loss(tcfg, tp, {"tokens": tokens, "vision_embeds": vis})
    n_stages = M.vlm_layout(tcfg)[0]
    assert calls.count("_vlm_stage") == n_stages
    assert "_lm_layer" not in calls and "_cross_layer" not in calls


# ---------------------------------------------------------------------------
# the routing on the card
# ---------------------------------------------------------------------------
def _route_as_on_card(monkeypatch):
    """``flash_attention``'s module routed as on the card: ``on_card``
    true, ``launch`` recording (entry point, its arguments, form) instead
    of launching, 132 SMs; every plain attention refused. Returns the
    record."""
    calls = []

    def refused(*a, **k):
        raise AssertionError("a plain attention ran on a card tensor")

    def launch(lib, entry, dev, *args, form=None):
        calls.append((entry, args, form))
    monkeypatch.setattr(FA, "backend", types.SimpleNamespace(
        on_card=lambda *t: True, launch=launch, aligned=backend.aligned))
    monkeypatch.setattr(FA, "_sm_count", lambda dev: 132)
    for name in ("attention_noncausal_plain", "attention_causal_plain",
                 "attention_plain"):
        monkeypatch.setattr(FA, name, refused)
    monkeypatch.setattr(A, "flash_attention_torch", refused)
    return calls


@pytest.mark.parametrize("shape", [((2, 7, 8, 16), (2, 70, 1, 16)),
                                   ((1, 65, 8, 128), (1, 33, 8, 128))],
                         ids=["Dh16-gqa8", "Dh128-mha"])
def test_noncausal_grad_launches_forward_and_backward_once(monkeypatch,
                                                           shape):
    """A bf16 non-causal call whose input requires grad takes
    ``NonCausalGQAAttention``: one ``flash_prefill_bf16`` launch with
    ``causal`` 0 and an lse buffer [B, Hq, Nq], counted under its form,
    then, on the backward, one ``flash_prefill_bwd_bf16`` launch with
    ``causal`` 0, that lse, no kv_start and a scratch of Nq rounded up to
    64 positions, counted under ``flash_prefill_bwd_bf16/noncausal``; no
    plain version runs."""
    calls = _route_as_on_card(monkeypatch)
    q_shape, kv_shape = shape
    B, Nq, Hq, Dh = q_shape
    Nk, KV = kv_shape[1], kv_shape[2]
    q = torch.zeros(q_shape, dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.zeros(kv_shape, dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    o = flash_attention(q, k, v)
    assert o.grad_fn is not None and \
        "NonCausalGQAAttention" in type(o.grad_fn).__name__
    (entry, args, form), = calls
    assert entry == "flash_prefill_bf16"
    assert form == "flash_prefill_bf16/noncausal"
    assert args[3:6] == (None, None, None) and args[7] is not None
    assert args[8:15] == (B, Nq, Nk, Hq, KV, Dh, 0)
    lse = o.grad_fn.saved_tensors[4]
    assert lse.shape == (B, Hq, Nq) and lse.dtype == torch.float32
    assert args[7] == lse.data_ptr()
    torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
    assert len(calls) == 2
    entry, args, form = calls[1]
    assert entry == "flash_prefill_bwd_bf16"
    assert form == "flash_prefill_bwd_bf16/noncausal"
    assert args[5] == lse.data_ptr() and args[6] is None
    assert args[11:18] == (B, Nq, Nk, Hq, KV, Dh, 0)
    assert args[18] == Dh ** -0.5
    assert FA.bwd_scratch_shape(B, Hq, Nq) == (2, B, Hq,
                                               -(-Nq // 64) * 64)


def test_causal_grad_takes_head_dim_128(monkeypatch):
    """The causal form with a gradient at Dh 128 (Llama-3.2-Vision's
    self-attention) launches the forward with lse and
    ``flash_prefill_bwd_bf16`` with ``causal`` 1, counted under no form."""
    calls = _route_as_on_card(monkeypatch)
    q = torch.zeros((1, 70, 8, 128), dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.zeros((1, 70, 2, 128), dtype=torch.bfloat16)
    o = flash_attention(q, kv, kv, causal=True)
    torch.autograd.grad(o, q, torch.ones_like(o))
    assert [(e, f) for e, _, f in calls] == [("flash_prefill_bf16", None),
                                             ("flash_prefill_bwd_bf16", None)]
    assert calls[1][1][11:18] == (1, 70, 70, 8, 2, 128, 1)


def mm_step_launches(cfg):
    """The attention launches of one training gradient, by (entry point,
    form): under full remat every checkpointed attention's forward runs
    twice (forward and recompute) and its backward once. The VLM: per
    stage its causal self-attention layers and its cross layer; Whisper:
    the encoder's non-causal self-attention (not checkpointed) once, each
    decoder layer's causal self-attention and non-causal cross-attention
    twice."""
    fwd, bwd = "flash_prefill_bf16", "flash_prefill_bwd_bf16"
    nc_fwd, nc_bwd = f"{fwd}/noncausal", f"{bwd}/noncausal"
    if cfg.family == "vlm":
        n_stages, n_self = M.vlm_layout(cfg)
        causal = cross = n_stages
        causal *= n_self
        return {(fwd, None): 2 * causal, (bwd, None): causal,
                (fwd, nc_fwd): 2 * cross, (bwd, nc_bwd): cross}
    L, E = cfg.num_layers, cfg.encoder_layers
    return {(fwd, None): 2 * L, (bwd, None): L,
            (fwd, nc_fwd): 2 * L + E, (bwd, nc_bwd): L + E}


@pytest.mark.parametrize("arch", ARCHS)
def test_training_gradient_launches_the_kernel_pairs(monkeypatch, arch):
    """One ``make_grad_fn`` gradient at bf16 activations with attention
    routed as on the card launches exactly ``mm_step_launches``: every
    attention on the path, both directions, through its kernel."""
    _, tcfg, jp = _model(arch, GATE)
    cfg = tcfg.replace(dtype="bfloat16")
    calls = _route_as_on_card(monkeypatch)
    b = _batch(cfg)
    ST.make_grad_fn(cfg)(_tparams(jp), {k: torch.from_numpy(v)
                                        for k, v in b.items()})
    got = {}
    for entry, _, form in calls:
        got[(entry, form)] = got.get((entry, form), 0) + 1
    assert got == mm_step_launches(cfg)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_and_exact_resume(tmp_path, capsys, arch):
    """The CLI trains the family's reduced config on the CPU (Whisper-base:
    2 encoder and 3 decoder layers; the VLM: one stage of one
    self-attention and one gated cross layer); a run stopped after 2 of 3
    steps and resumed from its checkpoint gives the losses and the state of
    the same 3 steps uninterrupted."""
    out = LT.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                   "--batch", "2", "--seq", "16"])
    p = out["state"]["params"]
    if arch == "whisper-base":
        assert (len(p["enc_layers"]), len(p["layers"])) == (2, 3)
    else:
        assert [len(s) for s in p["stages"]["self"]] == [1]
    assert len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert "final loss" in capsys.readouterr().out
    kw = dict(batch=2, seq=16, device="cpu")
    whole = LT.train(arch, steps=3, **kw)
    ck = str(tmp_path / "ck")
    first = LT.train(arch, steps=2, ckpt_dir=ck, checkpoint_every=1, **kw)
    again = LT.train(arch, steps=3, ckpt_dir=ck, checkpoint_every=1, **kw)
    assert (2, "restored") in again["events"]
    assert first["losses"] + again["losses"] == whole["losses"]
    for key in ("params", "opt"):
        for a, b in zip(leaves(again["state"][key]),
                        leaves(whole["state"][key])):
            assert torch.equal(a, b)


def test_train_config_cuts():
    """``launch/train``'s configs: ``--full`` trains Whisper-base uncut and
    Llama-3.2-Vision-90B at full width cut to ``CARD_CUTS`` (2 layers, one
    self-attention and one gated cross layer); the default is the reduced
    config."""
    assert LT.train_config("whisper-base", reduced=False) == \
        get_config("whisper-base")
    full = get_config("llama-3.2-vision-90b")
    v = LT.train_config("llama-3.2-vision-90b", reduced=False)
    assert v == full.replace(num_layers=2, cross_attn_period=2)
    assert (v.d_model, v.num_heads, v.num_kv_heads, v.d_ff) == \
        (full.d_model, full.num_heads, full.num_kv_heads, full.d_ff)
    assert M.vlm_layout(v) == (1, 1)
    assert LT.train_config("llama-3.2-vision-90b") == full.reduced()
