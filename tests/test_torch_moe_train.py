"""The port's MoE training against the reference package, on the CPU, at the
reduced MoE configs (3 layers, D=64, head_dim 16, vocab 256, 4 experts
top-2, a 128-wide shared expert): Granite-MoE-3B-A800M (GQA 4:1) and
Qwen2-MoE-A2.7B (MHA), both at ``dtype="float32"``, at the reduced
capacity factor 8.0 (no pair dropped) and at 1.0 (pairs dropped).

Weights and scores come from the reference's seeded init and are
converted (``convert.lm_params_from_jax`` / ``lm_scores_from_jax``, which
splits the reference's ``[L, E, n]`` expert scores into one ``[E, n]``
entry per layer); batches are ``synthetic_lm_batch`` (bit-identical in both
packages); other inputs numpy arrays from a seed. Tolerances, as in
``test_torch_lm_train.py``:

* the loss within 1e-5 relative to max(1, |ref|), each gradient leaf
  within 1e-4 of its largest |ref| element (fp32 sums over three layers,
  rounded in other orders; measured 3e-6);
* params and scores after one ``make_train_step``, relative to max(1,
  |ref|): 0.25·lr at the paper's eps, 1e-5 at lr = eps = 1;
* masks (per-expert top-k), the remat policies and the in-place AdamW
  against the functional one: EQUAL.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import block_pruning as JBP
from repro.data import DataConfig as JDataConfig
from repro.data import pipeline as JDP
from repro.models import model as JM
from repro.models import pruning_glue as JPG
from repro.models import steps as JST
from repro.optim import AdamW as JAdamW

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import block_pruning as BP
from repro_torch.launch import train as LT
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import pruning_glue as PG
from repro_torch.models import steps as ST
from repro_torch.optim import AdamW, adamw
from repro_torch.tree import flatten_with_path, leaves, tree_map

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 0.25   # x lr
LINEAR_TOL = 1e-5  # lr = eps = 1
ARCHS = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b")
PRUNE = dict(block_size=16, r_b=0.5, r_t=1.0)  # launch/train's --prune
_MODELS = {}


def _model(arch, prune=False):
    """(reference cfg, port cfg, reference params, reference scores or
    None), at the reduced config with fp32 activations; built once."""
    key = (arch, prune)
    if key not in _MODELS:
        jcfg = j_get_config(arch).reduced().replace(dtype="float32")
        tcfg = get_config(arch).reduced().replace(dtype="float32")
        if prune:
            jcfg = jcfg.replace(pruning=type(jcfg.pruning)(**PRUNE))
            tcfg = tcfg.replace(pruning=type(tcfg.pruning)(**PRUNE))
        k = jax.random.PRNGKey(0)
        jp = JM.init_params(jcfg, k)
        js = JPG.init_scores(jcfg, jp, jax.random.fold_in(k, 7)) \
            if prune else None
        _MODELS[key] = (jcfg, tcfg, jp, js)
    return _MODELS[key]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tparams(jp):
    return convert.lm_params_from_jax(_np(jp))


def _batch(jcfg, batch=2, seq=16, step=0):
    shape = JShapeConfig("t", seq, batch, "train")
    return JDP.synthetic_lm_batch(jcfg, shape, JDataConfig(seed=0), step)


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(1.0, np.abs(ref).max()))


def _pairs(t_tree, ref_tree):
    """(path, port leaf, reference leaf) over two trees of one layout."""
    ref = dict(flatten_with_path(ref_tree))
    out = [(path, a, ref[path]) for path, a in flatten_with_path(t_tree)]
    assert len(out) == len(ref)
    return out


def _dropped(monkeypatch, fn):
    """Run ``fn()`` recording every ``moe.route``; returns (fn's result,
    real (token, expert) pairs dropped over the calls)."""
    seen, route = [], MOE.route

    def recorded(*a, **kw):
        r = route(*a, **kw)
        seen.append(int((~r.kept).sum()))
        return r
    monkeypatch.setattr(MOE, "route", recorded)
    try:
        return fn(), sum(seen)
    finally:
        monkeypatch.setattr(MOE, "route", route)


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["no-drop", "drops"])
def test_lm_loss_gradients_match_reference(monkeypatch, arch, cf):
    """``jax.grad`` of the reference's ``lm_loss`` (CE plus 0.01 x the aux,
    its remat on) against ``make_grad_fn`` (full remat): the router's
    gradient through the gates and the aux's ``probs.mean(0)``, the banks'
    through the kept pairs; at capacity factor 1.0 pairs drop and pass 0."""
    jcfg, tcfg, jp, _ = _model(arch)
    jcfg, tcfg = (c.replace(moe_capacity_factor=cf) for c in (jcfg, tcfg))
    b = _batch(jcfg)
    ref_loss, jg = jax.jit(jax.value_and_grad(lambda p: JM.lm_loss(
        jcfg, p, {"tokens": jnp.asarray(b["tokens"])})[0]))(jp)
    (loss, parts, g), dropped = _dropped(monkeypatch, lambda: ST.make_grad_fn(
        tcfg, with_pruning=False)(_tparams(jp), {
            "tokens": torch.from_numpy(b["tokens"])}))
    assert (dropped > 0) == (cf == 1.0)
    assert float(parts["aux"]) > 0
    ref_loss = float(ref_loss)
    assert abs(float(loss) - ref_loss) <= LOSS_TOL * max(1.0, ref_loss)
    for path, a, r in _pairs(g, _tparams(jg)):
        r = r.numpy()
        assert np.abs(a.numpy() - r).max() <= GRAD_TOL * np.abs(r).max(), \
            path
        if path[-1] == "router" or "moe" in path:
            assert np.abs(r).max() > 0, path


def test_dropped_pairs_pass_zero():
    """One MoE layer where every pair of the last token is dropped (each
    expert's capacity filled by earlier tokens): that token's input
    gradient is the shared expert's alone: the routed part, the router's
    through the gates included, passes 0."""
    _, tcfg, jp, _ = _model("granite-moe-3b-a800m")
    p = _tparams(jp)["layers"][0]["moe"]
    cfg = tcfg.replace(moe_capacity_factor=0.1)  # C = 8 of T * K / E = 16
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 32, tcfg.d_model)).astype(np.float32)).requires_grad_(True)
    r = MOE.route(x.detach().reshape(32, -1), p, cfg)
    gone = torch.nonzero(~r.kept.any(dim=1))[:, 0]
    assert len(gone) > 0
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        x.shape).astype(np.float32))
    y, _ = MOE.moe_ffn(x, p, cfg)
    (gx,) = torch.autograd.grad((y * cot).sum(), x)
    xs = x.detach().clone().requires_grad_(True)
    (gs,) = torch.autograd.grad(
        (L.glu_mlp(xs, p["shared"]) * cot).sum(), xs)
    assert torch.equal(gx[0, gone], gs[0, gone])


# ---------------------------------------------------------------------------
# per-expert block pruning
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["col", "row"])
def test_per_expert_topk_matches_reference(kind):
    """A bank [E, M1, M2] whose expert 0's scores dominate every other
    expert's (a global top-k would keep expert 0 alone): each expert keeps
    its own top half, as the reference's vmap does, ties at the threshold
    kept; the STE passes the cotangent to the scores as the reference's."""
    rng = np.random.default_rng(5)
    E, M1, M2 = 4, 40, 24
    w = rng.standard_normal((E, M1, M2)).astype(np.float32)
    n = M2 if kind == "col" else M1
    s = rng.standard_normal((E, n)).astype(np.float32)
    s[0] += 100.0
    s[2, :3] = s[2, 3]  # a tie at expert 2's threshold region
    axis = 1 if kind == "col" else 0
    cot = rng.standard_normal(w.shape).astype(np.float32)

    def jf(w, s):
        return jax.vmap(lambda ww, ss: JBP.masked_weight_vector(
            ww, ss, 0.5, axis))(w, s)

    ref = np.asarray(jf(jnp.asarray(w), jnp.asarray(s)))
    gsj = jax.grad(lambda s: (jf(jnp.asarray(w), s) * cot).sum())(
        jnp.asarray(s))
    st = torch.tensor(s, requires_grad=True)
    got = BP.masked_weight_vector(torch.from_numpy(w), st, 0.5, axis)
    assert np.array_equal(got.detach().numpy(), ref)
    kept = (got.detach() != 0).any(dim=2 if kind == "row" else 1)
    assert bool((kept.sum(dim=1) >= math.ceil(n * 0.5)).all())
    flat = BP._hard_topk(torch.from_numpy(s), E * math.ceil(n * 0.5))
    assert not torch.equal(flat, kept.float())  # a global top-k differs
    (gst,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), st)
    np.testing.assert_allclose(gst.numpy(), np.asarray(gsj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_pruning_glue_masks_the_expert_banks(arch):
    """The reference's scores converted by ``lm_scores_from_jax`` (its
    ``layers/moe/w*`` [L, E, n] split into ``layers/{i}/moe/w*`` [E, n]),
    then ``apply_pruning`` on both sides: every masked leaf equal; the
    port's own ``init_scores`` draws the same paths and shapes, the banks'
    expert by expert."""
    jcfg, tcfg, jp, js = _model(arch, prune=True)
    ts = convert.lm_scores_from_jax(_np(js))
    for i in range(tcfg.num_layers):
        for w in ("wg", "wi", "wo"):
            assert ts[f"layers/{i}/moe/{w}"].shape == (4, tcfg.d_ff)
    ref = _tparams(JPG.apply_pruning(jcfg, jp, js))
    got = PG.apply_pruning(tcfg, _tparams(jp), ts)
    for path, a, r in _pairs(got, ref):
        assert torch.equal(a, r), path
    own = PG.init_scores(tcfg, _tparams(jp), torch.Generator().manual_seed(7))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in ts.items()}
    g = torch.Generator().manual_seed(7)
    bank = _tparams(jp)["layers"][0]["moe"]["wg"]
    first = BP.init_scores_for(bank, 16, "col", g)
    g = torch.Generator().manual_seed(7)
    alone = [BP.init_scores_for(bank[e], 16, "col", g) for e in range(4)]
    assert torch.equal(first, torch.stack(alone))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("prune", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("eps", [1e-8, 1.0])
def test_train_step_matches_reference(arch, prune, eps):
    """One ``make_train_step`` (AdamW in place) against the reference's
    jitted step, with and without the paper's per-expert block pruning
    (scores converted by ``lm_scores_from_jax``, trained jointly)."""
    lr = 1e-3 if eps < 1.0 else 1.0
    jcfg, tcfg, jp, js = _model(arch, prune)
    b = _batch(jcfg, batch=4)
    jopt, topt = JAdamW(lr=lr, eps=eps), AdamW(lr=lr, eps=eps)
    jtr = {"params": jp, "scores": js} if prune else jp
    rp, rs, _, rm = jax.jit(JST.make_train_step(jcfg, jopt, prune))(
        jp, jopt.init(jtr), {"tokens": jnp.asarray(b["tokens"])}, js)
    tp = _tparams(jp)
    ts = convert.lm_scores_from_jax(_np(js)) if prune else None
    opt0 = topt.init({"params": tp, "scores": ts} if prune else tp)
    tp1, ts1, opt1, tm = ST.make_train_step(tcfg, topt, prune)(
        tp, opt0, {"tokens": torch.from_numpy(b["tokens"])}, ts)
    assert int(opt1.step) == 1 and tp1 is tp and ts1 is ts  # in place
    tol = LINEAR_TOL if eps >= 1.0 else ADAM_TOL * lr
    assert sorted(tm) == sorted(rm) == ["aux", "ce", "loss"]
    for k in tm:
        assert abs(float(tm[k]) - float(rm[k])) <= \
            LOSS_TOL * max(1.0, abs(float(rm[k]))), k
    for path, a, r in _pairs(tp1, _tparams(rp)):
        assert _rel(a.numpy(), r.numpy()) <= tol, ("params", path)
    if prune:
        ref_scores = convert.lm_scores_from_jax(_np(rs))
        assert sorted(ts1) == sorted(ref_scores)
        for path, a in ts1.items():
            assert _rel(a.numpy(), ref_scores[path].numpy()) <= tol, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_policies_give_equal_gradients(dtype):
    """none / full / dots on the pruned reduced Granite-MoE at capacity
    factor 1.0 (pairs dropped): bitwise-equal loss, aux and gradients."""
    _, tcfg, jp, js = _model("granite-moe-3b-a800m", True)
    tcfg = tcfg.replace(dtype=dtype, moe_capacity_factor=1.0)
    b = {"tokens": torch.from_numpy(_batch(tcfg)["tokens"])}
    tp, ts = _tparams(jp), convert.lm_scores_from_jax(_np(js))
    out = {policy: ST.make_grad_fn(tcfg.replace(remat_policy=policy), True)(
        tp, b, ts) for policy in ("none", "full", "dots")}
    loss, parts, g = out["none"]
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], loss), policy
        assert torch.equal(out[policy][1]["aux"], parts["aux"]), policy
        for x, y in zip(leaves(out[policy][2]), leaves(g)):
            assert torch.equal(x, y), policy


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "no-clip"])
def test_inplace_adamw_equals_functional(monkeypatch, clip):
    """``AdamW.update_`` (in place, leaf groups small enough to split the
    tree) against ``AdamW.update`` over 3 steps of the pruned reduced
    Granite-MoE's gradients, with the LM's decay rule and the default one,
    and a callable lr: params, scores, moments and step EQUAL; the
    functional update leaves its inputs as they are."""
    _, tcfg, jp, js = _model("granite-moe-3b-a800m", True)
    monkeypatch.setattr(adamw, "GROUP_NUMEL", 5000)
    grad_fn = ST.make_grad_fn(tcfg, True)
    opt = AdamW(lr=lambda t: 1e-2 / t.float(), grad_clip=clip)
    tr = {"params": _tparams(jp), "scores": convert.lm_scores_from_jax(
        _np(js))}
    tr_f, st_f = tr, opt.init(tr)
    tr_i = tree_map(torch.clone, tr)
    st_i = opt.init(tr_i)
    for step in range(3):
        b = {"tokens": torch.from_numpy(_batch(tcfg, step=step)["tokens"])}
        _, _, g = grad_fn(tr_f["params"], b, tr_f["scores"])
        decay = ST.stacked_decay(tr) if step != 1 else None
        inputs = leaves(g) + leaves(tr_f)
        before = [t.clone() for t in inputs]
        tr_f, st_f = opt.update(g, st_f, tr_f, decay=decay)
        assert all(torch.equal(a, b) for a, b in zip(inputs, before))
        out, st_i2 = opt.update_(tree_map(torch.clone, g), st_i, tr_i,
                                 decay=decay)
        assert out is tr_i and st_i2.mu is st_i.mu and st_i2.nu is st_i.nu
        st_i = st_i2
        for a, b in zip(leaves(tr_i) + leaves(st_i.mu) + leaves(st_i.nu),
                        leaves(tr_f) + leaves(st_f.mu) + leaves(st_f.nu)):
            assert torch.equal(a, b), step
        assert int(st_i.step) == int(st_f.step) == step + 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launch_train_moe_prune_and_exact_resume(tmp_path, capsys):
    """``--prune`` through the CLI for Granite-MoE (scores at the attention
    matrices, the expert banks and the shared expert), then a run stopped
    after 2 of 3 steps and resumed from its checkpoint (params, scores,
    optimizer state) against the same 3 steps uninterrupted: equal losses
    and state."""
    out = LT.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu",
                   "--prune", "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert "final loss" in capsys.readouterr().out
    scores = out["state"]["scores"]
    assert sorted(scores) == sorted(
        f"layers/{i}/{m}/{w}" for i in range(3)
        for m, ws in (("attn", "wq wk wv wo"), ("moe", "wg wi wo"),
                      ("moe/shared", "wg wi wo"))
        for w in ws.split())
    assert scores["layers/0/moe/wo"].shape == (4, 128)
    kw = dict(batch=2, seq=16, prune=True, device="cpu")
    whole = LT.train("granite-moe-3b-a800m", steps=3, **kw)
    ck = str(tmp_path / "ck")
    first = LT.train("granite-moe-3b-a800m", steps=2, ckpt_dir=ck,
                     checkpoint_every=1, **kw)
    again = LT.train("granite-moe-3b-a800m", steps=3, ckpt_dir=ck,
                     checkpoint_every=1, **kw)
    assert (2, "restored") in again["events"]
    assert first["losses"] + again["losses"] == whole["losses"]
    for a, b in zip(leaves(again["state"]["params"])
                    + leaves(again["state"]["scores"])
                    + leaves(again["state"]["opt"]),
                    leaves(whole["state"]["params"])
                    + leaves(whole["state"]["scores"])
                    + leaves(whole["state"]["opt"])):
        assert torch.equal(a, b)
