"""The port's training slice against the reference package, on the CPU, at
the reduced DeiT-Small config (3 layers, D=64, 4 heads, 32 px / 8 px
patches, TDM at layer 1, r_b 0.5, r_t 0.7).

Weights and scores come from the reference's seeded init and are converted
(``convert.params_from_jax`` / ``scores_from_jax``), so both packages
compute the same function; other inputs are numpy arrays from a seed. The
port's ViT forward runs fp32 activations (the card's fp32 tier); the
reference's runs ``cfg.dtype``, bf16 by default, so the reference trains
here at ``cfg.replace(dtype="float32")``, as its own
``masked_dense_reference`` does.
Tolerances, all in fp32 where XLA and PyTorch sum in different orders:
  * structural outputs (masks, kept token indices, quantized int8 values,
    synthetic batches, complexity and size tables) must be equal;
  * the STE's gradient is the cotangent itself: equal;
  * a score's gradient sums up to 16x16 products per block: 1e-5
    relative to max(1, max|ref|);
  * schedules, losses and the optimizer's state: 1e-6 (schedules), 1e-5
    (losses, AdamW over 3 steps), relative to max(1, |ref|);
  * params and scores after one Algorithm-1 or ViT training step, relative
    to max(1, |ref|): AdamW's first step moves an element by
    lr·g/(|g| + eps), about ±lr, so rounding noise in a gradient near eps
    (1e-8) moves the step by a fraction of lr. The bound is 0.25·lr (each
    element moved the same way in both packages), and 2·lr for the
    attention's key biases: softmax ignores a shift of every key's logit,
    so their exact gradient is 0 and their step is the sign of the
    noise. Run with lr = eps = 1, the step is g/(|g| + 1), about the
    clipped gradient, and the bound is 1e-5: the gradients agree to 1e-5
    (at a small lr the step would drown in the params' fp32 spacing).
  * the 3-step loss trajectory: 1e-5 relative.
Kept token indices are compared before any value, at every TDM layer.
"""
import contextlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import DEIT_SMALL as J_DEIT
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import block_pruning as JBP
from repro.core import complexity as JC
from repro.core import schedule as JS
from repro.core import simultaneous as JSIM
from repro.core import token_pruning as JTP
from repro.data import DataConfig as JDataConfig
from repro.data import pipeline as JDP
from repro.models import model as JM
from repro.models import pruning_glue as JPG
from repro.models import steps as JST
from repro.optim import AdamW as JAdamW
from repro.optim import compression as JCOMP

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import DEIT_SMALL as T_DEIT
from repro_torch.configs import PruningConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import block_pruning as BP
from repro_torch.core import complexity as C
from repro_torch.core import schedule as S
from repro_torch.core import simultaneous as SIM
from repro_torch.core import token_pruning as TP
from repro_torch.data import DataConfig, batches, pipeline as DP
from repro_torch.dist.fault import FaultConfig, RestartableLoop, StepWatchdog
from repro_torch.launch import train as LT
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG
from repro_torch.models import steps as ST
from repro_torch.optim import AdamW, AdamWState, global_norm
from repro_torch.optim import compression as COMP
from repro_torch.tree import flatten_with_path, leaves

GRAD_TOL = 1e-5
SCHED_TOL = 1e-6
LOSS_TOL = 1e-5
ADAM_TOL = 0.25   # x lr: params and scores after one step, paper's eps
NOISE_TOL = 2.0   # x lr: key biases (exact gradient 0), paper's eps
LINEAR_TOL = 1e-5  # params and scores after one step at lr = eps = 1
LR = 2e-3  # the reference test's Algorithm-1 rate
TOTAL = 20


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def vit():
    jcfg, tcfg = J_DEIT.reduced().replace(dtype="float32"), T_DEIT.reduced()
    key = jax.random.PRNGKey(0)
    jparams = JM.init_params(jcfg, key)
    jscores = JPG.init_scores(jcfg, jparams, jax.random.fold_in(key, 7))
    jteacher = JM.init_params(jcfg, jax.random.PRNGKey(9))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, jscores=jscores,
                jteacher=jteacher)


def _torch_tree(v, name):
    if name == "scores":
        return convert.scores_from_jax(_np(v["jscores"]))
    return convert.params_from_jax(_np(v[name]))


def _tied_scores(rng, shape, levels=4):
    """Scores on a few levels, so ties at the top-k threshold are certain."""
    return (rng.integers(0, levels, size=shape) * 0.25).astype(np.float32)


# ---------------------------------------------------------------------------
# STE and masked weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ties", [False, True])
def test_ste_topk_mask_and_identity_gradient(ties):
    rng = np.random.default_rng(0)
    s = (_tied_scores(rng, (6, 7)) if ties
         else rng.standard_normal((6, 7)).astype(np.float32))
    cot = rng.standard_normal((6, 7)).astype(np.float32)
    for k in (0, 1, 7, 20, 41, 42, 50):
        mj = JBP.ste_topk_mask(jnp.asarray(s), k)
        st = torch.tensor(s, requires_grad=True)
        mt = BP.ste_topk_mask(st, k)
        assert np.array_equal(np.asarray(mj), mt.detach().numpy()), k
        if ties and 0 < k < 42:
            assert mt.sum().item() >= k  # ties at the threshold are kept
        gj = jax.grad(lambda x: (JBP.ste_topk_mask(x, k) * cot).sum())(
            jnp.asarray(s))
        (gt,) = torch.autograd.grad((mt * torch.tensor(cot)).sum(), st)
        assert np.array_equal(np.asarray(gj), cot)
        assert np.array_equal(gt.numpy(), cot)


@pytest.mark.parametrize("kind", ["block", "col", "row"])
@pytest.mark.parametrize("ties", [False, True])
def test_masked_weight_score_gradients_match_reference(kind, ties):
    """The score gradient is the block (or column / row) sum of g ⊙ W,
    through the block expansion and its crop (40 x 56 is not a multiple
    of the 16-wide block)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((40, 56)).astype(np.float32)
    cot = rng.standard_normal((40, 56)).astype(np.float32)
    shape = {"block": JBP.score_shape(w.shape, 16), "col": (56,),
             "row": (40,)}[kind]
    s = (_tied_scores(rng, shape) if ties
         else rng.standard_normal(shape).astype(np.float32))

    def jf(w, s):
        if kind == "block":
            return JBP.masked_weight(w, s, 0.5, 16)
        return JBP.masked_weight_vector(w, s, 0.5, 1 if kind == "col" else 0)

    def tf(w, s):
        if kind == "block":
            return BP.masked_weight(w, s, 0.5, 16)
        return BP.masked_weight_vector(w, s, 0.5, 1 if kind == "col" else 0)

    gwj, gsj = jax.grad(
        lambda w, s: (jf(w, s) * cot).sum(), argnums=(0, 1))(
            jnp.asarray(w), jnp.asarray(s))
    wt = torch.tensor(w, requires_grad=True)
    st = torch.tensor(s, requires_grad=True)
    mw = tf(wt, st)
    assert np.array_equal(np.asarray(jf(jnp.asarray(w), jnp.asarray(s))),
                          mw.detach().numpy())
    gwt, gst = torch.autograd.grad((mw * torch.tensor(cot)).sum(), (wt, st))
    assert np.array_equal(np.asarray(gwj), gwt.numpy())  # g ⊙ mask
    assert np.abs(np.asarray(gsj)).sum() > 0
    assert _rel(gst.numpy(), gsj) <= GRAD_TOL
    name = {"block": "wq", "col": "wi", "row": "wo"}[kind]
    direct = BP.apply_pruning_to_param(name, wt, st, 0.5, 16)
    assert np.array_equal(direct.detach().numpy(), mw.detach().numpy())


def test_apply_pruning_gradients_reach_params_and_scores(vit):
    """``apply_pruning`` keeps the graph to both trees: the gradients of a
    loss on the masked params, for params and scores, match the
    reference's."""
    cfg, jcfg = vit["tcfg"], vit["jcfg"]
    rng = np.random.default_rng(2)
    pt, st = _torch_tree(vit, "jparams"), _torch_tree(vit, "scores")
    cot = [rng.standard_normal(np.shape(l)).astype(np.float32)
           for l in jax.tree_util.tree_leaves(vit["jparams"])]

    def jloss(p, s):
        m = JPG.apply_pruning(jcfg, p, s)
        return sum((l * c).sum() for l, c in
                   zip(jax.tree_util.tree_leaves(m), cot))
    gpj, gsj = jax.grad(jloss, argnums=(0, 1))(vit["jparams"],
                                               vit["jscores"])
    flat_p = [t.requires_grad_(True) for t in leaves(pt)]
    flat_s = [t.requires_grad_(True) for t in leaves(st)]
    m = PG.apply_pruning(cfg, pt, st)
    loss = sum((l * torch.tensor(c)).sum() for l, c in zip(leaves(m), cot))
    grads = torch.autograd.grad(loss, flat_p + flat_s)
    for a, b in zip(grads[:len(flat_p)], jax.tree_util.tree_leaves(gpj)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for (path, a), b in zip(zip(sorted(st), grads[len(flat_p):]),
                            [gsj[k] for k in sorted(gsj)]):
        assert _rel(a.numpy(), b) <= GRAD_TOL, path


# ---------------------------------------------------------------------------
# Schedules, regularizer, masks' statistics
# ---------------------------------------------------------------------------
def test_schedules_match_reference():
    # the reference test's points, then every step of a run
    for t in (0, 95, 50):
        assert abs(float(S.cubic_keep_rate(t, 100, 0.5, 10, 10))
                   - float(JS.cubic_keep_rate(t, 100, 0.5, 10, 10))) \
            <= SCHED_TOL
    assert float(S.cubic_keep_rate(0, 100, 0.5, 10, 10)) == 1.0
    assert float(S.cubic_keep_rate(95, 100, 0.5, 10, 10)) == 0.5
    for t in range(0, 105):
        for args in ((100, 0.5, 10, 10), (20, 0.7, 2, 2), (7, 0.5, 0, 0)):
            assert abs(float(S.cubic_keep_rate(t, *args))
                       - float(JS.cubic_keep_rate(t, *args))) <= SCHED_TOL
        for args in ((100, 1e-3, 10, 1e-5), (20, 2e-5, 0, 0.0)):
            a = float(S.linear_warmup_cosine(t, *args))
            b = float(JS.linear_warmup_cosine(t, *args))
            assert abs(a - b) <= SCHED_TOL * max(1.0, abs(b)), (t, args)
    # a 0-d tensor step, as the training step passes it
    r = S.cubic_keep_rate(torch.tensor(5, dtype=torch.int32), 20, 0.5, 2, 2)
    assert r.shape == () and r.dtype == torch.float32


def test_regularizer_and_density_stats_match_reference(vit):
    st = _torch_tree(vit, "scores")
    rj = float(JPG.regularizer(vit["jscores"]))
    assert abs(float(PG.regularizer(st)) - rj) <= LOSS_TOL * max(1.0, rj)
    assert float(BP.sparsity_regularizer({})) == \
        float(JBP.sparsity_regularizer({}))
    hm_j = JPG.hard_masks(vit["jcfg"], vit["jparams"], vit["jscores"])
    hm_t = PG.hard_masks(vit["tcfg"], _torch_tree(vit, "jparams"), st)
    assert sorted(hm_j) == sorted(hm_t)
    for p in hm_j:
        assert BP.density_stats(hm_t[p]) == JBP.density_stats(hm_j[p]), p
    bm = np.asarray([[1, 0], [1, 1]], np.float32)
    assert BP.density_stats(torch.tensor(bm)) == \
        JBP.density_stats(jnp.asarray(bm))


def test_head_retained_ratio_and_alternate_tie_mask_match_reference(vit):
    cases = [np.asarray([[1, 1, 0, 0], [1, 0, 0, 0]], np.float32),
             np.asarray([[1, 0, 0], [0, 0, 1]], np.float32)]
    hm_j = JPG.hard_masks(vit["jcfg"], vit["jparams"], vit["jscores"])
    cases += [np.asarray(m) for m in hm_j.values()]
    rng = np.random.default_rng(3)
    cases.append((rng.random((24, 24)) < 0.1).astype(np.float32))
    for bm in cases:
        tie_j = JBP.alternate_tie_mask(jnp.asarray(bm))
        assert np.array_equal(
            BP.alternate_tie_mask(torch.tensor(bm)).numpy(),
            np.asarray(tie_j))
        for heads in (1, 2, 4):
            if bm.shape[1] % heads:
                continue
            assert float(BP.head_retained_ratio(torch.tensor(bm), heads)) \
                == float(JBP.head_retained_ratio(jnp.asarray(bm), heads))


def test_distillation_loss_matches_reference():
    rng = np.random.default_rng(4)
    s = rng.standard_normal((8, 10)).astype(np.float32) * 3
    t = rng.standard_normal((8, 10)).astype(np.float32) * 3
    for T in (1.0, 4.0):
        a = float(SIM.distillation_loss(torch.tensor(s), torch.tensor(t), T))
        b = float(JSIM.distillation_loss(jnp.asarray(s), jnp.asarray(t), T))
        assert abs(a - b) <= LOSS_TOL * max(1.0, abs(b))
    assert float(SIM.distillation_loss(torch.tensor(s), torch.tensor(s),
                                       4.0)) < 1e-6
    labels = rng.integers(-1, 10, size=(8,)).astype(np.int32)
    a = float(M.softmax_xent(torch.tensor(s), torch.tensor(labels)))
    b = float(JM.softmax_xent(jnp.asarray(s), jnp.asarray(labels)))
    assert abs(a - b) <= LOSS_TOL * max(1.0, abs(b))


# ---------------------------------------------------------------------------
# AdamW and gradient compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lr_kind", ["float", "schedule"])
def test_adamw_three_steps_match_reference(lr_kind):
    """Three updates of a tree with 1-D and 2-D leaves (decay on the 2-D
    ones only), with gradients large enough that the clip is active."""
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((6, 5)), "b": rng.standard_normal(5),
            "scores": {"layers/0/attn/wq": rng.standard_normal((2, 3)),
                       "layers/0/mlp/wi": rng.standard_normal(7)}}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 3).astype(np.float32),
        tree) for _ in range(3)]
    if lr_kind == "float":
        jopt, topt = JAdamW(lr=0.05, weight_decay=0.1), \
            AdamW(lr=0.05, weight_decay=0.1)
    else:
        jopt = JAdamW(lr=lambda t: JS.linear_warmup_cosine(t, 5, 0.05, 2),
                      weight_decay=0.1)
        topt = AdamW(lr=lambda t: S.linear_warmup_cosine(t, 5, 0.05, 2),
                     weight_decay=0.1)
    jp, tp = tree, convert.params_from_jax(tree)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        assert float(global_norm(convert.params_from_jax(g))) > \
            topt.grad_clip
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(convert.params_from_jax(g), ts, tp)
    assert int(ts.step) == int(js.step) == 3
    for (path, a), b in zip(flatten_with_path(tp),
                            jax.tree_util.tree_leaves(jp)):
        assert _rel(a.numpy(), b) <= LOSS_TOL, path
    for t_tree, j_tree in ((ts.mu, js.mu), (ts.nu, js.nu)):
        for a, b in zip(leaves(t_tree), jax.tree_util.tree_leaves(j_tree)):
            assert _rel(a.numpy(), b) <= LOSS_TOL
    # weight decay only on matrices: zero gradients move 2-D leaves alone
    z = {"w": torch.ones((2, 2)), "b": torch.ones(2)}
    new, _ = AdamW(lr=1e-2, weight_decay=0.5).update(
        {k: torch.zeros_like(v) for k, v in z.items()},
        AdamW().init(z), z)
    assert float(new["w"][0, 0]) < 1.0 and float(new["b"][0]) == 1.0


def test_int8_error_feedback_compression_matches_reference():
    rng = np.random.default_rng(6)
    g = {"w": (rng.standard_normal((32, 32)) * 1e-3).astype(np.float32),
         "b": (rng.standard_normal(9) * 1e-2).astype(np.float32)}
    js = JCOMP.init_ef_state(jax.tree_util.tree_map(jnp.asarray, g))
    tg = convert.params_from_jax(g)
    ts = COMP.init_ef_state(tg)
    for _ in range(3):
        qj, sj, js = JCOMP.compress_grads(g, js)
        qt, stt, ts = COMP.compress_grads(tg, ts)
        for k in g:
            assert qt[k].dtype == torch.int8
            assert np.array_equal(qt[k].numpy(), np.asarray(qj[k]))
            assert float(stt[k]) == float(sj[k])
            assert np.array_equal(ts.residual[k].numpy(),
                                  np.asarray(js.residual[k]))
        dj = JCOMP.decompress_grads(qj, sj)
        dt = COMP.decompress_grads(qt, stt)
        for k in g:
            assert np.array_equal(dt[k].numpy(), np.asarray(dj[k]))


# ---------------------------------------------------------------------------
# Algorithm 1 and the ViT training step
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _record_kept(monkeypatch, module):
    """Record the kept token indices of every TDM the model runs."""
    kept = []
    inner = module.tdm

    def tdm(*a, **kw):
        out = inner(*a, **kw)
        kept.append(np.asarray(out[1]))
        return out
    with monkeypatch.context() as m:
        m.setattr(module, "tdm", tdm)
        yield kept


def _eff_j(cfg, params, scores, step):
    """The reference's student weights at ``step`` (its loss_fn's lines)."""
    p = cfg.pruning
    r_b = JS.cubic_keep_rate(step, TOTAL, p.r_b, int(TOTAL * 0.1),
                             int(TOTAL * 0.1))
    blend = (1.0 - r_b) / max(1.0 - p.r_b, 1e-6)
    masked = JPG.apply_pruning(cfg, params, scores, r_b=p.r_b)
    return jax.tree.map(lambda d, m: (1 - blend) * d + blend * m, params,
                        masked)


def _batch(cfg, step, B=8):
    return JDP.synthetic_vit_batch(cfg, B, JDataConfig(seed=0), step)


def _assert_step_close(t_tree, j_tree, lr: float, eps: float, what: str):
    """A tree after one AdamW step against the reference's (see the module
    docstring for the bounds)."""
    for (path, a), c in zip(flatten_with_path(t_tree),
                            jax.tree_util.tree_leaves(j_tree)):
        if eps >= 1.0:
            tol = LINEAR_TOL
        elif path and path[-1] == "bk":
            tol = NOISE_TOL * lr
        else:
            tol = ADAM_TOL * lr
        assert _rel(a.numpy(), c) <= tol, (what, path)


@pytest.mark.parametrize("eps", [1e-8, 1.0])
def test_simultaneous_step_matches_reference(vit, monkeypatch, eps):
    """One Algorithm-1 step from step 5 (r_b 0.87, so the student runs on a
    blend of dense and STE-masked weights): kept token indices, the loss
    parts, then params and scores after the update; then (paper's eps) a
    3-step loss trajectory. At lr = ``eps`` = 1 the update is about the
    clipped gradient, so the bound on the params holds the gradients of
    every param and score to 1e-5."""
    jcfg, tcfg = vit["jcfg"], vit["tcfg"]
    start = 5
    lr = LR if eps < 1.0 else 1.0
    jopt, topt = JAdamW(lr=lr, eps=eps), AdamW(lr=lr, eps=eps)
    jtr = {"params": vit["jparams"], "scores": vit["jscores"]}
    jstate = JSIM.PruneTrainState(vit["jparams"], vit["jscores"],
                                  jopt.init(jtr), jnp.int32(start))
    tparams, tscores = _torch_tree(vit, "jparams"), _torch_tree(vit, "scores")
    tstate = SIM.PruneTrainState(
        tparams, tscores, topt.init({"params": tparams, "scores": tscores}),
        torch.tensor(start, dtype=torch.int32))
    jteacher, tteacher = vit["jteacher"], _torch_tree(vit, "jteacher")
    jstep = jax.jit(JSIM.make_simultaneous_step(jcfg, jcfg, jopt, TOTAL))
    tstep = SIM.make_simultaneous_step(tcfg, tcfg, topt, TOTAL)

    # kept indices first: the student's forward on the blended weights
    b0 = _batch(jcfg, 0)
    with _record_kept(monkeypatch, JTP) as kj:
        JM.forward_vit(jcfg, _eff_j(jcfg, vit["jparams"], vit["jscores"],
                                    start), jnp.asarray(b0["patches"]))
    with _record_kept(monkeypatch, TP) as kt:
        r_b = S.cubic_keep_rate(start, TOTAL, tcfg.pruning.r_b, 2, 2)
        M.forward_vit(tcfg, SIM.student_params(tcfg, tparams, tscores, r_b),
                      torch.tensor(b0["patches"]))
    assert len(kj) == len(kt) == len(tcfg.pruning.tdm_layers)
    for layer, (a, b) in enumerate(zip(kj, kt)):
        rows = np.nonzero((a != b).any(axis=1))[0]
        assert rows.size == 0, f"TDM {layer}: kept indices differ, rows " \
                               f"{rows.tolist()}"

    losses_j, losses_t = [], []
    n_steps = 3 if eps < 1.0 else 1
    for i in range(n_steps):
        b = _batch(jcfg, i)
        jstate, mj = jstep(jstate, jteacher,
                           {k: jnp.asarray(v) for k, v in b.items()})
        tstate, mt = tstep(tstate, tteacher,
                           {k: torch.tensor(v) for k, v in b.items()})
        losses_j.append(float(mj["loss"]))
        losses_t.append(float(mt["loss"]))
        if i == 0:  # the loss parts, then the state after one update
            for k in ("loss", "ce", "distill", "reg", "r_b"):
                assert abs(float(mt[k]) - float(mj[k])) <= \
                    LOSS_TOL * max(1.0, abs(float(mj[k]))), k
            assert 0.0 < float(mt["r_b"]) < 1.0
            _assert_step_close(tstate.params, jstate.params, lr, eps,
                               "params")
            _assert_step_close(tstate.scores, jstate.scores, lr, eps,
                               "scores")
            moved = max(np.abs(tstate.scores[k].numpy()
                               - np.asarray(vit["jscores"][k])).max()
                        for k in tstate.scores)
            assert moved > 100 * LINEAR_TOL * LR  # the scores moved
    assert int(tstate.step) == start + n_steps
    assert np.abs(np.array(losses_t) - np.array(losses_j)).max() <= \
        LOSS_TOL * max(1.0, max(losses_j))


def test_init_state_and_reference_training_behaviour():
    """The reference test's behaviour on the port alone: six steps from
    ``init_state`` lower the loss, r_b falls by the cubic schedule toward
    the final rate, and the scores move."""
    cfg = T_DEIT.reduced()
    state, opt = SIM.init_state(cfg, torch.Generator().manual_seed(0),
                                AdamW(lr=LR), device="cpu")
    scores0 = {k: v.clone() for k, v in state.scores.items()}
    teacher = M.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    step = SIM.make_simultaneous_step(cfg, cfg, opt, TOTAL)
    b = DP.synthetic_vit_batch(cfg, 8, DataConfig(seed=0), 0)
    b = {k: torch.tensor(v) for k, v in b.items()}
    losses, rbs = [], []
    for i in range(6):
        state, m = step(state, teacher, b)
        losses.append(float(m["loss"]))
        rbs.append(float(m["r_b"]))
        assert rbs[-1] == float(S.cubic_keep_rate(i, TOTAL, 0.5, 2, 2))
    assert losses[-1] < losses[0]
    assert rbs[0] > rbs[-1] >= cfg.pruning.r_b - 1e-6
    assert any(not torch.equal(state.scores[k], scores0[k]) for k in scores0)


def test_vit_train_step_matches_reference(vit):
    jcfg, tcfg = vit["jcfg"], vit["tcfg"]
    jopt, topt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    b = _batch(jcfg, 3)
    jp, js, mj = jax.jit(JST.make_vit_train_step(jcfg, jopt))(
        vit["jparams"], jopt.init(vit["jparams"]),
        {k: jnp.asarray(v) for k, v in b.items()})
    tparams = _torch_tree(vit, "jparams")
    tp, ts, mt = ST.make_vit_train_step(tcfg, topt)(
        tparams, topt.init(tparams), {k: torch.tensor(v) for k, v in
                                      b.items()})
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= \
        LOSS_TOL * max(1.0, float(mj["loss"]))
    _assert_step_close(tp, jp, 1e-3, topt.eps, "params")
    assert int(ts.step) == 1


# ---------------------------------------------------------------------------
# Data, complexity tables
# ---------------------------------------------------------------------------
def test_synthetic_batches_bitwise_equal():
    cfg, jcfg = T_DEIT.reduced(), J_DEIT.reduced()
    for dc_args in ((0, 1, 0), (3, 2, 1)):
        for step in (0, 7):
            a = DP.synthetic_vit_batch(cfg, 6, DataConfig(*dc_args), step)
            b = JDP.synthetic_vit_batch(jcfg, 6, JDataConfig(*dc_args), step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k]), k
    lcfg = get_config("minitron-4b").reduced()
    jl = j_get_config("minitron-4b").reduced()
    shape, jshape = (ShapeConfig("t", 16, 8, "train"),
                     JShapeConfig("t", 16, 8, "train"))
    dc, jdc = DataConfig(1, 2, 1), JDataConfig(1, 2, 1)
    a = DP.synthetic_lm_batch(lcfg, shape, dc, 7)
    b = JDP.synthetic_lm_batch(jl, jshape, jdc, 7)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == b["tokens"].dtype
    it_t, it_j = batches(lcfg, shape, dc, 3), JDP.batches(jl, jshape, jdc, 3)
    for _ in range(2):
        assert np.array_equal(next(it_t)["tokens"], next(it_j)["tokens"])


TABLE_VI = [  # tests/test_complexity.py's points: (block, r_b, r_t)
    (16, 1.0, 1.0), (16, 0.5, 0.5), (16, 0.5, 0.7), (16, 0.5, 0.9),
    (16, 0.7, 0.5), (16, 0.7, 0.7), (16, 0.7, 0.9), (32, 0.5, 0.5),
    (32, 0.7, 0.9)]


@pytest.mark.parametrize("b,rb,rt", TABLE_VI)
def test_complexity_and_size_tables_equal(b, rb, rt):
    from repro.configs import PruningConfig as JPruningConfig
    kw = dict(block_size=b, r_b=rb, r_t=rt,
              tdm_layers=(2, 6, 9) if rt < 1 else ())
    pc, jpc = PruningConfig(**kw), JPruningConfig(**kw)
    for batch in (1, 4):
        assert C.model_macs(T_DEIT, batch, pc) == \
            JC.model_macs(J_DEIT, batch, jpc)
    assert C.model_size_bytes(T_DEIT, pc) == JC.model_size_bytes(J_DEIT, jpc)
    assert C.compression_ratio(T_DEIT, pc) == \
        JC.compression_ratio(J_DEIT, jpc)
    d, jd = (C.EncoderDims(1, 197, 6, 64, 384, 1536),
             JC.EncoderDims(1, 197, 6, 64, 384, 1536))
    assert C.dense_encoder_macs(d) == JC.dense_encoder_macs(jd)
    kw = dict(alpha=rb, alpha_proj=rb, h_kept=6, n_kept=140, alpha_mlp=rb,
              has_tdm=rt < 1)
    assert C.pruned_encoder_macs(d, **kw) == JC.pruned_encoder_macs(jd, **kw)
    assert C.vit_num_tokens(T_DEIT) == JC.vit_num_tokens(J_DEIT)


# ---------------------------------------------------------------------------
# Checkpoints, the restartable loop, the launcher
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_retention_and_atomicity(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.int32)},
            "opt": AdamW().init({"w": torch.ones(2, 2)}), "none": None}
    for s in (5, 10, 15):
        cm.save(s, tree, extra={"note": s})
    assert cm.all_steps() == [10, 15]
    r = cm.restore(tree)
    assert torch.equal(r["a"], tree["a"])
    assert r["nested"]["b"].dtype == torch.int32
    assert isinstance(r["opt"], AdamWState) and r["opt"].step.dtype == \
        torch.int32
    assert r["none"] is None
    assert cm.extra()["note"] == 15
    # the reference's layout: one .npy per leaf named by its path
    names = sorted(os.listdir(os.path.join(str(tmp_path), "step_0000000015")))
    assert names == sorted(["manifest.json", "a.npy", "nested__b.npy",
                            "opt__step.npy", "opt__mu__w.npy",
                            "opt__nu__w.npy"])
    # a stale tmp dir from a crashed save never counts as a checkpoint
    os.makedirs(os.path.join(str(tmp_path), "step_0000000020.tmp"))
    assert cm.latest_step() == 15
    # the reference's manager reads the same files
    jr = JCheckpointManager(str(tmp_path), keep=2).restore(
        {"a": np.zeros((2, 3), np.float32),
         "nested": {"b": np.zeros(4, np.int32)}})
    assert np.array_equal(np.asarray(jr["a"]), tree["a"].numpy())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def test_restartable_loop_exact_resume(tmp_path):
    """A ViT training run through ``RestartableLoop`` with two injected
    faults ends bitwise where an uninterrupted run ends; the watchdog flags
    a straggler."""
    def run(directory, fails):
        def injector(step):
            if step in fails:
                fails.discard(step)
                raise RuntimeError("injected")
        cfg = T_DEIT.reduced()
        opt = AdamW(lr=1e-3)
        vstep = ST.make_vit_train_step(cfg, opt)

        def step_fn(state, b):
            params, o, m = vstep(state["params"], state["opt"],
                                 {k: torch.tensor(v) for k, v in b.items()})
            return {"params": params, "opt": o}, m
        loop = RestartableLoop(
            CheckpointManager(directory, keep=3),
            FaultConfig(checkpoint_every=2),
            make_state=lambda: LT.make_state_factory(
                cfg, opt, torch.device("cpu"))(),
            step_fn=step_fn,
            data_fn=lambda s: DP.synthetic_vit_batch(cfg, 4, DataConfig(),
                                                     s),
            state_to_tree=lambda s: {"params": s["params"], "opt": s["opt"]},
            tree_to_state=lambda t, s: {**s, **t})
        return loop.run(7, fail_injector=injector)

    clean = run(str(tmp_path / "a"), set())
    faulty = run(str(tmp_path / "b"), {3, 5})
    assert clean["restarts"] == 0 and faulty["restarts"] == 2
    assert faulty["losses"] == clean["losses"]
    for a, b in zip(leaves(faulty["state"]["params"]),
                    leaves(clean["state"]["params"])):
        assert torch.equal(a, b)
    w = StepWatchdog(FaultConfig(slow_step_factor=3.0))
    for _ in range(20):
        assert w.observe(1.0) is None
    assert w.observe(10.0) == "straggler"


def test_launch_train_cpu_and_lm_raise(tmp_path, capsys):
    out = LT.main(["--arch", "deit-small", "--steps", "2", "--batch", "4",
                   "--device", "cpu"])
    assert len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert "final loss" in capsys.readouterr().out
    ck = str(tmp_path / "ck")
    first = LT.train("deit-small", steps=2, batch=4, ckpt_dir=ck,
                     checkpoint_every=1, device="cpu")
    again = LT.train("deit-small", steps=3, batch=4, ckpt_dir=ck,
                     checkpoint_every=1, device="cpu")
    assert (2, "restored") in again["events"]
    assert len(first["losses"]) == 2 and len(again["losses"]) == 1
    lm = LT.train("minitron-4b", steps=2, batch=2, seq=16, device="cpu")
    assert len(lm["losses"]) == 2
    assert all(math.isfinite(x) for x in lm["losses"])
    assert lm["state"]["scores"] is None and int(lm["state"]["opt"].step) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LT.train("deit-small", steps=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LT.train("minitron-4b", steps=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SIM.init_state(T_DEIT.reduced(), torch.Generator())
