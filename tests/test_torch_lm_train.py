"""The port's LM training against the reference package, on the CPU, at the
reduced dense configs (3 layers, D=64, head_dim 16, vocab 256):
StableLM-1.6B (4 heads, MHA) and Minitron-4B (4 query heads over 1 KV
head, GQA), both at ``dtype="float32"``.

Weights and scores come from the reference's seeded init and are
converted (``convert.lm_params_from_jax`` / ``lm_scores_from_jax``);
batches are ``synthetic_lm_batch`` (bit-identical in both packages) and
other inputs numpy arrays from a seed. Tolerances:

* ``chunked_lm_xent`` and ``lm_loss``: 1e-5 relative to max(1, |ref|)
  (another summation order between XLA and PyTorch).
* ``jax.grad`` of the reference's ``lm_loss`` against the port's autograd
  gradients: each leaf within 1e-4 of its largest |ref| element (fp32 sums
  over three layers, rounded in other orders).
* ``attention_causal_bwd_plain`` (the plain version of the backward
  kernel), from the plain forward's ``lse``, against autograd of the
  plain forward and ``jax.vjp`` of ``flash_attention_jnp``: 1e-5 of each
  output's largest |ref| at fp32; one bf16 ulp (2^-7) of it at bf16 (all
  three round one fp32 result to bf16).
* params and scores after one ``make_train_step``, relative to max(1,
  |ref|): 0.25·lr at the paper's eps (AdamW's first step moves an element
  by lr·g/(|g| + eps), so gradient noise near eps moves it by a fraction
  of lr), and 1e-5 at lr = eps = 1, where the step is about the clipped
  gradient (``tests/test_torch_train.py``'s bounds). Microbatches and
  remat policies the same way; the remat policies give bitwise-equal
  gradients (the same operations, recomputed).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import DataConfig as JDataConfig
from repro.data import pipeline as JDP
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import pruning_glue as JPG
from repro.models import steps as JST
from repro.optim import AdamW as JAdamW

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (attention_causal_bwd_plain,
                                                 attention_causal_lse_plain,
                                                 attention_causal_plain)
from repro_torch.launch import train as LT
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.optim import AdamW
from repro_torch.tree import flatten_with_path, leaves

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ATTN_TOL = 1e-5
BF16_ULP = 2.0 ** -7
ADAM_TOL = 0.25   # x lr
LINEAR_TOL = 1e-5  # lr = eps = 1
ARCHS = ("stablelm-1.6b", "minitron-4b")
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


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk", [4, 5])
def test_chunked_xent_and_lm_loss_match_reference(arch, chunk):
    """S = 12 in chunks of 4 (divides) and 5 (padded with -1 labels), labels
    with -1 entries; then ``lm_loss`` on a synthetic batch."""
    jcfg, tcfg, jp, _ = _model(arch)
    tp = _tparams(jp)
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    lab = rng.integers(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    lab[0, 3] = lab[1, 7] = lab[1, 11] = -1
    ref = float(JM.chunked_lm_xent(jcfg, jp, jnp.asarray(h),
                                   jnp.asarray(lab), chunk=chunk))
    got = float(M.chunked_lm_xent(tcfg, tp, torch.from_numpy(h),
                                  torch.from_numpy(lab), chunk=chunk))
    assert abs(got - ref) <= LOSS_TOL * max(1.0, abs(ref))
    b = _batch(jcfg, seq=12)
    jcfg_c, tcfg_c = (c.replace(loss_chunk=chunk) for c in (jcfg, tcfg))
    ref_total, ref_parts = JM.lm_loss(jcfg_c, jp,
                                      {"tokens": jnp.asarray(b["tokens"])})
    total, parts = M.lm_loss(tcfg_c, tp,
                             {"tokens": torch.from_numpy(b["tokens"])})
    assert sorted(parts) == sorted(ref_parts) == ["aux", "ce"]
    for a, r in ((total, ref_total), (parts["ce"], ref_parts["ce"]),
                 (parts["aux"], ref_parts["aux"])):
        assert abs(float(a) - float(r)) <= LOSS_TOL * max(1.0, abs(float(r)))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_reference(arch):
    """``jax.grad`` of the reference's ``lm_loss`` (its remat on) against
    the port's gradients (full remat, the default)."""
    jcfg, tcfg, jp, _ = _model(arch)
    b = _batch(jcfg)
    jg = jax.grad(lambda p: JM.lm_loss(jcfg, p, {
        "tokens": jnp.asarray(b["tokens"])})[0])(jp)
    loss, parts, g = ST.make_grad_fn(tcfg, with_pruning=False)(
        _tparams(jp), {"tokens": torch.from_numpy(b["tokens"])})
    ref_loss = float(JM.lm_loss(jcfg, jp, {"tokens": jnp.asarray(
        b["tokens"])})[0])
    assert abs(float(loss) - ref_loss) <= LOSS_TOL * max(1.0, ref_loss)
    for path, a, r in _pairs(g, _tparams(jg)):
        r = r.numpy()
        assert np.abs(a.numpy() - r).max() <= GRAD_TOL * np.abs(r).max(), \
            path


# ---------------------------------------------------------------------------
# the attention backward's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("heads", [(4, 1), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("kv_start", [None, (2, 5)],
                         ids=["all", "kv_start"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_causal_bwd_plain(heads, kv_start, dtype):
    """The plain backward from the plain forward's lse, against autograd of
    the plain forward and ``jax.vjp`` of the reference's train-mode
    attention. With ``kv_start`` the first rows of each batch row have no
    key (pad rows: the reference averages V there)."""
    Hq, KV = heads
    B, N, Dh = 2, 9, 16
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, N, Hq, Dh), (B, N, KV, Dh), (B, N, KV, Dh), (B, N, Hq, Dh))]
    jq, jk, jv, jdo = (jnp.asarray(a).astype(dtype) for a in arrs)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(
        x.astype(jnp.float32))).to(getattr(torch, dtype)).requires_grad_(True)
        for x in (jq, jk, jv, jdo))
    start = None if kv_start is None else np.asarray(kv_start, np.int32)
    ts = None if start is None else torch.from_numpy(start)
    o, _ = attention_causal_plain(tq, tk, tv, kv_start=ts)
    lse = attention_causal_lse_plain(tq.detach(), tk.detach(), ts)
    got = attention_causal_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                     o.detach(), tdo.detach(), lse, ts)
    auto = torch.autograd.grad(o, (tq, tk, tv), tdo.detach())
    _, vjp = jax.vjp(lambda q, k, v: JA.flash_attention_jnp(
        q, k, v, causal=True,
        kv_start=None if start is None else jnp.asarray(start)), jq, jk, jv)
    ref = vjp(jdo)
    for name, a, b, c in zip("qkv", got, auto, ref):
        assert a.dtype == b.dtype == getattr(torch, dtype)
        c = np.asarray(c.astype(jnp.float32))
        for other in (b.float().numpy(), c):
            tol = (ATTN_TOL if dtype == "float32" else BF16_ULP) * \
                np.abs(other).max()
            assert np.abs(a.float().numpy() - other).max() <= tol, name


def test_attention_causal_lse_plain():
    """The plain lse is the log of the softmax's denominator: exp(s - lse)
    sums to 1 over each row's keys, and matches ``torch.logsumexp``."""
    rng = np.random.default_rng(2)
    q, k = (torch.from_numpy(rng.standard_normal((1, 7, 2, 16)).astype(
        np.float32)) for _ in range(2))
    lse = attention_causal_lse_plain(q, k)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5
    s = s.masked_fill(~torch.ones(7, 7, dtype=torch.bool).tril(), -math.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("N", [1, 37, 64, 65, 100, 512, 1000])
def test_bwd_scratch_shape_covers_every_tile(N):
    """The backward kernel's scratch (lse log2e and D per row, read by its
    dK/dV kernel in TMA boxes of 64 positions) holds a whole box for every
    query tile the kernels walk, rows past N included, and its rows are
    the multiple of 16 bytes TMA requires of a stride."""
    from repro_torch.kernels.flash_attention import ops as FA
    two, B, Hq, Np = FA.bwd_scratch_shape(3, 5, N)
    assert (two, B, Hq) == (2, 3, 5)
    assert Np % FA.BWD_TILE == 0 and N <= Np < N + FA.BWD_TILE
    assert (Np * 4) % 16 == 0
    starts = range(0, N, FA.BWD_TILE)  # the query tiles of both kernels
    assert len(starts) == Np // FA.BWD_TILE
    assert all(r0 + FA.BWD_TILE <= Np for r0 in starts)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _steps(arch, prune, lr, eps, microbatches=1):
    """One reference step and one port step from the same state; returns
    (ref params, ref scores, ref metrics, port params, port scores, port
    metrics)."""
    jcfg, tcfg, jp, js = _model(arch, prune)
    jcfg, tcfg = (c.replace(microbatches=microbatches) for c in (jcfg, tcfg))
    b = _batch(jcfg, batch=4)
    jopt, topt = (JAdamW(lr=lr, eps=eps), AdamW(lr=lr, eps=eps))
    jtr = {"params": jp, "scores": js} if prune else jp
    jstep = jax.jit(JST.make_train_step(jcfg, jopt, with_pruning=prune))
    rp, rs, _, rm = jstep(jp, jopt.init(jtr),
                          {"tokens": jnp.asarray(b["tokens"])}, js)
    tp = _tparams(jp)
    ts = convert.lm_scores_from_jax(_np(js)) if prune else None
    ttr = {"params": tp, "scores": ts} if prune else tp
    tp1, ts1, opt1, tm = ST.make_train_step(tcfg, topt, with_pruning=prune)(
        tp, topt.init(ttr), {"tokens": torch.from_numpy(b["tokens"])}, ts)
    assert int(opt1.step) == 1
    return rp, rs, rm, tp1, ts1, tm


def _assert_step(rp, rs, rm, tp, ts, tm, lr, eps):
    tol = LINEAR_TOL if eps >= 1.0 else ADAM_TOL * lr
    assert sorted(tm) == sorted(rm) == ["aux", "ce", "loss"]
    for k in tm:
        assert abs(float(tm[k]) - float(rm[k])) <= \
            LOSS_TOL * max(1.0, abs(float(rm[k]))), k
    for path, a, r in _pairs(tp, _tparams(rp)):
        assert _rel(a.numpy(), r.numpy()) <= tol, ("params", path)
    if rs is not None:
        ref_scores = convert.lm_scores_from_jax(_np(rs))
        assert sorted(ts) == sorted(ref_scores)
        for path, a in ts.items():
            assert _rel(a.numpy(), ref_scores[path].numpy()) <= tol, path


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("prune", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("eps", [1e-8, 1.0])
def test_train_step_matches_reference(arch, prune, eps):
    """One ``make_train_step``, dense and with the paper's block pruning
    (scores converted by ``lm_scores_from_jax``, trained jointly)."""
    lr = 1e-3 if eps < 1.0 else 1.0
    _assert_step(*_steps(arch, prune, lr, eps), lr, eps)


def test_microbatches_match_reference_and_single_batch():
    """``microbatches=2`` against the reference at 2, and against the port
    at 1 (each half of the batch has the same number of labels, so the
    mean of the halves' losses is the batch's), at lr = eps = 1."""
    rp, rs, rm, tp, ts, tm = _steps("stablelm-1.6b", True, 1.0, 1.0, 2)
    _assert_step(rp, rs, rm, tp, ts, tm, 1.0, 1.0)
    _, _, _, tp1, ts1, tm1 = _steps("stablelm-1.6b", True, 1.0, 1.0, 1)
    for k in tm:
        assert abs(float(tm[k]) - float(tm1[k])) <= \
            LOSS_TOL * max(1.0, abs(float(tm1[k]))), k
    for a, b in zip(leaves(tp) + leaves(ts), leaves(tp1) + leaves(ts1)):
        assert _rel(a.numpy(), b.numpy()) <= LINEAR_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_policies_give_equal_gradients(dtype):
    """none / full / dots: bitwise-equal loss and gradients."""
    _, tcfg, jp, js = _model("minitron-4b", True)
    tcfg = tcfg.replace(dtype=dtype)
    b = {"tokens": torch.from_numpy(_batch(tcfg)["tokens"])}
    tp, ts = _tparams(jp), convert.lm_scores_from_jax(_np(js))
    out = {}
    for policy in ("none", "full", "dots"):
        fn = ST.make_grad_fn(tcfg.replace(remat_policy=policy), True)
        out[policy] = fn(tp, b, ts)
    loss, _, g = out["none"]
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], loss), policy
        for x, y in zip(leaves(out[policy][2]), leaves(g)):
            assert torch.equal(x, y), policy
    with pytest.raises(ValueError, match="remat_policy"):
        ST.make_grad_fn(tcfg.replace(remat_policy="some"), True)(tp, b, ts)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launch_train_lm_prune_and_exact_resume(tmp_path, capsys):
    """``--prune`` through the CLI, then a run stopped after 2 of 3 steps
    and resumed from its checkpoint (params, scores, optimizer state)
    against the same 3 steps uninterrupted: equal losses and state."""
    out = LT.main(["--arch", "stablelm-1.6b", "--device", "cpu", "--prune",
                   "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert "final loss" in capsys.readouterr().out
    assert sorted(out["state"]["scores"]) == sorted(
        f"layers/{i}/{m}/{w}" for i in range(3)
        for m, ws in (("attn", "wq wk wv wo"), ("mlp", "wg wi wo"))
        for w in ws.split())
    kw = dict(batch=2, seq=16, prune=True, device="cpu")
    whole = LT.train("stablelm-1.6b", steps=3, **kw)
    ck = str(tmp_path / "ck")
    first = LT.train("stablelm-1.6b", steps=2, ckpt_dir=ck,
                     checkpoint_every=1, **kw)
    again = LT.train("stablelm-1.6b", steps=3, ckpt_dir=ck,
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
