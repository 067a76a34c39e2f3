"""Training the SSM and hybrid families in the port, against the reference
package on the CPU, at the reduced configs with fp32 activations:
Zamba2-1.2B (4 Mamba2 layers of 2 heads of dh 64, state 8, in 2 stages
with a shared block of 4 MHA heads of dh 16; and 5 layers, a tail) and
RWKV6-1.6B (3 layers of 4 WKV heads of dh 16), vocab 256.

Weights and scores come from the reference's seeded init, converted
(``convert.lm_params_from_jax`` / ``lm_scores_from_jax``); batches are
``synthetic_lm_batch`` (bit-identical in both packages); scan inputs are
drawn from a numpy seed. Tolerances:

* the plain backward versions (``mamba_scan_bwd_plain``,
  ``wkv6_bwd_plain``) against ``torch.autograd`` of the plain scans: the
  fp32 gradients within 1e-5 of max(1, max|autograd|) (sums in another
  order); a gradient of a bf16 input (dx; dr, dk, dv) within one bf16 ulp
  (2^-7) of that, since autograd rounds it to bf16 and the plain backward
  keeps fp32.
* ``lm_loss`` within 1e-5 of max(1, |ref|); each gradient leaf of
  ``make_grad_fn`` within 1e-4 of its largest |jax.grad| element (fp32
  sums over the scans and layers in other orders), the dense LM's bounds
  (``tests/test_torch_lm_train.py``), where that element is at least
  1e-3 of the largest of any leaf. Below it, 1e-4 of that floor: a
  Mamba2 layer's ``A_log`` gradient is a sum over steps, rows and batch
  rows of terms far larger than itself (measured: 8.5e-4 at most, its
  error 1.2e-7, the largest of any leaf 3.5).
* params and scores after two ``make_train_step`` steps, relative to
  max(1, |ref|): 0.25 x lr (AdamW's steps move an element by about lr
  whatever the gradient's size, so gradient noise near eps moves it by a
  fraction of lr), the dense LM's bound.
* the remat policies, a resumed launcher run and the routing as on the
  card: EQUAL.
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
from repro.models import pruning_glue as JPG
from repro.models import steps as JST
from repro.optim import AdamW as JAdamW

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import ops as SS
from repro_torch.launch import train as LT
from repro_torch.models import pruning_glue as PG
from repro_torch.models import steps as ST
from repro_torch.optim import AdamW
from repro_torch.tree import flatten_with_path, leaves

OP_TOL = 1e-5
BF16_ULP = 2.0 ** -7
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 0.25  # x lr
PRUNE = dict(block_size=16, r_b=0.5, r_t=1.0)  # launch/train's --prune
# (arch, layers): the reduced configs, and Zamba2 at 5 layers (a tail)
VARIANTS = {"zamba2": ("zamba2-1.2b", None), "zamba2-tail": ("zamba2-1.2b", 5),
            "rwkv6": ("rwkv6-1.6b", None)}
_MODELS = {}


def _model(name, prune=False):
    """(reference cfg, port cfg, reference params, reference scores or
    None) at the reduced config, fp32 activations; built once."""
    key = (name, prune)
    if key not in _MODELS:
        arch, layers = VARIANTS[name]
        jcfg = j_get_config(arch).reduced().replace(dtype="float32")
        tcfg = get_config(arch).reduced().replace(dtype="float32")
        if layers:
            jcfg, tcfg = (c.replace(num_layers=layers) for c in (jcfg, tcfg))
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
    ref = dict(flatten_with_path(ref_tree))
    out = [(path, a, ref[path]) for path, a in flatten_with_path(t_tree)]
    assert len(out) == len(ref)
    return out


# ---------------------------------------------------------------------------
# the plain backward versions
# ---------------------------------------------------------------------------
def _scan_case(kind, S, dtype, nonzero, B=2, H=3, dh=5, N=4):
    """A scan's inputs (leaves requiring grad), and the gradients of its
    outputs, from a numpy seed; the final state's gradient and the initial
    state nonzero with ``nonzero``."""
    rng = np.random.default_rng(S + 7 * nonzero)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    u01 = lambda *s: torch.from_numpy(rng.uniform(0.05, 1.0, s).astype(
        np.float32))
    state = lambda *s: t(*s) if nonzero else torch.zeros(s)
    if kind == "mamba":
        ins = (t(B, S, H, dh).to(dtype), u01(B, S, H), u01(B, S, H),
               t(B, S, N), t(B, S, N), state(B, H, dh, N))
        grads = (t(B, S, H, dh), state(B, H, dh, N))
    else:
        ins = (*(t(B, S, H, dh).to(dtype) for _ in range(3)),
               u01(B, S, H, dh), t(H, dh), state(B, H, dh, dh))
        grads = (t(B, S, H, dh), state(B, H, dh, dh))
    return [a.requires_grad_() for a in ins], grads


@pytest.mark.parametrize("kind", ["mamba", "wkv6"])
@pytest.mark.parametrize("S", [1, 5, 70])
@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "nonzero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_plain_backward_matches_autograd(kind, S, nonzero, dtype):
    """The reverse recurrences against autograd through the plain loops,
    with zero and nonzero initial states and final-state gradients."""
    fwd, bwd = ((SS.mamba_scan_plain, SS.mamba_scan_bwd_plain)
                if kind == "mamba" else (SS.wkv6_plain, SS.wkv6_bwd_plain))
    ins, (dy, ds) = _scan_case(kind, S, dtype, nonzero)
    y, s = fwd(*ins)
    ref = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), ins)
    got = bwd(*(a.detach() for a in ins), dy, ds)
    assert len(got) == len(ref) == 6
    for a, r, x in zip(got, ref, ins):
        assert a.dtype == torch.float32 and a.shape == x.shape
        tol = BF16_ULP if x.dtype == torch.bfloat16 else OP_TOL
        assert _rel(a.numpy(), r.float().numpy()) <= tol


@pytest.mark.parametrize("kind", ["mamba", "wkv6"])
def test_scan_functions_take_the_plain_backward_on_the_cpu(kind):
    """With grad, the wrappers run the autograd Functions: the forward the
    plain version's exactly, the gradients the plain backward's, in each
    input's dtype."""
    fn, fwd, bwd = ((SS.mamba_scan, SS.mamba_scan_plain,
                     SS.mamba_scan_bwd_plain) if kind == "mamba" else
                    (SS.wkv6, SS.wkv6_plain, SS.wkv6_bwd_plain))
    ins, (dy, ds) = _scan_case(kind, 9, torch.bfloat16, True)
    y, s = fn(*ins)
    assert y.grad_fn is not None and "Backward" in type(y.grad_fn).__name__
    y_ref, s_ref = fwd(*(a.detach() for a in ins))
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    got = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), ins)
    want = bwd(*(a.detach() for a in ins), dy, ds)
    for a, w, x in zip(got, want, ins):
        assert a.dtype == x.dtype and torch.equal(a, w.to(x.dtype))


def test_backward_constants_match_the_kernels():
    """The wrappers' scratch sizes and grids follow the kernels: the
    sequential form's (``scan_bwd.cuh``: a checkpoint every ``BWD_CKPT``
    steps, windows of ``BWD_WINDOW``, ``BWD_BLOCKS_PER_SM`` persistent
    blocks an SM) and the chunked form's (``scan_bwd_chunk.cuh``: chunks of
    ``CHUNK`` steps in sub-chunks of ``SUB``, a start state and an end
    adjoint of ``MAX_WIDTH`` x ``MAX_WIDTH`` floats a chunk and item)."""
    import pathlib
    csrc = pathlib.Path(SS.__file__).parents[1] / "csrc"
    src = (csrc / "scan_bwd.cuh").read_text()
    for const, want in (("kCk", SS.BWD_CKPT), ("kW", SS.BWD_WINDOW),
                        ("kMax", SS.MAX_WIDTH)):
        assert f"constexpr int {const} = {want};" in src, const
    for name in ("mamba_scan_bwd.cu", "wkv6_bwd.cu"):
        assert (f"__launch_bounds__(kThreads, {SS.BWD_BLOCKS_PER_SM})"
                in (csrc / name).read_text()), name
    chunk = (csrc / "scan_bwd_chunk.cuh").read_text()
    for const, want in (("kC", SS.CHUNK), ("kSub", SS.SUB),
                        ("kW", SS.MAX_WIDTH)):
        assert f"constexpr int {const} = {want};" in chunk, const
    assert SS.bwd_scratch_floats(1) == 9 * 64 * 64
    assert SS.bwd_scratch_floats(512) == (16 + 8) * 64 * 64
    assert SS.bwd_bounds_floats(512, 512) == 2 * 512 * 8 * 64 * 64
    assert SS.bwd_bounds_floats(3, 65) == 2 * 3 * 2 * 64 * 64


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(VARIANTS))
def test_lm_loss_gradients_match_reference(name):
    """``jax.grad`` of the reference's ``lm_loss`` (its remat on for the
    SSM) against ``make_grad_fn`` (full remat for the SSM, none for the
    hybrid, as in the reference)."""
    jcfg, tcfg, jp, _ = _model(name)
    b = _batch(jcfg)
    tok = {"tokens": jnp.asarray(b["tokens"])}
    ref_loss, jg = jax.value_and_grad(
        lambda p: JM.lm_loss(jcfg, p, tok)[0])(jp)
    loss, parts, g = ST.make_grad_fn(tcfg, with_pruning=False)(
        _tparams(jp), {"tokens": torch.from_numpy(b["tokens"])})
    assert sorted(parts) == ["aux", "ce"] and float(parts["aux"]) == 0.0
    assert abs(float(loss) - float(ref_loss)) <= \
        LOSS_TOL * max(1.0, abs(float(ref_loss)))
    pairs = _pairs(g, _tparams(jg))
    floor = 1e-3 * max(np.abs(r.numpy()).max() for _, _, r in pairs)
    for path, a, r in pairs:
        r = r.numpy()
        assert np.abs(a.numpy() - r).max() <= \
            GRAD_TOL * max(np.abs(r).max(), floor), path


def test_remat_policies_give_equal_gradients():
    """RWKV6 under none / full / dots: bitwise-equal loss and gradients."""
    _, tcfg, jp, _ = _model("rwkv6")
    b = {"tokens": torch.from_numpy(_batch(tcfg)["tokens"])}
    tp = _tparams(jp)
    out = {p: ST.make_grad_fn(tcfg.replace(remat_policy=p), False)(tp, b)
           for p in ("none", "full", "dots")}
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        for x, y in zip(leaves(out[policy][2]), leaves(out["none"][2])):
            assert torch.equal(x, y), policy


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["zamba2", "rwkv6"])
@pytest.mark.parametrize("prune", [False, True], ids=["dense", "pruned"])
def test_train_step_matches_reference_over_two_steps(name, prune):
    """Two ``make_train_step`` steps from the same state, dense and with
    the paper's block pruning (scores converted, trained jointly):
    metrics, params and scores against the reference's jitted step."""
    lr = 1e-3
    jcfg, tcfg, jp, js = _model(name, prune)
    jopt, topt = JAdamW(lr=lr), AdamW(lr=lr)
    jstep = jax.jit(JST.make_train_step(jcfg, jopt, with_pruning=prune))
    tstep = ST.make_train_step(tcfg, topt, with_pruning=prune)
    rp, rs = jp, js
    rst = jopt.init({"params": jp, "scores": js} if prune else jp)
    tp = _tparams(jp)
    ts = convert.lm_scores_from_jax(_np(js)) if prune else None
    tst = topt.init({"params": tp, "scores": ts} if prune else tp)
    for step in range(2):
        b = _batch(jcfg, batch=2, step=step)
        rp, rs2, rst, rm = jstep(rp, rst, {"tokens": jnp.asarray(
            b["tokens"])}, rs)
        rs = rs2 if prune else rs
        tp, ts, tst, tm = tstep(tp, tst, {"tokens": torch.from_numpy(
            b["tokens"])}, ts)
        for k in ("loss", "ce", "aux"):
            assert abs(float(tm[k]) - float(rm[k])) <= \
                LOSS_TOL * max(1.0, abs(float(rm[k]))), (step, k)
    assert int(tst.step) == 2
    for path, a, r in _pairs(tp, _tparams(rp)):
        assert _rel(a.numpy(), r.numpy()) <= ADAM_TOL * lr, path
    if prune:
        ref_scores = convert.lm_scores_from_jax(_np(rs))
        assert sorted(ts) == sorted(ref_scores)
        for path, a in ts.items():
            assert _rel(a.numpy(), ref_scores[path].numpy()) <= \
                ADAM_TOL * lr, path


def test_prune_picks_the_reference_leaves():
    """``--prune`` scores the hybrid's shared block (attention and MLP) and
    RWKV6's channel mix, as the reference's ``init_scores`` does, and the
    decay rule follows the reference's stacked layout."""
    for name, want in (("zamba2", {f"shared_attn/{m}/{w}" for m, ws in (
            ("attn", "wq wk wv wo"), ("mlp", "wg wi wo"))
            for w in ws.split()}),
            ("rwkv6", {f"layers/{i}/{w}" for i in range(3)
                       for w in ("cm_wk", "cm_wv")})):
        jcfg, tcfg, jp, js = _model(name, True)
        scores = PG.init_scores(tcfg, _tparams(jp), torch.Generator())
        assert set(scores) == want
        assert set(convert.lm_scores_from_jax(_np(js))) == want
        for path, s in scores.items():
            assert s.shape == convert.lm_scores_from_jax(_np(js))[path].shape
    _, tcfg, jp, _ = _model("zamba2-tail")
    decay = dict(zip((p for p, _ in flatten_with_path(_tparams(jp))),
                     ST.stacked_decay(_tparams(jp))))
    for path, d in decay.items():
        head = path[0]
        want = head in ("stages", "tail") or (head == "shared_attn" and
                                              path[-1] not in ("ln1", "ln2"))
        assert d == (want or head in ("embed", "unembed")), path


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b"])
def test_launch_train_prune_and_exact_resume(tmp_path, capsys, arch):
    """``--prune`` through the CLI, then a run stopped after 2 of 3 steps
    and resumed from its checkpoint against the same 3 steps
    uninterrupted: equal losses and state."""
    out = LT.main(["--arch", arch, "--device", "cpu", "--prune", "--steps",
                   "2", "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert "final loss" in capsys.readouterr().out
    assert out["state"]["scores"]
    kw = dict(batch=2, seq=16, prune=True, device="cpu")
    whole = LT.train(arch, steps=3, **kw)
    ck = str(tmp_path / "ck")
    first = LT.train(arch, steps=2, ckpt_dir=ck, checkpoint_every=1, **kw)
    again = LT.train(arch, steps=3, ckpt_dir=ck, checkpoint_every=1, **kw)
    assert (2, "restored") in again["events"]
    assert first["losses"] + again["losses"] == whole["losses"]
    for key in ("params", "scores", "opt"):
        for a, b in zip(leaves(again["state"][key]),
                        leaves(whole["state"][key])):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the routing on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["zamba2-tail", "rwkv6"])
def test_backward_launches_each_kernel_once_per_scan_call(monkeypatch,
                                                          name):
    """With the scans' module routed as on the card (``backend.on_card``
    true, ``backend.launch`` recording instead of launching), one training
    gradient launches the forward scan once per layer (twice for RWKV6,
    recomputed under full remat) and its backward kernel once per layer,
    at 16 tokens (the sequential backward) and at 48 (the chunked: each
    backward call's scratch the one of the form its length picks); no
    plain scan or plain backward runs."""
    _, tcfg, jp, _ = _model(name)
    calls, forms = [], []

    def refused(*a, **k):
        raise AssertionError("a plain scan ran on a card tensor")
    monkeypatch.setattr(SS, "backend", types.SimpleNamespace(
        on_card=lambda *t: True,
        launch=lambda lib, entry, dev, *a, **k: calls.append(entry)))
    monkeypatch.setattr(SS, "bwd_slots", lambda dev, items: 2)
    scratch = SS._bwd_scratch

    def recorded(kind, dev, items, S):
        slots, buf = scratch(kind, dev, items, S)
        want = (SS.bwd_bounds_floats(items, S)
                if SS.bwd_form(kind, S) == "chunked"
                else slots * SS.bwd_scratch_floats(S))
        assert buf.numel() == want
        forms.append(SS.bwd_form(kind, S))
        return slots, buf
    monkeypatch.setattr(SS, "_bwd_scratch", recorded)
    for plain in ("mamba_scan_plain", "wkv6_plain", "mamba_scan_bwd_plain",
                  "wkv6_bwd_plain"):
        monkeypatch.setattr(SS, plain, refused)
    L = tcfg.num_layers
    fwd, bwd = (("wkv6_f32", "wkv6_bwd_f32") if tcfg.family == "ssm"
                else ("mamba_scan_f32", "mamba_scan_bwd_f32"))
    for seq, form in ((16, "sequential"), (48, "chunked")):
        calls.clear()
        forms.clear()
        b = {"tokens": torch.from_numpy(_batch(tcfg, seq=seq)["tokens"])}
        ST.make_grad_fn(tcfg, with_pruning=False)(_tparams(jp), b)
        assert calls.count(bwd) == L
        assert calls.count(fwd) == (2 * L if tcfg.family == "ssm" else L)
        assert len(calls) == calls.count(fwd) + calls.count(bwd)
        assert forms == [form] * L
