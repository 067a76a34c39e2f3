"""The ViT training path's kernels (Algorithm 1 on the card) against the
reference package, on the CPU: the plain versions of the non-causal
attention backward (``attention_bwd_plain``, with the gradient of the CLS
row's probabilities) and of the token-drop backward
(``token_drop_bwd_plain``), the autograd functions that run the kernels on
the card (``NonCausalAttention``, ``TokenDrop``) routed here through the
plain formulas, and the wrappers' argument checks. Inputs are numpy arrays
from a seed. Tolerances (fp32, sums taken in other orders by XLA and
PyTorch):

* attention: dq, dk, dv within 1e-5 x max(1, max|ref|) of ``jax.vjp`` of
  ``flash_attention_jnp(causal=False)`` plus ``attention_probs_row(q[:,
  0], k).mean(1)``, the reference's ViT attention and TDM scores;
* token drop: dz and dscores within 1e-6 x max(1, max|ref|) of
  ``jax.vjp`` of ``token_pruning.tdm``; dz bitwise dy's rows at CLS and
  the kept rows, dscores exactly 0 there;
* ``forward_vit``'s gradient with attention and TDM routed as on the card
  (the autograd functions over the plain formulas) within 1e-5 x max(1,
  max|ref|) of ``jax.grad`` of the reference's, per leaf, at the reduced
  DeiT-Small, kept token indices first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DEIT_SMALL as J_DEIT
from repro.core import token_pruning as JTP
from repro.models import attention as JA
from repro.models import model as JM

from repro_torch import convert
from repro_torch.configs import DEIT_SMALL as T_DEIT
from repro_torch.core import token_pruning as TP
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import (attention_bwd_plain,
                                                 attention_lse_plain,
                                                 attention_plain,
                                                 flash_attention)
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.token_drop import token_drop, token_drop_bwd_plain
from repro_torch.kernels.token_drop import ops as TD
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.tree import flatten_with_path, leaves, unflatten

ATTN_TOL = 1e-5
TDM_TOL = 1e-6
GRAD_TOL = 1e-5


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(1.0, np.abs(ref).max()))


# ---------------------------------------------------------------------------
# attention: the plain backward against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 17, 4, 16), (2, 197, 6, 64),
                                   (2, 140, 6, 64), (2, 100, 6, 64),
                                   (2, 72, 6, 64)],
                         ids=["reduced", "deit-small", "deit-small-n140",
                              "deit-small-n100", "deit-small-n72"])
@pytest.mark.parametrize("with_scores", [False, True],
                         ids=["o", "o+scores"])
def test_attention_bwd_plain_matches_reference(shape, with_scores):
    """The plain backward, from the plain forward's o and lse, against
    ``jax.vjp`` of the reference's non-causal attention and its TDM scores
    (their cotangent 0 without scores) and against autograd of the plain
    forward. The scores' gradient enters as the head mean's: dscores / H at
    every head."""
    B, N, H, Dh = shape
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    dsc = (rng.standard_normal((B, N)).astype(np.float32) if with_scores
           else np.zeros((B, N), np.float32))

    def ref_fn(q, k, v):
        o = JA.flash_attention_jnp(q, k, v, causal=False)
        return o, JA.attention_probs_row(q[:, 0], k).mean(axis=1)

    _, vjp = jax.vjp(ref_fn, *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp((jnp.asarray(do), jnp.asarray(dsc)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, probs = attention_plain(tq, tk, tv)
    lse = attention_lse_plain(tq.detach(), tk.detach())
    dprobs = (torch.from_numpy(dsc)[:, None, :].expand(B, H, N) / H
              if with_scores else None)
    got = attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                              o.detach(), torch.from_numpy(do), lse, dprobs)
    loss = (o * torch.from_numpy(do)).sum()
    if with_scores:
        loss = loss + (probs.mean(dim=1) * torch.from_numpy(dsc)).sum()
    auto = torch.autograd.grad(loss, (tq, tk, tv))
    for name, a, b, c in zip("qkv", got, auto, ref):
        assert a.dtype == torch.float32 and a.shape == shape
        assert _rel(a.numpy(), np.asarray(c)) <= ATTN_TOL, name
        assert _rel(a.numpy(), b.numpy()) <= ATTN_TOL, name


def test_attention_bwd_plain_takes_broadcast_dprobs():
    """The head mean's gradient reaches the backward as a broadcast view of
    dscores / H (stride 0 over heads), which the kernel reads in place: the
    plain backward gives bitwise the same result for that view as for its
    contiguous copy."""
    B, N, H, Dh = 2, 33, 3, 16
    rng = np.random.default_rng(9)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, N, H, Dh)).astype(np.float32)) for _ in range(4))
    dsc = torch.from_numpy(rng.standard_normal((B, N)).astype(np.float32))
    o, _ = attention_plain(q, k, v)
    lse = attention_lse_plain(q, k)
    view = (dsc / H)[:, None, :].expand(B, H, N)
    assert view.stride(1) == 0
    got = attention_bwd_plain(q, k, v, o, do, lse, view)
    want = attention_bwd_plain(q, k, v, o, do, lse, view.contiguous())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_attention_lse_plain():
    """The plain lse is the log of each row's softmax denominator:
    exp(s - lse) sums to 1 over the keys."""
    rng = np.random.default_rng(4)
    q, k = (torch.from_numpy(rng.standard_normal((2, 9, 3, 16)).astype(
        np.float32)) for _ in range(2))
    lse = attention_lse_plain(q, k)
    assert lse.shape == (2, 3, 9)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5
    torch.testing.assert_close(torch.exp(s - lse[..., None]).sum(-1),
                               torch.ones(2, 3, 9), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# token drop: the plain backward against the reference
# ---------------------------------------------------------------------------
def _scores(rng, B, N, ties):
    """Random scores normalised like CLS probabilities, or scores on three
    levels (ties at the k-th kept token certain)."""
    if ties:
        return (rng.integers(0, 3, size=(B, N)) / 8).astype(np.float32)
    s = rng.random((B, N)).astype(np.float32)
    return s / s.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("shape", [(3, 17, 64, 12), (2, 197, 384, 138),
                                   (2, 140, 384, 98), (2, 100, 384, 70)],
                         ids=["reduced", "layer2", "layer6", "layer9"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_token_drop_bwd_plain_matches_reference(shape, ties):
    """The plain backward, from the plain forward's output and kept
    indices, against ``jax.vjp`` of ``token_pruning.tdm`` (the same kept
    indices first: ties toward the lower index in both)."""
    B, N, D, k = shape
    rng = np.random.default_rng(5 + ties)
    z = rng.standard_normal((B, N, D)).astype(np.float32)
    s = _scores(rng, B, N, ties)
    dy = rng.standard_normal((B, k + 2, D)).astype(np.float32)

    jfwd, vjp = jax.vjp(lambda z, s: JTP.tdm(z, s, None, has_cls=True,
                                             k=k)[0],
                        jnp.asarray(z), jnp.asarray(s))
    jidx = np.asarray(JTP.tdm(jnp.asarray(z), jnp.asarray(s), None,
                              has_cls=True, k=k)[1])
    rdz, rds = (np.asarray(a) for a in vjp(jnp.asarray(dy)))

    out, idx = TP.tdm(torch.from_numpy(z), torch.from_numpy(s), None,
                      has_cls=True, k=k)
    assert np.array_equal(idx.numpy(), jidx)
    assert _rel(out.numpy(), np.asarray(jfwd)) <= TDM_TOL
    tdy = torch.from_numpy(dy)
    dz, ds = token_drop_bwd_plain(torch.from_numpy(z), torch.from_numpy(s),
                                  idx.to(torch.int32), out, tdy)
    assert dz.shape == (B, N, D) and ds.shape == (B, N)
    assert _rel(dz.numpy(), rdz) <= TDM_TOL
    assert _rel(ds.numpy(), rds) <= TDM_TOL
    rows = torch.arange(B)[:, None]
    assert torch.equal(dz[:, 0], tdy[:, 0])
    assert torch.equal(dz[rows, 1 + idx], tdy[:, 1:k + 1])
    assert bool((ds[:, 0] == 0).all())
    assert bool((ds[rows, 1 + idx] == 0).all())


# ---------------------------------------------------------------------------
# the card's routing, on the CPU: the autograd functions over plain formulas
# ---------------------------------------------------------------------------
@pytest.fixture
def card_routing(monkeypatch):
    """Make the wrappers route CPU tensors as they route CUDA tensors, with
    each launch replaced by its plain formula and counted: the autograd
    functions, their saved tensors and the head mean's gradient run as on
    the card (the forward's outputs detached, as an autograd function's
    are). The plain wrappers' branches must not run. Returns the launch
    counts by entry point and the kept indices [B, k] int32 each TDM
    forward wrote."""
    calls = {"flash_attention_f32": 0, "flash_attention_bwd_f32": 0,
             "token_drop_f32": 0, "token_drop_bwd_f32": 0}
    kept = []

    def attention(q, k, v, kv_len, collect_scores, with_lse=False):
        assert kv_len is None
        calls["flash_attention_f32"] += 1
        o = A.flash_attention_torch(q, k, v).detach()
        probs = (A.attention_probs_row(q[:, 0], k).detach()
                 if collect_scores else None)
        return o, probs, attention_lse_plain(q, k) if with_lse else None

    def attention_bwd(q, k, v, o, do, lse, dprobs):
        calls["flash_attention_bwd_f32"] += 1
        return attention_bwd_plain(q, k, v, o, do, lse, dprobs)

    def drop(z, scores, k, with_idx):
        calls["token_drop_f32"] += 1
        out, idx = TP.tdm(z, scores, None, has_cls=True, k=k)
        kept.append(idx.to(torch.int32))
        return out, kept[-1] if with_idx else None

    def drop_bwd(z, scores, idx, y, dy):
        calls["token_drop_bwd_f32"] += 1
        return token_drop_bwd_plain(z, scores, idx, y, dy)

    def refused(*a, **kw):
        raise AssertionError("a plain wrapper branch ran on the card's route")

    monkeypatch.setattr(backend, "on_card", lambda *t: True)
    monkeypatch.setattr(FA, "_attention_cuda", attention)
    monkeypatch.setattr(FA, "_attention_bwd_cuda", attention_bwd)
    monkeypatch.setattr(FA, "attention_plain", refused)
    monkeypatch.setattr(TD, "_token_drop_cuda", drop)
    monkeypatch.setattr(TD, "_token_drop_bwd_cuda", drop_bwd)
    monkeypatch.setattr(TD, "token_drop_plain", refused)
    return calls, kept


def test_noncausal_attention_routed_gradient(card_routing):
    """``flash_attention(collect_scores=True)`` with a gradient takes
    ``NonCausalAttention``: one forward and one backward launch, and the
    gradient of o and of the head-mean scores equal to autograd of the
    plain version (both feed ``attention_bwd_plain`` or autograd the same
    cotangents)."""
    rng = np.random.default_rng(6)
    shape = (2, 17, 4, 16)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    co = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    cs = torch.from_numpy(rng.standard_normal((2, 17)).astype(np.float32))
    calls, _ = card_routing
    got = []
    for routed in (True, False):
        t = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
        if routed:
            o, sc = flash_attention(*t, collect_scores=True)
        else:
            o, p = attention_plain(*t)
            sc = p.mean(dim=1)
        got.append(torch.autograd.grad((o * co).sum() + (sc * cs).sum(), t))
    assert calls["flash_attention_f32"] == 1
    assert calls["flash_attention_bwd_f32"] == 1
    for a, b in zip(*got):
        assert _rel(a.numpy(), b.numpy()) <= ATTN_TOL


def test_token_drop_routed_gradient(card_routing):
    """``token_drop`` with a gradient takes ``TokenDrop``: its forward
    writes the kept indices [B, k] int32, TP.tdm's, and the gradients of z
    and of the scores equal autograd of ``TP.tdm``'s."""
    rng = np.random.default_rng(7)
    B, N, D, k = 3, 17, 64, 12
    z = rng.standard_normal((B, N, D)).astype(np.float32)
    s = _scores(rng, B, N, ties=True)
    co = torch.from_numpy(rng.standard_normal((B, k + 2, D)).astype(
        np.float32))
    calls, kept = card_routing
    got = []
    for routed in (True, False):
        tz, ts = (torch.from_numpy(a).requires_grad_(True) for a in (z, s))
        if routed:
            out, idx = token_drop(tz, ts, k), kept[-1]
            assert type(out.grad_fn).__name__ == "TokenDropBackward"
            assert idx.dtype == torch.int32
        else:
            out, idx = TP.tdm(tz, ts, None, has_cls=True, k=k)
        got.append((idx.long(), torch.autograd.grad((out * co).sum(),
                                                    (tz, ts))))
    assert calls["token_drop_f32"] == 1
    assert calls["token_drop_bwd_f32"] == 1
    (ia, ga), (ib, gb) = got
    assert torch.equal(ia, ib)
    for a, b in zip(ga, gb):
        assert _rel(a.numpy(), b.numpy()) <= TDM_TOL


def test_forward_vit_routed_gradient_matches_reference(card_routing):
    """The slice as a whole: ``forward_vit``'s loss gradient at the reduced
    DeiT-Small (TDM at layer 1) with attention and the TDM on the card's
    route against ``jax.grad`` of the reference's, per leaf; the routed
    run launches 3 attention forwards and backwards and one TDM each way,
    and the teacher's no-grad forward no backward."""
    jcfg, tcfg = J_DEIT.reduced().replace(dtype="float32"), T_DEIT.reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    n = (tcfg.image_size // tcfg.patch_size) ** 2
    patches = rng.standard_normal((4, n, tcfg.patch_size ** 2 * 3)).astype(
        np.float32)
    labels = rng.integers(0, tcfg.num_classes, size=(4,)).astype(np.int32)

    def jloss(p):
        return JM.softmax_xent(JM.forward_vit(jcfg, p, jnp.asarray(
            patches)).logits, jnp.asarray(labels))

    jgrads = jax.grad(jloss)(jparams)
    params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
    calls, kept = card_routing
    flat = [t.detach().requires_grad_(True) for t in leaves(params)]
    out = M.forward_vit(tcfg, unflatten(params, flat),
                        torch.from_numpy(patches))
    loss = M.softmax_xent(out.logits, torch.from_numpy(labels).long())
    grads = torch.autograd.grad(loss, flat)
    with torch.no_grad():
        M.forward_vit(tcfg, params, torch.from_numpy(patches),
                      use_tdm=False)
    L = tcfg.num_layers
    assert calls == {"flash_attention_f32": 2 * L,
                            "flash_attention_bwd_f32": L,
                            "token_drop_f32": 1, "token_drop_bwd_f32": 1}
    ref_kept = _reference_kept(jcfg, jparams, patches)
    assert len(kept) == len(ref_kept) == len(tcfg.pruning.tdm_layers)
    for a, b in zip(kept, ref_kept):
        assert np.array_equal(a.long().numpy(), b)
    for (path, a), b in zip(flatten_with_path(unflatten(params, list(grads))),
                            jax.tree_util.tree_leaves(jgrads)):
        assert _rel(a.numpy(), np.asarray(b)) <= GRAD_TOL, path


def _reference_kept(jcfg, jparams, patches):
    """The reference's kept token indices at each TDM of its forward."""
    kept = []
    inner = JTP.tdm

    def tdm(*a, **kw):
        out = inner(*a, **kw)
        kept.append(np.asarray(out[1]))
        return out
    JTP.tdm = tdm
    try:
        JM.forward_vit(jcfg, jparams, jnp.asarray(patches))
    finally:
        JTP.tdm = inner
    return kept


# ---------------------------------------------------------------------------
# the wrappers' argument checks (raised before any launch)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["kv_len", "fp16", "head_dim"])
def test_noncausal_gradient_forms_raise(case, monkeypatch):
    """With a gradient, the card takes the non-causal form in fp32, without
    kv_len, at a head width in ``HEAD_DIMS``: anything else raises before a
    launch, and never falls back to the plain version."""
    def refused(*a, **kw):
        raise AssertionError("launched or fell back")
    monkeypatch.setattr(backend, "on_card", lambda *t: True)
    monkeypatch.setattr(backend, "launch", refused)
    monkeypatch.setattr(FA, "attention_plain", refused)
    dt = torch.float16 if case == "fp16" else torch.float32
    Dh = 32 if case == "head_dim" else 16
    q, k, v = (torch.zeros((1, 5, 2, Dh), dtype=dt, requires_grad=True)
               for _ in range(3))
    kv_len = torch.tensor([3], dtype=torch.int32) if case == "kv_len" \
        else None
    err = TypeError if case == "fp16" else ValueError
    with pytest.raises(err):
        flash_attention(q, k, v, kv_len=kv_len, collect_scores=True)


def test_token_drop_gradient_forms_raise(monkeypatch):
    """The TDM's training form checks what the kernel takes (fp32, D a
    multiple of 4, at most ``MAX_TOKENS`` tokens) before a launch."""
    def refused(*a, **kw):
        raise AssertionError("launched or fell back")
    monkeypatch.setattr(backend, "on_card", lambda *t: True)
    monkeypatch.setattr(backend, "launch", refused)
    z = torch.zeros((1, 5, 6), requires_grad=True)
    with pytest.raises(ValueError):
        token_drop(z, torch.zeros((1, 5)), 2)
    z = torch.zeros((1, 5, 8), dtype=torch.float64, requires_grad=True)
    with pytest.raises(TypeError):
        token_drop(z, torch.zeros((1, 5), dtype=torch.float64), 2)
    z = torch.zeros((1, TD.MAX_TOKENS + 1, 8), requires_grad=True)
    with pytest.raises(ValueError):
        token_drop(z, torch.zeros((1, TD.MAX_TOKENS + 1)), 2)
