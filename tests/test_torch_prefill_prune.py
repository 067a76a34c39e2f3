"""The paper's TDM on an LM prompt (``models/prefill_prune``) and
``attention_block``'s ``positions`` / ``collect_scores`` / ``score_row``
against the reference package, on the CPU, at the reduced dense configs
with fp32 activations: Minitron-4B (GQA 4 over 1), StableLM-1.6B (MHA) and
Qwen3-14B (qk-norm), 3 layers, D=64, head_dim 16, vocab 256.

Weights come from the reference's seeded init (``convert
.lm_params_from_jax``); tokens, activations and scores from a numpy seed.
Tolerances:

* ``pruned_prefill_logits``: the tokens left equal, logits within 1e-3
  absolute (the dense LM's forward bound, ``tests/test_torch_lm.py``:
  fp32 sums over the layers in another order).
* ``_tdm_causal``: positions and kept rows equal (gathers), the carrier
  within 1e-6 (one weighted sum of fp32 values, in another order), on
  tie-heavy scores, where the kept set is decided by the lower index.
* ``attention_block``'s output and scores within 1e-5 of max(1, |ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import prefill_prune as JPP

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import prefill_prune as PP

LOGIT_TOL = 1e-3
OP_TOL = 1e-5
ARCHS = ("minitron-4b", "stablelm-1.6b", "qwen3-14b")
_MODELS = {}


def _model(arch, tdm_layers=(1,), r_t=0.7):
    key = (arch, tdm_layers, r_t)
    if key not in _MODELS:
        pr = dict(r_t=r_t, tdm_layers=tdm_layers)
        jcfg = j_get_config(arch).reduced().replace(dtype="float32")
        tcfg = get_config(arch).reduced().replace(dtype="float32")
        jcfg = jcfg.replace(pruning=type(jcfg.pruning)(**pr))
        tcfg = tcfg.replace(pruning=type(tcfg.pruning)(**pr))
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp))
        _MODELS[key] = (jcfg, tcfg, jp, tp)
    return _MODELS[key]


def _tokens(B, N, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (B, N)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tdm_layers", [(1,), (0, 2)], ids=["one", "two"])
def test_pruned_prefill_logits_match_reference(arch, tdm_layers):
    jcfg, tcfg, jp, tp = _model(arch, tdm_layers)
    toks = _tokens(3, 23)
    ref, n_ref = JPP.pruned_prefill_logits(jcfg, jp, jnp.asarray(toks))
    got, n = PP.pruned_prefill_logits(tcfg, tp, torch.from_numpy(toks))
    want_n = 23
    for _ in tdm_layers:
        want_n = int(np.ceil((want_n - 1) * 0.7)) + 2
    assert n == n_ref == want_n
    assert got.shape == (3, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=LOGIT_TOL)
    assert (got.argmax(-1).numpy() == np.asarray(ref).argmax(-1)).all()


def test_pruned_prefill_without_tdm_is_the_dense_last_logits():
    """r_t 1.0: no token drops, the logits are the dense forward's last."""
    from repro_torch.models import model as M
    _, tcfg, _, tp = _model("minitron-4b", (1,), 1.0)
    toks = torch.from_numpy(_tokens(2, 11))
    got, n = PP.pruned_prefill_logits(tcfg, tp, toks)
    dense = M.forward_lm(tcfg, tp, toks, mode="train",
                         logits_for="last").logits[:, -1]
    assert n == 11
    torch.testing.assert_close(got, dense, rtol=0, atol=1e-6)


@pytest.mark.parametrize("r_t", [0.5, 0.7])
def test_tdm_causal_matches_reference_on_ties(r_t):
    """Scores at three levels (many ties), positions already permuted by
    an earlier drop: kept rows, carrier and positions equal."""
    rng = np.random.default_rng(5)
    B, N, D = 3, 17, 8
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    pos = np.stack([np.sort(rng.choice(40, N, replace=False))
                    for _ in range(B)]).astype(np.int32)
    scores = rng.choice([0.0, 0.05, 0.1], (B, N)).astype(np.float32)
    rx, rpos = JPP._tdm_causal(jnp.asarray(x), jnp.asarray(pos),
                               jnp.asarray(scores), r_t)
    tx, tpos = PP._tdm_causal(torch.from_numpy(x), torch.from_numpy(pos),
                              torch.from_numpy(scores), r_t)
    k = int(np.ceil((N - 1) * r_t))
    assert tx.shape == (B, k + 2, D)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(rpos))
    np.testing.assert_allclose(tx.numpy(), np.asarray(rx), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tx[:, :k].numpy(), np.asarray(rx)[:, :k])


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen3-14b"])
@pytest.mark.parametrize("score_row", [-1, 4])
def test_attention_block_positions_and_scores_match_reference(arch,
                                                             score_row):
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.stack([np.sort(rng.choice(30, 9, replace=False))
                    for _ in range(2)]).astype(np.int32)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    ref, _, ref_s = JA.attention_block(
        jnp.asarray(x), jl["attn"], jcfg, causal=True,
        positions=jnp.asarray(pos), collect_scores=True,
        score_row=score_row)
    out, cache, s = A.attention_block(
        torch.from_numpy(x), tp["layers"][0]["attn"], tcfg,
        positions=torch.from_numpy(pos).long(), collect_scores=True,
        score_row=score_row)
    assert cache is None and s.shape == (2, 9) and s.dtype == torch.float32
    for a, r in ((out, ref), (s, ref_s)):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                   atol=OP_TOL * max(1.0, np.abs(r).max()))
    # without the options, the two-value form and the built positions
    two = A.attention_block(torch.from_numpy(x), tp["layers"][0]["attn"],
                            tcfg)
    built = A.attention_block(torch.from_numpy(x), tp["layers"][0]["attn"],
                              tcfg, positions=torch.arange(9).expand(2, 9))
    assert len(two) == 2 and torch.equal(two[0], built[0])


def test_prefill_tdm_refuses_other_families():
    tcfg = get_config("zamba2-1.2b").reduced()
    with pytest.raises(NotImplementedError, match="dense LMs only"):
        PP.pruned_prefill_logits(tcfg, {}, torch.zeros((1, 4),
                                                       dtype=torch.long))
    with pytest.raises(AssertionError):
        JPP.pruned_prefill_logits(j_get_config("zamba2-1.2b").reduced(), {},
                                  jnp.zeros((1, 4), jnp.int32))
