"""The non-causal bf16 kernels' split of the key range, on the CPU: the
host's plans (``noncausal_prefill_plan``, ``noncausal_decode_plan``) and
``key_chunks``, and ``attention_noncausal_chunked_plain``, the kernels'
split-key algorithm as tensor code (per chunk the partial m, l and
unnormalised o in log2 units, combined in chunk order), against
``attention_noncausal_plain`` and the reference's
``flash_attention_jnp(causal=False)`` (``src/repro/models/attention.py``).

Inputs are numpy arrays from a seed, at fp32: both sides then take exact
products and differ only in the order of fp32 sums and in exp against
exp2 of scaled scores, so the tolerance is ``OP_TOL`` = 1e-5 (absolute and
relative), ``tests/test_torch_lm.py``'s for attention at fp32. At bf16
the twin and the plain version each round an fp32 result once: within one
bf16 ulp of the largest element, as the card's checks hold the kernels.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA

from repro_torch.kernels.flash_attention import ops as FA

OP_TOL = 1e-5
BF16_ULP = 2.0 ** -7
CSRC = pathlib.Path(FA.__file__).resolve().parents[1] / "csrc"

KEYS = (1, 8, 33, 65, 1601)
GROUPS = ((4, 4), (8, 1))  # (Hq, KV): GQA 1:1 and 8:1
HEAD_DIMS = (16, 64, 128)


def _inputs(B, Nq, Hq, KV, Nk, Dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Nq, Hq, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, Nk, KV, Dh)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _chunk_counts(Nk):
    """1, 2, the most (up to MAX_CHUNKS) and the prefill plan's count at a
    132-SM card, each as a kernel takes it: at most the key tiles, and
    the count its tiles per chunk give back (no chunk empty)."""
    n_kt = -(-Nk // FA.NONCAUSAL_TILE)
    plan = FA.noncausal_prefill_plan(2, 3, 8, 1, Nk, 132)[1]
    return sorted({-(-n_kt // -(-n_kt // min(n, n_kt)))
                   for n in (1, 2, FA.MAX_CHUNKS, plan)})


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("Hq,KV", GROUPS)
@pytest.mark.parametrize("Nk", KEYS)
def test_chunked_twin_matches_plain_and_reference(Nk, Hq, KV, Dh):
    """The split-key combine at every chunk count a plan may give equals
    the plain version and the reference's non-causal attention within
    OP_TOL at fp32."""
    q, k, v = _inputs(2, 3, Hq, KV, Nk, Dh)
    ref = np.asarray(JA.flash_attention_jnp(
        *map(jnp.asarray, (q, k, v)), causal=False))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = FA.attention_noncausal_plain(tq, tk, tv)
    np.testing.assert_allclose(plain.numpy(), ref, atol=OP_TOL, rtol=OP_TOL)
    for n in _chunk_counts(Nk):
        got = FA.attention_noncausal_chunked_plain(tq, tk, tv, n)
        assert got.dtype == torch.float32 and got.shape == tq.shape
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=OP_TOL,
                                   rtol=OP_TOL, err_msg=f"{n} chunks")
        np.testing.assert_allclose(got.numpy(), ref, atol=OP_TOL,
                                   rtol=OP_TOL, err_msg=f"{n} chunks")


@pytest.mark.parametrize("Nk", (65, 1601))
def test_chunked_twin_bf16_within_one_ulp(Nk):
    """On bf16 operands the twin (fp32 inside, rounded once) is within one
    bf16 ulp of the largest element of the plain version."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _inputs(2, 5, 8, 1, Nk, 64, seed=1))
    plain = FA.attention_noncausal_plain(q, k, v).float()
    for n in _chunk_counts(Nk):
        got = FA.attention_noncausal_chunked_plain(q, k, v, n)
        assert got.dtype == torch.bfloat16
        err = (got.float() - plain).abs().max().item()
        assert err <= BF16_ULP * plain.abs().max().item(), (n, err)


# (B, Nq, Hq, KV, Nk): the multimodal serves' shapes (Whisper-base's
# encoder and cross prefill, Llama-3.2-Vision-90B's cross prefill, both
# decodes), the reduced configs' and edge counts of rows and keys
PLAN_SHAPES = (
    (4, 1500, 8, 8, 1500), (4, 32, 8, 8, 1500), (2, 64, 64, 8, 1601),
    (4, 1, 8, 8, 1500), (2, 1, 64, 8, 1601), (3, 5, 4, 1, 8),
    (3, 70, 4, 1, 33), (1, 1, 8, 1, 65), (2, 1, 32, 1, 100),
    (1, 1, 1, 1, 1), (64, 197, 6, 6, 197), (1, 7, 2, 1, 100000),
)


def _covers_once(Nk, n):
    """key_chunks(Nk, n) is n non-empty ranges that tile [0, Nk) in
    order, each a whole number of 64-key tiles but the last, and the count
    the kernels' own check accepts."""
    chunks = FA.key_chunks(Nk, n)
    assert len(chunks) == n
    assert chunks[0][0] == 0 and chunks[-1][1] == Nk
    for (lo, hi), (nxt, _) in zip(chunks, chunks[1:] + ((Nk, Nk),)):
        assert lo < hi == nxt  # none empty, no gap, no overlap
    assert all(lo % FA.NONCAUSAL_TILE == 0 for lo, _ in chunks)
    n_kt = -(-Nk // FA.NONCAUSAL_TILE)
    per = -(-n_kt // n)
    assert n == -(-n_kt // per)  # flash_prefill.cu / flash_decode.cu


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
@pytest.mark.parametrize("sms", (132, 114, 16, 1))
def test_plans_cover_every_key_once(shape, sms):
    """Each plan splits the keys into chunks that cover every key once,
    none empty, within the kernels' limits, and gives the same answer for
    the same shape."""
    B, Nq, Hq, KV, Nk = shape
    if Nq == 1:
        n = FA.noncausal_decode_plan(B, Hq, KV, Nk, sms)
        assert n == FA.noncausal_decode_plan(B, Hq, KV, Nk, sms)
        assert 1 <= n <= FA.MAX_SPLITS
    else:
        wgs, n = FA.noncausal_prefill_plan(B, Nq, Hq, KV, Nk, sms)
        assert (wgs, n) == FA.noncausal_prefill_plan(B, Nq, Hq, KV, Nk, sms)
        assert wgs == (2 if Nq * (Hq // KV) > 64 else 1)
        assert 1 <= n <= FA.MAX_CHUNKS
    _covers_once(Nk, n)


@pytest.mark.parametrize("Nk", (1, 63, 64, 65, 1500, 1601, 100000))
def test_key_chunks_every_count(Nk):
    """Every chunk count up to the tiles (and the kernels' limit) whose
    tiles-per-chunk gives it back cuts the keys without gap or overlap."""
    n_kt = -(-Nk // FA.NONCAUSAL_TILE)
    for n in range(1, min(n_kt, FA.MAX_SPLITS) + 1):
        per = -(-n_kt // n)
        if n == -(-n_kt // per):
            _covers_once(Nk, n)


def test_plans_at_the_serves_shapes():
    """On a 132-SM card: Whisper's encoder walks whole keys with two
    warpgroups a block; its cross prefill (32 rows a (b, g)) and
    Llama-Vision's (512 rows) split the keys; both decodes fill about one
    wave of blocks walking several tiles each."""
    assert FA.noncausal_prefill_plan(4, 1500, 8, 8, 1500, 132) == (2, 1)
    wgs, n = FA.noncausal_prefill_plan(4, 32, 8, 8, 1500, 132)
    assert wgs == 1 and n > 1 and 32 * n <= 2 * 132
    wgs, n = FA.noncausal_prefill_plan(2, 64, 64, 8, 1601, 132)
    assert wgs == 2 and n > 1 and 64 * n <= 132
    for B, Hq, KV, Nk in ((4, 8, 8, 1500), (2, 64, 8, 1601)):
        n = FA.noncausal_decode_plan(B, Hq, KV, Nk, 132)
        assert n > 1 and B * KV * n <= FA.DECODE_BLOCKS_PER_SM * 132


def test_constants_match_the_sources():
    """The host's constants are the kernels' own."""
    pre = (CSRC / "flash_prefill.cu").read_text()
    dec = (CSRC / "flash_decode.cu").read_text()
    tile = (CSRC / "wgmma_tile.cuh").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))
    assert const(pre, "kMaxChunks") == FA.MAX_CHUNKS
    assert const(dec, "kMaxSplits") == FA.MAX_SPLITS
    assert const(dec, "kRows") == FA.NONCAUSAL_HEAD_TILE
    assert const(dec, "kTile") == const(tile, "kTile") == FA.NONCAUSAL_TILE
