"""Attention, plain PyTorch — the port of the reference package's
``models/attention.py``: the ViT's non-causal attention with per-row
``kv_len``, the LMs' causal grouped-query attention with per-row
``q_offset``, ``kv_len`` and ``kv_start``, non-causal grouped-query
attention over any number of keys (cross-attention, Whisper's encoder),
the per-slot KV cache, and ``attention_block`` (projections, qk-norm,
RoPE, cache write, attention, and the decode ``attn_mass`` update; or a
cross-attention call over keys and values projected elsewhere).

:func:`flash_attention_torch` and :func:`attention_probs_row` are the
references the ``flash_attention`` kernels are held against
(``kernels/flash_attention``). They materialize the full score matrix,
which is fine for a reference and for the CPU tests. Masked scores are
the reference's finite ``NEG_INF``, not ``-inf``: a row with no valid key
(a left-pad row of a bucket-padded prompt) then averages V instead of
giving NaN, as in the reference. ``attention_block`` runs the attention
through the kernel wrapper, which launches the kernel for CUDA tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models.layers import apply_rope, linear, rms_norm

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, S_max, KV, Dh]
    v: torch.Tensor          # [B, S_max, KV, Dh]
    length: torch.Tensor     # [B] int32: tokens currently valid, PER SLOT
    # dynamic KV pruning: attention mass accumulated per slot
    attn_mass: torch.Tensor  # [B, S_max] float32


def init_kv_cache(batch: int, max_len: int, kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    """A zeroed cache on ``device`` (the card unless the CPU is asked
    for)."""
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                      device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        attn_mass=torch.zeros((batch, max_len), dtype=torch.float32,
                              device=device),
    )


def _per_row(x, B: int, device) -> Optional[torch.Tensor]:
    """A scalar or [B] bound as a [B, 1] int64 column (None stays None)."""
    if x is None:
        return None
    return torch.as_tensor(x, device=device).to(torch.int64).reshape(
        -1, 1).expand(B, 1)


def _key_mask(B: int, Nk: int, device, kv_len=None, kv_start=None
              ) -> Optional[torch.Tensor]:
    """[B, Nk] bool, True at keys in [kv_start[b], kv_len[b])."""
    if kv_len is None and kv_start is None:
        return None
    pos = torch.arange(Nk, device=device)[None, :]
    mask = torch.ones((B, Nk), dtype=torch.bool, device=device)
    if kv_len is not None:
        mask = mask & (pos < _per_row(kv_len, B, device))
    if kv_start is not None:
        mask = mask & (pos >= _per_row(kv_start, B, device))
    return mask


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len=None, scale: Optional[float] = None,
                          causal: bool = False, q_offset=None,
                          kv_start=None) -> torch.Tensor:
    """Grouped-query attention. q: [B, Nq, Hq, Dh]; k, v: [B, Nk, KV, Dh]
    with Hq = KV·per; query head h reads KV head h // per.

    ``kv_len`` ([B] or scalar) masks keys >= kv_len, ``kv_start`` ([B])
    keys < kv_start; with ``causal``, query row i of batch row b sees keys
    <= ``q_offset[b]`` + i (``q_offset``: scalar or [B], default 0, the
    cache slot of q[:, 0]). Masked scores are ``NEG_INF``. Returns
    [B, Nq, Hq, Dh] in q's dtype (fp32 math)."""
    B, Nq, Hq, Dh = q.shape
    Nk, KV = k.shape[1], k.shape[2]
    per = Hq // KV
    if scale is None:
        scale = Dh ** -0.5
    qg = q.float().reshape(B, Nq, KV, per, Dh)
    s = torch.einsum("bqgpd,bkgd->bgpqk", qg, k.float()) * scale
    mask = _key_mask(B, Nk, q.device, kv_len, kv_start)
    mask = (torch.ones((B, 1, Nk), dtype=torch.bool, device=q.device)
            if mask is None else mask[:, None, :])  # [B, 1|Nq, Nk]
    if causal:
        off = _per_row(0 if q_offset is None else q_offset, B, q.device)
        q_pos = off + torch.arange(Nq, device=q.device)[None, :]  # [B, Nq]
        k_pos = torch.arange(Nk, device=q.device)
        mask = mask & (q_pos[:, :, None] >= k_pos)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgpqk,bkgd->bqgpd", p, v.float())
    return o.reshape(B, Nq, Hq, Dh).to(q.dtype)


def attention_probs_row(q_row: torch.Tensor, k: torch.Tensor,
                        kv_len=None, scale: Optional[float] = None,
                        kv_start=None) -> torch.Tensor:
    """Softmax attention of ONE query row against all keys, per head —
    the ViT's CLS row for the TDM scores, the LM's decode row for the KV
    attention mass. q_row: [B, Hq, Dh]; k: [B, Nk, KV, Dh]. Keys outside
    [kv_start, kv_len) score ``NEG_INF`` and get probability exactly 0
    (when the row has a valid key). Returns probs [B, Hq, Nk]."""
    B, Nk, KV, Dh = k.shape
    Hq = q_row.shape[1]
    per = Hq // KV
    if scale is None:
        scale = Dh ** -0.5
    qg = q_row.float().reshape(B, KV, per, Dh)
    s = torch.einsum("bgpd,bkgd->bgpk", qg, k.float()) * scale
    mask = _key_mask(B, Nk, k.device, kv_len, kv_start)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    return torch.softmax(s, dim=-1).reshape(B, Hq, Nk)


# ---------------------------------------------------------------------------
# Full attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------
def _write_cache_rows(buf: torch.Tensor, new: torch.Tensor,
                     start: torch.Tensor) -> torch.Tensor:
    """Write ``new`` [B, N, ...] into ``buf`` [B, S, ...] at each row's own
    slots [start[b], start[b] + N), IN PLACE, and return ``buf``. A start
    past S - N is clamped to S - N, as ``jax.lax.dynamic_update_slice``
    clamps (freed slots keep advancing with every batched decode)."""
    B, N = new.shape[:2]
    S = buf.shape[1]
    first = torch.clamp(start.to(torch.int64), 0, S - N)
    idx = first[:, None] + torch.arange(N, device=buf.device)  # [B, N]
    idx = idx.reshape(B, N, *([1] * (buf.dim() - 2))).expand(new.shape)
    return buf.scatter_(1, idx, new.to(buf.dtype))


def _fill_keyless_rows(out: torch.Tensor, v: torch.Tensor,
                       first_slot: torch.Tensor,
                       valid_start: torch.Tensor) -> torch.Tensor:
    """``out`` [B, N, H, Dh] with each row that has no key (its slot
    ``first_slot[b] + i`` before ``valid_start[b]``: left padding) set to
    the mean of ``v`` [B, S, KV, Dh] over all S slots: what the
    reference's finite ``NEG_INF`` mask gives such a row (a uniform
    softmax), and what the plain version computes, where the causal kernels
    write 0. Pad rows reach no token of a dense LM, but in an MoE layer
    they route and take expert capacity, so they must hold the reference's
    values."""
    B, N, H, _ = out.shape
    rows = first_slot[:, None] + torch.arange(N, device=out.device)
    keyless = (rows < valid_start[:, None])[:, :, None, None]
    mean = v.float().mean(dim=1).repeat_interleave(H // v.shape[2], dim=1)
    return torch.where(keyless, mean[:, None].to(out.dtype), out)


def attention_block(x: torch.Tensor, p, cfg, *,
                    cache: Optional[KVCache] = None,
                    valid_start: Optional[torch.Tensor] = None,
                    causal: bool = True, use_rope: bool = True,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    positions: Optional[torch.Tensor] = None,
                    collect_scores: bool = False, score_row: int = 0,
                    ):
    """One attention sublayer: causal self-attention by default. Returns
    ``(out, new_cache)``, and with ``collect_scores`` ``(out, new_cache,
    scores)``.

    * train / no cache: ``cache is None``; RoPE positions 0..N-1.
    * prefill / decode: each row writes its new K/V at its own
      ``cache.length[b]`` and attends to its cache window. The cache's K
      and V buffers are updated IN PLACE (``new_cache`` holds the same
      tensors with the new lengths): a serve step rebinds its caches to
      the result and never reads the old lengths again.
    * ``valid_start`` ([B] int32): first real cache slot per row; earlier
      slots (left-padded prompts, compacted-cache garbage prefixes) are
      masked out of the attention and of the ``attn_mass`` accumulation.
      RoPE positions count real tokens (cache slot − valid_start), so
      per-slot prefill and left-padded batch prefill rope identically.
    * decode (N == 1): the row's head-mean attention probabilities, the
      kernel's by-product, accumulate into ``attn_mass``.
    * rows without a key (left padding) hold the mean of V, as in the
      reference (:func:`_fill_keyless_rows`).
    * ``causal=False`` without a cache (Whisper's encoder): every position
      sees every other; RoPE still applies unless ``use_rope`` is False,
      as in the reference, where ``use_rope`` defaults to True.
    * cross-attention: ``kv_override=(k, v)``, keys and values [B, Nk, KV,
      Dh] projected elsewhere (from the encoder's output or the vision
      tokens). Only q is projected from x (with ``bq``); there is no
      qk-norm on k, no RoPE, no cache and no mask: every query row,
      left-pad rows too, sees all Nk keys.
    * ``positions`` ([B, N]): the RoPE positions of this call's tokens,
      in place of the built ones (the prompt TDM's kept tokens keep
      theirs); nothing else reads them.
    * ``collect_scores``: the TDM scores of the reference, query row
      ``score_row``'s attention probabilities over this call's N keys
      (no mask), averaged over heads, [B, N] fp32 (``models/
      prefill_prune``). On the card they are the causal decode kernel's
      probabilities for that row against the N keys (one more launch); on
      the CPU :func:`attention_probs_row`.
    """
    B, N, D = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = linear(x, p["wq"], p.get("bq")).reshape(B, N, H, Dh)
    if kv_override is not None:
        if cache is not None or valid_start is not None or collect_scores:
            raise ValueError("cross-attention (kv_override) takes no cache, "
                             "no valid_start and collects no scores")
        k, v = kv_override
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        out = FA.flash_attention(q, k, v)
        return linear(out.reshape(B, N, H * Dh), p["wo"], p.get("bo")), None
    if not causal and (cache is not None or valid_start is not None):
        raise ValueError("non-causal self-attention (an encoder) takes no "
                         "cache and no valid_start")
    k = linear(x, p["wk"], p.get("bk")).reshape(B, N, KV, Dh)
    v = linear(x, p["wv"], p.get("bv")).reshape(B, N, KV, Dh)

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    # per-slot write offsets: [B] cache-slot index of this call's first token
    slot_off = None if cache is None else cache.length.expand(B)
    if positions is None:
        positions = torch.arange(N, device=x.device).expand(B, N)
        if slot_off is not None:
            base = (slot_off - valid_start) if valid_start is not None \
                else slot_off  # rope counts real tokens, not buffer slots
            positions = base[:, None] + positions
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        k_all = _write_cache_rows(cache.k, k, slot_off)
        v_all = _write_cache_rows(cache.v, v, slot_off)
        new_len = slot_off + N
        res = FA.flash_attention(q, k_all, v_all, causal=True,
                                 q_offset=slot_off, kv_len=new_len,
                                 kv_start=valid_start,
                                 collect_scores=N == 1)
        mass = cache.attn_mass
        if N == 1:  # accumulate attention mass for dynamic KV pruning
            out, scores = res
            mass = mass + scores
        else:
            out = res
            if valid_start is not None:
                out = _fill_keyless_rows(out, v_all, slot_off, valid_start)
        new_cache = KVCache(k_all, v_all, new_len.to(torch.int32), mass)
    elif not causal:
        out = FA.flash_attention(q, k, v)
    else:
        out = FA.flash_attention(q, k, v, causal=True, kv_start=valid_start)
        if valid_start is not None and N > 1:
            out = _fill_keyless_rows(out, v, torch.zeros_like(valid_start),
                                     valid_start)

    out = linear(out.reshape(B, N, H * Dh), p["wo"], p.get("bo"))
    if collect_scores:
        return out, new_cache, _score_row(q, k, v, score_row)
    return out, new_cache


def _score_row(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               row: int) -> torch.Tensor:
    """Query row ``row``'s attention probabilities over all N keys, the
    mean over heads [B, N] fp32: the causal kernels' decode row placed
    last (q_offset N - 1, kv_len N: every key valid)."""
    N = k.shape[1]
    q_row = q.narrow(1, row % N, 1)
    return FA.flash_attention(q_row, k, v, causal=True, q_offset=N - 1,
                              kv_len=N, collect_scores=True)[1]
