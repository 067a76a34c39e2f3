"""Flash attention: the ViT's non-causal form (per-row ``kv_len``, the TDM
scores as a by-product) and the LMs' causal grouped-query form (per-row
``q_offset``, ``kv_len`` and ``kv_start``, the decode row's attention
probabilities as a by-product).

Kernel K2 of the port: ``kernels/csrc/flash_attention.cu``,
``flash_decode.cu``, ``flash_prefill.cu`` and ``flash_prefill_bwd.cu``
replace the reference
package's Pallas ``_flash_kernel`` / ``flash_attention_pallas``
(``kernels/flash_attention/flash_attention.py``) in the forms the serving
paths need; on the reference paths these stages are ``flash_attention_jnp``
and ``attention_probs_row`` (``core/packed_runner.py`` for the ViT,
``models/attention.attention_block`` for the LMs). Five entry points:

* ``flash_attention_f32`` / ``flash_attention_f16``: non-causal, q, k, v
  of one shape and one type, fp32 sums, output in the operands' type
  (``flash_attention_jnp`` returns ``q.dtype``): fp32 on the CUDA cores,
  fp16 with Q.K^T and P.V on the fp16 tensor cores (fp32 accumulation);
* causal, bf16 q [B, Nq, Hq, Dh] against a bf16 KV cache [B, S, KV, Dh]
  read in place per query head (head h reads KV head h // (Hq / KV)),
  bf16 output, picked by ``Nq``: ``flash_decode_bf16`` for one query row
  (split over the key window, fp32 on CUDA cores, the row's
  probabilities as a by-product) and ``flash_prefill_bf16`` for more
  (Q.K^T and P.V on the bf16 tensor cores, fp32 accumulation).
* non-causal on bf16 operands, q [B, Nq, Hq, Dh] against k, v [B, Nk, KV,
  Dh] with any Nq and Nk (the LMs' cross-attention, Whisper's encoder):
  the same two entry points with ``causal`` 0, which launch kernels of
  their own, picked by ``Nq`` alike, every query row seeing all Nk keys,
  no probabilities: the prefill on ``wgmma`` fed by TMA, the decode on
  ``mma.sync``, each splitting the key range across a cluster of blocks
  where rows are few (:func:`noncausal_prefill_plan`,
  :func:`noncausal_decode_plan`) that combine the chunks' partials in
  distributed shared memory. Their launches also count under the forms
  ``flash_prefill_bf16/noncausal`` and ``flash_decode_bf16/noncausal``
  (``backend.FORMS``).
  :func:`attention_noncausal_plain` is their plain version;
  :func:`attention_noncausal_chunked_plain` their split-key algorithm as
  tensor code (tests only). In training, :class:`NonCausalGQAAttention`:
  the prefill form also writing each row's log-sum-exp
  (:func:`attention_noncausal_lse_plain`), and ``flash_prefill_bwd_bf16``
  with ``causal`` 0, counted under ``flash_prefill_bwd_bf16/noncausal``
  (:func:`attention_noncausal_bwd_plain`).
* training: :class:`CausalAttention`, the causal form over a whole
  sequence as an autograd function, taken when a CUDA input requires
  grad: ``flash_prefill_bf16`` also writing each row's log-sum-exp, and
  ``flash_prefill_bwd_bf16`` (``csrc/flash_prefill_bwd.cu``) giving dq,
  dk, dv, the gradient JAX takes of ``flash_attention_jnp`` in the
  reference's train mode. :func:`attention_causal_bwd_plain` is its plain
  version. :class:`NonCausalAttention` is the same for the ViT's
  non-causal fp32 form (Algorithm 1's training): ``flash_attention_f32``
  also writing the log-sum-exp, and ``flash_attention_bwd_f32``
  (``csrc/flash_attention_bwd.cu``), whose dq, dk, dv include the
  gradient of the CLS row's probabilities (the TDM scores).
  :func:`attention_bwd_plain` is its plain version.

What bounds each kernel on the H100 and how the design answers that is
noted in the CUDA source.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import backend
from repro_torch.models import attention as A

NAME = "flash_attention"
ENTRY_POINTS = {torch.float32: "flash_attention_f32",
                torch.float16: "flash_attention_f16"}
# the causal kernels: (library, entry point), by whether Nq == 1
CAUSAL_KERNELS = {True: ("flash_decode", "flash_decode_bf16"),
                  False: ("flash_prefill", "flash_prefill_bf16")}
DECODE_SPLIT = 64  # keys per decode block (kSplit in csrc/flash_decode.cu)
HEAD_DIMS = (16, 64)  # head widths the non-causal kernel is instantiated
# for: full DeiT-Small (64) and its reduced test config (16)
# head widths each causal kernel is instantiated for (the non-causal
# forms too): the reduced LM configs (16), StableLM-1.6B and Whisper-base
# (64), Minitron-4B and Llama-3.2-Vision-90B (128)
CAUSAL_HEAD_DIMS = {"flash_decode_bf16": (16, 64, 128),
                    "flash_prefill_bf16": (16, 64, 128),
                    "flash_prefill_bwd_bf16": (16, 64, 128)}
# the form each entry point's non-causal kernels (``causal`` 0) count
# under (``backend.FORMS``), by whether Nq == 1
NONCAUSAL_FORMS = {decode: f"{entry}/noncausal"
                   for decode, (_, entry) in CAUSAL_KERNELS.items()}
# the non-causal kernels' work split (their sources' constants): keys per
# tile (kTile), query heads per decode block (nc::kRows), the most key
# chunks of a prefill row tile (nc::kMaxChunks) and splits of a decode
# (nc::kMaxSplits), each a cluster of at most 8 blocks (the portable size)
NONCAUSAL_TILE = 64
NONCAUSAL_HEAD_TILE = 16
MAX_CHUNKS = 8
MAX_SPLITS = 8
# blocks an SM is counted to hold when the host sizes a split of the keys
# (one wave of the card): a decode block, a prefill block of one warpgroup
# and of two
DECODE_BLOCKS_PER_SM = 3
PREFILL_BLOCKS_PER_SM = {1: 2, 2: 1}
# the most chunks or splits the plans give a cluster: past six, its
# barrier and combine cost more than the shorter walk saves
# (tools/noncausal_sweep.py on an H100 at every headline shape)
PLAN_MAX_CHUNKS = 6
LOG2E = 1.4426950408889634
_SMS: Dict[int, int] = {}  # SMs of each card, by device index
BWD_KERNEL = ("flash_prefill_bwd", "flash_prefill_bwd_bf16")
# the form the backward's non-causal kernels (``causal`` 0) count under
NONCAUSAL_BWD_FORM = "flash_prefill_bwd_bf16/noncausal"
NONCAUSAL_BWD_KERNEL = ("flash_attention_bwd", "flash_attention_bwd_f32")
NONCAUSAL_BWD_KEYS = 64  # keys per block of its main kernel (kKT)
BWD_TILE = 64  # positions per tile of the backward (kTile in its source)
# the decode kernel's arrival counters, by (device, stream): zero between
# launches (the combining block of each launch resets its own)
_ARRIVALS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the non-causal kernel: ``(o [B, N, H, Dh], probs
    [B, H, N])`` with ``probs`` the CLS row's per-head attention
    probabilities."""
    o = A.flash_attention_torch(q, k, v, kv_len=kv_len)
    return o, A.attention_probs_row(q[:, 0], k, kv_len=kv_len)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The natural log-sum-exp of each non-causal row's scaled scores, fp32
    [B, H, N], every key valid: the plain version of the ``lse`` the
    non-causal fp32 kernel writes in training."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * \
        q.shape[3] ** -0.5
    return torch.logsumexp(s, dim=-1)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        dprobs: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_attention_bwd_f32``: the gradient of the
    non-causal form with every key valid (q, k, v, o, do [B, N, H, Dh];
    ``lse`` [B, H, N] from :func:`attention_lse_plain`) and, where
    ``dprobs`` [B, H, N] is given, of the CLS row's per-head probabilities
    (``attention_plain``'s second output), by the kernel's formulas step by
    step in fp32: P = exp(s - lse), D = rowsum(dO o O), dP = dO V^T; row 0
    of P is the CLS probabilities, so dP_0j += dprobs_j and D_0 += sum_j
    P_0j dprobs_j; dS = P o (dP - D), dV = P^T dO, dK = scale dS^T Q, dQ =
    scale dS K. Returns fp32 (dq, dk, dv)."""
    B, N, H, Dh = q.shape
    scale = Dh ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    d = (dof * of).sum(dim=-1).permute(0, 2, 1)  # [B, H, N]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    if dprobs is not None:
        dpr = dprobs.float()
        dp[:, :, 0] = dp[:, :, 0] + dpr
        d[:, :, 0] = d[:, :, 0] + (p[:, :, 0] * dpr).sum(dim=-1)
    ds = p * (dp - d[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq, dk, dv


def attention_causal_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_offset=None, kv_len=None, kv_start=None,
                           collect_probs: bool = False
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the causal kernel: ``(o [B, Nq, Hq, Dh], probs)``
    with ``probs`` [B, Hq, S] the attention probabilities of query row 0
    (the decode row) when ``collect_probs``, else None."""
    o = A.flash_attention_torch(q, k, v, kv_len=kv_len, causal=True,
                                q_offset=q_offset, kv_start=kv_start)
    probs = (A.attention_probs_row(q[:, 0], k, kv_len=kv_len,
                                   kv_start=kv_start)
             if collect_probs else None)
    return o, probs


def attention_noncausal_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version of the non-causal bf16 kernels: every query row
    of q [B, Nq, Hq, Dh] against all keys of k, v [B, Nk, KV, Dh] (query
    head h reads KV head h // (Hq / KV)). Returns [B, Nq, Hq, Dh] in q's
    dtype."""
    return A.flash_attention_torch(q, k, v)


def key_chunks(n_keys: int, n_chunk: int) -> Tuple[Tuple[int, int], ...]:
    """The key ranges [start, end) of the non-causal kernels' ``n_chunk``
    chunks over ``n_keys`` keys, as the kernels cut them: each
    ceil(ceil(n_keys / 64) / n_chunk) whole tiles of 64 keys, in order (the
    last may be short, and an index past the last tile gives an empty
    range, which the plans never ask for)."""
    n_kt = -(-n_keys // NONCAUSAL_TILE)
    per = -(-n_kt // n_chunk) * NONCAUSAL_TILE
    return tuple((min(c * per, n_keys), min((c + 1) * per, n_keys))
                 for c in range(n_chunk))


def _spread(items: int, n_kt: int, slots: int, cap: int) -> int:
    """Chunks of ``n_kt`` key tiles so that ``items`` work items times the
    chunks come to about ``slots`` blocks (one wave): at least 1, at most
    ``n_kt`` and ``cap``, and none empty (the count is recomputed from the
    tiles per chunk)."""
    want = max(1, min(n_kt, cap, slots // max(items, 1)))
    per = -(-n_kt // want)
    return -(-n_kt // per)


def noncausal_prefill_plan(B: int, Nq: int, Hq: int, KV: int, Nk: int,
                           sms: int) -> Tuple[int, int]:
    """``(warpgroups a block, key chunks)`` of the non-causal prefill
    kernel for q [B, Nq, Hq, Dh] against Nk keys on a card of ``sms`` SMs:
    two warpgroups (128 rows of a KV head's flattened (position, head)
    rows) where a (b, g) has more than 64 rows, else one; the key range
    split into chunks only where the blocks of whole rows fill less than a
    wave (``PREFILL_BLOCKS_PER_SM`` blocks an SM), at most
    ``PLAN_MAX_CHUNKS`` of them."""
    rows = Nq * (Hq // KV)
    wgs = 2 if rows > 64 else 1
    items = B * KV * -(-rows // (64 * wgs))
    n_kt = -(-Nk // NONCAUSAL_TILE)
    return wgs, _spread(items, n_kt, sms * PREFILL_BLOCKS_PER_SM[wgs],
                        PLAN_MAX_CHUNKS)


def noncausal_decode_plan(B: int, Hq: int, KV: int, Nk: int,
                          sms: int) -> int:
    """The key splits of the non-causal decode kernel for q [B, 1, Hq, Dh]
    against Nk keys on a card of ``sms`` SMs: about one wave of blocks
    (``DECODE_BLOCKS_PER_SM`` an SM) over the B KV (head tiles) items,
    each walking whole tiles of 64 keys, none empty, at most
    ``PLAN_MAX_CHUNKS`` splits."""
    items = B * KV * -(-(Hq // KV) // NONCAUSAL_HEAD_TILE)
    n_kt = -(-Nk // NONCAUSAL_TILE)
    return _spread(items, n_kt, sms * DECODE_BLOCKS_PER_SM, PLAN_MAX_CHUNKS)


def attention_noncausal_chunked_plain(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      n_chunk: int) -> torch.Tensor:
    """The non-causal kernels' split-key algorithm as tensor code (used by
    the tests only): q [B, Nq, Hq, Dh] against k, v [B, Nk, KV, Dh] (query
    head h reads KV head h // (Hq / KV)), the keys cut by
    :func:`key_chunks`. Per chunk, in fp32 with the scores in log2 units,
    the partial m (the chunk's max), l = sum exp2(s - m) and the
    unnormalised o = sum exp2(s - m) v; then M = max_j m_j, w_j = exp2(m_j
    - M) and o = sum_j w_j o_j / sum_j w_j l_j, both sums in chunk order.
    Returns q's dtype."""
    B, Nq, Hq, Dh = q.shape
    Nk, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Nq, KV, Hq // KV, Dh)
    s = torch.einsum("bqgpd,bkgd->bgpqk", qg, k.float()) * (Dh ** -0.5
                                                            * LOG2E)
    vf = v.float()
    parts = []
    for lo, hi in key_chunks(Nk, n_chunk):
        m = s[..., lo:hi].amax(dim=-1, keepdim=True)
        p = torch.exp2(s[..., lo:hi] - m)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bgpqk,bkgd->bgpqd", p, vf[:, lo:hi])))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    o = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, oj in parts:
        w = torch.exp2(m - M)
        o = o + oj * w
        den = den + l * w
    return (o / den).permute(0, 3, 1, 2, 4).reshape(B, Nq, Hq, Dh).to(
        q.dtype)


def _noncausal_scores(q, k):
    """fp32 scaled scores [B, KV, per, Nq, Nk] of the non-causal GQA
    form."""
    B, Nq, Hq, Dh = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, Nq, KV, Hq // KV, Dh)
    return torch.einsum("bqgpd,bkgd->bgpqk", qg, k.float()) * Dh ** -0.5


def attention_noncausal_lse_plain(q: torch.Tensor,
                                  k: torch.Tensor) -> torch.Tensor:
    """The natural log-sum-exp of each non-causal row's scaled scores, fp32
    [B, Hq, Nq], for q [B, Nq, Hq, Dh] against all keys of k [B, Nk, KV,
    Dh]: the plain version of the ``lse`` the non-causal prefill writes in
    training."""
    B, Nq, Hq, _ = q.shape
    return torch.logsumexp(_noncausal_scores(q, k), dim=-1).reshape(
        B, Hq, Nq)


def attention_noncausal_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  do: torch.Tensor, lse: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version of ``flash_prefill_bwd_bf16`` with ``causal`` 0: the
    gradient of the non-causal GQA form (q, o, do [B, Nq, Hq, Dh]; k, v
    [B, Nk, KV, Dh], any Nq and Nk; ``lse`` [B, Hq, Nq] from
    :func:`attention_noncausal_lse_plain`) by the kernel's formulas, those
    of :func:`attention_causal_bwd_plain` with no mask. Returns (dq, dk,
    dv) in q's, k's and v's dtypes."""
    return _gqa_bwd_plain(q, k, v, o, do, lse, _noncausal_scores(q, k),
                          None)


def attention_causal_lse_plain(q: torch.Tensor, k: torch.Tensor,
                               kv_start=None) -> torch.Tensor:
    """The natural log-sum-exp of each causal row's scaled scores, fp32
    [B, Hq, N], for q [B, N, Hq, Dh] against k [B, N, KV, Dh] (query row i
    sees keys [kv_start[b], i + 1)): the plain version of the ``lse`` the
    prefill kernel writes in training. Masked scores are ``NEG_INF``, as in
    :func:`attention_causal_plain`, so a row without a key gives about
    ``NEG_INF`` (the kernel writes -inf there)."""
    s, _ = _causal_scores(q, k, kv_start)
    B, N, Hq, _ = q.shape
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, N)


def _causal_scores(q, k, kv_start):
    """fp32 scaled scores [B, KV, per, N, N] of the causal form with
    ``NEG_INF`` at masked keys, and the mask [B, 1, 1, N, N]."""
    B, N, Hq, Dh = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, N, KV, Hq // KV, Dh)
    s = torch.einsum("bqgpd,bkgd->bgpqk", qg, k.float()) * Dh ** -0.5
    pos = torch.arange(N, device=q.device)
    mask = (pos[None, :, None] >= pos[None, None, :]).expand(B, N, N)
    if kv_start is not None:
        start = torch.as_tensor(kv_start, device=q.device).to(
            torch.int64).reshape(-1, 1, 1)
        mask = mask & (pos[None, None, :] >= start)
    mask = mask[:, None, None]
    return s.masked_fill(~mask, A.NEG_INF), mask


def attention_causal_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               do: torch.Tensor, lse: torch.Tensor,
                               kv_start=None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain version of ``flash_prefill_bwd_bf16``: the gradient of the
    causal form (q, o, do [B, N, Hq, Dh]; k, v [B, N, KV, Dh]; ``lse``
    [B, Hq, N] from :func:`attention_causal_lse_plain`) by the kernel's
    formulas, step by step in fp32: D = rowsum(dO o O), P = exp(s - lse),
    dV = P^T dO, dP = dO V^T, dS = P o (dP - D), dK = scale dS^T Q, dQ =
    scale dS K, dK and dV summed over each KV head's query heads; dS is 0
    at masked keys, as autograd of the masked scores gives. A row without a
    valid key follows the reference (its forward averages V): P = 1/N at
    every key, so it adds to dV, and dS = 0. Returns (dq, dk, dv) in q's,
    k's and v's dtypes."""
    s, mask = _causal_scores(q, k, kv_start)
    return _gqa_bwd_plain(q, k, v, o, do, lse, s, mask)


def _gqa_bwd_plain(q, k, v, o, do, lse, s, mask):
    """The backward's formulas over the scaled scores ``s`` [B, KV, per,
    Nq, Nk] (masked keys at ``NEG_INF``, ``mask`` True where a row sees a
    key, or None where every row sees every key)."""
    B, Nq, Hq, Dh = q.shape
    Nk, KV = k.shape[1], k.shape[2]
    per = Hq // KV
    scale = Dh ** -0.5
    p = torch.exp(s - lse.float().reshape(B, KV, per, Nq, 1))
    if mask is not None:
        p = torch.where(mask.any(dim=-1, keepdim=True), p, 1.0 / Nk)
    split = lambda t: t.float().reshape(B, Nq, KV, per, Dh)
    qf, dof = split(q), split(do)
    kf, vf = k.float(), v.float()
    d = (dof * split(o)).sum(dim=-1).permute(0, 2, 3, 1)  # [B, KV, per, Nq]
    dv = torch.einsum("bgpqk,bqgpd->bkgd", p, dof)
    dp = torch.einsum("bqgpd,bkgd->bgpqk", dof, vf)
    ds = p * (dp - d[..., None])
    if mask is not None:
        ds = torch.where(mask, ds, 0.0)
    dk = torch.einsum("bgpqk,bqgpd->bkgd", ds, qf) * scale
    dq = torch.einsum("bgpqk,bkgd->bqgpd", ds, kf) * scale
    return (dq.reshape(B, Nq, Hq, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _attention_cuda(q, k, v, kv_len, collect_scores: bool,
                    with_lse: bool = False):
    """``(o, probs, lse)`` by the non-causal kernel: ``probs`` None unless
    ``collect_scores``, ``lse`` (each row's log-sum-exp [B, H, N] fp32,
    for training) None unless ``with_lse``."""
    B, N, H, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {Dh}")
    q, k, v = (backend.aligned(t) for t in (q, k, v))
    o = torch.empty_like(q)
    empty = lambda: torch.empty((B, H, N), dtype=torch.float32,
                                device=q.device)
    probs = empty() if collect_scores else None
    lse = empty() if with_lse else None
    ptr = lambda t: None if t is None else t.data_ptr()
    backend.launch(NAME, ENTRY_POINTS[q.dtype], q.device, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), ptr(kv_len), o.data_ptr(),
                   ptr(probs), ptr(lse), B, N, H, Dh, Dh ** -0.5)
    return o, probs, lse


class NonCausalAttention(torch.autograd.Function):
    """The ViT's non-causal attention on the card with its gradient: the
    forward is ``flash_attention_f32`` writing each row's log-sum-exp
    beside o (and, with ``collect_scores``, the CLS row's per-head
    probabilities), the backward ``flash_attention_bwd_f32``, which also
    takes the probabilities' gradient. q, k, v [B, N, H, Dh] fp32 CUDA
    tensors, every key valid. Returns ``o``, or ``(o, probs [B, H, N])``
    with ``collect_scores``."""

    @staticmethod
    def forward(ctx, q, k, v, collect_scores):
        q, k, v = (backend.aligned(t) for t in (q, k, v))
        o, probs, lse = _attention_cuda(q, k, v, None, collect_scores,
                                        with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.set_materialize_grads(False)
        return (o, probs) if collect_scores else o

    @staticmethod
    def backward(ctx, do, dprobs=None):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        return (*_attention_bwd_cuda(q, k, v, o, do, lse, dprobs), None)


def _attention_bwd_cuda(q, k, v, o, do, lse, dprobs):
    """(dq, dk, dv) by ``flash_attention_bwd_f32``: one launch of its entry
    point, two kernels (the main pass, then the sum of each key tile's
    partial dQ, kept in a scratch of ``ceil(N / NONCAUSAL_BWD_KEYS)``
    times dq's size). ``dprobs`` [B, H, N] (or None) is read in place
    through its batch and head strides: the head mean's gradient arrives
    as a broadcast view of dscores / H (stride 0 over heads). Only a view
    without unit stride along N is copied."""
    B, N, H, Dh = q.shape
    do = backend.aligned(do)
    strides = (0, 0)
    if dprobs is not None:
        if N > 1 and dprobs.stride(2) != 1:
            dprobs = dprobs.contiguous()
        strides = (dprobs.stride(0), dprobs.stride(1))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dq_part = torch.empty((-(-N // NONCAUSAL_BWD_KEYS), B, N, H, Dh),
                          dtype=torch.float32, device=q.device)
    backend.launch(*NONCAUSAL_BWD_KERNEL, q.device, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                   lse.data_ptr(),
                   None if dprobs is None else dprobs.data_ptr(),
                   dq_part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), B, N, H, Dh, *strides, Dh ** -0.5)
    return dq, dk, dv


def _row_bound(x, B: int, device, name: str) -> Optional[torch.Tensor]:
    """A per-row bound as a contiguous [B] int32 tensor on ``device``
    (a scalar broadcasts; None stays None, the kernel's default)."""
    if x is None:
        return None
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    if t.dim() == 0:
        t = t.expand(B)
    if t.shape != (B,):
        raise ValueError(f"{name} must be a scalar or have shape ({B},), "
                         f"got {tuple(t.shape)}")
    return t.contiguous()


def _arrivals(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters for a decode launch on
    ``device``'s current stream, allocated once and grown as needed."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        buf = _ARRIVALS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return buf


def _check_causal(entry: str, Dh: int, *tensors: torch.Tensor) -> None:
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{entry} takes bf16 operands, got "
                        f"{[t.dtype for t in tensors]}")
    if Dh not in CAUSAL_HEAD_DIMS[entry]:
        raise ValueError(f"{entry} takes head_dim in "
                         f"{CAUSAL_HEAD_DIMS[entry]}, got {Dh}")


def _causal_cuda(q, k, v, q_offset, kv_len, kv_start, collect_probs: bool,
                 with_lse: bool = False):
    """``(o, probs)``, or ``(o, lse)`` with ``with_lse`` (prefill only), by
    the decode kernel for one query row and the prefill kernel for more."""
    B, Nq, Hq, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    decode = Nq == 1
    lib, entry = CAUSAL_KERNELS[decode]
    _check_causal(entry, Dh, q, k, v)
    if collect_probs and not decode:
        raise ValueError(f"causal attention writes the probabilities of a "
                         f"decode row only (Nq == 1), got Nq={Nq}")
    bounds = [_row_bound(x, B, q.device, name) for x, name in
              ((q_offset, "q_offset"), (kv_len, "kv_len"),
               (kv_start, "kv_start"))]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(ptr(t) for t in bounds), o.data_ptr()]
    probs = None
    if decode:
        n_split = -(-S // DECODE_SPLIT)
        if collect_probs:
            probs = torch.empty((B, Hq, S), dtype=torch.float32,
                                device=q.device)
        part = torch.empty((B, KV, n_split, Hq // KV, Dh + 2),
                           dtype=torch.float32, device=q.device)
        backend.launch(lib, entry, q.device, *args, ptr(probs),
                       part.data_ptr(), _arrivals(q.device, B * KV).data_ptr(),
                       B, S, Hq, KV, Dh, n_split, 1, Dh ** -0.5)
    else:
        lse = (torch.empty((B, Hq, Nq), dtype=torch.float32, device=q.device)
               if with_lse else None)
        backend.launch(lib, entry, q.device, *args, ptr(lse), B, Nq, S, Hq,
                       KV, Dh, 1, 1, 1, Dh ** -0.5)
        if with_lse:
            return o, lse
    return o, probs


def _sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` names (read once per card)."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _noncausal_cuda(q, k, v, with_lse: bool = False):
    """o by the non-causal kernels, with the key range split by the host's
    plan: ``flash_decode_bf16`` for one query row
    (:func:`noncausal_decode_plan`), ``flash_prefill_bf16`` for more
    (:func:`noncausal_prefill_plan`), both with ``causal`` 0 and counted
    under their form. One launch a call: the chunks of a row tile are a
    cluster of blocks that combine their partials in shared memory. With
    ``with_lse`` (the prefill only, for training) returns ``(o, lse)``,
    lse [B, Hq, Nq] fp32 each row's log-sum-exp; o is the same bits."""
    B, Nq, Hq, Dh = q.shape
    Nk, KV = k.shape[1], k.shape[2]
    decode = Nq == 1
    lib, entry = CAUSAL_KERNELS[decode]
    _check_causal(entry, Dh, q, k, v)
    q, k, v = (backend.aligned(t) for t in (q, k, v))
    o = torch.empty_like(q)
    sms = _sm_count(q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None,
            o.data_ptr())
    if decode:
        if with_lse:
            raise ValueError("the non-causal decode form writes no lse")
        n_split = noncausal_decode_plan(B, Hq, KV, Nk, sms)
        backend.launch(lib, entry, q.device, *args, None, None, None, B, Nk,
                       Hq, KV, Dh, n_split, 0, Dh ** -0.5,
                       form=NONCAUSAL_FORMS[decode])
        return o
    lse = (torch.empty((B, Hq, Nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    wgs, n_chunk = noncausal_prefill_plan(B, Nq, Hq, KV, Nk, sms)
    backend.launch(lib, entry, q.device, *args,
                   None if lse is None else lse.data_ptr(), B, Nq, Nk, Hq,
                   KV, Dh, 0, wgs, n_chunk, Dh ** -0.5,
                   form=NONCAUSAL_FORMS[decode])
    return (o, lse) if with_lse else o


class NonCausalGQAAttention(torch.autograd.Function):
    """Non-causal GQA attention on bf16 operands on the card, with its
    gradient (the VLM's and Whisper's cross-attention, Whisper's encoder in
    training): the forward is the non-causal prefill writing each row's
    log-sum-exp beside o, the backward ``flash_prefill_bwd_bf16`` with
    ``causal`` 0 (counted under ``flash_prefill_bwd_bf16/noncausal``). q
    [B, Nq, Hq, Dh] with Nq > 1 against k, v [B, Nk, KV, Dh], all bf16 CUDA
    tensors, every row seeing all Nk keys."""

    @staticmethod
    def forward(ctx, q, k, v):
        _check_causal(BWD_KERNEL[1], q.shape[3], q, k, v)
        q, k, v = (backend.aligned(t) for t in (q, k, v))
        o, lse = _noncausal_cuda(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return _prefill_bwd_cuda(q, k, v, o, do, lse, None, causal=False)


class CausalAttention(torch.autograd.Function):
    """Causal GQA attention over a whole sequence on the card, with its
    gradient: the forward is ``flash_prefill_bf16`` writing each row's
    log-sum-exp beside o, the backward ``flash_prefill_bwd_bf16``. q
    [B, N, Hq, Dh], k, v [B, N, KV, Dh], all bf16 CUDA tensors; query row i
    of batch row b sees keys [kv_start[b], i + 1) (``kv_start`` an int32
    [B] tensor or None)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_start):
        _check_causal(BWD_KERNEL[1], q.shape[3], q, k, v)
        o, lse = _causal_cuda(q, k, v, None, None, kv_start, False,
                              with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, kv_start)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_start = ctx.saved_tensors
        return (*_causal_bwd_cuda(q, k, v, o, do, lse, kv_start), None)


def bwd_scratch_shape(B: int, Hq: int, Nq: int) -> Tuple[int, int, int, int]:
    """Shape of the fp32 scratch of ``flash_prefill_bwd_bf16``: [2, B, Hq,
    Np], each query row's lse log2e and D = rowsum(dO o O), written by its
    dQ kernel and read by its dK/dV kernel in boxes of ``BWD_TILE``
    positions (TMA). Np is Nq rounded up to the tile, so every box lies
    inside and each row of the scratch is a multiple of 16 bytes, as TMA
    requires."""
    Np = -(-Nq // BWD_TILE) * BWD_TILE
    return 2, B, Hq, Np


def _causal_bwd_cuda(q, k, v, o, do, lse, kv_start):
    """(dq, dk, dv) of the causal form by ``flash_prefill_bwd_bf16``."""
    return _prefill_bwd_cuda(q, k, v, o, do, lse, kv_start, causal=True)


def _prefill_bwd_cuda(q, k, v, o, do, lse, kv_start, causal: bool):
    """(dq, dk, dv) by ``flash_prefill_bwd_bf16``: one launch of its entry
    point (two kernels: dQ with D, then dK/dV), causal (Nq == Nk, an
    optional ``kv_start``) or not (any Nq and Nk, counted under
    :data:`NONCAUSAL_BWD_FORM`)."""
    B, Nq, Hq, Dh = q.shape
    Nk, KV = k.shape[1], k.shape[2]
    q, k, v, o, do = (backend.aligned(t)
                      for t in (q, k, v, o, do.to(q.dtype)))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty(bwd_scratch_shape(B, Hq, Nq), dtype=torch.float32,
                       device=q.device)
    backend.launch(*BWD_KERNEL, q.device, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                   None if kv_start is None else kv_start.data_ptr(),
                   dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), B, Nq, Nk, Hq, KV, Dh, int(causal),
                   Dh ** -0.5, form=None if causal else NONCAUSAL_BWD_FORM)
    return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None,
                    collect_scores: bool = False, causal: bool = False,
                    q_offset=None, kv_start=None,
                    ) -> Union[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Attention through the kernel for CUDA tensors, the plain version
    for CPU tensors.

    Non-causal (the ViT): q, k, v [B, N, H, Dh], all fp32 or all fp16;
    ``kv_len`` a scalar or [B] int32 (keys >= kv_len[b] are masked,
    kv_len[b] > N acts as N; ``None`` = all N). A row with kv_len[b] <= 0
    has no valid key and, as in the reference (which masks with a finite
    ``NEG_INF``), attends to all N keys alike: the mean of V, probabilities
    1/N. ``collect_scores`` adds the CLS row's probabilities averaged over
    heads. When grad is enabled and a CUDA input requires it,
    :class:`NonCausalAttention` runs (the gradient of o and of the scores
    by the backward kernel); it takes fp32 without ``kv_len`` only and
    raises on any other form.

    ``causal=True`` (the LMs): q [B, Nq, Hq, Dh] against k, v
    [B, S, KV, Dh], all bf16 on the card (the decode kernel for
    ``Nq == 1``, the prefill kernel otherwise; when grad is enabled and an
    input requires it, :class:`CausalAttention`, which takes the
    whole-sequence form with ``kv_start`` only and raises on any other);
    query row i of batch row b
    sees keys in [kv_start[b], min(kv_len[b], q_offset[b] + i + 1))
    (each a scalar or [B]; defaults 0, S and 0). ``collect_scores``
    (decode, Nq == 1) adds the row's probabilities averaged over heads,
    ``attention_probs_row(q[:, 0], k, kv_len, kv_start).mean(1)``. A row
    with no valid key comes out finite: the plain version averages V
    there, as the reference does, and the kernel gives 0.

    Non-causal on bf16 operands (the LMs' cross-attention and Whisper's
    encoder): q [B, Nq, Hq, Dh] against k, v [B, Nk, KV, Dh], any Nq and
    Nk, every query row seeing all Nk keys: on the card the non-causal
    kernels (``causal`` 0 of the decode entry point for ``Nq == 1``, of the
    prefill entry point otherwise), on the CPU
    :func:`attention_noncausal_plain`. It takes no ``kv_len`` and no
    scores. When grad is enabled and a CUDA input requires it,
    :class:`NonCausalGQAAttention` runs (the prefill form with the
    log-sum-exp, then the non-causal backward kernel); the decode form
    (Nq == 1) has no gradient on the card and raises. fp32 and fp16 calls
    whose q, k and v differ in shape run the same plain version on the CPU
    and raise on the card.

    Returns ``o`` in q's dtype, or ``(o, scores [B, Nk])`` with
    ``collect_scores`` — fp32, exactly 0 at masked keys."""
    if causal:
        if q.shape[0] != k.shape[0] or k.shape != v.shape \
                or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
            raise ValueError(f"causal attention takes q [B, Nq, Hq, Dh] and "
                             f"k, v [B, S, KV, Dh] with KV dividing Hq, got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        if backend.on_card(q, k, v) and torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            if q.shape[1] == 1 or collect_scores or k.shape[1] != q.shape[1]:
                raise ValueError(
                    "causal attention has a gradient on the card for the "
                    "whole-sequence form only (Nq == S > 1, no scores), got "
                    f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                    f"collect_scores={collect_scores}")
            if q_offset is not None or kv_len is not None:
                raise ValueError("causal attention with a gradient takes "
                                 "kv_start only, not q_offset or kv_len")
            return CausalAttention.apply(
                q, k, v, _row_bound(kv_start, q.shape[0], q.device,
                                    "kv_start"))
        if backend.on_card(q, k, v):
            o, probs = _causal_cuda(q, k, v, q_offset, kv_len, kv_start,
                                    collect_scores)
        else:
            o, probs = attention_causal_plain(q, k, v, q_offset, kv_len,
                                              kv_start, collect_scores)
        return (o, probs.mean(dim=1)) if collect_scores else o
    if q_offset is not None or kv_start is not None:
        raise ValueError("q_offset and kv_start apply to causal attention")
    if q.dtype == torch.bfloat16 or k.shape != q.shape or v.shape != q.shape:
        return _grouped_noncausal(q, k, v, kv_len, collect_scores)
    B, N, H, Dh = q.shape
    if not backend.on_card(q, k, v):
        o, probs = attention_plain(q, k, v, kv_len)
    else:
        if q.dtype not in ENTRY_POINTS or not (
                k.dtype == v.dtype == q.dtype):
            raise TypeError(f"flash_attention kernel takes q, k, v all fp32 "
                            f"or all fp16, got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            # training has no padded rows, and the fp16 tier no gradient
            if kv_len is not None:
                raise ValueError("non-causal attention has a gradient on "
                                 "the card without kv_len only")
            if q.dtype != torch.float32:
                raise TypeError(f"non-causal attention has a gradient on "
                                f"the card for fp32 operands only, got "
                                f"{q.dtype}")
            res = NonCausalAttention.apply(q, k, v, collect_scores)
            if not collect_scores:
                return res
            return res[0], res[1].mean(dim=1)
        if kv_len is not None:
            kv_len = _row_bound(kv_len, B, q.device, "kv_len")
        o, probs, _ = _attention_cuda(q, k, v, kv_len, collect_scores)
    if not collect_scores:
        return o
    return o, probs.mean(dim=1)


def _grouped_noncausal(q, k, v, kv_len, collect_scores: bool) -> torch.Tensor:
    """The non-causal form of any Nq and Nk with the GQA repeat
    (:func:`flash_attention`): the non-causal kernels for bf16 CUDA
    tensors, :func:`attention_noncausal_plain` for CPU tensors."""
    if q.shape[0] != k.shape[0] or k.shape != v.shape \
            or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"non-causal attention takes q [B, Nq, Hq, Dh] and "
                         f"k, v [B, Nk, KV, Dh] with KV dividing Hq, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if kv_len is not None or collect_scores:
        raise ValueError("non-causal attention over Nk != Nq keys, with the "
                         "GQA repeat or on bf16 takes no kv_len and writes "
                         "no scores")
    if not backend.on_card(q, k, v):
        return attention_noncausal_plain(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"non-causal attention with Nq != Nk or the GQA "
                        f"repeat runs on the card on bf16 operands (the "
                        f"non-causal bf16 kernels), got {q.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.shape[1] == 1:
            raise ValueError(
                "non-causal bf16 attention has a gradient on the card for "
                f"Nq > 1 query rows only (no training path decodes), got q "
                f"{tuple(q.shape)}")
        return NonCausalGQAAttention.apply(q, k, v)
    return _noncausal_cuda(q, k, v)
