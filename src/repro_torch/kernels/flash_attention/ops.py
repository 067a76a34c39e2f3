"""Flash attention: the ViT's non-causal form (per-row ``kv_len``, the TDM
scores as a by-product) and the LMs' causal grouped-query form (per-row
``q_offset``, ``kv_len`` and ``kv_start``, the decode row's attention
probabilities as a by-product).

Kernel K2 of the port: ``kernels/csrc/flash_attention.cu``,
``flash_decode.cu`` and ``flash_prefill.cu`` replace the reference
package's Pallas ``_flash_kernel`` / ``flash_attention_pallas``
(``kernels/flash_attention/flash_attention.py``) in the forms the serving
paths need; on the reference paths these stages are ``flash_attention_jnp``
and ``attention_probs_row`` (``core/packed_runner.py`` for the ViT,
``models/attention.attention_block`` for the LMs). Four entry points:

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
CAUSAL_HEAD_DIMS = (16, 128)  # the causal kernels': Minitron-4B (128) and
# the reduced LM configs (16)
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the non-causal kernel stages
    its operands 16 bytes at a time): copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _attention_cuda(q, k, v, kv_len, collect_scores: bool):
    B, N, H, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {Dh}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    probs = (torch.empty((B, H, N), dtype=torch.float32, device=q.device)
             if collect_scores else None)
    backend.launch(NAME, ENTRY_POINTS[q.dtype], q.device, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(),
                   None if kv_len is None else kv_len.data_ptr(),
                   o.data_ptr(), None if probs is None else probs.data_ptr(),
                   B, N, H, Dh, Dh ** -0.5)
    return o, probs


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


def _causal_cuda(q, k, v, q_offset, kv_len, kv_start, collect_probs: bool):
    B, Nq, Hq, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    decode = Nq == 1
    lib, entry = CAUSAL_KERNELS[decode]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{entry} takes q, k, v all bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if Dh not in CAUSAL_HEAD_DIMS:
        raise ValueError(f"{entry} takes head_dim in "
                         f"{CAUSAL_HEAD_DIMS}, got {Dh}")
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
                       B, S, Hq, KV, Dh, n_split, Dh ** -0.5)
    else:
        backend.launch(lib, entry, q.device, *args, B, Nq, S, Hq, KV, Dh,
                       Dh ** -0.5)
    return o, probs


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
    heads.

    ``causal=True`` (the LMs): q [B, Nq, Hq, Dh] against k, v
    [B, S, KV, Dh], all bf16 on the card (the decode kernel for
    ``Nq == 1``, the prefill kernel otherwise); query row i of batch row b
    sees keys in [kv_start[b], min(kv_len[b], q_offset[b] + i + 1))
    (each a scalar or [B]; defaults 0, S and 0). ``collect_scores``
    (decode, Nq == 1) adds the row's probabilities averaged over heads,
    ``attention_probs_row(q[:, 0], k, kv_len, kv_start).mean(1)``. A row
    with no valid key comes out finite: the plain version averages V
    there, as the reference does, and the kernel gives 0.

    Returns ``o`` in q's dtype, or ``(o, scores [B, Nk])`` with
    ``collect_scores`` — fp32, exactly 0 at masked keys."""
    if causal:
        if q.shape[0] != k.shape[0] or k.shape != v.shape \
                or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
            raise ValueError(f"causal attention takes q [B, Nq, Hq, Dh] and "
                             f"k, v [B, S, KV, Dh] with KV dividing Hq, got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        if backend.on_card(q, k, v):
            o, probs = _causal_cuda(q, k, v, q_offset, kv_len, kv_start,
                                    collect_scores)
        else:
            o, probs = attention_causal_plain(q, k, v, q_offset, kv_len,
                                              kv_start, collect_scores)
        return (o, probs.mean(dim=1)) if collect_scores else o
    if q_offset is not None or kv_start is not None:
        raise ValueError("q_offset and kv_start apply to causal attention")
    B, N, H, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, N, H, Dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not backend.on_card(q, k, v):
        o, probs = attention_plain(q, k, v, kv_len)
    else:
        if q.dtype not in ENTRY_POINTS or not (
                k.dtype == v.dtype == q.dtype):
            raise TypeError(f"flash_attention kernel takes q, k, v all fp32 "
                            f"or all fp16, got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        if kv_len is not None:
            kv_len = _row_bound(kv_len, B, q.device, "kv_len")
        o, probs = _attention_cuda(q, k, v, kv_len, collect_scores)
    if not collect_scores:
        return o
    return o, probs.mean(dim=1)
