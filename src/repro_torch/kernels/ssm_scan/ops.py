"""The recurrences of the SSM and hybrid families: Mamba2's selective scan
and RWKV6's WKV, each a whole sequence in one launch.

Neither replaces a Pallas kernel. The reference runs both as
``jax.lax.scan`` (``models/ssm.py:116``, the ``step`` of ``mamba_block``;
``:234``, ``_wkv_sequential``), which XLA keeps on the device; here a
Python loop would issue about eight launches a token a layer, and the
recurrent families re-prefill the whole batch at every admission, so each
scan is a hand-written kernel (``csrc/mamba_scan.cu``, ``csrc/wkv6.cu``;
their bounds and designs are noted there). The plain versions beside them
are the reference's loops over the sequence.

Rules (``kernels/backend``): CUDA tensors launch the kernel or raise, CPU
tensors run the plain version. Outputs and the new state are new tensors
(``torch.empty``): the state is functional, as in the reference, so a
caller may keep the old one. The kernels have no backward: with grad
enabled and an input that requires it, a CUDA call raises (training these
families is a later slice).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import backend

MAX_WIDTH = 64  # largest head width and Mamba state width the kernels take


def mamba_scan_plain(x: torch.Tensor, dt_sp: torch.Tensor,
                     decay: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                     h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's scan (``ssm.py:102-116``), step by step: ``h = h *
    decay + (dt * x) (outer) B``, then ``y = h . C``."""
    h = h0
    ys = []
    for t in range(x.shape[1]):
        upd = (dt_sp[:, t, :, None, None] * x[:, t].float()[..., None]
               * Bm[:, t, None, None, :])
        h = h * decay[:, t, :, None, None] + upd
        ys.append(torch.einsum("bhds,bs->bhd", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_wkv_sequential`` (``ssm.py:217-235``), step by
    step: ``y = r . (s + u (*) k v^T)``, then ``s = s (*) w + k v^T``."""
    s = s0
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t].float()[..., :, None] * v[:, t].float()[..., None, :]
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, t].float(),
                               s + u[None, :, :, None] * kv))
        s = s * w[:, t].float()[..., None] + kv
    return torch.stack(ys, dim=1), s


def _require(cond: bool, exc, msg: str) -> None:
    if not cond:
        raise exc(msg)


def _check_common(name: str, acts, fp32) -> None:
    _require(len({t.dtype for t in acts}) == 1
             and acts[0].dtype in (torch.bfloat16, torch.float32), TypeError,
             f"{name} takes its activations all bf16 or all fp32, got "
             f"{[t.dtype for t in acts]}")
    _require(all(t.dtype == torch.float32 for t in fp32), TypeError,
             f"{name} takes its decays, projections and state in fp32, got "
             f"{[t.dtype for t in fp32]}")


def _check_card(name: str, grad: bool, tensors, width: int) -> None:
    """What the kernel takes beyond the plain version: contiguous operands,
    widths up to ``MAX_WIDTH``, no gradient."""
    _require(all(t.is_contiguous() for t in tensors), ValueError,
             f"{name} kernel takes contiguous operands")
    _require(1 <= width <= MAX_WIDTH, ValueError,
             f"{name} kernel takes head and state widths of 1 to "
             f"{MAX_WIDTH}, got {width}")
    _require(not grad, NotImplementedError,
             f"{name} has no backward kernel: training the SSM and hybrid "
             f"families is a later slice (ROADMAP queue A, item 8)")


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def mamba_scan(x: torch.Tensor, dt_sp: torch.Tensor, decay: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor,
               h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2's scan over a whole sequence. x [B, S, H, dh] (bf16 or fp32);
    ``dt_sp`` (softplus of dt plus its bias) and ``decay`` (exp(dt A))
    [B, S, H] fp32; ``Bm``, ``Cm`` [B, S, N] fp32; ``h0`` [B, H, dh, N]
    fp32. Returns ``(y [B, S, H, dh] fp32, h_final [B, H, dh, N] fp32)``:
    ``mamba_scan_f32`` on the card (dh, N <= 64), the plain version on the
    CPU."""
    B, S, H, dh = x.shape
    N = Bm.shape[-1]
    _require(dt_sp.shape == decay.shape == (B, S, H)
             and Bm.shape == Cm.shape == (B, S, N)
             and h0.shape == (B, H, dh, N), ValueError,
             f"mamba_scan takes x [B, S, H, dh], dt and decay [B, S, H], B "
             f"and C [B, S, N], h0 [B, H, dh, N]; got {tuple(x.shape)}, "
             f"{tuple(dt_sp.shape)}, {tuple(decay.shape)}, "
             f"{tuple(Bm.shape)}, {tuple(Cm.shape)}, {tuple(h0.shape)}")
    _check_common("mamba_scan", [x], [dt_sp, decay, Bm, Cm, h0])
    ins = (x, dt_sp, decay, Bm, Cm, h0)
    if not backend.on_card(*ins):
        return mamba_scan_plain(*ins)
    _check_card("mamba_scan", _wants_grad(*ins), ins, max(dh, N))
    return _mamba_scan_cuda(*ins)


def _mamba_scan_cuda(x, dt_sp, decay, Bm, Cm, h0):
    """``(y, h_final)`` by ``mamba_scan_f32``: one launch."""
    B, S, H, dh = x.shape
    y = torch.empty((B, S, H, dh), dtype=torch.float32, device=x.device)
    h_out = torch.empty_like(h0)
    backend.launch("mamba_scan", "mamba_scan_f32", x.device,
                   *(t.data_ptr() for t in (x, dt_sp, decay, Bm, Cm, h0)),
                   y.data_ptr(), h_out.data_ptr(),
                   int(x.dtype == torch.bfloat16), B, S, H, dh, Bm.shape[-1])
    return y, h_out


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6's WKV over a whole sequence. r, k, v [B, S, H, dh] (all bf16 or
    all fp32); ``w`` (the decay, exp(-exp(w_raw))) [B, S, H, dh] fp32;
    ``u`` [H, dh] fp32; ``s0`` [B, H, dh, dh] fp32. Returns ``(y [B, S, H,
    dh] fp32, s_final [B, H, dh, dh] fp32)``: ``wkv6_f32`` on the card
    (dh <= 64), the plain version on the CPU."""
    B, S, H, dh = r.shape
    _require(k.shape == v.shape == w.shape == r.shape
             and u.shape == (H, dh) and s0.shape == (B, H, dh, dh),
             ValueError,
             f"wkv6 takes r, k, v, w [B, S, H, dh], u [H, dh], s0 [B, H, dh, "
             f"dh]; got {tuple(r.shape)}, {tuple(k.shape)}, "
             f"{tuple(v.shape)}, {tuple(w.shape)}, {tuple(u.shape)}, "
             f"{tuple(s0.shape)}")
    _check_common("wkv6", [r, k, v], [w, u, s0])
    ins = (r, k, v, w, u, s0)
    if not backend.on_card(*ins):
        return wkv6_plain(*ins)
    _check_card("wkv6", _wants_grad(*ins), ins, dh)
    return _wkv6_cuda(*ins)


def _wkv6_cuda(r, k, v, w, u, s0):
    """``(y, s_final)`` by ``wkv6_f32``: one launch."""
    B, S, H, dh = r.shape
    y = torch.empty((B, S, H, dh), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(s0)
    backend.launch("wkv6", "wkv6_f32", r.device,
                   *(t.data_ptr() for t in (r, k, v, w, u, s0)),
                   y.data_ptr(), s_out.data_ptr(),
                   int(r.dtype == torch.bfloat16), B, S, H, dh)
    return y, s_out
