"""State-space and recurrent token mixers: Mamba2 (the Zamba2 hybrid) and
RWKV6 — the port of the reference package's ``models/ssm.py``.

Both are attention-free: a full sequence runs a time scan that carries the
recurrent state; a decode step is one O(1) state update. The scans run
through the ``kernels/ssm_scan`` wrappers: on the card the hand-written
``mamba_scan_f32`` and ``wkv6_f32`` kernels, on the CPU their plain
versions (the reference's loops); whenever a gradient is wanted the
wrappers run the autograd Functions ``MambaScan`` / ``WKV6``, whose
backward is ``mamba_scan_bwd_f32`` / ``wkv6_bwd_f32`` on the card.
Everything around them keeps the reference's operations, order and casts:
the causal depthwise conv over a carried buffer of ``W - 1`` rows,
``softplus(dt + dt_bias)`` and ``exp(dt A)`` in fp32, the state in fp32,
``y + x D`` before the gated RMSNorm; RWKV's token shifts, ``w =
exp(-exp(w_raw))`` in fp32 and ``u`` read in fp32. ``_wkv_chunked``
(``cfg.rwkv_chunk > 0``) is tensor code on any device, as in the
reference.

States are functional: a block returns a new state and never writes the
one it was given.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import mamba_scan, wkv6
from repro_torch.models.layers import dense_init, linear, rms_norm


# ===========================================================================
# Mamba2 (SSD, scalar-identity A per head)
# ===========================================================================
class MambaState(NamedTuple):
    h: torch.Tensor     # [B, H, Dh, State] fp32
    conv: torch.Tensor  # [B, ConvW-1, D_inner] rolling conv buffer


def mamba_head_dim() -> int:
    return 64


def _mamba_dims(cfg) -> Tuple[int, int, int]:
    inner = cfg.ssm_expand * cfg.d_model
    return inner, cfg.ssm_state, inner // mamba_head_dim()


def init_mamba_params(g: torch.Generator, cfg,
                      dtype=torch.float32) -> Dict:
    d = cfg.d_model
    inner, state, H = _mamba_dims(cfg)
    dev = g.device
    return {
        "in_proj": dense_init(g, d, 2 * inner + 2 * state + H, dtype),
        "conv_w": 0.1 * torch.randn((cfg.ssm_conv_width, inner),
                                    generator=g, dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)
                           .to(dtype)),
        "dt_bias": torch.zeros(H, dtype=dtype, device=dev),
        "D": torch.ones(H, dtype=dtype, device=dev),
        "norm": torch.ones(inner, dtype=dtype, device=dev),
        "out_proj": dense_init(g, inner, d, dtype),
    }


def init_mamba_state(batch: int, cfg, dtype=torch.float32,
                     device="cpu") -> MambaState:
    inner, state, H = _mamba_dims(cfg)
    return MambaState(
        h=torch.zeros((batch, H, mamba_head_dim(), state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, inner), dtype=dtype,
                         device=device),
    )


def _mamba_split(x: torch.Tensor, p: Dict, cfg):
    inner, state, H = _mamba_dims(cfg)
    zxbcdt = linear(x, p["in_proj"])
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [inner, inner, state, state, H],
                                    dim=-1)
    return z, xs, Bm, Cm, dt, inner, state, H


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, as max(x, 0) + log1p(exp(
    -|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def mamba_block(x: torch.Tensor, p: Dict, cfg,
                state: Optional[MambaState] = None
                ) -> Tuple[torch.Tensor, MambaState]:
    """x: [B, S, D]. The full-sequence scan (training, prefill; a decode
    step is S = 1). ``state`` is the initial state (zeros when None); the
    final state comes back beside the output."""
    B, S, D = x.shape
    z, xs, Bm, Cm, dt, inner, n_state, H = _mamba_split(x, p, cfg)
    dh = mamba_head_dim()
    if state is None:
        state = init_mamba_state(B, cfg, x.dtype, x.device)

    # causal depthwise conv over the x-branch with the carried buffer
    conv_in = torch.cat([state.conv.to(xs.dtype), xs], dim=1)
    W = cfg.ssm_conv_width
    xs_conv = sum(conv_in[:, i:i + S, :] * p["conv_w"][i].to(xs.dtype)
                  for i in range(W))
    xs_conv = F.silu(xs_conv)
    new_conv = conv_in[:, -(W - 1):, :]

    xh = xs_conv.reshape(B, S, H, dh)
    dt_sp = _softplus(dt.float() + p["dt_bias"].float())  # [B, S, H]
    A = -torch.exp(p["A_log"].float())                    # [H]
    decay = torch.exp(dt_sp * A)                          # [B, S, H]
    y, h_final = mamba_scan(xh, dt_sp, decay, Bm.float().contiguous(),
                            Cm.float().contiguous(), state.h)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = linear(y, p["out_proj"])
    return out, MambaState(h_final, new_conv.to(state.conv.dtype))


# ===========================================================================
# RWKV6 ("Finch": data-dependent decay)
# ===========================================================================
class RWKVState(NamedTuple):
    wkv: torch.Tensor       # [B, H, Dh, Dh] fp32
    shift_tm: torch.Tensor  # [B, D] last token (time-mix shift)
    shift_cm: torch.Tensor  # [B, D] last token (channel-mix shift)


def rwkv_head_dim(cfg) -> int:
    return cfg.d_model // cfg.num_heads


def init_rwkv_params(g: torch.Generator, cfg, dtype=torch.float32) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    dev = g.device
    full = lambda v: torch.full((d,), v, dtype=dtype, device=dev)
    return {
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_w": full(0.5), "mix_g": full(0.5),
        "wr": dense_init(g, d, d, dtype),
        "wk": dense_init(g, d, d, dtype),
        "wv": dense_init(g, d, d, dtype),
        "wg": dense_init(g, d, d, dtype),
        "ww": dense_init(g, d, d, dtype),  # data-dependent decay proj
        "w_bias": full(-6.0),
        "u": 0.1 * torch.randn((cfg.num_heads, rwkv_head_dim(cfg)),
                               generator=g, dtype=dtype, device=dev),
        "wo": dense_init(g, d, d, dtype),
        "ln_x": full(1.0),
        # channel mix
        "cm_mix_k": full(0.5),
        "cm_wk": dense_init(g, d, ff, dtype),
        "cm_wv": dense_init(g, ff, d, dtype),
        # pre-norms of the two sublayers
        "ln1": full(1.0),
        "ln2": full(1.0),
    }


def init_rwkv_state(batch: int, cfg, dtype=torch.float32,
                    device="cpu") -> RWKVState:
    H, dh = cfg.num_heads, rwkv_head_dim(cfg)
    return RWKVState(
        wkv=torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                        device=device),
        shift_tm=torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        shift_cm=torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
    )


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D]; last: [B, D] (the previous token). x shifted one step
    right, ``last`` first (the two promoted to a common dtype, as
    ``jnp.concatenate`` does)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def rwkv_time_mix(x: torch.Tensor, p: Dict, cfg, state: RWKVState,
                  chunk: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``chunk=0``: the sequential scan (``wkv6``). ``chunk=C>0``, when C
    divides S and S > C: the chunked form (``_wkv_chunked``). Returns
    ``(out, new wkv state, last token of x)``."""
    B, S, D = x.shape
    H = cfg.num_heads
    dh = rwkv_head_dim(cfg)
    xp = _token_shift(x, state.shift_tm)

    def mixed(mix):
        m = p[mix].to(x.dtype)
        return x * m + xp * (1 - m)

    r = linear(mixed("mix_r"), p["wr"]).reshape(B, S, H, dh)
    k = linear(mixed("mix_k"), p["wk"]).reshape(B, S, H, dh)
    v = linear(mixed("mix_v"), p["wv"]).reshape(B, S, H, dh)
    g = F.silu(linear(mixed("mix_g"), p["wg"]))
    # data-dependent decay (Finch): w in (0, 1), per channel per step
    w_raw = linear(mixed("mix_w"), p["ww"]) + p["w_bias"].to(x.dtype)
    w = torch.exp(-torch.exp(w_raw.float())).reshape(B, S, H, dh)
    u = p["u"].float()  # [H, dh]

    if chunk and S % chunk == 0 and S > chunk:
        y, s_final = _wkv_chunked(r, k, v, w, u, state.wkv, chunk)
    else:
        y, s_final = wkv6(r, k, v, w, u, state.wkv)
    y = y.reshape(B, S, D).to(x.dtype)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps) * g
    out = linear(y, p["wo"])
    return out, s_final, x[:, -1, :]


def _wkv_chunked(r, k, v, w, u, s0, C: int):
    """The reference's flash-linear-attention chunking of the RWKV6
    recurrence (``ssm.py:240-288``), fp32 throughout. With P_t the
    exclusive product of w inside a chunk: y_t = (r_t P_t) S_chunk0
    [inter] + sum_{s<t} (r_t P_t)(k_s / P_{s+1}) v_s^T [intra, causal] +
    (r_t u k_t) v_t^T [bonus]; S_end = P_C (S_chunk0 + sum_s (k_s /
    P_{s+1}) v_s^T)."""
    B, S, H, dh = r.shape
    n = S // C
    rf, kf, vf, wf = (a.float().reshape(B, n, C, H, dh)
                      for a in (r, k, v, w))
    s = s0
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    ys = []
    for i in range(n):
        rc, kc, vc, wc = rf[:, i], kf[:, i], vf[:, i], wf[:, i]
        P_excl = torch.cat([torch.ones_like(wc[:, :1]),
                            torch.cumprod(wc, dim=1)[:, :-1]], dim=1)
        P_incl = P_excl * wc
        r_dec = rc * P_excl
        k_gro = kc / torch.clamp_min(P_incl, 1e-20)
        y_inter = torch.einsum("bchd,bhde->bche", r_dec, s)
        A = torch.einsum("bchd,bshd->bhcs", r_dec, k_gro)
        A = torch.where(mask[None, None], A, 0.0)
        y_intra = torch.einsum("bhcs,bshe->bche", A, vc)
        y_bonus = (rc * u[None, None] * kc).sum(-1)[..., None] * vc
        ys.append(y_inter + y_intra + y_bonus)
        kv_sum = torch.einsum("bshd,bshe->bhde", k_gro, vc)
        s = P_incl[:, -1][..., None] * (s + kv_sum)
    return torch.stack(ys, dim=1).reshape(B, S, H, dh), s


def rwkv_channel_mix(x: torch.Tensor, p: Dict, cfg, state: RWKVState
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    xp = _token_shift(x, state.shift_cm)
    m = p["cm_mix_k"].to(x.dtype)
    xk = x * m + xp * (1 - m)
    h = torch.square(torch.relu(linear(xk, p["cm_wk"])))
    return linear(h, p["cm_wv"]), x[:, -1, :]


def rwkv_block(x: torch.Tensor, p: Dict, cfg,
               state: Optional[RWKVState] = None
               ) -> Tuple[torch.Tensor, RWKVState]:
    """One RWKV6 layer: time mix then channel mix, each behind its RMSNorm
    and residual. Returns ``(x out, new state)``."""
    if state is None:
        state = init_rwkv_state(x.shape[0], cfg, x.dtype, x.device)
    y_tm, wkv, last_tm = rwkv_time_mix(
        rms_norm(x, p["ln1"], cfg.norm_eps), p, cfg, state,
        chunk=cfg.rwkv_chunk)
    x2 = x + y_tm
    y_cm, last_cm = rwkv_channel_mix(
        rms_norm(x2, p["ln2"], cfg.norm_eps), p, cfg, state)
    return x2 + y_cm, RWKVState(wkv, last_tm, last_cm)
