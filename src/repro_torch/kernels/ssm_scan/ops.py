"""The recurrences of the SSM and hybrid families: Mamba2's selective scan
and RWKV6's WKV, each a whole sequence in one launch.

Neither replaces a Pallas kernel. The reference runs both as
``jax.lax.scan`` (``models/ssm.py:116``, the ``step`` of ``mamba_block``;
``:234``, ``_wkv_sequential``), which XLA keeps on the device; here a
Python loop would issue about eight launches a token a layer, and the
recurrent families re-prefill the whole batch at every admission, so each
scan is a hand-written kernel (``csrc/mamba_scan.cu``, ``csrc/wkv6.cu``;
their bounds and designs are noted there). Each C entry point has two
forms, one launch either way: below ``CHUNK_MIN`` steps the sequential
kernel (its final state bitwise the plain loop's), from it on a chunked
kernel whose products run on the tensor cores in 3xTF32 (y and the state
within 1e-5 of max(1, max|plain|)). The plain versions beside them are the
reference's loops over the sequence; ``mamba_scan_chunked_plain`` and
``wkv6_chunked_plain`` are the chunked kernels' algorithm as tensor code,
for the CPU tests only.

Training: with grad enabled and an input that requires it, a call runs
:class:`MambaScan` / :class:`WKV6`, whose backward is a hand-written kernel
too (``csrc/mamba_scan_bwd.cu`` ``mamba_scan_bwd_f32``, ``csrc/wkv6_bwd.cu``
``wkv6_bwd_f32``: the gradient JAX takes of the reference's scans) on the
card and ``mamba_scan_bwd_plain`` / ``wkv6_bwd_plain``, the reverse
recurrences written out step by step, on the CPU. Each backward entry
point has two forms as well, one launch either way: below
``BWD_CHUNK_MIN`` steps a sequential walk, from it a chunked form (the
forward's chunks in reverse: each chunk's start state and end adjoint,
then every chunk's gradients at once, on the tensor cores in 3xTF32;
every gradient within 1e-5 of max(1, max|plain|)).
``mamba_scan_bwd_chunked_plain`` and ``wkv6_bwd_chunked_plain`` are its
algorithm as tensor code, for the CPU tests only.

Rules (``kernels/backend``): CUDA tensors launch the kernel or raise, CPU
tensors run the plain version. Outputs and the new state are new tensors
(``torch.empty``): the state is functional, as in the reference, so a
caller may keep the old one.
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


def mamba_scan_bwd_plain(x, dt_sp, decay, Bm, Cm, h0, dy, dh):
    """The gradient of :func:`mamba_scan_plain` given ``dy`` [B, S, H, dh]
    and ``dh`` (of the final state) [B, H, dh, N], step by step in reverse:
    with ``g_t = dy_t (outer) C_t + decay_{t+1} g_{t+1}`` (``g_S = dh``),
    ``dx_t = dt_t (g_t B_t)``, ``d dt_t = sum g_t (*) (x_t (outer) B_t)``,
    ``d decay_t = sum g_t (*) h_{t-1}``, ``dB_t = sum_h dt_t g_t^T x_t``,
    ``dC_t = sum_h h_t^T dy_t`` and ``dh0 = decay_0 g_0``; the states are
    the forward's, kept, never recovered by dividing by a decay. Returns
    ``(dx, ddt, ddecay, dB, dC, dh0)``, all fp32."""
    hs = [h0.float()]
    for t in range(x.shape[1]):
        upd = (dt_sp[:, t, :, None, None] * x[:, t].float()[..., None]
               * Bm[:, t, None, None, :])
        hs.append(hs[-1] * decay[:, t, :, None, None] + upd)
    g = dh.float()
    out = {k: [] for k in ("dx", "ddt", "ddecay", "dB", "dC")}
    for t in reversed(range(x.shape[1])):
        xt, dyt = x[:, t].float(), dy[:, t].float()
        g = g + dyt[..., None] * Cm[:, t, None, None, :]
        gB = torch.einsum("bhdn,bn->bhd", g, Bm[:, t])
        out["dx"].append(dt_sp[:, t, :, None] * gB)
        out["ddt"].append((gB * xt).sum(-1))
        out["ddecay"].append((g * hs[t]).sum((-1, -2)))
        out["dB"].append(torch.einsum("bhdn,bhd,bh->bn", g, xt, dt_sp[:, t]))
        out["dC"].append(torch.einsum("bhdn,bhd->bn", hs[t + 1], dyt))
        g = g * decay[:, t, :, None, None]
    return (*(torch.stack(v[::-1], dim=1) for v in out.values()), g)


def wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds):
    """The gradient of :func:`wkv6_plain` given ``dy`` [B, S, H, dh] and
    ``ds`` (of the final state) [B, H, dh, dh], step by step in reverse:
    with ``G = dL/dS_t`` (``ds`` after the last step) and ``p_t = dy_t .
    v_t``, ``dr_t = S_{t-1} dy_t + u (*) k_t p_t``, ``dw_t = rowsum(G (*)
    S_{t-1})``, ``dk_t = G v_t + r_t (*) u p_t``, ``dv_t = G^T k_t + (r_t .
    (u (*) k_t)) dy_t``, ``du = sum r_t (*) k_t p_t`` over batch rows and
    steps, then ``G = w_t (*) G + r_t (outer) dy_t``; ``ds0`` is G after
    the first step. The states are the forward's, kept. Returns ``(dr, dk,
    dv, dw, du, ds0)``, all fp32."""
    ss = [s0.float()]
    for t in range(r.shape[1]):
        kv = k[:, t].float()[..., :, None] * v[:, t].float()[..., None, :]
        ss.append(ss[-1] * w[:, t].float()[..., None] + kv)
    G, du = ds.float(), torch.zeros(u.shape, device=u.device)
    out = {n: [] for n in ("dr", "dk", "dv", "dw")}
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        dyt = dy[:, t].float()
        p = (dyt * vt).sum(-1, keepdim=True)
        out["dr"].append(torch.einsum("bhde,bhe->bhd", ss[t], dyt)
                         + u * kt * p)
        out["dk"].append(torch.einsum("bhde,bhe->bhd", G, vt) + rt * u * p)
        out["dv"].append(torch.einsum("bhde,bhd->bhe", G, kt)
                         + (rt * u * kt).sum(-1, keepdim=True) * dyt)
        out["dw"].append((G * ss[t]).sum(-1))
        du = du + (rt * kt * p).sum(0)
        G = G * wt[..., None] + rt[..., :, None] * dyt[..., None, :]
    dr, dk, dv, dw = (torch.stack(v[::-1], dim=1) for v in out.values())
    return dr, dk, dv, dw, du, G


# The kernels' two forms (``csrc/mamba_scan.cu``, ``csrc/wkv6.cu``): below
# CHUNK_MIN[kind] steps the sequential kernel, from it on the chunked one,
# which takes CHUNK steps at a time in sub-chunks of SUB (the kernels'
# ``kChunkMin``, ``kC``, ``kSub``; ``test_torch_scan_chunked`` holds the
# sources to these numbers)
CHUNK, SUB = 64, 16
CHUNK_MIN = {"mamba": 32, "wkv6": 48}


def scan_form(kind: str, S: int) -> str:
    """Which form of the ``kind`` ("mamba" or "wkv6") kernel a call of
    ``S`` steps runs."""
    return "chunked" if S >= CHUNK_MIN[kind] else "sequential"


def _chunks(S: int, *seqs: torch.Tensor):
    """Yield (start, steps, per-chunk tensors) with every [B, S, ...]
    tensor cut to CHUNK steps and padded past the end with zeros."""
    for c0 in range(0, S, CHUNK):
        n = min(CHUNK, S - c0)
        yield c0, n, [torch.nn.functional.pad(
            t[:, c0:c0 + n].float(),
            (0, 0) * (t.dim() - 2) + (0, CHUNK - n)) for t in seqs]


def _sub_factors(dec: torch.Tensor):
    """The decay factors of one chunk, every one a running product of
    factors <= 1 (no division, no log): ``dec`` [..., CHUNK] with padded
    steps at 1. Returns (incl [..., CHUNK]: the product over the sub-chunk
    up to and including t; excl: up to t, excluding it; suffix: after s to
    the sub-chunk's end; total [..., CHUNK / SUB]: each sub-chunk's
    product)."""
    d = dec.unflatten(-1, (CHUNK // SUB, SUB))
    incl, excl, suffix = (torch.empty_like(d) for _ in range(3))
    run = torch.ones_like(d[..., 0])
    for t in range(SUB):
        excl[..., t] = run
        run = run * d[..., t]
        incl[..., t] = run
    run = torch.ones_like(run)
    for t in reversed(range(SUB)):
        suffix[..., t] = run
        run = run * d[..., t]
    return (incl.flatten(-2), excl.flatten(-2), suffix.flatten(-2),
            incl[..., -1])


def _across(total: torch.Tensor):
    """From each sub-chunk's product [..., n]: (before [..., n], the
    product of the sub-chunks before each; after, of those after it;
    between(j, i) for j < i - 1, of those strictly between, as
    {(j, i): tensor}), each a running product in sub-chunk order."""
    n = total.shape[-1]
    before, after = torch.empty_like(total), torch.empty_like(total)
    run = torch.ones_like(total[..., 0])
    for i in range(n):
        before[..., i] = run
        run = run * total[..., i]
    run = torch.ones_like(run)
    for j in reversed(range(n)):
        after[..., j] = run
        run = run * total[..., j]
    between = {}
    for i in range(n):
        run = torch.ones_like(total[..., 0])
        for j in reversed(range(i - 1)):
            run = run * total[..., j + 1]
            between[(j, i)] = run
    return before, after, between


def _within_sub(d: torch.Tensor) -> torch.Tensor:
    """seg(s->t) within each sub-chunk, [..., n, SUB (t), SUB (s)], from
    ``d`` [..., n, SUB]: from each s a running product of the decays after
    it, 0 above the diagonal."""
    s_idx = torch.arange(SUB)
    run = torch.ones(d.shape[:-1] + (SUB,))
    out = torch.zeros(d.shape[:-1] + (SUB, SUB))
    for t in range(SUB):
        run = torch.where(t > s_idx, run * d[..., t:t + 1], run)
        out[..., t, :] = torch.where(t >= s_idx, run, torch.zeros(()))
    return out


def _wkv_within_sub(r, k, w, u):
    """A's diagonal blocks, [..., n, SUB (t), SUB (s)], from r, k, w
    [..., n, SUB, dh]: ``r_t . (k_s (*) prod_{s<u<t} w_u)`` below the
    diagonal by running products from each key s on, the bonus ``r_t . (u
    (*) k_t)`` on it, 0 above."""
    s_idx = torch.arange(SUB)[:, None]
    run = torch.ones(k.shape)                       # [..., n, SUB (s), dh]
    out = torch.zeros(k.shape[:-1] + (SUB,))
    for t in range(SUB):
        below = (t > s_idx)[..., 0]
        part = (r[..., t:t + 1, :] * (k * run)).sum(-1)
        out[..., t, :] = torch.where(below, part, torch.zeros(()))
        run = torch.where(t > s_idx, run * w[..., t:t + 1, :], run)
    bonus = (r * u[:, None, None, :] * k).sum(-1)   # [..., n, SUB]
    return out + torch.diag_embed(bonus)


def _mamba_factors(dec: torch.Tensor):
    """The decay factors of one Mamba2 chunk, formed in sub-chunks of SUB
    as ``mamba_scan.cu`` forms them, from ``dec`` [..., CHUNK] (padded steps
    at 1): (L [..., CHUNK (t), CHUNK (s)], seg(s->t) for s <= t and 0
    above; a, seg(start->t); e, seg(s->end); all, seg(start->end))."""
    nsub = CHUNK // SUB
    incl, _, suffix, total = _sub_factors(dec)
    before, after, between = _across(total)
    sub = torch.arange(CHUNK) // SUB
    L = torch.zeros(dec.shape + (CHUNK,))
    lin = _within_sub(dec.unflatten(-1, (nsub, SUB)))
    for i in range(nsub):
        rows = slice(SUB * i, SUB * (i + 1))
        L[..., rows, rows] = lin[..., i, :, :]
        for j in range(i):
            cols = slice(SUB * j, SUB * (j + 1))
            f = incl[..., rows, None]
            if j < i - 1:
                f = f * between[(j, i)][..., None, None]
            L[..., rows, cols] = f * suffix[..., None, cols]
    return (L, before[..., sub] * incl, suffix * after[..., sub],
            before[..., -1] * total[..., -1])


def _chunk_decays(decay: torch.Tensor, c0: int, n: int) -> torch.Tensor:
    """Steps c0 .. c0 + n - 1 of ``decay`` [B, S, ...] as a chunk of CHUNK
    steps, padded with 1, steps moved last: [B, ..., CHUNK]."""
    dec = torch.ones((decay.shape[0], CHUNK) + decay.shape[2:])
    dec[:, :n] = decay[:, c0:c0 + n]
    return dec.movedim(1, -1)


def mamba_scan_chunked_plain(x: torch.Tensor, dt_sp: torch.Tensor,
                             decay: torch.Tensor, Bm: torch.Tensor,
                             Cm: torch.Tensor, h0: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's algorithm as tensor code (tests only; the plain
    version stays the reference loop). Per chunk of CHUNK steps, with
    ``seg(s->t)`` the product of the decays after s up to t, formed in
    sub-chunks of SUB as ``mamba_scan.cu`` forms it:
    ``y_t = sum_{s<=t} seg(s->t) (C_t . B_s) dt_s x_s + seg(start->t) h C_t``
    and ``h_end = seg(start->end) h + sum_s seg(s->end) dt_s x_s B_s^T``,
    four products a (batch row, head, chunk)."""
    h, ys = h0.float(), []
    for c0, n, (xc, dtc, Bc, Cc) in _chunks(x.shape[1], x, dt_sp, Bm, Cm):
        Xp = (dtc[..., None] * xc).permute(0, 2, 1, 3)   # [B, H, C, dh]
        L, a, e, all_ = _mamba_factors(_chunk_decays(decay, c0, n))
        G = torch.einsum("btn,bsn->bts", Cc, Bc)[:, None]  # shared by heads
        y = (G * L) @ Xp + (a[..., None] * Cc[:, None]) @ h.transpose(-1, -2)
        h = all_[..., None, None] * h + \
            (e[..., None] * Xp).transpose(-1, -2) @ Bc[:, None]
        ys.append(y.permute(0, 2, 1, 3)[:, :n])
    return torch.cat(ys, dim=1), h


def wkv6_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's algorithm as tensor code (tests only; the plain
    version stays the reference loop). Per chunk of CHUNK steps in
    sub-chunks of SUB, as ``wkv6.cu`` forms it: ``A[t, s] = r_t . (k_s (*)
    prod_{s<u<t} w_u)`` for s < t, by running products within a sub-chunk
    and, for an earlier sub-chunk, as ``(r_t (*) prod_{ref<=u<t} w_u) .
    (k_s (*) prod_{s<u<ref} w_u)`` with ref the query sub-chunk's first
    step (both factors <= 1); ``A[t, t] = r_t . (u (*) k_t)`` (the bonus);
    ``y = A v + (r_t (*) prod_{u<t} w_u) S`` and ``S_end = prod w (*) S +
    sum_s (k_s (*) prod_{s<u} w_u) v_s^T``."""
    B, S, H, dh = r.shape
    s, ys, nsub = s0.float(), [], CHUNK // SUB
    for c0, n, (rc, kc, vc) in _chunks(S, r, k, v):
        wc = torch.ones((B, CHUNK, H, dh))
        wc[:, :n] = w[:, c0:c0 + n]
        rc, kc, vc, wc = (t.permute(0, 2, 1, 3) for t in (rc, kc, vc, wc))
        _, excl, suffix, total = _sub_factors(wc.transpose(-1, -2))
        excl, suffix = excl.transpose(-1, -2), suffix.transpose(-1, -2)
        before, after, between = _across(total)           # [B, H, dh, nsub]
        sub = torch.arange(CHUNK) // SUB
        rt = rc * excl                       # r_t (*) prod_{ref<=u<t} w_u
        kq = kc * suffix                     # k_s (*) prod_{s<u<=end} w_u
        A = torch.zeros((B, H, CHUNK, CHUNK))
        diag = _wkv_within_sub(*(t.unflatten(-2, (nsub, SUB))
                                 for t in (rc, kc, wc)), u)
        for i in range(nsub):
            rows = slice(SUB * i, SUB * (i + 1))
            A[..., rows, rows] = diag[..., i, :, :]
            for j in range(i):
                cols = slice(SUB * j, SUB * (j + 1))
                kj = kq[..., cols, :]
                if j < i - 1:
                    kj = kj * between[(j, i)][..., None, :]
                A[..., rows, cols] = rt[..., rows, :] @ kj.transpose(-1, -2)
        rhat = rt * before[..., sub].transpose(-1, -2)    # prod_{u<t} w_u
        y = A @ vc + rhat @ s
        kbar = kq * after[..., sub].transpose(-1, -2)     # prod_{s<u} w_u
        s = (before[..., -1] * total[..., -1])[..., None] * s + \
            kbar.transpose(-1, -2) @ vc
        ys.append(y.permute(0, 2, 1, 3)[:, :n])
    return torch.cat(ys, dim=1), s


# ---------------------------------------------------------------------------
# The backward kernels' chunked form as tensor code (tests only)
# ---------------------------------------------------------------------------
def _shift_down(L: torch.Tensor) -> torch.Tensor:
    """``Pre[s, v] = L[v - 1, s]`` (0 at v = 0): the products of the decays
    after s up to v, v left out, from seg(s->t) = L [..., t, s]."""
    pre = torch.zeros_like(L)
    pre[..., :, 1:] = L[..., :-1, :].transpose(-1, -2)
    return pre


def mamba_scan_bwd_chunked_plain(x, dt_sp, decay, Bm, Cm, h0, dy, dh):
    """The chunked backward kernel's algorithm (``csrc/mamba_scan_bwd.cu``)
    as tensor code, for the CPU tests; the same outputs as
    :func:`mamba_scan_bwd_plain`. Per chunk of CHUNK steps, with ``L[t, s]
    = seg(s->t)``, ``a = seg(start->t)``, ``e = seg(s->end)`` formed as
    the forward forms them (:func:`_mamba_factors`):

    1. the chunks' start states forward, ``h <- all h + (e X)^T B`` (X = dt
       x);
    2. their end adjoints in reverse, ``g <- all g + (a dY)^T C``; ``dh0``
       is the one out of the first chunk;
    3. per chunk, from its start state h and end adjoint g, with ``G = C
       B^T``, ``D = dY x^T``: ``dx = dt (M^T dY + e (B g^T))`` with ``M = G
       (*) L``; ``d dt`` the row-dot of ``dx / dt`` with x; ``dB = dt
       ((D (*) L)^T C + e (x g))`` and ``dC = (D (*) L) (dt B) + a (dY h)``
       per head; ``d decay_v``, a sum over s < v <= t of ``W[t, s] = (dY_t
       . X_s) (C_t . B_s)`` times seg(s->t) with v left out, as ``(W Pre)
       (*) L`` summed over t, where ``Pre[s, v] = L[v - 1, s]`` (no
       division), plus the terms against h and g."""
    chunks = list(_chunks(x.shape[1], x, dt_sp, Bm, Cm, dy))
    facs = [_mamba_factors(_chunk_decays(decay, c0, n))
            for c0, n, _ in chunks]
    h, starts = h0.float(), []
    for (_, _, (xc, dtc, Bc, _, _)), (_, _, e, all_) in zip(chunks, facs):
        starts.append(h)
        X = (dtc[..., None] * xc).permute(0, 2, 1, 3)       # [B, H, C, dh]
        h = all_[..., None, None] * h + \
            (e[..., None] * X).transpose(-1, -2) @ Bc[:, None]
    g, ends = dh.float(), [None] * len(chunks)
    for i in reversed(range(len(chunks))):
        ends[i] = g
        _, _, (_, _, _, Cc, dyc) = chunks[i]
        _, a, _, all_ = facs[i]
        g = all_[..., None, None] * g + \
            (a[..., None] * dyc.permute(0, 2, 1, 3)).transpose(-1, -2) \
            @ Cc[:, None]
    out = {n: [] for n in ("dx", "ddt", "ddecay", "dB", "dC")}
    strict = torch.ones(CHUNK, CHUNK).tril(-1)
    for (_, n, (xc, dtc, Bc, Cc, dyc)), (L, a, e, _), hs, ge in zip(
            chunks, facs, starts, ends):
        xp, dY = xc.permute(0, 2, 1, 3), dyc.permute(0, 2, 1, 3)
        dtp = dtc.permute(0, 2, 1)                          # [B, H, C]
        Bc, Cc = Bc[:, None], Cc[:, None]
        G = Cc @ Bc.transpose(-1, -2)                        # [t, s]
        D = dY @ xp.transpose(-1, -2)                        # dy_t . x_s
        DL = D * L
        Bg = Bc @ ge.transpose(-1, -2)                       # [t, d]
        dxg = (G * L).transpose(-1, -2) @ dY + e[..., None] * Bg
        dYh = dY @ hs                                        # [t, n]
        W = D * G * dtp[..., None, :] * strict
        pre = _shift_down(L)
        U = (dYh * Cc).sum(-1)                               # [t]
        V = (dtp[..., None] * xp * Bg).sum(-1)               # [s]
        a_prev = torch.cat([torch.ones_like(a[..., :1]), a[..., :-1]], -1)
        ddecay = ((W @ pre) * L).sum(-2) + \
            a_prev * (L * U[..., :, None]).sum(-2) + \
            e * (pre * V[..., :, None]).sum(-2) + \
            a_prev * e * (hs * ge).sum((-1, -2))[..., None]
        parts = {"dx": dtp[..., None] * dxg, "ddt": (dxg * xp).sum(-1),
                 "ddecay": ddecay,
                 "dB": (dtp[..., None] * (DL.transpose(-1, -2) @ Cc
                                          + e[..., None] * (xp @ ge))
                        ).sum(1),
                 "dC": (DL @ (dtp[..., None] * Bc)
                        + a[..., None] * dYh).sum(1)}
        for name, t in parts.items():
            t = t if name in ("dB", "dC") else t.movedim(1, 2)
            out[name].append(t[:, :n])
    return (*(torch.cat(v, dim=1) for v in out.values()), g)


def _wkv_factors(w: torch.Tensor):
    """The per-channel decay factors of one WKV chunk from ``w`` [..., CHUNK,
    dh] (padded steps at 1), formed in sub-chunks of SUB as ``wkv6.cu``
    forms them: (excl, the product from the sub-chunk's start up to t
    exclusive; suffix, after s to the sub-chunk's end; before, after
    [..., CHUNK / SUB, dh] and between {(j, i): [..., dh]}, the products of
    whole sub-chunks (:func:`_across`); all [..., dh])."""
    _, excl, suffix, total = _sub_factors(w.transpose(-1, -2))
    before, after, between = _across(total)
    return (excl.transpose(-1, -2), suffix.transpose(-1, -2),
            before.transpose(-1, -2), after.transpose(-1, -2), between,
            before[..., -1] * total[..., -1])


def _wkv_within(w: torch.Tensor) -> torch.Tensor:
    """``prod_{s<u<t} w_u`` within each sub-chunk for s < t, 0 elsewhere:
    [..., n, SUB (t), SUB (s), dh] from ``w`` [..., n, SUB, dh], by
    running products from each s on."""
    s_idx = torch.arange(SUB)[:, None]
    run = torch.ones(w.shape)                       # [..., n, SUB (s), dh]
    out = torch.zeros(w.shape[:-1] + (SUB, w.shape[-1]))
    for t in range(SUB):
        out[..., t, :, :] = torch.where(t > s_idx, run, torch.zeros(()))
        run = torch.where(t > s_idx, run * w[..., t:t + 1, :], run)
    return out


def wkv6_bwd_chunked_plain(r, k, v, w, u, s0, dy, ds):
    """The chunked backward kernel's algorithm (``csrc/wkv6_bwd.cu``) as
    tensor code, for the CPU tests; the same outputs as
    :func:`wkv6_bwd_plain`. Per chunk, with the forward's factors
    (:func:`_wkv_factors`; r~ = r (*) excl, kq = k (*) suffix, F =
    prod_{start<=u<t} w_u, E = prod_{t<u<=end} w_u):

    1. the chunks' start states forward, ``S <- all (*) S + (k E)^T v``;
    2. their end adjoints in reverse, ``G <- all (*) G + (r F)^T dy``;
       ``ds0`` the one out of the first chunk;
    3. per chunk, from its start state S0 and end adjoint Ge, with ``P =
       dY v^T`` (p_t its diagonal), ``Hs = dY S0^T``, ``Gv = v Ge^T`` and
       A the forward's (the bonus on its diagonal): ``dv = A^T dY + (k E)
       Ge``; ``Yr = sum_{j<i} P_ij (kq_j (*) between) + before (*) Hs``
       and ``Yk = sum_{i>j} P_ij^T (r~_i (*) between) + after (*) Gv`` (the
       sub-chunks' products), so ``dr = excl (*) Yr + (diagonal blocks) +
       u k p`` and ``dk = suffix (*) Yk + (diagonal blocks) + r u p``;
       ``dw_v``, a sum over s < v < t of ``P[t, s] k_s r_t`` times the
       decays from s to t with v left out, split by where s and t lie
       against v's sub-chunk m: both outside (whole sub-chunks' sums X,
       S0 and Ge standing in as a step before the chunk and one after it),
       s before m (Yr), t after m (Yk), both inside (a walk within m); no
       division. ``du`` summed over batch rows and steps."""
    nsub = CHUNK // SUB
    chunks = list(_chunks(r.shape[1], r, k, v, dy))
    facs, FE = [], []
    for c0, n, _ in chunks:
        wc = _chunk_decays(w, c0, n).movedim(-1, -2)         # [B, H, C, dh]
        f = _wkv_factors(wc)
        excl, suffix, before, after = f[:4]
        sub = torch.arange(CHUNK) // SUB
        facs.append((wc, *f))
        FE.append((excl * before[..., sub, :], suffix * after[..., sub, :]))
    s, starts = s0.float(), []
    for (_, _, (_, kc, vc, _)), f, (_, E) in zip(chunks, facs, FE):
        starts.append(s)
        kc, vc = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
        s = f[-1][..., None] * s + (kc * E).transpose(-1, -2) @ vc
    G, ends = ds.float(), [None] * len(chunks)
    for i in reversed(range(len(chunks))):
        ends[i] = G
        _, _, (rc, _, _, dyc) = chunks[i]
        G = facs[i][-1][..., None] * G + \
            (rc.permute(0, 2, 1, 3) * FE[i][0]).transpose(-1, -2) @ \
            dyc.permute(0, 2, 1, 3)
    out = {n: [] for n in ("dr", "dk", "dv", "dw")}
    du, uu = torch.zeros(u.shape), u[:, None, :]
    blk = lambda i: slice(SUB * i, SUB * (i + 1))
    for (_, n, seqs), f, (_, E), S0, Ge in zip(chunks, facs, FE, starts,
                                               ends):
        rc, kc, vc, dY = (t.permute(0, 2, 1, 3) for t in seqs)
        wc, excl, suffix, before, after, between, all_ = f
        rt, kq = rc * excl, kc * suffix
        btw = lambda j, i: (between[(j, i)] if j < i - 1
                            else torch.ones_like(all_))[..., None, :]
        P = dY @ vc.transpose(-1, -2)                        # dy_t . v_s
        p = torch.diagonal(P, dim1=-2, dim2=-1)[..., None]
        Hs = dY @ S0.transpose(-1, -2)                       # [t, d]
        Gv = vc @ Ge.transpose(-1, -2)                       # [s, d]
        A = torch.zeros(P.shape)
        diag = _wkv_within_sub(*(t.unflatten(-2, (nsub, SUB))
                                 for t in (rc, kc, wc)), u)
        Yr, Yk = torch.zeros(Hs.shape), torch.zeros(Gv.shape)
        X = {}  # whole sub-chunks' sums, -1 and nsub the virtual steps
        for i in range(nsub):
            A[..., blk(i), blk(i)] = diag[..., i, :, :]
            Yr[..., blk(i), :] = before[..., i:i + 1, :] * Hs[..., blk(i), :]
            Yk[..., blk(i), :] = after[..., i:i + 1, :] * Gv[..., blk(i), :]
            X[(-1, i)] = (rt[..., blk(i), :] * Hs[..., blk(i), :]).sum(-2)
            X[(i, nsub)] = (kq[..., blk(i), :] * Gv[..., blk(i), :]).sum(-2)
        X[(-1, nsub)] = (Ge * S0).sum(-1)
        for i in range(nsub):
            for j in range(i):
                kj = kq[..., blk(j), :] * btw(j, i)
                A[..., blk(i), blk(j)] = rt[..., blk(i), :] @ \
                    kj.transpose(-1, -2)
                Pij = P[..., blk(i), blk(j)]
                Yr[..., blk(i), :] += Pij @ kj
                Yk[..., blk(j), :] += Pij.transpose(-1, -2) @ \
                    (rt[..., blk(i), :] * btw(j, i))
                if j < i - 1:
                    X[(j, i)] = (rt[..., blk(i), :]
                                 * (Pij @ kq[..., blk(j), :])).sum(-2)
        dv = A.transpose(-1, -2) @ dY + (kc * E) @ Ge
        # within a sub-chunk: pi[t, s] = prod_{s<u<t} w_u (s < t)
        sub = lambda t: t.unflatten(-2, (nsub, SUB))
        pi = _wkv_within(sub(wc))                 # [B, H, n, t, s, dh]
        Pm = torch.stack([P[..., blk(i), blk(i)] for i in range(nsub)], 2)
        rs, ks = sub(rc), sub(kc)
        dr = excl * Yr + torch.einsum("bhmts,bhmtsd,bhmsd->bhmtd", Pm, pi,
                                      ks).flatten(2, 3) + uu * kc * p
        dk = suffix * Yk + torch.einsum("bhmts,bhmtsd,bhmtd->bhmsd", Pm, pi,
                                        rs).flatten(2, 3) + rc * uu * p
        # dw by where s and t lie against v's sub-chunk m
        inner = torch.einsum("bhmts,bhmsd,bhmtd,bhmvsd,bhmtvd->bhmvd", Pm,
                             ks, rs, pi, pi)
        from_r = torch.einsum("bhmtvd,bhmtd,bhmtd->bhmvd", pi, rs, sub(Yr))
        from_k = torch.einsum("bhmvsd,bhmsd,bhmsd->bhmvd", pi, ks, sub(Yk))
        dw = (inner + sub(excl) * from_r + sub(suffix) * from_k).flatten(2, 3)
        lead = lambda j, m: (before[..., m, :] if j < 0
                             else btw(j, m)[..., 0, :])
        trail = lambda m, i: (after[..., m, :] if i == nsub
                              else btw(m, i)[..., 0, :])
        for m in range(nsub):
            outside = sum(lead(j, m) * trail(m, i) * X[(j, i)]
                          for j in range(-1, m)
                          for i in range(m + 1, nsub + 1))
            dw[..., blk(m), :] += (excl * suffix)[..., blk(m), :] * \
                outside[..., None, :]
        du = du + (rc * kc * p).sum((0, 2))
        for name, t in (("dr", dr), ("dk", dk), ("dv", dv), ("dw", dw)):
            out[name].append(t.permute(0, 2, 1, 3)[:, :n])
    dr, dk, dv, dw = (torch.cat(t, dim=1) for t in out.values())
    return dr, dk, dv, dw, du, G


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


def _check_card(name: str, tensors, width: int) -> None:
    """What the kernels take beyond the plain versions: contiguous
    operands, widths up to ``MAX_WIDTH``."""
    _require(all(t.is_contiguous() for t in tensors), ValueError,
             f"{name} kernel takes contiguous operands")
    _require(1 <= width <= MAX_WIDTH, ValueError,
             f"{name} kernel takes head and state widths of 1 to "
             f"{MAX_WIDTH}, got {width}")


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
    CPU; with grad enabled and an input that requires it, through
    :class:`MambaScan`."""
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
    if backend.on_card(*ins):
        _check_card("mamba_scan", ins, max(dh, N))
    if _wants_grad(*ins):
        return MambaScan.apply(*ins)
    return _mamba_scan_fwd(*ins)


def _mamba_scan_fwd(*ins):
    return (_mamba_scan_cuda(*ins) if backend.on_card(*ins)
            else mamba_scan_plain(*ins))


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
    (dh <= 64), the plain version on the CPU; with grad enabled and an
    input that requires it, through :class:`WKV6`."""
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
    if backend.on_card(*ins):
        _check_card("wkv6", ins, dh)
    if _wants_grad(*ins):
        return WKV6.apply(*ins)
    return _wkv6_fwd(*ins)


def _wkv6_fwd(*ins):
    return _wkv6_cuda(*ins) if backend.on_card(*ins) else wkv6_plain(*ins)


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


# ---------------------------------------------------------------------------
# Training: the scans with their gradient
# ---------------------------------------------------------------------------
# The backward kernels' two forms, one launch of the entry point either
# way: below BWD_CHUNK_MIN[kind] steps the sequential walk, from it on the
# chunked form (the kernels' ``kBwdChunkMin``; ``test_torch_scan_bwd_chunked``
# holds the sources to these numbers)
BWD_CHUNK_MIN = {"mamba": 32, "wkv6": 32}


def bwd_form(kind: str, S: int) -> str:
    """Which form of the ``kind`` ("mamba" or "wkv6") backward kernel a
    call of ``S`` steps runs."""
    return "chunked" if S >= BWD_CHUNK_MIN[kind] else "sequential"


# The sequential form's recomputation (``csrc/scan_bwd.cuh``'s ``kCk``,
# ``kW``): a checkpoint of the state every BWD_CKPT steps, a window start
# every BWD_WINDOW; and the persistent blocks an SM its grid assumes
BWD_CKPT, BWD_WINDOW, BWD_BLOCKS_PER_SM = 32, 4, 2
_STATE = MAX_WIDTH * MAX_WIDTH  # floats of one padded state
_SMS: dict = {}


def bwd_slots(device: torch.device, items: int) -> int:
    """Blocks of a sequential backward launch: one persistent block a
    (head, batch row) item up to ``BWD_BLOCKS_PER_SM`` an SM."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return max(1, min(items, BWD_BLOCKS_PER_SM * n))


def bwd_scratch_floats(S: int) -> int:
    """fp32 scratch of one block of the sequential form: a checkpoint every
    ``BWD_CKPT`` steps and the window starts of one interval
    (``scan_bwd.cuh``'s ``slot_floats``)."""
    return (-(-S // BWD_CKPT) + BWD_CKPT // BWD_WINDOW) * _STATE


def bwd_bounds_floats(items: int, S: int) -> int:
    """fp32 scratch of the chunked form: every chunk's start state and end
    adjoint of each (head, batch row) item, padded to 64 x 64
    (``scan_bwd_chunk.cuh``)."""
    return 2 * items * -(-S // CHUNK) * _STATE


def _bwd_scratch(kind: str, dev: torch.device, items: int, S: int):
    """(blocks of the sequential form (1 for the chunked), fp32 scratch) of
    one backward launch."""
    f32 = dict(dtype=torch.float32, device=dev)
    if bwd_form(kind, S) == "chunked":
        return 1, torch.empty(bwd_bounds_floats(items, S), **f32)
    slots = bwd_slots(dev, items)
    return slots, torch.empty(slots * bwd_scratch_floats(S), **f32)


def _grads_in(dy, ds):
    """The outputs' gradients (autograd gives zeros for an output that took
    none) as the fp32 contiguous tensors the backward kernels read."""
    return dy.float().contiguous(), ds.float().contiguous()


class MambaScan(torch.autograd.Function):
    """:func:`mamba_scan` with its gradient: the forward is
    ``mamba_scan_f32`` on the card and :func:`mamba_scan_plain` on the CPU,
    the backward ``mamba_scan_bwd_f32`` on the card and
    :func:`mamba_scan_bwd_plain` on the CPU. Gradients come back in each
    input's dtype."""

    @staticmethod
    def forward(ctx, x, dt_sp, decay, Bm, Cm, h0):
        y, h = _mamba_scan_fwd(x, dt_sp, decay, Bm, Cm, h0)
        ctx.save_for_backward(x, dt_sp, decay, Bm, Cm, h0)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        ins = ctx.saved_tensors
        dy, dh = _grads_in(dy, dh)
        if backend.on_card(*ins):
            grads = _mamba_scan_bwd_cuda(*ins, dy, dh)
        else:
            grads = mamba_scan_bwd_plain(*ins, dy, dh)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins))


def _mamba_scan_bwd_cuda(x, dt_sp, decay, Bm, Cm, h0, dy, dh):
    """``(dx, ddt, ddecay, dB, dC, dh0)`` by ``mamba_scan_bwd_f32``: one
    launch of its entry point (the sequential walk, or the chunked form's
    boundary walk and chunks; then dB and dC summed over heads in
    order)."""
    B, S, H, dh_ = x.shape
    N = Bm.shape[-1]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((B, S, H, dh_), **f32)
    ddt, ddecay = torch.empty_like(dt_sp), torch.empty_like(decay)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dh0 = torch.empty_like(h0)
    dBh, dCh = (torch.empty((B, S, H, N), **f32) for _ in range(2))
    slots, scratch = _bwd_scratch("mamba", dev, B * H, S)
    backend.launch("mamba_scan_bwd", "mamba_scan_bwd_f32", dev,
                   *(t.data_ptr() for t in (x, dt_sp, decay, Bm, Cm, h0, dy,
                                            dh, dx, ddt, ddecay, dB, dC, dh0,
                                            dBh, dCh, scratch)),
                   int(x.dtype == torch.bfloat16), B, S, H, dh_, N, slots)
    return dx, ddt, ddecay, dB, dC, dh0


class WKV6(torch.autograd.Function):
    """:func:`wkv6` with its gradient: the forward is ``wkv6_f32`` on the
    card and :func:`wkv6_plain` on the CPU, the backward ``wkv6_bwd_f32``
    on the card and :func:`wkv6_bwd_plain` on the CPU. Gradients come back
    in each input's dtype."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, s = _wkv6_fwd(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        ins = ctx.saved_tensors
        dy, ds = _grads_in(dy, ds)
        if backend.on_card(*ins):
            grads = _wkv6_bwd_cuda(*ins, dy, ds)
        else:
            grads = wkv6_bwd_plain(*ins, dy, ds)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins))


def _wkv6_bwd_cuda(r, k, v, w, u, s0, dy, ds):
    """``(dr, dk, dv, dw, du, ds0)`` by ``wkv6_bwd_f32``: one launch of its
    entry point (the sequential walk, or the chunked form's boundary walk
    and chunks; then du summed over batch rows, and chunks, in order)."""
    B, S, H, dh = r.shape
    dev = r.device
    f32 = dict(dtype=torch.float32, device=dev)
    dr, dk, dv = (torch.empty((B, S, H, dh), **f32) for _ in range(3))
    dw, du, ds0 = torch.empty_like(w), torch.empty_like(u), \
        torch.empty_like(s0)
    slots, scratch = _bwd_scratch("wkv6", dev, B * H, S)
    parts = B * -(-S // CHUNK) if bwd_form("wkv6", S) == "chunked" else B
    du_part = torch.empty((parts, H, dh), **f32)
    backend.launch("wkv6_bwd", "wkv6_bwd_f32", dev,
                   *(t.data_ptr() for t in (r, k, v, w, u, s0, dy, ds, dr,
                                            dk, dv, dw, du, ds0, du_part,
                                            scratch)),
                   int(r.dtype == torch.bfloat16), B, S, H, dh, slots)
    return dr, dk, dv, dw, du, ds0
