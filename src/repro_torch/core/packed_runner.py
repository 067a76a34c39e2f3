"""Packed-model execution — the deployment path of the paper's accelerator,
on the card; the port of the reference package's ``core/packed_runner.py``
(fp32 tier, hard TDM).

After simultaneous pruning, ``pack_model`` hardens the masks and converts
every block-pruned attention weight into the block-compressed SBMM format.
The forward then runs the ViT with those weights through the hand-written
kernels:

* q/k/v/o projections — ``kernels.sbmm`` (K1);
* attention with per-row ``n_valid`` and, at TDM layers, the CLS-row
  scores — ``kernels.flash_attention`` (K2);
* the TDM's gather + fuse — ``kernels.token_drop`` (K3).

Embedding, LayerNorm, the masked-dense MLP and the head are plain PyTorch
(cuBLAS matmuls in full fp32), as the reference leaves them to XLA.

Per-stage segmentation (``serving.vision``): the forward is decomposed
into segments whose boundaries are the TDM layers —

    ("embed",)          patches -> tokens          (count = n_patches + 1)
    ("layers", lo, hi)  encoder layers [lo, hi)    (count constant)
    ("tdm", i)          encoder layer i with the TDM (count shrinks)
    ("head",)           final norm + CLS readout   (-> logits)

``forward_vit_packed`` composes them for one request, offline; the vision
engine schedules each segment over a ragged population. Every segment
optionally takes ``n_valid`` ([B] int32, real token count per row):
token-padded rows are masked out of attention and score exactly 0 in the
TDM, so batching never leaks padding into a request's logits.

Soft TDM, the fp16/int8 tiers and the STE training path are later slices
(ROADMAP queue A); asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import packing
from repro_torch.core import token_pruning as TP
from repro_torch.kernels.backend import host_to_device, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.sbmm import sbmm
from repro_torch.kernels.token_drop import token_drop
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG

SOFT_TODO = ("soft pruning (package-token TDM) is not ported yet: ROADMAP "
             "queue A, next slice (soft TDM + token_package kernel)")
PRECISION_TODO = ("only the fp32 tier is ported: fp16 and int8 are ROADMAP "
                  "queue A/B items (fp16 tier, int8 dequant SBMM)")


def _require_fp32(precision: str) -> None:
    if precision != "fp32":
        raise NotImplementedError(f"precision={precision!r}: "
                                  + PRECISION_TODO)


def pack_model(cfg: ModelConfig, params: Dict, scores: Dict,
               lanes: int = 8) -> Dict[str, packing.PackedWeight]:
    """Block-compress every masked attention weight. Returns
    {path: PackedWeight} on the params' device; paths match
    ``pruning_glue.hard_masks`` keys."""
    masks = PG.hard_masks(cfg, params, scores)
    out = {}
    for path, mask in masks.items():
        layer_idx = int(path.split("/")[1])
        leafname = path.split("/")[-1]
        w = params["layers"][layer_idx]["attn"][leafname]
        out[path] = packing.pack_weight(
            w.detach().float().cpu().numpy(), mask.cpu().numpy(),
            cfg.pruning.block_size, lanes, device=w.device)
    return out


# ===========================================================================
# Stage plan
# ===========================================================================
Segment = Tuple  # ("embed",) | ("layers", lo, hi) | ("tdm", i) | ("head",)


def vit_segments(cfg: ModelConfig,
                 use_tdm: Optional[bool] = None) -> Tuple[Segment, ...]:
    """Per-stage segmentation of the packed ViT forward: one segment per
    maximal run of constant token count, TDM layers as their own segments
    (prune boundaries ARE batching boundaries for the serving engine)."""
    p = cfg.pruning
    if use_tdm is None:
        use_tdm = p.token_pruning_enabled
    tdm_layers = sorted(p.tdm_layers) if use_tdm else []
    segs: List[Segment] = [("embed",)]
    prev = 0
    for t in tdm_layers:
        if not 0 <= t < cfg.num_layers:
            raise ValueError(f"tdm layer {t} outside [0, {cfg.num_layers})")
        if t > prev:
            segs.append(("layers", prev, t))
        segs.append(("tdm", t))
        prev = t + 1
    if prev < cfg.num_layers:
        segs.append(("layers", prev, cfg.num_layers))
    segs.append(("head",))
    return tuple(segs)


def tdm_keep_count(n_tokens: int, r_t: float) -> int:
    """Top-k count for a TDM applied at a *real* token count of
    ``n_tokens`` (CLS included); output count is ``1 + k + 1``."""
    return TP.num_kept_tokens(n_tokens, r_t, has_cls=True) - 2


def keep_schedule(cfg: ModelConfig, r_t: Optional[float] = None,
                  use_tdm: Optional[bool] = None) -> Tuple[float, ...]:
    """Uniform per-step keep schedule: ``r_t`` (default ``cfg.pruning.r_t``)
    broadcast over every TDM segment of ``vit_segments``."""
    if r_t is None:
        r_t = cfg.pruning.r_t
    n_tdm = sum(1 for seg in vit_segments(cfg, use_tdm) if seg[0] == "tdm")
    return (float(r_t),) * n_tdm


def token_trajectory(cfg: ModelConfig, n_patches: int,
                     r_t: Optional[float] = None,
                     use_tdm: Optional[bool] = None,
                     schedule: Optional[Sequence[float]] = None,
                     soft: bool = False) -> Tuple[int, ...]:
    """Real token count a single image carries *after* each segment of
    ``vit_segments`` (head repeats the final count). ``schedule`` gives
    the keep rate per TDM segment; ``None`` broadcasts ``r_t``."""
    if soft:
        raise NotImplementedError(SOFT_TODO)
    n = n_patches + 1  # + CLS
    counts = []
    ordinal = 0
    if schedule is None:
        schedule_t: Tuple[float, ...] = keep_schedule(cfg, r_t, use_tdm)
    else:
        schedule_t = tuple(float(r) for r in schedule)
    for seg in vit_segments(cfg, use_tdm):
        if seg[0] == "tdm":
            if ordinal >= len(schedule_t):
                raise ValueError(
                    f"keep schedule has {len(schedule_t)} entries but the "
                    f"segment plan reaches TDM ordinal {ordinal}")
            n = tdm_keep_count(n, schedule_t[ordinal]) + 2
            ordinal += 1
        counts.append(n)
    return tuple(counts)


# ===========================================================================
# Segment bodies (plain functions over tensors on one device)
# ===========================================================================
def _proj(params: Dict, packed: Dict, i: int, name: str,
          inp: torch.Tensor) -> torch.Tensor:
    key = f"layers/{i}/attn/{name}"
    if key in packed:
        return sbmm(inp, packed[key])
    return L.linear(inp, params["layers"][i]["attn"][name])


def _bias(ap: Dict, name: str):
    b = ap.get(name)
    return 0.0 if b is None else b


def _encoder_attn(cfg: ModelConfig, params: Dict, packed: Dict,
                  x: torch.Tensor, i: int, *, collect_scores: bool = False,
                  n_valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention sublayer + residual of encoder layer ``i``: projections
    through SBMM when packed, attention (and the TDM scores) through the
    flash-attention kernel. ``n_valid`` masks token padding; padded rows'
    scores are exactly 0."""
    H, Dh = cfg.num_heads, cfg.head_dim
    lp = params["layers"][i]
    ap = lp["attn"]
    h = L.layer_norm(x, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
    Bc, Nc, _ = h.shape
    q = (_proj(params, packed, i, "wq", h) + _bias(ap, "bq")).reshape(
        Bc, Nc, H, Dh)
    k = (_proj(params, packed, i, "wk", h) + _bias(ap, "bk")).reshape(
        Bc, Nc, H, Dh)
    v = (_proj(params, packed, i, "wv", h) + _bias(ap, "bv")).reshape(
        Bc, Nc, H, Dh)
    scores = None
    if collect_scores:
        o, scores = flash_attention(q, k, v, kv_len=n_valid,
                                    collect_scores=True)
    else:
        o = flash_attention(q, k, v, kv_len=n_valid)
    o = o.reshape(Bc, Nc, H * Dh)
    attn_out = _proj(params, packed, i, "wo", o) + _bias(ap, "bo")
    return x + attn_out, scores


def _encoder_mlp(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                 i: int) -> torch.Tensor:
    lp = params["layers"][i]
    h = L.layer_norm(x, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps)
    return x + L.gelu_mlp(h, lp["mlp"])


def vit_embed(cfg: ModelConfig, params: Dict,
              patches: torch.Tensor) -> torch.Tensor:
    """patches [B, N, P²·3] -> tokens [B, N+1, D] (fp32, CLS prepended).
    Token-padded patch rows embed to don't-care rows; downstream segments
    mask them via ``n_valid``."""
    x = L.linear(patches.float(), params["patch_embed"], params["patch_bias"])
    B, N, D = x.shape
    cls = params["cls"].float().expand(B, 1, D)
    return torch.cat([cls, x], dim=1) + params["pos"][None, : N + 1]


def vit_layers(cfg: ModelConfig, params: Dict, packed: Dict,
               x: torch.Tensor, lo: int, hi: int,
               n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder layers [lo, hi) at constant token count."""
    for i in range(lo, hi):
        x, _ = _encoder_attn(cfg, params, packed, x, i, n_valid=n_valid)
        x = _encoder_mlp(cfg, params, x, i)
    return x


def vit_tdm_layer(cfg: ModelConfig, params: Dict, packed: Dict,
                  x: torch.Tensor, layer: int, r_t: Optional[float] = None,
                  k: Optional[int] = None,
                  n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder layer ``layer`` with the TDM between its attention and MLP
    sublayers: [B, N, D] -> [B, k + 2, D]. ``k`` must be passed when rows
    are token-padded; otherwise it derives from N and ``r_t``."""
    if k is None:
        if n_valid is not None:
            raise ValueError("token-padded TDM tiles need an explicit k")
        k = tdm_keep_count(x.shape[1], cfg.pruning.r_t if r_t is None
                           else r_t)
    x, scores = _encoder_attn(cfg, params, packed, x, layer,
                              collect_scores=True, n_valid=n_valid)
    x = token_drop(x, scores, k)
    return _encoder_mlp(cfg, params, x, layer)


def vit_head(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + CLS readout -> logits [B, num_classes] (fp32)."""
    x = L.layer_norm(x, params["ln_f_s"], params["ln_f_b"], cfg.norm_eps)
    return L.linear(x[:, 0], params["head"]).float()


def run_fused_steps(cfg: ModelConfig, params: Dict, packed: Dict,
                    x: torch.Tensor, steps: Tuple[Tuple, ...]) -> torch.Tensor:
    """Compose consecutive segments into one call: ``steps`` is a tuple of
    ``(segment, k)`` pairs (``k`` only for TDM segments). The express-lane
    body for requests that are singletons in every bucket — unbatched and
    unpadded, so no ``n_valid`` is needed."""
    for step in steps:
        seg, k = step
        kind = seg[0]
        if kind == "embed":
            x = vit_embed(cfg, params, x)
        elif kind == "layers":
            x = vit_layers(cfg, params, packed, x, seg[1], seg[2])
        elif kind == "tdm":
            if k is None:
                raise ValueError("fused tdm steps need an explicit k")
            x = vit_tdm_layer(cfg, params, packed, x, seg[1], k=k)
        elif kind == "head":
            x = vit_head(cfg, params, x)
        else:
            raise ValueError(f"unknown segment {seg!r} in fused steps")
    return x


# ===========================================================================
# Offline single-request forward — the segments composed sequentially
# ===========================================================================
def forward_vit_packed(cfg: ModelConfig, params: Dict,
                       packed: Dict[str, packing.PackedWeight],
                       patches: torch.Tensor,
                       use_tdm: bool | None = None,
                       segments: "Optional[PackedVitSegments]" = None,
                       schedule: Optional[Sequence[float]] = None,
                       soft: bool = False,
                       precision: str = "fp32",
                       device: "str | torch.device" = "cuda") -> M.Output:
    """ViT forward with the attention projections through the SBMM kernel
    and attention / TDM through their kernels (plain versions for CPU
    tensors).

    ``params`` should be the MASKED tree (``PG.apply_pruning``) so the
    MLPs run masked-dense (the paper's DBMM path). This is the
    single-request oracle the vision serving engine is held against: it
    walks the same ``vit_segments`` plan through the same segment bodies,
    unbatched and unpadded. ``schedule`` is a per-TDM-segment keep
    schedule (``None`` broadcasts ``cfg.pruning.r_t``). ``segments``
    reuses an executor (e.g. an engine's), whose device then wins."""
    if soft:
        raise NotImplementedError(SOFT_TODO)
    _require_fp32(precision)
    runner = segments if segments is not None else PackedVitSegments(
        cfg, params, packed, use_tdm=use_tdm, device=device)
    if schedule is None:
        schedule = keep_schedule(cfg, use_tdm=use_tdm)
    x = torch.as_tensor(patches, dtype=torch.float32).to(runner.device)
    n = patches.shape[1] + 1  # + CLS after embed
    ordinal = 0
    for seg in runner.plan:
        if seg[0] == "tdm":
            k = tdm_keep_count(n, schedule[ordinal])
            x = runner.run(seg, x, k=k)
            n = k + 2
            ordinal += 1
        elif seg[0] == "head":
            return M.Output(runner.run(seg, x))
        else:
            x = runner.run(seg, x)
    raise AssertionError("vit_segments plan must end with ('head',)")


def masked_dense_reference(cfg: ModelConfig, params: Dict, scores: Dict,
                           patches: torch.Tensor,
                           use_tdm: bool | None = None) -> M.Output:
    """Oracle: same model with masked-dense weights, plain PyTorch only
    (no kernel), fp32 activations."""
    masked = PG.apply_pruning(cfg, params, scores)
    return M.forward_vit(cfg, masked, patches, use_tdm=use_tdm)


# ===========================================================================
# Segment executor (the vision serving engine's runner)
# ===========================================================================
class PackedVitSegments:
    """Runs the per-segment step functions for one (cfg, params, packed)
    triple, behind a ledger of dispatched tile shapes.

    The ledger keys are the reference's compile-ledger keys: each distinct
    (segment, tile shape, masked?, k) combination is recorded once.
    PyTorch runs eagerly, so nothing compiles per shape; the ledger still
    bounds what the batcher lets through (its bucket set)."""

    def __init__(self, cfg: ModelConfig, params: Dict,
                 packed: Dict[str, packing.PackedWeight],
                 use_tdm: Optional[bool] = None,
                 device: "str | torch.device" = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = M.to_device(params, self.device)
        self.packed = {path: pw.to(self.device) for path, pw in packed.items()}
        self.plan = vit_segments(cfg, use_tdm)
        self._compiled: set = set()
        self._fused_trajectories: set = set()

    def _valid_rows(self, n_valid, x: torch.Tensor
                    ) -> Optional[torch.Tensor]:
        """``n_valid`` checked on the host (every row holds 1..N real
        tokens) and copied to the device without a stream sync."""
        if n_valid is None:
            return None
        nv = np.asarray(n_valid, np.int32)
        if nv.shape != (x.shape[0],) or nv.min() < 1 or \
                nv.max() > x.shape[1]:
            raise ValueError(f"n_valid {nv.tolist()} does not fit a tile of "
                             f"{x.shape[0]} rows x {x.shape[1]} tokens")
        return host_to_device(nv, self.device, np.int32)

    def run(self, seg: Segment, x: torch.Tensor,
            n_valid: Optional[np.ndarray] = None,
            k: Optional[int] = None, soft: bool = False,
            precision: str = "fp32") -> torch.Tensor:
        """Execute one segment on a dense tile ``x``. ``n_valid`` ([B]) is
        required whenever rows are token-padded; ``k`` is required for
        ``tdm`` segments (uniform across the tile by batcher
        construction)."""
        if soft:
            raise NotImplementedError(SOFT_TODO)
        _require_fp32(precision)
        kind = seg[0]
        nv = self._valid_rows(n_valid, x)
        self._compiled.add((seg, tuple(x.shape), nv is not None, k))
        if kind == "embed":
            return vit_embed(self.cfg, self.params, x)
        if kind == "layers":
            return vit_layers(self.cfg, self.params, self.packed, x,
                              seg[1], seg[2], n_valid=nv)
        if kind == "tdm":
            if k is None:
                raise ValueError("tdm segments need an explicit k "
                                 "(per-request keep count)")
            return vit_tdm_layer(self.cfg, self.params, self.packed, x,
                                 seg[1], k=k, n_valid=nv)
        if kind == "head":
            return vit_head(self.cfg, self.params, x)
        raise ValueError(f"unknown segment {seg!r}")

    def run_fused(self, steps: Tuple[Tuple, ...], x: torch.Tensor,
                  precision: str = "fp32") -> torch.Tensor:
        """Express lane: execute ``steps`` — consecutive ``(segment, k)``
        pairs — as one call for a bucket-singleton request. Recorded once
        per distinct (steps, entry shape) in ``fused_trajectory_count``."""
        _require_fp32(precision)
        if any(len(s) > 2 and s[2] for s in steps):
            raise NotImplementedError(SOFT_TODO)
        steps = tuple((tuple(s[0]), None if s[1] is None else int(s[1]))
                      for s in steps)
        if not steps:
            raise ValueError("fused run needs at least one step")
        self._fused_trajectories.add((steps, tuple(x.shape)))
        self._compiled.add((("fused",) + steps, tuple(x.shape), False, None))
        return run_fused_steps(self.cfg, self.params, self.packed, x, steps)

    # -- shape ledger --------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Distinct segment tiles dispatched so far (the ledger)."""
        return len(self._compiled)

    def compiled_tiles(self) -> List[Tuple]:
        return sorted(self._compiled, key=repr)

    @property
    def fused_trajectory_count(self) -> int:
        """Distinct fused trajectories dispatched."""
        return len(self._fused_trajectories)

    def jit_compile_count(self) -> int:
        """Nothing is compiled per shape in eager PyTorch: the ledger
        count stands in (the reference asks its jit caches)."""
        return self.compile_count
