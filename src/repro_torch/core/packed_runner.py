"""Packed-model execution — the deployment path of the paper's accelerator,
on the card; the port of the reference package's ``core/packed_runner.py``.

After simultaneous pruning, ``pack_model`` hardens the masks and converts
every block-pruned attention weight into the block-compressed SBMM format.
The forward then runs the ViT with those weights through the hand-written
kernels:

* q/k/v/o projections — ``kernels.sbmm`` (K1: fp32 or fp16 blocks; int8
  blocks with scales through its dequant-in-kernel variant);
* attention with per-row ``n_valid`` and, at TDM layers, the CLS-row
  scores — ``kernels.flash_attention`` (K2: fp32, or fp16 operands);
* the hard TDM's stable top-k, drop weights, gather and fuse —
  ``kernels.token_drop`` (K3), one launch;
* the soft TDM's stable top-k, raw weights, gather and package update —
  ``kernels.token_package`` (K4), one launch.

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

Precision tiers (``core.quant``): the weight precision rides in the
packed dict (``PackedVitSegments.packed_for``); ``"fp16"`` also casts q, k
and v to fp16 before the attention, whose fp16 output is cast back to
fp32 before the ``wo`` projection. Embed and head run fp32 at every tier.

Soft pruning (``soft=True``): each TDM folds its dropped tokens into a
package token that carries their score mass (``token_pruning.tdm_soft``);
the mass threads from one soft TDM to the next.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import packing
from repro_torch.core import quant as Q
from repro_torch.core import token_pruning as TP
from repro_torch.kernels.backend import host_to_device, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.sbmm import sbmm
from repro_torch.kernels.token_drop import token_drop
from repro_torch.kernels.token_package import token_package
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG

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


def tdm_soft_keep_count(n_tokens: int, r_t: float, has_pkg: bool) -> int:
    """Top-k count for a SOFT TDM at ``n_tokens`` real tokens: as
    :func:`tdm_keep_count`, except that once a package row exists
    (``has_pkg``: every soft TDM after the first) it is pinned, so ``k``
    clamps at the ``n_tokens - 2`` real body rows."""
    k = tdm_keep_count(n_tokens, r_t)
    return min(k, n_tokens - 2) if has_pkg else k


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
    the keep rate per TDM segment; ``None`` broadcasts ``r_t``. ``soft``
    prices the soft TDM (``tdm_soft_keep_count``'s package-row clamp)."""
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
            r = schedule_t[ordinal]
            k = (tdm_soft_keep_count(n, r, has_pkg=ordinal > 0) if soft
                 else tdm_keep_count(n, r))
            n = k + 2
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
                  n_valid: Optional[torch.Tensor] = None,
                  precision: str = "fp32"
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention sublayer + residual of encoder layer ``i``: projections
    through SBMM when packed (at the packed dict's precision), attention
    (and the TDM scores) through the flash-attention kernel. ``n_valid``
    masks token padding; padded rows' scores are exactly 0. ``"fp16"``
    casts q, k and v to fp16; the attention output comes back in fp16 and
    is cast to fp32 before ``wo``, and the scores stay fp32."""
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
    if precision == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    scores = None
    if collect_scores:
        o, scores = flash_attention(q, k, v, kv_len=n_valid,
                                    collect_scores=True)
    else:
        o = flash_attention(q, k, v, kv_len=n_valid)
    o = o.to(x.dtype).reshape(Bc, Nc, H * Dh)
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
               n_valid: Optional[torch.Tensor] = None,
               precision: str = "fp32") -> torch.Tensor:
    """Encoder layers [lo, hi) at constant token count."""
    for i in range(lo, hi):
        x, _ = _encoder_attn(cfg, params, packed, x, i, n_valid=n_valid,
                             precision=precision)
        x = _encoder_mlp(cfg, params, x, i)
    return x


def vit_tdm_layer(cfg: ModelConfig, params: Dict, packed: Dict,
                  x: torch.Tensor, layer: int, r_t: Optional[float] = None,
                  k: Optional[int] = None,
                  n_valid: Optional[torch.Tensor] = None,
                  precision: str = "fp32") -> torch.Tensor:
    """Encoder layer ``layer`` with the TDM between its attention and MLP
    sublayers: [B, N, D] -> [B, k + 2, D]. ``k`` must be passed when rows
    are token-padded; otherwise it derives from N and ``r_t``."""
    if k is None:
        if n_valid is not None:
            raise ValueError("token-padded TDM tiles need an explicit k")
        k = tdm_keep_count(x.shape[1], cfg.pruning.r_t if r_t is None
                           else r_t)
    x, scores = _encoder_attn(cfg, params, packed, x, layer,
                              collect_scores=True, n_valid=n_valid,
                              precision=precision)
    x = token_drop(x, scores, k)
    return _encoder_mlp(cfg, params, x, layer)


def vit_tdm_soft_layer(cfg: ModelConfig, params: Dict, packed: Dict,
                       x: torch.Tensor, layer: int, k: int,
                       pkg_mass: Optional[torch.Tensor] = None,
                       n_valid: Optional[torch.Tensor] = None,
                       precision: str = "fp32"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-pruning variant of :func:`vit_tdm_layer`: the dropped tokens
    fold into a persistent package token (``kernels.token_package``). Same
    output token count as the hard TDM, plus the package mass ([B]) the
    next soft TDM needs (``pkg_mass=None`` marks the first TDM, where no
    package row exists yet). With ``pkg_mass`` and ``n_valid``, each row's
    package sits at its own valid-token boundary (body index
    ``n_valid - 2``), so token-padded tiles pin the right row."""
    x, scores = _encoder_attn(cfg, params, packed, x, layer,
                              collect_scores=True, n_valid=n_valid,
                              precision=precision)
    pkg_pos = None
    if pkg_mass is not None and n_valid is not None:
        pkg_pos = n_valid - 2
    x, mass = token_package(x, scores, k, pkg_mass=pkg_mass, pkg_pos=pkg_pos)
    return _encoder_mlp(cfg, params, x, layer), mass


def vit_head(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + CLS readout -> logits [B, num_classes] (fp32)."""
    x = L.layer_norm(x, params["ln_f_s"], params["ln_f_b"], cfg.norm_eps)
    return L.linear(x[:, 0], params["head"]).float()


def run_fused_steps(cfg: ModelConfig, params: Dict, packed: Dict,
                    x: torch.Tensor, steps: Tuple[Tuple, ...],
                    pkg_mass: Optional[torch.Tensor] = None,
                    precision: str = "fp32") -> torch.Tensor:
    """Compose consecutive segments into one call: ``steps`` is a tuple of
    ``(segment, k)`` pairs, or ``(segment, k, soft)`` triples for soft TDM
    steps (``k`` only for TDM segments). The express-lane body for
    requests that are singletons in every bucket — unbatched and unpadded,
    so no ``n_valid`` is needed. ``pkg_mass`` seeds the package mass for a
    lane entered after a soft request's first TDM ran tiled; the mass
    threads through the soft steps. ``precision`` applies to the encoder
    steps only: embed and head run fp32."""
    for step in steps:
        seg, k = step[0], step[1]
        soft = bool(step[2]) if len(step) > 2 else False
        kind = seg[0]
        if kind == "embed":
            x = vit_embed(cfg, params, x)
        elif kind == "layers":
            x = vit_layers(cfg, params, packed, x, seg[1], seg[2],
                           precision=precision)
        elif kind == "tdm":
            if k is None:
                raise ValueError("fused tdm steps need an explicit k")
            if soft:
                x, pkg_mass = vit_tdm_soft_layer(
                    cfg, params, packed, x, seg[1], k=k, pkg_mass=pkg_mass,
                    precision=precision)
            else:
                x = vit_tdm_layer(cfg, params, packed, x, seg[1], k=k,
                                  precision=precision)
                pkg_mass = None  # a hard TDM treats the package as a token
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
    reuses an executor (e.g. an engine's), whose device then wins.
    ``soft`` selects the package-token soft TDM; ``precision`` runs the
    encoder segments at that tier's weights and kernels."""
    runner = segments if segments is not None else PackedVitSegments(
        cfg, params, packed, use_tdm=use_tdm, device=device)
    if schedule is None:
        schedule = keep_schedule(cfg, use_tdm=use_tdm)
    x = torch.as_tensor(patches, dtype=torch.float32).to(runner.device)
    n = patches.shape[1] + 1  # + CLS after embed
    pkg_mass = None
    ordinal = 0
    for seg in runner.plan:
        if seg[0] == "tdm":
            r = schedule[ordinal]
            if soft:
                k = tdm_soft_keep_count(n, r, has_pkg=ordinal > 0)
                x, pkg_mass = runner.run(seg, x, k=k, soft=True,
                                         pkg_mass=pkg_mass,
                                         precision=precision)
            else:
                k = tdm_keep_count(n, r)
                x = runner.run(seg, x, k=k, precision=precision)
            n = k + 2
            ordinal += 1
        elif seg[0] == "head":
            return M.Output(runner.run(seg, x))
        else:
            x = runner.run(seg, x, precision=precision)
    raise AssertionError("vit_segments plan must end with ('head',)")


def masked_dense_reference(cfg: ModelConfig, params: Dict, scores: Dict,
                           patches: torch.Tensor,
                           use_tdm: bool | None = None) -> M.Output:
    """Oracle: same model with masked-dense weights, fp32 activations.
    ``forward_vit`` runs the plain versions of the kernels on CPU tensors
    and the kernels on CUDA tensors, so the oracle is kernel-free on the
    CPU: a caller holding the card's kernels against it passes CPU
    copies."""
    masked = PG.apply_pruning(cfg, params, scores)
    return M.forward_vit(cfg, masked, patches, use_tdm=use_tdm)


# ===========================================================================
# Segment executor (the vision serving engine's runner)
# ===========================================================================
class PackedVitSegments:
    """Runs the per-segment step functions for one (cfg, params, packed)
    triple, behind a ledger of dispatched tile shapes.

    The ledger keys are the reference's compile-ledger keys: each distinct
    (segment, tile shape, masked?, k[, "soft"][, precision]) combination is
    recorded once. PyTorch runs eagerly, so nothing compiles per shape;
    the ledger still bounds what the batcher lets through (its bucket
    set)."""

    def __init__(self, cfg: ModelConfig, params: Dict,
                 packed: Dict[str, packing.PackedWeight],
                 use_tdm: Optional[bool] = None,
                 device: "str | torch.device" = "cuda",
                 quant_granularity: str = "channel"):
        if quant_granularity not in Q.GRANULARITIES:
            raise ValueError(
                f"quant_granularity must be one of {Q.GRANULARITIES}, "
                f"got {quant_granularity!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = M.to_device(params, self.device)
        self.packed = {path: pw.to(self.device) for path, pw in packed.items()}
        self.plan = vit_segments(cfg, use_tdm)
        self.quant_granularity = quant_granularity
        # the packed dict per precision, derived from the fp32 one on
        # first use (embed/MLP/head weights are the same at every tier)
        self._packed_by: Dict[str, Dict] = {"fp32": self.packed}
        self._compiled: set = set()
        self._fused_trajectories: set = set()

    def packed_for(self, precision: str) -> Dict:
        """The packed dict at ``precision``: the fp32 dict itself, or its
        fp16/int8 form (``core.quant``, at this runner's
        ``quant_granularity``), quantized on first use and memoized. The
        int8 pass reads the fp32 blocks back to the host once."""
        if precision not in Q.PRECISIONS:
            raise ValueError(f"precision must be one of {Q.PRECISIONS}, "
                             f"got {precision!r}")
        pk = self._packed_by.get(precision)
        if pk is None:
            pk = Q.quantize_packed_dict(self.packed, precision,
                                        self.quant_granularity)
            self._packed_by[precision] = pk
        return pk

    @staticmethod
    def _ledger_key(base: Tuple, precision: str) -> Tuple:
        # fp32 keys are the plain ones; other tiers append their marker
        # (after the soft marker)
        return base if precision == "fp32" else base + (precision,)

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
            pkg_mass: Optional[torch.Tensor] = None,
            precision: str = "fp32"):
        """Execute one segment on a dense tile ``x``. ``n_valid`` ([B]) is
        required whenever rows are token-padded; ``k`` is required for
        ``tdm`` segments (uniform across the tile by batcher construction).
        ``soft`` selects the package-token TDM: the call takes the tile's
        package masses (``None`` before the first TDM) and returns
        ``(y, new_mass)`` instead of ``y``. ``precision`` selects the
        weights and kernels of the encoder segments; embed and head ignore
        it (always fp32)."""
        kind = seg[0]
        nv = self._valid_rows(n_valid, x)
        base = ((seg, tuple(x.shape), nv is not None, k, "soft") if soft
                else (seg, tuple(x.shape), nv is not None, k))
        if kind == "embed":
            self._compiled.add(base)
            return vit_embed(self.cfg, self.params, x)
        if kind == "layers":
            self._compiled.add(self._ledger_key(base, precision))
            return vit_layers(self.cfg, self.params,
                              self.packed_for(precision), x, seg[1], seg[2],
                              n_valid=nv, precision=precision)
        if kind == "tdm":
            if k is None:
                raise ValueError("tdm segments need an explicit k "
                                 "(per-request keep count)")
            self._compiled.add(self._ledger_key(base, precision))
            if soft:
                return vit_tdm_soft_layer(
                    self.cfg, self.params, self.packed_for(precision), x,
                    seg[1], k=k, pkg_mass=pkg_mass, n_valid=nv,
                    precision=precision)
            return vit_tdm_layer(self.cfg, self.params,
                                 self.packed_for(precision), x, seg[1], k=k,
                                 n_valid=nv, precision=precision)
        if kind == "head":
            self._compiled.add(base)
            return vit_head(self.cfg, self.params, x)
        raise ValueError(f"unknown segment {seg!r}")

    def run_fused(self, steps: Tuple[Tuple, ...], x: torch.Tensor,
                  pkg_mass: Optional[torch.Tensor] = None,
                  precision: str = "fp32") -> torch.Tensor:
        """Express lane: execute ``steps`` — consecutive ``(segment, k)``
        pairs, or ``(segment, k, soft)`` triples for soft TDM steps — as
        one call for a bucket-singleton request. ``pkg_mass`` ([1]) seeds
        the package mass when the lane starts after a soft request's first
        TDM. Recorded once per distinct (steps, entry shape, precision) in
        ``fused_trajectory_count``."""
        steps = tuple(
            (tuple(s[0]), None if s[1] is None else int(s[1]))
            + ((True,) if len(s) > 2 and s[2] else ())
            for s in steps)
        if not steps:
            raise ValueError("fused run needs at least one step")
        self._fused_trajectories.add(
            self._ledger_key((steps, tuple(x.shape)), precision))
        self._compiled.add(self._ledger_key(
            (("fused",) + steps, tuple(x.shape), False, None), precision))
        return run_fused_steps(self.cfg, self.params,
                               self.packed_for(precision), x, steps,
                               pkg_mass=pkg_mass, precision=precision)

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
