"""Config dataclasses for the repro framework.

A single ``ModelConfig`` covers every assigned architecture family:
dense GQA LMs, MoE LMs, cross-attention VLMs, encoder-decoder audio
models, Mamba2 hybrids, RWKV6, and the paper's own ViT/DeiT family.

``PruningConfig`` carries the paper's two pruning knobs:
  * static block weight pruning  (block size ``b``, top-k keep rate ``r_b``)
  * dynamic token pruning        (keep rate ``r_t``, TDM layer indices)

``ShapeConfig`` is one cell of the assigned (arch x shape) grid.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class PruningConfig:
    """Hyper-parameters of the paper's simultaneous pruning.

    ``block_size`` is the logical score-block granularity (paper: 16/32).
    ``r_b`` is the weight-block top-k keep rate (paper: 0.5/0.7; 1.0 = dense).
    ``r_t`` is the token keep rate at each TDM layer (paper: 0.5/0.7/0.9).
    ``tdm_layers`` are encoder indices where the TDM is inserted (paper: 3,7,10;
    1-indexed in the paper, we store 0-indexed).
    ``prune_msa`` / ``prune_mlp`` select which weight groups are block-pruned.
    ``kv_prune_keep`` (beyond-paper) enables dynamic KV-cache pruning in decode:
    keep rate of cached tokens ranked by aggregated attention mass.
    """

    block_size: int = 16
    r_b: float = 1.0
    r_t: float = 1.0
    tdm_layers: Tuple[int, ...] = ()
    prune_msa: bool = True
    prune_mlp: bool = True
    lambda_reg: float = 1e-4
    distill_temperature: float = 4.0
    lambda_distill: float = 0.5
    lambda_task: float = 0.5
    kv_prune_keep: float = 1.0

    @property
    def weight_pruning_enabled(self) -> bool:
        return self.r_b < 1.0

    @property
    def token_pruning_enabled(self) -> bool:
        return self.r_t < 1.0 and len(self.tdm_layers) > 0

    @property
    def kv_pruning_enabled(self) -> bool:
        return self.kv_prune_keep < 1.0


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the assigned grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shapes. ``decode_*``/``long_*`` lower ``serve_step``
# (one new token against a KV cache of ``seq_len``), not ``train_step``.
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description.

    Only the fields relevant to ``family`` are consulted by the model
    code; the rest keep their defaults.
    """

    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm | vit
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_shared_d_ff: int = 0  # 0 -> d_ff * moe_num_shared
    moe_capacity_factor: float = 1.25
    # pad the routed-expert bank so it divides the TP axis (EP sharding);
    # padded experts receive no tokens (router logits stay at E real experts)
    moe_expert_pad_to: int = 1

    # --- VLM (cross-attention image layers) ---
    cross_attn_period: int = 0  # insert a cross-attn layer every N layers
    num_vision_tokens: int = 0
    vision_d_model: int = 0  # frontend stub output dim (0 -> d_model)

    # --- audio enc-dec ---
    encoder_layers: int = 0  # for family=="audio"; num_layers = decoder layers
    num_audio_frames: int = 1500  # stub frontend output length for train kind

    # --- hybrid / ssm ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    attn_layer_period: int = 0  # zamba2: shared attn block every N ssm layers

    # --- ViT (the paper's own family) ---
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    pool_type: str = "cls"

    # --- pruning (the paper's technique, first-class) ---
    pruning: PruningConfig = field(default_factory=PruningConfig)

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # --- perf levers (§Perf hillclimbs; defaults = paper-faithful baseline) ---
    remat_policy: str = "full"      # full | dots | none
    fuse_qkv: bool = False          # single QKV matmul + split
    loss_chunk: int = 1024          # chunked-CE sequence chunk
    serve_param_dtype: str = "float32"  # bf16 halves decode weight reads
    microbatches: int = 1           # gradient-accumulation splits
    shard_rwkv_kv: bool = False     # TP-shard rwkv time-mix wk/wv (§Perf)
    rwkv_chunk: int = 0             # flash-linear-attention WKV chunking

    # shapes this arch should skip, with reasons (recorded in DESIGN.md)
    skip_shapes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            f"{self.name}: num_heads={self.num_heads} must be divisible by "
            f"num_kv_heads={self.num_kv_heads}"
        )

    @property
    def moe_num_experts_padded(self) -> int:
        pad = max(self.moe_expert_pad_to, 1)
        return -(-self.moe_num_experts // pad) * pad

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter counting (used by benchmarks + roofline MODEL_FLOPS).
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; ``active_only`` counts only routed
        experts actually used per token (for MoE 6*N_active*D rooflines)."""
        d, h, kv, hd, ff, v = (
            self.d_model,
            self.num_heads,
            self.num_kv_heads,
            self.head_dim,
            self.d_ff,
            self.vocab_size,
        )
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d  # q,k,v,o
        if self.family == "ssm":  # rwkv6-style: r,k,v,g,o + channel mix
            inner = d
            per_layer = 5 * d * inner + 2 * d * ff + ff * d  # time-mix + channel-mix
            emb = v * d
            return self.num_layers * per_layer + emb + (0 if self.tie_embeddings else v * d)
        if self.family == "hybrid":
            inner = self.ssm_expand * d
            mamba = d * 2 * inner + inner * d + inner * (2 * self.ssm_state)
            n_attn = (
                self.num_layers // self.attn_layer_period if self.attn_layer_period else 0
            )
            shared_attn = attn + 2 * d * ff + ff * d  # one shared block
            return (
                self.num_layers * mamba
                + shared_attn
                + v * d
                + (0 if self.tie_embeddings else v * d)
            )
        if self.family == "moe":
            n_e = self.moe_num_experts if not active_only else self.moe_top_k
            shared_ff = self.moe_shared_d_ff or (self.d_ff * max(self.moe_num_shared, 0))
            ffn = n_e * 3 * d * ff + (3 * d * shared_ff if shared_ff else 0)
            per_layer = attn + ffn
        else:
            glu = self.family in ("dense", "moe")
            ffn = (3 if glu else 2) * d * ff
            per_layer = attn + ffn
        layers = self.num_layers + self.encoder_layers
        if self.cross_attn_period:
            n_cross = self.num_layers // self.cross_attn_period
            layers_extra = n_cross * (attn + 3 * d * ff)
        else:
            layers_extra = 0
        emb = v * d + (0 if self.tie_embeddings else v * d)
        if self.family == "vit":
            emb = (self.patch_size**2 * 3) * d + self.num_classes * d
        return layers * per_layer + layers_extra + emb

    # ------------------------------------------------------------------
    # Reduced config for CPU smoke tests.
    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config: few layers, narrow width, small vocab."""
        heads = min(self.num_heads, 4)
        q_per_kv = max(1, self.num_heads // self.num_kv_heads)
        kv = max(1, heads // min(q_per_kv, heads))
        kw = dict(
            num_layers=min(self.num_layers, 3),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.family == "moe":
            # capacity high enough that reduced smoke tests never drop
            # tokens (capacity overflow makes prefill+decode diverge from
            # the full forward — real GShard semantics, noisy for tests)
            kw.update(moe_num_experts=4, moe_top_k=2,
                      moe_num_shared=min(self.moe_num_shared, 1),
                      moe_shared_d_ff=128, moe_capacity_factor=8.0)
        if self.family == "audio":
            kw.update(encoder_layers=2, num_audio_frames=32)
        if self.family == "vlm":
            kw.update(cross_attn_period=2, num_vision_tokens=8, vision_d_model=0)
        if self.family == "hybrid":
            kw.update(ssm_state=8, attn_layer_period=2, num_layers=4)
        if self.family == "vit":
            kw.update(image_size=32, patch_size=8, num_classes=10)
            # TDM layers must precede the final encoder to be observable
            # through the CLS readout (reduced depth = 3)
            if self.pruning.token_pruning_enabled:
                kw.setdefault("pruning", dataclasses.replace(
                    self.pruning, block_size=16, tdm_layers=(1,)))
        # keep the paper's pruning knobs but shrink the block size so tiny
        # matrices still have multiple blocks
        if self.pruning.block_size > 16:
            kw["pruning"] = dataclasses.replace(self.pruning, block_size=16)
        return self.replace(**kw)
