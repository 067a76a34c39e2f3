"""The architectures this package serves: the paper's own DeiT-Small,
the four dense LMs, the two MoE LMs, the VLM Llama-3.2-Vision-90B, the
audio encoder-decoder Whisper-base, the hybrid Zamba2-1.2B and the
attention-free RWKV6-1.6B (public-literature configs, sources inline). Each
configuration is identical to the reference package's."""
from __future__ import annotations

from .base import ModelConfig, PruningConfig

# Default pruning posture for LM archs: the paper's technique is available as
# a first-class switch; configs ship with it OFF (r_b=r_t=1.0) so the faithful
# dense baseline is the default, and benchmarks/examples flip it on.
_NO_PRUNE = PruningConfig()

# --------------------------------------------------------------------------
# The paper's own model: DeiT-Small (12L, D=384, 6 heads, ImageNet-1k).
# TDM at encoders {3,7,10} (1-indexed in the paper) -> 0-indexed {2,6,9}.
# --------------------------------------------------------------------------
DEIT_SMALL = ModelConfig(
    name="deit-small",
    family="vit",
    num_layers=12,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=0,
    use_bias=True,
    image_size=224,
    patch_size=16,
    num_classes=1000,
    pruning=PruningConfig(
        block_size=16, r_b=0.5, r_t=0.7, tdm_layers=(2, 6, 9),
        lambda_reg=1e-4, distill_temperature=4.0,
    ),
    skip_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

# --------------------------------------------------------------------------
# Dense LM family
# --------------------------------------------------------------------------
# [hf:CohereForAI/c4ai-command-r-v01; unverified]
COMMAND_R_PLUS_104B = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    use_bias=False,
    pruning=_NO_PRUNE,
    skip_shapes=("long_500k",),  # full attention: O(N^2) at 524k — skipped
)

# [hf:Qwen/Qwen3-8B; hf] — qk_norm, GQA
QWEN3_14B = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    use_bias=False,
    pruning=_NO_PRUNE,
    skip_shapes=("long_500k",),
)

# [arXiv:2407.14679; hf] — pruned nemotron
MINITRON_4B = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    use_bias=False,
    pruning=_NO_PRUNE,
    skip_shapes=("long_500k",),
)

# [hf:stabilityai/stablelm-2-1_6b; unverified] — MHA (kv=32)
STABLELM_1_6B = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    use_bias=False,
    pruning=_NO_PRUNE,
    skip_shapes=("long_500k",),
)

# --------------------------------------------------------------------------
# MoE family
# --------------------------------------------------------------------------
# [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 4 shared + 60 routed top-4, d_ff per expert
QWEN2_MOE_A2_7B = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    moe_num_experts=60,
    moe_top_k=4,
    moe_num_shared=4,
    use_bias=False,
    pruning=_NO_PRUNE,
    skip_shapes=("long_500k",),
)

# [hf:ibm-granite/granite-3.0-3b-a800m-base; hf] — 40 experts top-8
GRANITE_MOE_3B_A800M = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe_num_experts=40,
    moe_top_k=8,
    moe_num_shared=0,
    use_bias=False,
    pruning=_NO_PRUNE,
    skip_shapes=("long_500k",),
)

# --------------------------------------------------------------------------
# VLM — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
# --------------------------------------------------------------------------
LLAMA_3_2_VISION_90B = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_period=5,  # a cross-attention layer every 5 decoder layers
    num_vision_tokens=1601,  # stub frontend: precomputed patch embeddings
    use_bias=False,
    pruning=_NO_PRUNE,
    skip_shapes=("long_500k",),
)

# --------------------------------------------------------------------------
# Audio enc-dec — backbone only; conv frontend is a STUB (precomputed frames).
# [arXiv:2212.04356; unverified]
# --------------------------------------------------------------------------
WHISPER_BASE = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,  # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    use_bias=True,
    num_audio_frames=1500,
    pruning=_NO_PRUNE,
    skip_shapes=("long_500k",),
)

# --------------------------------------------------------------------------
# Hybrid — Mamba2 + shared attention blocks [arXiv:2411.15242; hf]
# --------------------------------------------------------------------------
ZAMBA2_1_2B = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    attn_layer_period=6,  # shared attention block applied every 6 mamba layers
    use_bias=False,
    pruning=_NO_PRUNE,
    skip_shapes=(),  # sub-quadratic: long_500k runs
)

# --------------------------------------------------------------------------
# SSM (attention-free) — RWKV6 "Finch" [arXiv:2404.05892; unverified]
# --------------------------------------------------------------------------
RWKV6_1_6B = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # rwkv6 heads for the wkv state (head_dim=64)
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    use_bias=False,
    pruning=_NO_PRUNE,
    skip_shapes=(),  # attention-free: long_500k runs
)
