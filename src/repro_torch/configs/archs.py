"""The paper's own model, DeiT-Small — the one architecture this package
serves. The configuration is identical to the reference package's."""
from __future__ import annotations

from .base import ModelConfig, PruningConfig

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
