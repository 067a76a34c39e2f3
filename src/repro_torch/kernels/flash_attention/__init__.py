from repro_torch.kernels.flash_attention.ops import (
    CausalAttention, NonCausalAttention, NonCausalGQAAttention,
    attention_bwd_plain, attention_causal_bwd_plain,
    attention_causal_lse_plain, attention_causal_plain, attention_lse_plain,
    attention_noncausal_bwd_plain, attention_noncausal_lse_plain,
    attention_noncausal_plain, attention_plain, flash_attention)

__all__ = ["flash_attention", "attention_plain", "attention_lse_plain",
           "attention_bwd_plain", "attention_causal_plain",
           "attention_causal_lse_plain", "attention_causal_bwd_plain",
           "attention_noncausal_plain", "attention_noncausal_lse_plain",
           "attention_noncausal_bwd_plain", "CausalAttention",
           "NonCausalAttention", "NonCausalGQAAttention"]
