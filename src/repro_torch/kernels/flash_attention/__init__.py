from repro_torch.kernels.flash_attention.ops import (attention_plain,
                                                     flash_attention)

__all__ = ["flash_attention", "attention_plain"]
