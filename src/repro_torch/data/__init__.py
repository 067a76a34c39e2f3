from repro_torch.data.pipeline import (DataConfig, batches,
                                       synthetic_lm_batch,
                                       synthetic_vit_batch)

__all__ = ["DataConfig", "synthetic_lm_batch", "synthetic_vit_batch",
           "batches"]
