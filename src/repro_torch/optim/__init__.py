from repro_torch.optim.adamw import AdamW, AdamWState, global_norm

__all__ = ["AdamW", "AdamWState", "global_norm"]
