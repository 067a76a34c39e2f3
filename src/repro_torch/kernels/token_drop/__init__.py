from repro_torch.kernels.token_drop.ops import token_drop, token_drop_plain

__all__ = ["token_drop", "token_drop_plain"]
