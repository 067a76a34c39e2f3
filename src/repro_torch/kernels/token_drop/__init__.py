from repro_torch.kernels.token_drop.ops import (TokenDrop, token_drop,
                                                token_drop_bwd_plain,
                                                token_drop_plain)

__all__ = ["token_drop", "token_drop_plain", "token_drop_bwd_plain",
           "TokenDrop"]
