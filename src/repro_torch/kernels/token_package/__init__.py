from repro_torch.kernels.token_package.ops import (token_package,
                                                   token_package_plain)

__all__ = ["token_package", "token_package_plain"]
