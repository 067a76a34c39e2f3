from repro_torch.kernels.ssm_scan.ops import (mamba_scan, mamba_scan_plain,
                                              wkv6, wkv6_plain)

__all__ = ["mamba_scan", "mamba_scan_plain", "wkv6", "wkv6_plain"]
