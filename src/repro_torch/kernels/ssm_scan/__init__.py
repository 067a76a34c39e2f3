from repro_torch.kernels.ssm_scan.ops import (MambaScan, WKV6, mamba_scan,
                                              mamba_scan_bwd_plain,
                                              mamba_scan_plain, wkv6,
                                              wkv6_bwd_plain, wkv6_plain)

__all__ = ["MambaScan", "WKV6", "mamba_scan", "mamba_scan_bwd_plain",
           "mamba_scan_plain", "wkv6", "wkv6_bwd_plain", "wkv6_plain"]
