from repro_torch.kernels.sbmm.ops import (pad_input, sbmm, sbmm_plain,
                                         sbmm_raw, unpermute)

__all__ = ["sbmm", "sbmm_raw", "sbmm_plain", "pad_input", "unpermute"]
