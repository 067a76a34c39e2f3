from repro_torch.kernels.sbmm.ops import (pad_input, sbmm, sbmm_plain,
                                         sbmm_raw)
from repro_torch.kernels.sbmm.quant import sbmm_quant_plain, sbmm_quant_raw

__all__ = ["sbmm", "sbmm_raw", "sbmm_plain", "sbmm_quant_raw",
           "sbmm_quant_plain", "pad_input"]
