#!/usr/bin/env python3
"""Two of ``chip_smoke.py``'s phases alone on the card: the prefill TDM on
full-width Minitron-4B (``prefill_tdm_path``, weights from seed 0, the bf16
serving copy) and the training of full-width Zamba2-1.2B and RWKV6-1.6B
(``ssm_train_path``: step 0 against the CPU, 8 ``--prune`` steps at 8 x
512, the profile). Pass ``tdm`` or ``train`` to run one of them.

    python3 tools/recurrent_train_probe.py [tdm|train]
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as CS  # noqa: E402


def main():
    import torch
    from repro_torch.kernels import backend
    if not torch.cuda.is_available():
        sys.exit("recurrent_train_probe: no CUDA device")
    which = sys.argv[1:] or ["tdm", "train"]
    dev = backend.resolve_device("cuda")
    print(CS.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip(), flush=True)
    print(f"build: {backend.build():.2f} s", flush=True)
    if "tdm" in which:
        from repro_torch.configs import MINITRON_4B
        from repro_torch.models import model as M
        from repro_torch.serving.runner import serving_params
        params = serving_params(MINITRON_4B, M.init_params(
            MINITRON_4B, torch.Generator(dev).manual_seed(0), device=dev))
        CS.prefill_tdm_path(torch, dev, MINITRON_4B, params)
        del params
        torch.cuda.empty_cache()
    if "train" in which:
        CS.ssm_train_path(torch, dev)
    print("recurrent_train_probe: ok", flush=True)


if __name__ == "__main__":
    try:
        main()
    except CS.SmokeFailure as e:
        sys.exit(f"recurrent_train_probe: FAILED: {e}")
