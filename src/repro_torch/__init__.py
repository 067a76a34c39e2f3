"""PyTorch/CUDA port of the packed-ViT serving path for NVIDIA Hopper.

Mirrors the layout of the reference package ``repro`` (JAX/Pallas), which
it is tested against; imports ``torch`` and ``numpy`` only. Entry points
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run.
"""
