"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Imports torch, numpy and the standard library only; never jax and never a
module of ``repro``. Entry points run on the card (``device="cuda"``) unless
the caller asks for ``"cpu"``.
"""
