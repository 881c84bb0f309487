"""PyTorch / CUDA port of VideoLLaMB for NVIDIA Hopper.

Mirrors the module layout and function names of the JAX package
``videollamb_tpu``, which stays the reference the port is tested against.
Imports torch and never jax, and nothing of ``videollamb_tpu``: the host
modules it needs (config, constants, conversation, mm_utils, data) are its
own copies.
"""
