"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper.

A second package beside the JAX reference: it imports ``torch`` and
numpy, never JAX and nothing of ``repro``. This slice serves dense
decoders (``attn``/``swa`` blocks) through a continuous-batching engine
whose prefill and decode attention run hand-written CUDA kernels on the
card (``csrc/``) and their plain PyTorch versions on the CPU.
"""
