"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper.

A second package beside the JAX reference: it imports ``torch`` and
numpy, never JAX and nothing of ``repro``. It serves dense decoders
(``attn``/``swa`` blocks) through a continuous-batching engine, from a
dense slot cache or from fp / int8 / int4 / svd page pools, and trains
them with PAMM-compressed Q/K/V projections; the Pallas kernels of the
reference on those paths run as hand-written CUDA kernels on the card
(``csrc/``) and as their plain PyTorch versions on the CPU.
"""
