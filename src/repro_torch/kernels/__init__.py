"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the one dispatch point (:mod:`repro_torch.kernels.ops`)."""
