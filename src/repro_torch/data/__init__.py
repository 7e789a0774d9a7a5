"""Synthetic token streams (numpy)."""
from repro_torch.data.pipeline import SyntheticStream

__all__ = ["SyntheticStream"]
