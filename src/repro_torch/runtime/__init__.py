"""Runtime of the port's training loop: checkpoint/restart supervision."""
from repro_torch.runtime import fault

__all__ = ["fault"]
