"""Runtime of the port's training loop: checkpoint/restart supervision,
the mesh's axes and ZeRO-1 rule (``sharding``), the collectives between
ranks (``collectives``) and the int8 error-feedback all-reduce
(``grad_compress``)."""
from repro_torch.runtime import collectives, fault, grad_compress, sharding

__all__ = ["collectives", "fault", "grad_compress", "sharding"]
