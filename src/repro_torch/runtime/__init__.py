from .driver import (FaultInjector, FaultTolerantTrainer, SimulatedFailure,
                     elastic_remesh)

__all__ = ["FaultTolerantTrainer", "FaultInjector", "SimulatedFailure",
           "elastic_remesh"]
