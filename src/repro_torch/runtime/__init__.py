"""The port's training runtime (port of ``src/repro/runtime``)."""
from repro_torch.runtime.trainer import (FailureInjector, SimulatedFailure,
                                         TrainConfig, Trainer)

__all__ = ["Trainer", "TrainConfig", "FailureInjector", "SimulatedFailure"]
