"""Checkpoints of the port: the read half of the reference's store."""
from repro_torch.checkpoint.store import (latest_step, restore_flat,
                                          restore_params, steps)

__all__ = ["latest_step", "restore_flat", "restore_params", "steps"]
