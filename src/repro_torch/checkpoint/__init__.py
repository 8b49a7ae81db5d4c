"""Checkpoints of the port: the reference's store, in its file format."""
from repro_torch.checkpoint.store import (AsyncCheckpointer, flatten_tree,
                                          latest_step, restore, restore_flat,
                                          restore_params, retain, save, steps,
                                          unflatten_into)

__all__ = ["save", "restore", "latest_step", "steps", "retain",
           "AsyncCheckpointer", "flatten_tree", "unflatten_into",
           "restore_flat", "restore_params"]
