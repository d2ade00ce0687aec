"""Optimizers of the port over dict trees (AdamW, SGD)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, sgd_update)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "sgd_update"]
