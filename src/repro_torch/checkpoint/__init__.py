"""Checkpoints in the JAX package's on-disk format (counterpart of
``repro.checkpoint``)."""
from repro_torch.checkpoint.store import (latest_step, manifest_extra,
                                          restore, save, save_async,
                                          wait_pending)

__all__ = ["latest_step", "manifest_extra", "restore", "save", "save_async",
           "wait_pending"]
