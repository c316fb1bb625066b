"""AdamW and its schedules (counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                     global_norm, make_schedule)

__all__ = ["OptConfig", "adamw_init", "adamw_update", "global_norm",
           "make_schedule"]
