from repro_torch.cluster.fleet import (Allocation, FleetSimulator, TenantSpec,
                                       epoch_batch, epoch_stream)

__all__ = ["Allocation", "FleetSimulator", "TenantSpec", "epoch_batch",
           "epoch_stream"]
