"""The token pipeline (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import (MemmapTokens, SyntheticLM, make_source,
                                       prefetched)

__all__ = ["MemmapTokens", "SyntheticLM", "make_source", "prefetched"]
