"""Batched LM serving (counterpart of ``repro.serving.engine``).  The
admission daemon, its wire protocol, server and client are not ported yet
(ROADMAP.md Queue 1 item 12)."""
from repro_torch.serving.engine import generate, pad_attn_cache

__all__ = ["generate", "pad_attn_cache"]
