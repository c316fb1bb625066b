"""Serving in PyTorch (counterpart of ``repro.serving``): batched LM
``generate``, and the admission daemon with its wire protocol, server and
client."""
from repro_torch.serving.allocd import (ARRIVAL_PROFILES, AdmissionTicket,
                                        AllocDaemon, diurnal_times,
                                        drive_open_loop, flash_crowd_times,
                                        interleave_traces, poisson_times,
                                        rejection_penalty)
from repro_torch.serving.client import AllocClient, WireTicket
from repro_torch.serving.engine import generate, pad_attn_cache
from repro_torch.serving.server import AllocServer
from repro_torch.serving.wire import (MAX_FRAME_BYTES, PROTOCOL_VERSION,
                                      FrameTooLargeError, MalformedFrameError,
                                      ProtocolVersionError, RemoteError,
                                      WireError, WireFlushReport)

__all__ = [
    "ARRIVAL_PROFILES",
    "AdmissionTicket",
    "AllocClient",
    "AllocDaemon",
    "AllocServer",
    "FrameTooLargeError",
    "MAX_FRAME_BYTES",
    "MalformedFrameError",
    "PROTOCOL_VERSION",
    "ProtocolVersionError",
    "RemoteError",
    "WireError",
    "WireFlushReport",
    "WireTicket",
    "diurnal_times",
    "drive_open_loop",
    "flash_crowd_times",
    "generate",
    "interleave_traces",
    "pad_attn_cache",
    "poisson_times",
    "rejection_penalty",
]
