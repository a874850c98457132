"""repro_torch.memory — the shared off-chip channel subsystem.

Models the one resource every SMOF eviction stream competes for: the
off-chip port.  Four pieces:

``channel``
    :class:`OffChipChannel` — burst-granular bandwidth accounting in the
    Eq. 5/6 model-cycle unit; :class:`ChannelConfig` — the user-facing
    knobs on ``CompileSpec.channel``.
``arbiter``
    :class:`ChannelArbiter` — divides the channel between weight-fetch /
    activation-evict / activation-restore streams under round-robin,
    fixed-priority or weighted-fair policies, and the contended
    Eq. 5/6 extension (``L_j^cont = max(L_j, X_j)``).
``prefetch``
    double-buffered weight prefetch schedule with stage-start deadlines
    and deadline-miss accounting.
``model``
    :func:`build_memory_model` — assembles all of the above for one
    lowered plan into a :class:`MemoryModel` that rides on
    ``StreamReport.memory``.

Dependency-free (no JAX): property tests and the fuzz generator drive
it standalone.
"""
from .arbiter import (PRIORITY_ORDER, STREAM_KINDS, ArbiterReport,
                      ChannelArbiter, StreamAllocation, StreamDemand,
                      contended_stage_latencies, contention_stall_cycles)
from .channel import POLICIES, ChannelConfig, OffChipChannel
from .model import MemoryModel, build_memory_model
from .prefetch import PrefetchReport, PrefetchSlot, prefetch_schedule

__all__ = [
    "POLICIES", "ChannelConfig", "OffChipChannel",
    "STREAM_KINDS", "PRIORITY_ORDER", "StreamDemand", "StreamAllocation",
    "ArbiterReport", "ChannelArbiter",
    "contended_stage_latencies", "contention_stall_cycles",
    "PrefetchSlot", "PrefetchReport", "prefetch_schedule",
    "MemoryModel", "build_memory_model",
]
