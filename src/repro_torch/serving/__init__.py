"""The serving front ends of the port: the LM decode engine
(:class:`ServingEngine`, continuous batching with BFP8 KV-page eviction)
and :class:`GraphStreamServer`, which packs submitted frames into
microbatch streams for the pipelined executor, with their registry-backed
stats views."""
from .engine import (EngineStats, GraphStreamServer, Request, ServingEngine,
                     StreamServerStats)

__all__ = ["EngineStats", "GraphStreamServer", "Request", "ServingEngine",
           "StreamServerStats"]
