"""The serving front end of the port: :class:`GraphStreamServer`, which
packs submitted frames into microbatch streams for the pipelined
executor, and its registry-backed :class:`StreamServerStats`."""
from .engine import GraphStreamServer, StreamServerStats

__all__ = ["GraphStreamServer", "StreamServerStats"]
