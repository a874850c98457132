"""Statistics of a step run on a device mesh: floating-point operations,
collective traffic and memory, per device — the counterpart of the
reference package's ``launch/hlo_analysis.py``, with its names.

The reference parses XLA's optimised, SPMD-partitioned HLO.  The port has
no HLO: it runs the step eagerly (on the meta device in the dry-run,
``launch/dryrun.py``) under :class:`StepStats`, a ``TorchDispatchMode`` that
counts each rank's own work.  For a DTensor call it returns
``NotImplemented``, so DTensor first turns the call into the local shard's
operations and the collectives its redistributions need, which the mode
then sees on plain tensors; the fake tensors of DTensor's sharding
propagation (and the factory calls that make them) pass uncounted.  So
every count is per device, as the
reference's (``FlopCounterMode`` over DTensors counts the global
operation).

* **Operations**: ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode``'s registry: the matrix products, convolutions and
  attention) on each local operation; ``flops_dot`` the matrix products
  alone.  Eager execution runs every loop iteration, so no trip count is
  parsed: the reference's ``trip_aware_stats`` has no counterpart, and the
  record's ``trip_aware.flops_dot`` is this count.
* **Collectives**: the c10d functional and c10d operations, per-device
  *operand* bytes summed by kind with the reference's rule

    all-reduce           operand = result
    all-gather           operand = result / group_size
    reduce-scatter       operand = result * group_size
    all-to-all           operand = result

  which in each case is the bytes a rank puts in: its input.
* **Memory**: ``argument_size_in_bytes``, the bytes of the local shards of
  the step's inputs; ``temp_size_in_bytes``, the peak over the step of the
  bytes of the storages it allocated that are alive at once (each storage
  counted once when an operation creates it, released when it is freed:
  a weak reference to it); ``output_size_in_bytes``, the local bytes of the
  step's outputs.  The reference's ``generated_code_size_in_bytes`` (a
  compiled program's code) and ``alias_size_in_bytes`` (donated buffers)
  have no counterpart: the port runs no compiled program and updates its
  state in place.  ``bytes_accessed`` sums every counted operation's
  operand and result bytes, with no fusion.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# op name -> (kind, index of the argument a rank puts in)
_COLL = {
    "_c10d_functional::all_reduce": ("all-reduce", 0),
    "_c10d_functional::all_reduce_": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0),
    "_c10d_functional::broadcast": ("broadcast", 0),
    "_c10d_functional::broadcast_": ("broadcast", 0),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::broadcast_": ("broadcast", 0),
}
_DOTS = ("mm", "addmm", "bmm", "baddbmm")


@dataclasses.dataclass
class CollectiveStats:
    """Byte counts are PER-DEVICE operand bytes, summed over ops;
    ``largest`` the largest single operand of each kind."""
    by_kind: dict
    total_bytes: float
    n_ops: int
    largest: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"by_kind": self.by_kind, "total_bytes": self.total_bytes,
                "n_ops": self.n_ops, "largest": self.largest}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree: Any, mesh=None) -> int:
    """The bytes of one device's share of a tree: a DTensor's local
    tensor, a tensor's own, or, on a shape-only ``mesh``, a
    ``steps.Sharded`` leaf's share of its whole tensor
    (:func:`sharded_bytes`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(local_bytes(v, mesh) for v in tree.values())
    if hasattr(tree, "spec") and hasattr(tree, "tensor"):
        from ..runtime.sharding import mesh_shape
        return sharded_bytes(tree.tensor, tree.spec, mesh_shape(mesh).shape)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    raise TypeError(f"no local bytes of {type(tree).__name__}")


def sharded_bytes(t: torch.Tensor, spec: tuple, sizes: dict) -> int:
    """Bytes of one device's share of ``t`` laid out by ``spec`` on a mesh
    of axis ``sizes``."""
    n = 1
    for dim, s in zip(t.shape, tuple(spec) + (None,) * t.dim()):
        div = 1
        for a in (s if isinstance(s, tuple) else (s,) if s else ()):
            div *= sizes[a]
        n *= dim // div
    return n * t.element_size()


class StepStats(TorchDispatchMode):
    """Counts each rank's operations, collective operand bytes and live
    storage bytes while active (module docstring).  ``arguments``: the
    step's inputs, whose storages are neither counted nor released."""

    def __init__(self, arguments: Any = ()):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0.0
        self.flops_dot = 0.0
        self.bytes_accessed = 0.0
        self.by_kind: dict[str, float] = {}
        self.largest: dict[str, float] = {}
        self.n_ops = 0
        self.operands: list[tuple[str, list]] = []   # (kind, input shapes)
        self.live = 0
        self.peak = 0
        self._live: dict[int, int] = {}
        self._known: set[int] = set()
        self._args = []
        for t in _leaf_tensors(arguments):
            self._args.append(t)           # kept alive: their ids stay theirs
            self._known.add(id(t.untyped_storage()))

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        # DTensor's sharding propagation runs the global op on fake
        # tensors, made by factory calls of its own: neither is the step's
        # work
        if any(issubclass(t, FakeTensor) for t in types) or (
                not types and _in_propagation()):
            return func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._schema.name
        coll = _COLL.get(name)
        if coll is not None:
            kind, i = coll
            operand = float(sum(_nbytes(t) for t in _tensors(args[i])))
            self.operands.append((kind, [tuple(t.shape)
                                         for t in _tensors(args[i])]))
            self.by_kind[kind] = self.by_kind.get(kind, 0.0) + operand
            self.largest[kind] = max(self.largest.get(kind, 0.0), operand)
            self.n_ops += 1
        elif func._overloadpacket in self._formulas:
            f = float(self._formulas[func._overloadpacket](
                *args, **kwargs, out_val=out))
            self.flops += f
            if func._overloadpacket.__name__ in _DOTS:
                self.flops_dot += f
        ins, outs = _tensors((args, list(kwargs.values()))), _tensors(out)
        self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation (``_sharding_prop.py``) is
    on the Python stack: the global-shape tensors it makes to derive an
    output's shape are no rank's memory."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _leaf_tensors(tree) -> list:
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaf_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaf_tensors(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    return []


def collective_stats(stats: StepStats) -> CollectiveStats:
    """The collectives :class:`StepStats` saw, per-device operand bytes by
    kind."""
    return CollectiveStats(by_kind=dict(stats.by_kind),
                           total_bytes=sum(stats.by_kind.values()),
                           n_ops=stats.n_ops, largest=dict(stats.largest))


def memory_stats(stats: StepStats, outputs: Any = ()) -> dict:
    """Argument, output and peak temporary bytes per device (module
    docstring)."""
    return {"argument_size_in_bytes": sum(_nbytes(t)
                                          for t in stats._args),
            "output_size_in_bytes": sum(_nbytes(t)
                                        for t in _leaf_tensors(outputs)),
            "temp_size_in_bytes": stats.peak}


def cost_stats(stats: StepStats) -> dict:
    """Per-device floating-point operations and bytes accessed."""
    return {"flops": stats.flops, "bytes_accessed": stats.bytes_accessed}


def trip_aware_stats(stats: StepStats) -> dict:
    """The reference's trip-count-aware record: here every iteration ran,
    so its counts are the plain ones."""
    return {"flops_dot": stats.flops_dot,
            "collectives": collective_stats(stats).to_json()}


__all__ = ["CollectiveStats", "StepStats", "collective_stats",
           "memory_stats", "cost_stats", "trip_aware_stats", "local_bytes",
           "sharded_bytes"]
