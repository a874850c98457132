"""Sharding rules: parameter / batch / cache partition specs — the
counterpart of the reference package's ``runtime/sharding.py``, on
``torch.distributed``.

Logical scheme on the (``pod``,) ``data``, ``model`` mesh:

* **FSDP** — parameter matrices shard their d_model-like axis over ``data``;
* **TP**   — head / hidden axes shard over ``model``;
* **EP**   — MoE expert axis shards over ``model`` when divisible (olmoe 64e,
  jamba 16e), otherwise experts stay together and TP falls back to d_ff
  (grok 8e on a 16-wide model axis);
* **DP**   — the batch shards over (``pod`` x) ``data``;
* **SP**   — when the batch is too small to shard (long_500k, B=1), the KV
  cache shards its *sequence* axis over ``data`` instead.

Every rule is divisibility-guarded: an axis that does not divide by its mesh
axis size is left unsharded rather than failing (e.g. whisper's vocab 51866).

A spec is the reference's ``PartitionSpec`` as a tuple, one entry a tensor
dimension: ``None`` (whole), a mesh-axis name, or a tuple of names (the
dimension split over those axes, the first the major).  The rules read only
a mesh's axis names and sizes, so they run on a :class:`MeshShape` at
production sizes as well as on a ``DeviceMesh``.  :func:`placements` turns a
spec into DTensor placements on a real ``DeviceMesh``: ``Shard(d)`` on each
mesh dimension the entry of tensor dimension ``d`` names.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

import torch

if TYPE_CHECKING:
    from ..models.config import ArchConfig

Spec = tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it (the
    reference's ``AbstractMesh``)."""
    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out


def mesh_shape(mesh) -> MeshShape:
    """The axis names and sizes of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names))


def _axsize(mesh, name: str) -> int:
    return mesh_shape(mesh).shape.get(name, 1)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel mesh axes: ("pod","data") on multi-pod meshes."""
    return ("pod", "data") if "pod" in mesh_shape(mesh).shape else ("data",)


def dp_size(mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= _axsize(mesh, a)
    return out


def _guard(shape: tuple, spec: list, mesh) -> Spec:
    """Drop any sharding a dimension cannot honour."""
    out = []
    for dim, s in zip(shape, spec):
        if s is None:
            out.append(None)
            continue
        names = s if isinstance(s, tuple) else (s,)
        total = 1
        for n in names:
            total *= _axsize(mesh, n)
        out.append(s if dim % total == 0 and total > 1 else None)
    return tuple(out)


def _param_spec(names: tuple, shape: tuple, cfg: ArchConfig, mesh) -> Spec:
    name = names[-1]
    grouped = "groups" in names            # stacked (n_groups, ...) leading dim
    core = shape[1:] if grouped else shape

    def done(spec_core: list) -> Spec:
        spec = ([None] + spec_core) if grouped else spec_core
        return _guard(shape, spec, mesh)

    if name in ("embed", "lm_head"):
        return done(["model", None])
    # --- attention -----------------------------------------------------------
    if name in ("wq", "wk", "wv"):
        return done(["data", "model"])
    if name == "wo":
        return done(["model", "data"])
    # --- ffn / moe ------------------------------------------------------------
    if name == "router":
        return done(["data", None])
    if name in ("w_up", "w_gate", "w_down") and len(core) == 3:   # (E, d, f)
        E = core[0]
        if E % _axsize(mesh, "model") == 0:
            return done(["model", "data", None] if name != "w_down"
                        else ["model", None, "data"])
        return done([None, "data", "model"] if name != "w_down"
                    else [None, "model", "data"])
    if name in ("w_up", "w_gate"):
        return done(["data", "model"])
    if name == "w_down":
        return done(["model", "data"])
    # --- ssm / xlstm -----------------------------------------------------------
    if name == "in_proj":
        return done(["data", "model"])
    if name == "out_proj":
        return done(["model", "data"])
    if name in ("conv_w",):
        return done([None, "model"])
    if name == "x_proj":
        return done(["model", None])
    if name == "dt_proj":
        return done([None, "model"])
    if name in ("A_log",):
        return done(["model", None])
    if name in ("D", "wq_diag", "wk_diag"):
        return done(["model"])
    if name == "w_in":
        return done(["data", "model"])
    if name == "r":                         # (H, dh, 4dh)
        return done([None, None, "model"])
    # --- norms / biases / everything 1-D: replicate -----------------------------
    if len(core) <= 1:
        return done([None] * len(core))
    # generic 2-D fallback
    return done(["data", "model"] + [None] * (len(core) - 2))


def _shape(leaf) -> tuple:
    return tuple(leaf) if isinstance(leaf, (tuple, list, torch.Size)) \
        else tuple(leaf.shape)


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts (and tuples or lists of
    subtrees); a leaf is a tensor, a shape tuple, or anything with
    ``.shape``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not all(
            isinstance(s, int) for s in tree):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(cfg: ArchConfig, params_shapes: Any, mesh) -> Any:
    """A spec tree matching a params (shape) tree."""
    return _map_with_path(
        lambda path, leaf: _param_spec(path, _shape(leaf), cfg, mesh),
        params_shapes)


def opt_state_shardings(cfg: ArchConfig, opt_shapes: Any, mesh) -> Any:
    """Moments follow their parameter's sharding; scales drop the last axis."""
    size = mesh_shape(mesh).size

    def f(path, leaf):
        shape = _shape(leaf)
        if path and path[-1] == "step":
            return ()
        # strip the m/v level and any q/s quantisation leaf so the rule sees
        # the underlying parameter's path
        eff = tuple(k for k in path if k not in ("m", "v", "q", "s"))
        if path[-1] == "s":    # row scale: parameter spec minus the last axis
            fake = shape[:-1] + (size * 1024,)
            base = _param_spec(eff, fake, cfg, mesh)
            return _guard(shape, list(base)[:-1] + [None], mesh)
        return _param_spec(eff, shape, cfg, mesh)
    return _map_with_path(f, opt_shapes)


def batch_shardings(cfg: ArchConfig, batch: int, mesh) -> dict:
    dp = dp_axes(mesh)
    dp = dp[0] if len(dp) == 1 else dp
    b_ok = batch % dp_size(mesh) == 0
    row = (dp,) if b_ok else (None,)
    return {
        "tokens": (*row, None),
        "labels": (*row, None),
        "enc_frames": (*row, None, None),
        "patch_embeds": (*row, None, None),
        "pos": (*row,),
    }


def cache_shardings(cfg: ArchConfig, batch: int, mesh, cache_shapes) -> Any:
    """KV / state cache shardings; SP fallback when the batch won't shard."""
    dp = dp_axes(mesh)
    dp = dp[0] if len(dp) == 1 else dp
    b_ok = batch % dp_size(mesh) == 0

    def f(path, leaf):
        shape = _shape(leaf)
        name = path[-1]
        nd = len(shape)
        spec: list = [None] * nd
        if name in ("k", "v", "xk", "xv") and nd == 5:
            # KV cache (ng, B, S, KH, D): batch over DP + *sequence over
            # model*, so a KH head axis smaller than the model axis never
            # forces a replica.
            if b_ok:
                spec[1] = dp
            spec[2] = "model" if b_ok else ("data", "model")
        elif b_ok:
            spec[1] = dp                                   # (ng, B, ...)
        elif name in ("h", "C") and nd >= 4:
            spec[2] = "model"                              # d_inner / heads
        return _guard(shape, spec, mesh)

    return _map_with_path(f, cache_shapes)


def replicated(mesh) -> Spec:
    return ()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (the reference's ``NamedSharding``): a
    leaf of the ``shardings`` trees ``CheckpointStore.restore`` and
    ``FaultTolerantLoop.try_restore`` take."""
    mesh: Any
    spec: Spec


def named_shardings(mesh, specs: Any) -> Any:
    """A tree of :class:`NamedSharding` from a tree of specs on ``mesh``."""
    if isinstance(specs, dict):
        return {k: named_shardings(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list) or (isinstance(specs, tuple) and specs and
                                   isinstance(specs[0], (dict, list))):
        return type(specs)(named_shardings(mesh, v) for v in specs)
    return NamedSharding(mesh, specs)


# -- specs on a DeviceMesh ----------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)`` on
    every mesh dimension that tensor dimension ``d``'s entry names, in the
    mesh's order (the reference lists an entry's axes major first, as the
    mesh orders them); ``Replicate()`` on the others, and on a dimension of
    size 1 (where a shard is the whole, and DTensor's view rules refuse to
    reshape a sharded dimension)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = list(mesh.mesh.shape)
    out: list = [Replicate()] * len(names)
    for d, s in enumerate(spec):
        if s is None:
            continue
        for n in (s if isinstance(s, tuple) else (s,)):
            i = names.index(n)
            if sizes[i] == 1:
                continue
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {n!r} shards two "
                                 f"dimensions")
            out[i] = Shard(d)
    return tuple(out)


_REGISTERED = []


def register_strategies() -> None:
    """Sharding strategies DTensor lacks for ops the models' training
    routes run: ``log_sigmoid_backward`` (the mLSTM gates' gradient),
    replicated (gathered where its inputs are sharded).  Once a process."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_output, x, buffer):
        return [([Replicate()], [Replicate(), Replicate(), Replicate()])]
    _REGISTERED.append(_log_sigmoid_backward)


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    strides, with no tensor made)."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def distribute(t: torch.Tensor, spec: Spec, mesh):
    """``t``, the whole tensor on every rank, as a DTensor laid out by
    ``spec``: each rank keeps its own slice, no collective runs.  A DTensor
    on ``mesh`` already is redistributed to ``spec`` (not at all where it
    is laid out so)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """:func:`distribute` over matching trees of tensors and specs."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(distribute_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return distribute(tree, specs, mesh)


__all__ = ["MeshShape", "mesh_shape", "dp_axes", "dp_size",
           "param_shardings", "opt_state_shardings", "batch_shardings",
           "cache_shardings", "replicated", "NamedSharding",
           "named_shardings", "placements", "contiguous_strides",
           "distribute", "distribute_tree"]
