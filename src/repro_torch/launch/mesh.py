"""Device meshes — the counterpart of the reference package's
``launch/mesh.py``, as ``torch.distributed`` ``DeviceMesh``es.

FUNCTIONS, not module-level constants: importing this module starts no
process group and touches no device.

* :func:`make_host_mesh` is a 1x1 ``("data", "model")`` mesh on one device.
  Where no process group runs it starts a world of one, with a store of its
  own (no environment variables, no port): NCCL on the card, gloo when the
  caller asks for ``"cpu"``.
* :func:`make_production_mesh` lays ``(16, 16)`` ``("data", "model")`` or
  ``(2, 16, 16)`` ``("pod", "data", "model")`` over the running world (one
  started from ``torchrun``'s environment if none runs), and refuses a world
  of another size, naming the size it needs.
"""
from __future__ import annotations

import os

import torch

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_host_mesh(device: str | torch.device = "cuda"):
    """A 1x1 ``("data", "model")`` mesh on the one device (examples, tests,
    the train CLI's ``--mesh host``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"a host mesh is one device; this process runs in a "
                         f"world of {dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data",
                                                               "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda"):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod, over the
    running world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION[multi_pod]
    need = 1
    for s in shape:
        need *= s
    dev = torch.device(device)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(_backend(dev))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production "
            f"mesh {shape} {axes} needs a world of {need} ranks; this one "
            f"has {world} (start {need} ranks with torchrun)")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


__all__ = ["make_host_mesh", "make_production_mesh", "PRODUCTION"]
