"""Run a function of the port on N spawned ranks of one
``torch.distributed`` world.

:func:`run_ranks` starts ``world`` fresh interpreters (never a copy or a
re-import of the caller's main module), each of which joins a process
group through a ``file://`` store under a temporary directory of its own
(so concurrent launches never share a port), sets one intra-op thread,
calls ``fn(rank, world, *args)`` and hands its result back through a file.
The function is named by ``"module:qualname"`` and must live in the port:
the children import only ``repro_torch`` and what the function imports.
A child's exception is raised in the caller with its traceback; a world
that does not finish within ``timeout`` seconds is killed.

    from repro_torch.testing.ranks import run_ranks
    out = run_ranks("repro_torch.testing.mesh_cases:pod_compress", 2,
                    grads, errors, w, batch, backend="gloo", timeout=120)
"""
from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback

#: what a child runs: its call from a file, the caller's import path first
_BOOT = ("import pickle, sys; a = pickle.load(open(sys.argv[1], 'rb')); "
         "sys.path[:0] = a['path']; "
         "from repro_torch.testing.ranks import _child; _child(**a['call'])")


def _resolve(name: str):
    mod, _, qual = name.partition(":")
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _child(name: str, rank: int, world: int, backend: str, store: str,
           out: str, args: tuple, kwargs: dict) -> None:
    import faulthandler
    import torch
    import torch.distributed as dist
    faulthandler.enable()       # a crash in a collective names its frame
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            res = ("ok", _resolve(name)(rank, world, *args, **kwargs))
        finally:
            dist.destroy_process_group()
    except BaseException:                                  # noqa: BLE001
        res = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(out + ".tmp", out)


def run_ranks(name: str, world: int, *args, backend: str = "gloo",
              timeout: float = 300.0, **kwargs) -> list:
    """``[fn(rank, world, *args, **kwargs) for rank in range(world)]``, run
    on ``world`` spawned ranks of one process group (``backend``)."""
    with tempfile.TemporaryDirectory(prefix="smof_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = []
        for r in range(world):
            call = os.path.join(tmp, f"call{r}.pkl")
            with open(call, "wb") as f:
                pickle.dump({"path": list(sys.path), "call": dict(
                    name=name, rank=r, world=world, backend=backend,
                    store=store, out=outs[r], args=args, kwargs=kwargs)}, f)
            procs.append(subprocess.Popen([sys.executable, "-c", _BOOT,
                                           call]))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                try:
                    p.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
            late = [r for r, p in enumerate(procs) if p.poll() is None]
            if late:
                raise TimeoutError(f"{name} on {world} ranks: ranks {late} "
                                   f"still running after {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                raise RuntimeError(f"{name}: rank {r} exited with code "
                                   f"{procs[r].returncode} and no result")
            with open(path, "rb") as f:
                kind, val = pickle.load(f)
            if kind == "error":
                raise RuntimeError(f"{name}: rank {r} failed:\n{val}")
            results.append(val)
    return results


__all__ = ["run_ranks"]
