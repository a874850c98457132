"""Async, atomically-committed checkpoints with optional BFP8 compression —
the counterpart of the reference package's ``checkpoint/store.py``, in its
on-disk format, so that each package restores the other's checkpoints.

Layout:  <dir>/step_<N>/  manifest.json + one .npy per tree leaf.  A leaf
is named by its path as the reference's ``jax.tree_util`` names it: dict
keys in sorted order, a tuple's or list's items by index (``0/...``,
``1/...`` for ``(params, opt_state)``), joined by ``/``; files are numbered
in the sorted order of those names, bf16 is stored as its ``uint16`` bits
with ``dtype: "bfloat16"``.  Writes go to ``step_<N>.tmp`` and are renamed
into place only after the manifest is written — a crashed save can never
produce a half-readable checkpoint.  ``save_async`` copies the tree to host
memory at once and serialises it on a worker thread, so the train loop
only blocks on the previous save's completion (one outstanding save).

BFP8 mode stores f32/f16/bf16 leaves in the paper's §V-A block-floating-
point format (``core/compression.py``, about 2x smaller); restore
dequantises transparently.

Restore returns torch tensors on ``device`` (by default each template
leaf's own).  On a mesh: ``save`` / ``save_async`` take DTensor leaves,
each gathered whole on the caller's thread (every rank takes part in the
collective; the writer thread runs none), one rank writes, and every rank
meets the others at a barrier when the write is done (``wait`` for an
asynchronous save).  ``restore(..., shardings=...)`` (a tree of
``runtime.sharding.NamedSharding``) lays every leaf out again on its new
mesh and spec, each rank keeping its own slice: the elastic restore of a
job restarted on another device population.  The bytes on disk are the
same either way.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import pathlib
import shutil
from typing import Any

import numpy as np
import torch

from ..core.compression import BFP8Blocks, bfp8_decode, bfp8_encode


def _world() -> tuple[int, int]:
    """(rank, world size) of the running process group, (0, 1) without
    one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _paths(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs in the reference's tree order: dict keys sorted,
    sequence items by index; ``None`` holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _flat(tree: Any) -> dict[str, Any]:
    return {"/".join(str(p) for p in path): leaf
            for path, leaf in _paths(tree)}


def _rebuild(tree: Any, leaves: dict[str, Any], prefix: tuple = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves, prefix + (i,))
                          for i, v in enumerate(tree))
    return leaves["/".join(str(p) for p in prefix)]


def _host(leaf: Any) -> tuple[np.ndarray, bool]:
    """A leaf as a host array, and whether it is bf16 (then its uint16
    bits)."""
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), True
        return t.numpy().copy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16).copy(), True
    return arr, False


_TORCH_OF = {"float32": torch.float32, "float16": torch.float16,
             "bfloat16": torch.bfloat16,
             "float64": torch.float64, "int8": torch.int8,
             "int16": torch.int16, "int32": torch.int32,
             "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


class CheckpointStore:
    def __init__(self, directory: str, *, bfp8: bool = False,
                 keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.bfp8 = bfp8
        self.keep_last = keep_last
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: cf.Future | None = None
        self._barrier = False

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        flat = {k: _host(v) for k, v in _flat(tree).items()}
        rank, world = _world()
        if rank == 0:
            self._write(step, flat, extra or {})
        if world > 1:
            import torch.distributed as dist
            dist.barrier()

    def save_async(self, step: int, tree: Any,
                   extra: dict | None = None) -> None:
        """Snapshot to host now (every rank gathering its DTensor leaves
        whole), serialise on the worker thread of rank 0."""
        self.wait()
        flat = {k: _host(v) for k, v in _flat(tree).items()}
        rank, world = _world()
        if rank == 0:
            self._pending = self._pool.submit(self._write, step, flat,
                                              extra or {})
        self._barrier = world > 1

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        if self._barrier:
            import torch.distributed as dist
            dist.barrier()
            self._barrier = False

    def _write(self, step: int, flat: dict[str, tuple[np.ndarray, bool]],
               extra: dict) -> None:
        final = self.dir / f"step_{step}"
        tmp = self.dir / f"step_{step}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "bfp8": self.bfp8, "extra": extra,
                    "leaves": {}}
        for i, (key, (arr, bf16)) in enumerate(sorted(flat.items())):
            fname = f"leaf_{i}.npy"
            meta = {"file": fname,
                    "dtype": "bfloat16" if bf16 else str(arr.dtype),
                    "shape": list(arr.shape)}
            if self.bfp8 and (bf16 or arr.dtype in (np.float32, np.float16)):
                if bf16:
                    arr = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16).float().numpy()
                blocks = bfp8_encode(np.asarray(arr, np.float32))
                np.save(tmp / fname, blocks.mantissas)
                np.save(tmp / f"exp_{i}.npy", blocks.exponents)
                meta.update({"codec": "bfp8", "exp_file": f"exp_{i}.npy",
                             "block": blocks.block,
                             "orig_len": blocks.orig_len})
            else:
                np.save(tmp / fname, arr)
            manifest["leaves"][key] = meta
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                     # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: int | None = None, *,
                device: str | torch.device | None = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` (tensors or arrays):
        each leaf a tensor of its template leaf's dtype, on ``device`` or,
        by default, on the template leaf's device (the CPU for an array).
        With ``shardings``, a tree of ``NamedSharding`` matching
        ``template``, each leaf is a DTensor laid out on its mesh and spec
        (on ``device`` or the mesh's device type, the current card for
        ``cuda``)."""
        from ..runtime.sharding import distribute
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat_s = _flat(shardings) if shardings is not None else {}
        out = {}
        for key, leaf in _flat(template).items():
            meta = manifest["leaves"][key]
            arr = np.load(d / meta["file"])
            if meta.get("codec") == "bfp8":
                exp = np.load(d / meta["exp_file"])
                arr = bfp8_decode(BFP8Blocks(arr, exp, meta["block"],
                                             meta["orig_len"],
                                             tuple(meta["shape"])))
            if meta["dtype"] == "bfloat16" and arr.dtype == np.uint16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(arr))
            t = t.reshape(meta["shape"])
            want = (leaf.dtype if isinstance(leaf, torch.Tensor)
                    else _TORCH_OF[np.asarray(leaf).dtype.name])
            sh = flat_s.get(key)
            if sh is not None:
                dev = device if device is not None else (
                    "cpu" if sh.mesh.device_type == "cpu"
                    else torch.device(sh.mesh.device_type,
                                      torch.cuda.current_device()))
                out[key] = distribute(t.to(dtype=want).to(dev), sh.spec,
                                      sh.mesh)
                continue
            dev = device if device is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
            out[key] = t.to(dtype=want).to(dev)
        return _rebuild(template, out), manifest["extra"]


__all__ = ["CheckpointStore"]
