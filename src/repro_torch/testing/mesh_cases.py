"""The distributed training cases the tests and ``chip_smoke.py`` run on N
ranks through :func:`repro_torch.testing.ranks.run_ranks`: each is
``fn(rank, world, ...)`` on a process group already joined, returns plain
Python and numpy values, and imports only the port.

* :func:`train_steps` — ``make_train_step(..., mesh=)`` steps on a
  ``DeviceMesh`` of the world from a numpy parameter tree; per step the
  metrics and (rank 0) every parameter gathered whole, each rank's layout;
  optionally a checkpoint of the final state.
* :func:`restore` — a checkpoint restored onto this world's mesh through
  ``elastic_remesh`` or ``FaultTolerantLoop.try_restore(shardings=)``,
  every leaf's layout checked against the rules and gathered whole.
* :func:`pod_compress` — ``compressed_psum`` on given per-pod gradients
  and errors, and ``make_pod_compressed_grad_fn`` on a loss, over the
  world as the ``pod`` axis; :func:`pod_lm` the latter on ``lm_loss``.
* :func:`serve_steps` — ``make_prefill_step`` / ``make_decode_step(...,
  mesh=)``: a prefill and decode steps on a ``DeviceMesh`` of the world,
  each step's logits and (rank 0) every cache leaf gathered whole, the
  leaves whose layout strays from ``cache_shardings``, and each decode
  step's collectives (``launch/hlo_analysis.py``).
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def config(arch: str, reduced: bool = True, layers: int | None = None):
    """``arch``'s config: its reduced form or its published widths, with
    the depth cut to ``layers`` where given."""
    from ..configs import ARCHS
    cfg = ARCHS[arch].reduced() if reduced else ARCHS[arch]
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def _device(kind: str):
    import torch
    if kind == "cpu":
        return torch.device("cpu")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def make_mesh(kind: str, shape: tuple):
    """A ``DeviceMesh`` of ``shape`` over the world, named by :data:`AXES`
    (``kind`` "cpu" or "cuda"; every rank's card is the first)."""
    from torch.distributed.device_mesh import DeviceMesh
    _device(kind)
    n = int(np.prod(shape))
    return DeviceMesh(kind, np.arange(n).reshape(shape).tolist(),
                      mesh_dim_names=AXES[len(shape)])


def weights(cfg, tree, seed: int, dev):
    """The parameters: the numpy ``tree`` carried over, or made from
    ``seed`` on ``dev``."""
    import torch
    from ..models import init_params, params_from_numpy
    if tree is not None:
        return params_from_numpy(tree, cfg, dev)
    return init_params(torch.Generator(device=dev).manual_seed(seed), cfg)


def _whole(t) -> np.ndarray:
    """A DTensor or tensor gathered whole, as a host array of its own (the
    step updates the tensor in place), f32 if narrower."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach()
    return (t.float() if t.element_size() < 4 else t).cpu().numpy().copy()


def train_steps(rank: int, world: int, arch: str, batches: list, *,
                mesh_shape: tuple, opt: dict, tree, device: str = "cpu",
                microbatches: int | None = None, save: str | None = None
                ) -> dict:
    """``len(batches)`` steps of ``make_train_step(..., mesh=)`` (remat
    "full", AdamW ``opt``) on a ``mesh_shape`` mesh of the reduced
    ``arch`` from the numpy parameter ``tree``.  Returns the metrics of
    each step, rank 0's every parameter gathered whole after each, this
    rank's placements and local shape of every leaf, the type and shape
    of every q ``FlashAttention`` ran on, and the modules of jax, of the
    reference package or of a test module loaded in this rank (none
    expected)."""
    from ..checkpoint import CheckpointStore
    from ..kernels import flash_attention as FA
    from ..models.model import _leaves
    from ..optim.adamw import AdamWConfig, init_opt_state
    from ..runtime.steps import make_train_step
    dev = _device(device)
    mesh = make_mesh(device, mesh_shape)
    cfg = config(arch)
    params = weights(cfg, tree, 0, dev)
    opt_cfg = AdamWConfig(**opt)
    state = init_opt_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat="full", device=dev,
                           microbatches=microbatches, mesh=mesh)
    out: dict = {"metrics": [], "params": []}
    # the (B, S, H, D) shapes FlashAttention's forward is given: on a mesh
    # each rank's own rows and heads, plain tensors
    seen: set = set()
    forward = FA.FlashAttention.forward

    def recording(ctx, q, k, v, causal=True):
        seen.add((type(q).__name__, tuple(q.shape)))
        return forward(ctx, q, k, v, causal)
    FA.FlashAttention.forward = staticmethod(recording)
    try:
        for b in batches:
            params, state, m = step(params, state, b)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            whole = {n: _whole(t) for n, t in _leaves(params)}
            out["params"].append(whole if rank == 0 else None)
    finally:
        FA.FlashAttention.forward = staticmethod(forward)
    out["attention"] = sorted(seen)
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro")
                            or m.split(".")[0].startswith("test_"))
    out["placements"] = {n: [str(p) for p in t.placements]
                         for n, t in _leaves(params)}
    out["local_shapes"] = {n: tuple(t.to_local().shape)
                           for n, t in _leaves(params)}
    if save is not None:
        CheckpointStore(save).save(len(batches), (params, state),
                                   {"next_step": len(batches)})
    return out


def restore(rank: int, world: int, arch: str, ckpt: str, *,
            mesh_shape: tuple, opt: dict, via: str = "elastic",
            device: str = "cpu") -> dict:
    """The newest checkpoint in ``ckpt`` restored onto a ``mesh_shape``
    mesh of this world, laid out by the rules, through ``elastic_remesh``
    (``via="elastic"``) or ``FaultTolerantLoop.try_restore(shardings=)``.
    Returns ``next_step``, the leaves whose placements differ from the
    rules' (none expected) and rank 0's every leaf gathered whole."""
    from ..checkpoint import CheckpointStore
    from ..models.model import _leaves
    from ..optim.adamw import AdamWConfig, init_opt_state
    from ..runtime import sharding as SH
    from ..runtime.fault import FaultTolerantLoop, elastic_remesh
    dev = _device(device)
    cfg = config(arch)
    params = weights(cfg, None, 1, dev)
    opt_cfg = AdamWConfig(**opt)
    template = (params, init_opt_state(params, opt_cfg))
    store = CheckpointStore(ckpt)

    def specs(mesh):
        return (SH.param_shardings(cfg, template[0], mesh),
                SH.opt_state_shardings(cfg, template[1], mesh))

    def shardings(mesh):
        return SH.named_shardings(mesh, specs(mesh))

    def new_mesh():
        return make_mesh(device, mesh_shape)

    if via == "elastic":
        mesh, state, nxt = elastic_remesh(new_mesh, shardings, store,
                                          template)
    else:
        mesh = new_mesh()
        loop = FaultTolerantLoop(lambda s, b: s, store)
        state, nxt = loop.try_restore(template, shardings=shardings(mesh))
    want = dict(_leaves({"0": specs(mesh)[0], "1": specs(mesh)[1]}))
    got = dict(_leaves({"0": state[0], "1": state[1]}))
    wrong = [n for n, t in got.items()
             if tuple(t.placements) != SH.placements(want[n], mesh)]
    whole = {n: _whole(t) for n, t in got.items()}
    return {"next_step": nxt, "wrong_layout": wrong,
            "leaves": whole if rank == 0 else None}


def _mse(params, batch):
    """The reference's TestPodCompression loss: mean((batch @ w)^2)."""
    return ((batch @ params["w"]) ** 2).mean()


def pod_compress(rank: int, world: int, grads: np.ndarray,
                 errors: np.ndarray, w: np.ndarray, batch: np.ndarray, *,
                 device: str = "cpu") -> dict:
    """On a (world, 1, 1) ("pod", "data", "model") mesh: rank r's
    ``compressed_psum`` of ``grads[r]`` with ``errors[r]``, and
    ``make_pod_compressed_grad_fn`` of :func:`_mse` at ``{"w": w}`` over
    ``batch`` (each pod its slice of the rows) with zero errors, beside the
    rank's own uncompressed gradient of its slice."""
    import torch
    from ..optim.compress import (compressed_psum, init_error_state,
                                  make_pod_compressed_grad_fn)
    dev = _device(device)
    mesh = make_mesh(device, (world, 1, 1))
    g, e = compressed_psum({"w": torch.from_numpy(grads[rank]).to(dev)},
                           {"w": torch.from_numpy(errors[rank]).to(dev)},
                           "pod", mesh)
    params = {"w": torch.from_numpy(w).to(dev)}
    fn = make_pod_compressed_grad_fn(_mse, mesh)
    batch = torch.from_numpy(batch).to(dev)
    cg, loss, ne = fn(params, batch, init_error_state(params))
    rows = batch.shape[0] // world
    wt = params["w"].clone().requires_grad_(True)
    own, = torch.autograd.grad(
        _mse({"w": wt}, batch[rank * rows:(rank + 1) * rows]), [wt])
    return {"psum": g["w"].cpu().numpy(), "error": e["w"].cpu().numpy(),
            "grads": cg["w"].cpu().numpy(), "loss": float(loss),
            "new_error": ne["w"].cpu().numpy(), "own": own.cpu().numpy()}


def pod_lm(rank: int, world: int, arch: str, batch: dict, *,
           layers: int | None = None, reduced: bool = True, seed: int = 0,
           device: str = "cpu") -> dict:
    """``make_pod_compressed_grad_fn`` of ``lm_loss`` (remat "full") over a
    (world, 1, 1) ("pod", "data", "model") mesh, weights made from
    ``seed``, each pod its slice of ``batch``'s rows, zero errors: each
    leaf's largest distance from the exact mean of the pods' gradients
    (all-reduced here) over its largest magnitude, and whether every new
    error is exactly ``corrected - q * scale`` of the shared row scale."""
    import torch
    import torch.distributed as dist
    from ..models.model import _leaves, _tree, lm_loss
    from ..optim.compress import init_error_state, make_pod_compressed_grad_fn
    dev = _device(device)
    mesh = make_mesh(device, (world, 1, 1))
    cfg = config(arch, reduced, layers)
    params = weights(cfg, None, seed, dev)
    batch = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in
             batch.items()}

    def loss_fn(p, b):
        return lm_loss(p, cfg, b["tokens"], b["labels"], remat="full")

    fn = make_pod_compressed_grad_fn(loss_fn, mesh)
    flat = dict(_leaves(params))
    err0 = init_error_state(params)
    grads, loss, new_err = fn(params, batch, err0)
    rows = batch["tokens"].shape[0] // world
    mine = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
    leaves = {n: t.detach().requires_grad_(True) for n, t in flat.items()}
    own = torch.autograd.grad(loss_fn(_tree(leaves), mine),
                              list(leaves.values()))
    rel, exact_error = {}, True
    for (n, g_own), (_, g) in zip(zip(leaves, own), _leaves(grads)):
        exact = g_own.float().clone()
        dist.all_reduce(exact, op=dist.ReduceOp.SUM)
        exact /= world
        rel[n] = float((g - exact).abs().max() / exact.abs().max())
        corrected = g_own.float()
        amax = corrected.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(amax, min=1e-20) / 127.0
        dist.all_reduce(scale, op=dist.ReduceOp.MAX)
        q = torch.clamp(torch.round(corrected / scale), -127, 127)
        exact_error &= bool(torch.equal(dict(_leaves(new_err))[n],
                                        corrected - q * scale))
    return {"loss": float(loss), "rel": rel, "exact_error": exact_error}


def serve_steps(rank: int, world: int, arch: str, tokens: np.ndarray,
                decode: np.ndarray, *, mesh_shape: tuple, s_max: int, tree,
                device: str = "cpu") -> dict:
    """One prefill of ``tokens`` (B, S) and a decode step of each row of
    ``decode`` (n, B) at positions S, S + 1, ... on a ``mesh_shape`` mesh
    of the reduced ``arch`` from the numpy parameter ``tree``, f32, cache of
    length ``s_max``.  Returns the logits of each step and (rank 0) every
    cache leaf after each, gathered whole; after each step the leaves not
    laid out by ``cache_shardings`` (none expected); this rank's local
    cache shapes and bytes; per decode step
    :class:`~repro_torch.launch.hlo_analysis.StepStats`' collectives (by
    kind, total and largest operand bytes, each operand's shapes); and the
    type and shape of every q ``flash_attention`` ran on."""
    import torch
    from ..launch.hlo_analysis import StepStats, collective_stats, local_bytes
    from ..models import attention as A
    from ..models import init_cache
    from ..models.model import _leaves
    from ..runtime import sharding as SH
    from ..runtime.steps import (make_decode_step, make_prefill_step,
                                 shard_serve_state)
    dev = _device(device)
    mesh = make_mesh(device, mesh_shape)
    cfg = config(arch)
    B, S = tokens.shape
    params, cache, _ = shard_serve_state(
        cfg, B, weights(cfg, tree, 0, dev), init_cache(cfg, B, s_max,
                                                       device=dev), mesh)
    prefill = make_prefill_step(cfg, B, s_max, device=dev, mesh=mesh)
    step = make_decode_step(cfg, B, s_max, device=dev, mesh=mesh)
    out: dict = {"logits": [], "cache": [], "stray": [], "collectives": []}

    def record(logits, cache):
        out["logits"].append(_whole(logits))
        specs = dict(_leaves(SH.cache_shardings(cfg, B, mesh, cache)))
        out["stray"].append(sorted(
            n for n, t in _leaves(cache)
            if tuple(t.placements) != SH.placements(specs[n], mesh)))
        whole = {n: _whole(t) for n, t in _leaves(cache)}
        out["cache"].append(whole if rank == 0 else None)

    seen: set = set()
    flash = A.flash_attention

    def recording(q, k, v, *, causal=True):
        seen.add((type(q).__name__, tuple(q.shape)))
        return flash(q, k, v, causal=causal)
    A.flash_attention = recording
    try:
        logits, cache = prefill(params, cache, {"tokens": tokens})
    finally:
        A.flash_attention = flash
    out["attention"] = sorted(seen)
    record(logits, cache)
    out["local_shapes"] = {n: tuple(t.to_local().shape)
                           for n, t in _leaves(cache)}
    out["local_cache_bytes"] = local_bytes(cache)
    for i, tok in enumerate(decode):
        pos = torch.full((B,), S + i, dtype=torch.long)
        with StepStats((params, cache)) as st:
            logits, cache = step(params, cache,
                                 torch.as_tensor(tok)[:, None], pos)
        out["collectives"].append(collective_stats(st).to_json()
                                  | {"operands": st.operands})
        record(logits, cache)
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro")
                            or m.split(".")[0].startswith("test_"))
    return out


__all__ = ["AXES", "config", "make_mesh", "weights", "train_steps",
           "restore", "pod_compress", "pod_lm", "serve_steps"]
