"""The port's sharding rules, hints and gradient compression against the
reference package, in one process.

* Rules: for every architecture at its published widths and on meshes of
  (1, 1), (2, 4), (16, 16) and (2, 16, 16) ranks, every parameter's,
  optimizer-state leaf's (f32 and int8 states), batch entry's and cache
  leaf's spec equals the reference's ``PartitionSpec`` on a shape-only mesh
  (``AbstractMesh`` there, ``MeshShape`` here).  The reference's shapes come
  from ``jax.eval_shape``, the port's from ``param_shapes`` and tensors on
  the meta device: nothing is allocated.
* Specs on a ``DeviceMesh``: an entry spanning two mesh axes is ``Shard(d)``
  on each; a dimension of size 1 stays whole.
* Compression: ``quantize_int8``, ``dequantize_int8`` and
  ``ef_compress_tree`` bit for bit the reference's on seeded inputs (the
  same f32 operations: abs-max, clamp, divide, round half to even).
* Hints: ``constrain`` is the identity outside ``activation_hints``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402
from jax.sharding import AbstractMesh                       # noqa: E402

from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.optim import compress as JC                      # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig   # noqa: E402
from repro.runtime import sharding as JSH                   # noqa: E402
from repro.runtime.steps import (abstract_cache,            # noqa: E402
                                 abstract_opt_state, abstract_params)

from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.models import model as TM                  # noqa: E402
from repro_torch.optim import compress as TC                # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.runtime import hints as TH                 # noqa: E402
from repro_torch.runtime import sharding as SH              # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCH_NAMES = tuple(ARCHS)
S_MAX = 4096


def _meshes(key):
    sizes, names = MESHES[key]
    return AbstractMesh(sizes, names), SH.MeshShape(sizes, names)


def _jflat(tree) -> dict:
    """The reference's spec tree as "/"-joined paths -> spec tuples."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: hasattr(x, "spec")):
        out["/".join(str(getattr(k, "key", k)) for k in path)] = \
            tuple(leaf.spec)
    return out


def _meta(shapes: dict) -> dict:
    return TM._tree({n: torch.empty(s, device="meta")
                     for n, s in shapes.items()})


@pytest.fixture(scope="module")
def shapes():
    """arch -> (reference params, f32 and int8 opt states, caches of B = 4
    and 1, all abstract; the port's params, opt states and caches on the
    meta device)."""
    out = {}
    for name in ARCH_NAMES:
        jc, tc = JARCHS[name], ARCHS[name]
        jp = abstract_params(jc, jnp.float32)
        jo = {q: abstract_opt_state(jc, JAdamWConfig(quantize_states=q),
                                    jnp.float32) for q in (False, True)}
        jcache = {b: abstract_cache(jc, b, S_MAX) for b in (4, 1)}
        tp = _meta(TM.param_shapes(tc))
        to = {q: init_opt_state(tp, AdamWConfig(quantize_states=q))
              for q in (False, True)}
        tcache = {b: TM.init_cache(tc, b, S_MAX, device="meta")
                  for b in (4, 1)}
        out[name] = (jp, jo, jcache, tp, to, tcache)
    return out


def _hold(want: dict, got: dict) -> None:
    assert set(want) == set(got)
    bad = {n: (want[n], got[n]) for n in want if want[n] != got[n]}
    assert not bad, bad


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_parameter_specs_are_the_references(shapes, name, mesh):
    jm, tm = _meshes(mesh)
    jp, _, _, tp, _, _ = shapes[name]
    _hold(_jflat(JSH.param_shardings(JARCHS[name], jp, jm)),
          dict(TM._leaves(SH.param_shardings(ARCHS[name], tp, tm))))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_opt_state_specs_are_the_references(shapes, name, mesh, quantize):
    """Moments follow their parameter; an int8 moment's row scale drops the
    parameter's last axis; the step count is replicated."""
    jm, tm = _meshes(mesh)
    _, jo, _, _, to, _ = shapes[name]
    want = _jflat(JSH.opt_state_shardings(JARCHS[name], jo[quantize], jm))
    got = dict(TM._leaves(SH.opt_state_shardings(ARCHS[name], to[quantize],
                                                  tm)))
    _hold(want, got)
    assert got["step"] == ()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_batch_and_cache_specs_are_the_references(shapes, name, mesh):
    """A batch the data-parallel ranks divide and one they do not (B = 1:
    the rows stay whole); the cache at B = 4 and at B = 1, where the KV
    pages fall back to sharding their sequence over (data, model)."""
    jm, tm = _meshes(mesh)
    _, _, jcache, _, _, tcache = shapes[name]
    jc, tc = JARCHS[name], ARCHS[name]
    for b in (512, 4, 1):
        want = {k: tuple(v.spec) for k, v in
                JSH.batch_shardings(jc, b, jm).items()}
        _hold(want, SH.batch_shardings(tc, b, tm))
    for b in (4, 1):
        _hold(_jflat(JSH.cache_shardings(jc, b, jm, jcache[b])),
              dict(TM._leaves(SH.cache_shardings(tc, b, tm, tcache[b]))))


def test_rules_shard_what_the_mesh_divides():
    """Spot checks at production sizes: olmoe's 64 experts expert-parallel
    over model; grok-1's 8 experts stay together (TP on d_ff); whisper's
    vocab 51866 left whole; long_500k's B = 1 KV pages sequence-sharded
    over (data, model)."""
    tm = SH.MeshShape((16, 16), ("data", "model"))
    olmoe = SH.param_shardings(ARCHS["olmoe-1b-7b"], _meta(TM.param_shapes(
        ARCHS["olmoe-1b-7b"])), tm)
    assert olmoe["groups"]["pos_0"]["moe"]["w_up"] == (None, "model",
                                                       "data", None)
    assert olmoe["groups"]["pos_0"]["mixer"]["wq"] == (None, "data", "model")
    grok = SH.param_shardings(ARCHS["grok-1-314b"], _meta(TM.param_shapes(
        ARCHS["grok-1-314b"])), tm)
    assert grok["groups"]["pos_0"]["moe"]["w_down"] == (None, None, "model",
                                                        "data")
    whisper = SH.param_shardings(ARCHS["whisper-large-v3"], _meta(
        TM.param_shapes(ARCHS["whisper-large-v3"])), tm)
    assert whisper["embed"] == (None, None)
    cfg = ARCHS["jamba-v0.1-52b"]
    cache = SH.cache_shardings(cfg, 1, tm,
                               TM.init_cache(cfg, 1, S_MAX, device="meta"))
    kv = [s for n, s in TM._leaves(cache) if n.endswith("/k")]
    assert kv and all(s[2] == ("data", "model") for s in kv)


def _fake_mesh(sizes, names):
    """What :func:`placements` reads of a DeviceMesh: names and sizes."""
    return types.SimpleNamespace(mesh_dim_names=names,
                                 mesh=np.zeros(sizes))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _fake_mesh((2, 2, 2), ("pod", "data", "model"))
    assert SH.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert SH.placements((None, "data"), mesh) == (Replicate(), Shard(1),
                                                   Replicate())
    assert SH.placements((), mesh) == (Replicate(),) * 3
    # a mesh dimension of one rank: its shard is the whole tensor
    one = _fake_mesh((1, 2), ("data", "model"))
    assert SH.placements(("data", "model"), one) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="shards two dimensions"):
        SH.placements(("model", "model"), mesh)


# =============================================================================
# compression
# =============================================================================

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((16, 32), dtype=np.float32),
            "b": {"c": (rng.standard_normal((3, 4, 64), dtype=np.float32)
                        * np.float32(1e-3))},
            "z": np.zeros((2, 8), np.float32)}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree).copy())


def _same(got, want):
    if isinstance(want, dict):
        for k in want:
            _same(got[k], want[k])
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    assert np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_dequantize_are_the_references(seed):
    for x in jax.tree.leaves(_grads(seed)):
        jq, js = JC.quantize_int8(jnp.asarray(x))
        tq, ts = TC.quantize_int8(torch.from_numpy(x))
        _same(tq, jq)
        _same(ts, js)
        _same(TC.dequantize_int8(tq, ts), JC.dequantize_int8(jq, js))


@pytest.mark.parametrize("seed", [0, 1])
def test_error_feedback_tree_is_the_references(seed):
    g, e = _grads(seed), jax.tree.map(lambda a: a * np.float32(0.01),
                                      _grads(seed + 10))
    jq, js, je = JC.ef_compress_tree(jax.tree.map(jnp.asarray, g),
                                     jax.tree.map(jnp.asarray, e))
    tq, ts, te = TC.ef_compress_tree(_t(g), _t(e))
    _same(tq, jq)
    _same(ts, js)
    _same(te, je)
    zeros = TC.init_error_state(_t(g))
    _same(zeros, JC.init_error_state(g))


# =============================================================================
# hints
# =============================================================================

def test_constrain_is_the_identity_outside_the_hints():
    x = torch.randn(2, 8, 4, 16)
    assert not TH.active()
    assert TH.constrain(x, "dp", None, "tp", None) is x
    assert TH.axis_size("dp") == TH.axis_size("tp") == 1
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=np.zeros((2, 4)))
    with TH.activation_hints(mesh, ("data",), "model"):
        assert TH.active() and TH.axis_size("tp") == 4
        assert TH.axis_size("dp") == 2
        assert TH.spec_of(x.shape, "dp", None, "tp", None) == (
            "data", None, "model", None)
        # a dimension the axis does not divide stays whole
        assert TH.spec_of((3, 8, 6, 16), "dp", None, "tp", None) == (
            None, None, None, None)
        # a plain tensor (replicated by the step) passes as it is
        assert TH.constrain(x, "dp", None, "tp", None) is x
    assert not TH.active()
