"""The port's shape-only step inputs, its step statistics and its dry-run,
against the reference package.

* ``input_specs`` for the 10 architectures x 4 shapes on shape-only meshes
  (``MeshShape``) of 1x1, 16x16 and 2x16x16 give the reference's
  ``input_specs`` (on an ``AbstractMesh``) entry for entry: the same keys,
  shapes and types (int32 tokens, labels and positions; the reference's
  ``tests/test_launch.py::TestInputSpecs`` figures among them) and the same
  specs, every leaf on the meta device; and each device's argument bytes,
  reckoned from the specs (each leaf's shape divided by the mesh axes its
  spec names, times its type's bytes), equal the reference's.  The
  reference's ``abstract_*`` trees likewise, and the port's
  ``abstract_params`` types are its own ``init_params``'.
* The statistics (``launch/hlo_analysis.py``), with known answers
  translated from ``tests/test_hlo_analysis.py``: a matmul's operations
  exactly, a loop of n matmuls n times one, their gradient (both operands
  requiring one) 3n times, no collective on one rank, the memory keys.
* On a fake 16x16 world (``torch.distributed``'s ``fake`` backend), in a
  subprocess: a (128, 4096) x (4096, 4096) product with x split over data
  and w over model counted at 1/256 of its global operations; an
  all-gather's and a reduce-scatter's bytes by the operand rule;
  ``input_specs`` on the fake ``DeviceMesh`` as DTensors over meta local
  shards whose bytes are the shape-only reckoning; and one
  ``launch/dryrun.py`` cell of reduced yi-6b writing a record with the
  reference's keys (the reduced configs substituted in the subprocess).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
from jax.sharding import AbstractMesh                       # noqa: E402

from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.configs import SHAPES as JSHAPES                 # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig   # noqa: E402
from repro.runtime import steps as JS                       # noqa: E402

from repro_torch.configs import ARCHS, SHAPES               # noqa: E402
from repro_torch.launch import hlo_analysis as HA           # noqa: E402
from repro_torch.models import init_params                  # noqa: E402
from repro_torch.models import model as TM                  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig             # noqa: E402
from repro_torch.runtime import sharding as SH              # noqa: E402
from repro_torch.runtime import steps as TS                 # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ITEM = {"bfloat16": 2, "float32": 4, "int32": 4, "int8": 1}
FAKE_TIMEOUT = 600


def _jflat(tree) -> dict:
    """path -> (shape, type name, spec) of the reference's stand-ins."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        spec = getattr(leaf, "sharding", None)
        out[name] = (tuple(leaf.shape), str(leaf.dtype),
                     None if spec is None else tuple(spec.spec))
    return out


def _tflat(tree) -> dict:
    """The same of the port's (``Sharded`` leaves or meta tensors)."""
    out = {}
    for name, leaf in tree.items() if "" in tree else TM._leaves(tree):
        t, spec = (leaf.tensor, leaf.spec) if isinstance(
            leaf, TS.Sharded) else (leaf, None)
        assert t.device.type == "meta", name
        out[name] = (tuple(t.shape), str(t.dtype).split(".")[-1], spec)
    return out


def _bytes(flat: dict, sizes: dict) -> int:
    """Per-device bytes reckoned from (shape, type, spec) leaves."""
    total = 0
    for shape, dtype, spec in flat.values():
        n = 1
        for dim, s in zip(shape, tuple(spec) + (None,) * len(shape)):
            div = 1
            for a in (s if isinstance(s, tuple) else (s,) if s else ()):
                div *= sizes[a]
            n *= dim // div
        total += n * ITEM[dtype]
    return total


def _memo(fn):
    """``fn`` (one of the reference's ``abstract_*``: ``jax.eval_shape``,
    the same trees for the same arguments) answering a repeated call from
    its first."""
    seen = {}

    def call(*args, **kw):
        key = repr((args, kw))
        if key not in seen:
            seen[key] = fn(*args, **kw)
        return seen[key]
    return call


@pytest.fixture(scope="module")
def references():
    """(mesh, arch, shape) -> the reference's input_specs, flattened.  Its
    own input_specs runs for every cell; the eval_shape trees it asks for
    again (the same arch's parameters on the next mesh) are taken from the
    first call."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("abstract_params", "abstract_opt_state",
                     "abstract_cache"):
            mp.setattr(JS, name, _memo(getattr(JS, name)))
        for key, (sizes, names) in MESHES.items():
            m = AbstractMesh(sizes, names)
            for arch in ARCHS:
                for shape in SHAPES:
                    specs = JS.input_specs(JARCHS[arch], JSHAPES[shape], m)
                    out[key, arch, shape] = {k: _jflat(v)
                                             for k, v in specs.items()}
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh", MESHES)
def test_input_specs_are_the_references(references, mesh, arch, shape):
    """Keys, shapes, types and specs entry for entry, every leaf on meta,
    and the per-device argument bytes equal (no difference to explain:
    the shapes, types and specs are the same)."""
    sizes, names = MESHES[mesh]
    ms = SH.MeshShape(sizes, names)
    got = TS.input_specs(ARCHS[arch], SHAPES[shape], ms)
    want = references[mesh, arch, shape]
    assert set(got) == set(want)
    axes = dict(zip(names, sizes))
    for k, v in got.items():
        assert _tflat(v if isinstance(v, dict) else {"": v}) == want[k], k
        assert HA.local_bytes(v, ms) == _bytes(want[k], axes), k


def test_input_specs_carry_the_reference_test_figures():
    """The reference's TestInputSpecs contract on a 1x1 mesh."""
    ms = SH.MeshShape((1, 1), ("data", "model"))
    s = TS.input_specs(ARCHS["yi-6b"], SHAPES["train_4k"], ms)
    assert set(s) == {"params", "opt_state", "batch"}
    assert s["batch"]["tokens"].tensor.shape == (256, 4096)
    assert s["batch"]["tokens"].tensor.dtype == torch.int32
    s = TS.input_specs(ARCHS["glm4-9b"], SHAPES["prefill_32k"], ms)
    assert set(s) == {"params", "cache", "batch"}
    assert s["batch"]["tokens"].tensor.shape == (32, 32768)
    s = TS.input_specs(ARCHS["granite-8b"], SHAPES["decode_32k"], ms)
    assert set(s) == {"params", "cache", "token", "pos"}
    assert s["token"].tensor.shape == (128, 1)
    assert s["pos"].tensor.shape == (128,)
    assert s["cache"]["pos_0"]["k"].tensor.shape[2] == 32768
    s = TS.input_specs(ARCHS["whisper-large-v3"], SHAPES["prefill_32k"], ms)
    assert s["batch"]["enc_frames"].tensor.shape == (32, 1500, 1280)
    s = TS.input_specs(ARCHS["qwen2-vl-72b"], SHAPES["train_4k"], ms)
    assert s["batch"]["patch_embeds"].tensor.shape == (256, 1024, 8192)
    s = TS.input_specs(ARCHS["qwen2-vl-72b"], SHAPES["decode_32k"], ms)
    assert "patch_embeds" not in s


@pytest.mark.parametrize("arch", list(ARCHS))
def test_abstract_trees_are_the_references(arch):
    """abstract_params (bf16 and f32), abstract_opt_state (f32 and int8
    moments) and abstract_cache against the reference's eval_shape trees,
    shape and type of every leaf, on meta."""
    jc, tc = JARCHS[arch], ARCHS[arch]
    import jax.numpy as jnp
    for jd, td in ((jnp.bfloat16, torch.bfloat16),
                   (jnp.float32, torch.float32)):
        assert _tflat(TS.abstract_params(tc, td)) == \
            _jflat(JS.abstract_params(jc, jd))
    for q in (False, True):
        assert _tflat(TS.abstract_opt_state(tc, AdamWConfig(
            quantize_states=q))) == _jflat(JS.abstract_opt_state(
                jc, JAdamWConfig(quantize_states=q)))
    for b in (4, 1):
        assert _tflat(TS.abstract_cache(tc, b, 4096)) == \
            _jflat(JS.abstract_cache(jc, b, 4096))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_abstract_params_have_init_params_types(arch):
    """The F32_PARAMS rule gives the types the port's own init_params
    gives a bf16 tree (on the reduced config)."""
    cfg = ARCHS[arch].reduced()
    made = init_params(torch.Generator().manual_seed(0), cfg,
                       dtype=torch.bfloat16)
    meta = dict(TM._leaves(TS.abstract_params(cfg)))
    for n, t in TM._leaves(made):
        assert (meta[n].dtype, tuple(meta[n].shape)) == \
            (t.dtype, tuple(t.shape)), n


# =============================================================================
# statistics: known answers
# =============================================================================

def _stats(fn, *args):
    with HA.StepStats(args) as st:
        out = fn(*args)
    return st, out


def test_plain_matmul_exact():
    M, K, N = 128, 256, 512
    st, _ = _stats(lambda a, b: a @ b, torch.ones(M, K), torch.ones(K, N))
    assert HA.trip_aware_stats(st)["flops_dot"] == 2 * M * K * N
    assert HA.cost_stats(st)["flops"] == 2 * M * K * N


@pytest.mark.parametrize("n", [2, 8])
def test_loop_counts_every_iteration(n):
    M = 128

    def f(x, w):
        for _ in range(n):
            x = x @ w
        return x.sum()

    st, _ = _stats(f, torch.ones(M, M), torch.ones(M, M))
    assert st.flops_dot == 2 * n * M ** 3


def test_grad_of_loop():
    """Forward n products, backward 2n (each step's gradient to both of
    its operands)."""
    n, M = 8, 128
    x = torch.ones(M, M, requires_grad=True)
    w = torch.ones(M, M, requires_grad=True)

    def f(x, w):
        c = x
        for _ in range(n):
            c = c @ w
        return torch.autograd.grad(c.sum(), [x, w])

    st, _ = _stats(f, x, w)
    assert st.flops_dot == 2 * 3 * n * M ** 3


def test_memory_and_cost_stats_present():
    a = torch.ones(64, 64)
    st, out = _stats(lambda a: (a @ a).sum(), a)
    m = HA.memory_stats(st, out)
    assert m["argument_size_in_bytes"] == 64 * 64 * 4
    assert m["output_size_in_bytes"] == 4
    # a @ a and its sum alive at once
    assert m["temp_size_in_bytes"] == 64 * 64 * 4 + 4
    assert HA.cost_stats(st)["flops"] == 2 * 64 ** 3


def test_temporaries_are_released():
    """A temporary freed before the next one is allocated is not counted
    twice."""
    def f(a):
        for _ in range(4):
            b = a * 2.0
            del b
        return a.sum()

    st, _ = _stats(f, torch.ones(256, 256))
    assert st.peak == 256 * 256 * 4


def test_collective_stats_empty_on_single_device():
    st, _ = _stats(lambda a: (a @ a).sum(), torch.ones(64, 64))
    s = HA.collective_stats(st)
    assert s.total_bytes == 0.0 and s.n_ops == 0


def test_trip_aware_no_loops():
    st, _ = _stats(lambda a: a * 2, torch.ones(8))
    assert HA.trip_aware_stats(st)["flops_dot"] == 0.0


# =============================================================================
# a fake world of 256 ranks, in a subprocess
# =============================================================================

FAKE = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
torch.set_num_threads(1)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import hlo_analysis as HA
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.steps import input_specs

def meta(shape, pl):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local
    loc, _ = local(shape, mesh, pl)
    return DTensor.from_local(torch.empty(loc, device="meta"), mesh, pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())

out = {}
x = meta((128, 4096), (Shard(0), Replicate()))
w = meta((4096, 4096), (Replicate(), Shard(0)))
with HA.StepStats((x, w)) as st:
    y = x @ w
out["matmul"] = st.flops
a = meta((128, 4096), (Shard(0), Replicate()))
with HA.StepStats((a,)) as st:
    a.redistribute(mesh, (Replicate(), Replicate()))
out["all_gather"] = [st.by_kind, st.n_ops]
p = DTensor.from_local(torch.empty(128, 4096, device="meta"), mesh,
                       (Partial(), Replicate()), run_check=False)
with HA.StepStats((p,)) as st:
    p.redistribute(mesh, (Shard(0), Replicate()))
out["reduce_scatter"] = [st.by_kind, st.n_ops]
specs = {}
for arch, shape in (("yi-6b", "train_4k"), ("jamba-v0.1-52b", "decode_32k"),
                    ("whisper-large-v3", "prefill_32k")):
    on_mesh = input_specs(ARCHS[arch], SHAPES[shape], mesh)
    shaped = input_specs(ARCHS[arch], SHAPES[shape],
                         SH.MeshShape((16, 16), ("data", "model")))
    metas = all(t.to_local().device.type == "meta"
                for part in on_mesh.values()
                for t in (part.values() if isinstance(part, dict) else [part])
                if isinstance(t, DTensor))
    specs[arch + "/" + shape] = [
        sum(HA.local_bytes(v) for v in on_mesh.values()),
        sum(HA.local_bytes(v, SH.MeshShape((16, 16), ("data", "model")))
            for v in shaped.values()), metas]
out["specs"] = specs
print("RESULT " + json.dumps(out))
"""

DRYRUN = r"""
import sys
import torch
torch.set_num_threads(1)
from repro_torch import configs
for name in list(configs.ARCHS):
    configs.ARCHS[name] = configs.ARCHS[name].reduced()
from repro_torch.launch import dryrun
dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k", "--out",
             sys.argv[1]])
"""


def _run(code, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-c", code, *argv], env=env,
                          capture_output=True, text=True,
                          timeout=FAKE_TIMEOUT)


@pytest.fixture(scope="module")
def fake():
    out = _run(FAKE)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def test_sharded_matmul_counts_each_ranks_share(fake):
    """x split over data (16) and w over model (16): each rank's product
    is 1/256 of the global 2 * 128 * 4096 * 4096 (which FlopCounterMode
    over the DTensors reads)."""
    assert fake["matmul"] == 2 * 128 * 4096 * 4096 / 256


def test_all_gather_bytes_by_the_operand_rule(fake):
    """(128, 4096) f32 split over data gathered whole: one all-gather over
    data, its operand result / group = 2 MiB / 16."""
    by_kind, n = fake["all_gather"]
    assert by_kind == {"all-gather": 128 * 4096 * 4 / 16} and n == 1


def test_reduce_scatter_bytes_by_the_operand_rule(fake):
    """A partial sum over data scattered to rows: operand result x group =
    the whole (128, 4096) f32 a rank puts in."""
    by_kind, n = fake["reduce_scatter"]
    assert by_kind == {"reduce-scatter": 128 * 4096 * 4} and n == 1


def test_input_specs_on_a_fake_device_mesh(fake):
    """DTensors over meta local shards, each rank's bytes those the
    shape-only mesh reckons."""
    for key, (on_mesh, shaped, metas) in fake["specs"].items():
        assert on_mesh == shaped and metas, key


def test_dryrun_cell_writes_the_references_record(tmp_path):
    """One cell of reduced yi-6b on the fake 16x16 world: the record has
    the reference's keys, less its TPU estimates
    (``per_device_bytes_tpu_est``, ``fits_hbm_tpu_est``) and
    ``compile_s`` (nothing is compiled), and ``fits_hbm`` against the
    H100's memory."""
    out = _run(DRYRUN, str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "yi-6b__decode_32k__singlepod.json")
                     .read_text())
    assert set(rec) == {"arch", "shape", "mesh", "remat", "n_devices",
                        "lower_s", "memory", "cost", "collectives",
                        "trip_aware", "per_device_bytes", "fits_hbm"}
    assert rec["n_devices"] == 256 and rec["fits_hbm"] is True
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert rec["per_device_bytes"] == (
        rec["memory"]["argument_size_in_bytes"]
        + rec["memory"]["temp_size_in_bytes"])
    assert rec["cost"]["flops"] > 0
    assert rec["trip_aware"]["flops_dot"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert "ok lower=" in out.stdout
