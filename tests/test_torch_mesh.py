"""The port's train step on a device mesh, on the CPU, against the
unsharded step of both packages.

Ranks are spawned by ``repro_torch.testing.ranks.run_ranks`` (fresh
interpreters joining a gloo process group through a ``file://`` store of
their own, one intra-op thread each) and run the cases of
``repro_torch.testing.mesh_cases``; one spawn per scenario, module-scoped,
each under its own timeout.  Weights are the reference's
``init_params(PRNGKey(0))`` of the reduced configs, carried to every rank as
numpy; batches come from seeded numpy generators.

* Step parity on a 2 x 2 ("data", "model") mesh: reduced yi-6b and olmoe
  (its 4 experts expert-parallel over model), two steps of f32 states, 4
  rows in 2 microbatches: loss, lr, grad_norm and every parameter after
  each step within 2e-4 x max(1, max|ref|) of the port's unsharded step and
  of the reference's on its host mesh (FSDP's sums split over data reduce
  in another order); every parameter laid out by the rules.  One yi-6b step
  with int8 states, held as ``tests/test_torch_train.py`` holds int8 (the
  reference's amplified updates to their sign).
* The recurrent mixers on the 2 x 2 mesh: one step of reduced jamba and
  xlstm within the same tolerance of both unsharded steps.
* A 1 x 1 mesh (``make_host_mesh("cpu")``, in this process) bit for bit the
  unsharded step.
* Pod compression on 2 ranks forming the pod axis: ``compressed_psum``'s
  per-pod outputs and errors equal the reference's under
  ``jax.vmap(axis_name="pod")`` on the same stacked gradients, and the
  2-pod compressed gradient of the reference test's loss within 0.02 of
  the exact one (the reference's TestPodCompression bound).
* Sharded restore: the 2 x 2 run's checkpoint restored onto a 4 x 1 mesh
  (``FaultTolerantLoop.try_restore(shardings=)``) and onto a world of 2
  (``elastic_remesh``): every leaf bit for bit the saved one, laid out by
  the new mesh's rules, resuming at the saved ``next_step``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.launch.mesh import make_host_mesh as jhost_mesh  # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.optim import adamw as JO                         # noqa: E402
from repro.optim import compress as JC                      # noqa: E402
from repro.runtime.steps import make_train_step as jmake_step  # noqa: E402

from repro_torch.checkpoint import CheckpointStore          # noqa: E402
from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.launch.mesh import make_host_mesh          # noqa: E402
from repro_torch.models import model as TM                  # noqa: E402
from repro_torch.models import params_from_numpy            # noqa: E402
from repro_torch.optim import adamw as TO                   # noqa: E402
from repro_torch.runtime import sharding as SH              # noqa: E402
from repro_torch.runtime.steps import make_train_step       # noqa: E402
from repro_torch.testing.ranks import run_ranks             # noqa: E402

CASES = "repro_torch.testing.mesh_cases"
TOL = 2e-4
WORLD, MESH = 4, (2, 2)
SPAWN_TIMEOUT = 150
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
ROWS = {"yi-6b": (4, 64), "olmoe-1b-7b": (4, 256)}
STEPS = 2
MBS = 2
AMPLIFIED = 1.5          # as tests/test_torch_train.py


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this process's steps, as each spawned rank
    has (beside the other test workers, small ops stall in a pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = tol * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= lim


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batches(vocab, arch, n, seed):
    B, S = ROWS[arch]
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(n)]


@pytest.fixture(scope="module")
def trees():
    out = {}
    for arch in ROWS:
        jc, tc = JARCHS[arch].reduced(), ARCHS[arch].reduced()
        jp = JM.init_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
        out[arch] = (jc, tc, jp, jax.tree.map(np.asarray, jp))
    return out


def _reference(trees, arch, quantize, batches):
    """(metrics, flat parameters) after each step of the reference's step
    on its host mesh."""
    jc, _, jp, _ = trees[arch]
    cfg = JO.AdamWConfig(**OPT, quantize_states=quantize)
    with jhost_mesh() as m:
        jstep = jax.jit(jmake_step(jc, m, cfg, remat="full",
                                   dtype=jnp.float32, microbatches=MBS)[0])
        jpp, jo = jp, JO.init_opt_state(jp, cfg)
        out = []
        for b in batches:
            jpp, jo, jm = jstep(jpp, jo, jax.tree.map(jnp.asarray, b))
            out.append(({k: float(v) for k, v in jm.items()}, _jflat(jpp)))
    return out


def _port(trees, arch, quantize, batches, mesh=None):
    """The same from the port's step, unsharded or on ``mesh``."""
    _, tc, _, tree = trees[arch]
    cfg = TO.AdamWConfig(**OPT, quantize_states=quantize)
    tp = params_from_numpy(tree, tc, "cpu")
    to = TO.init_opt_state(tp, cfg)
    step = make_train_step(tc, cfg, device="cpu", microbatches=MBS,
                           mesh=mesh)
    out = []
    for b in batches:
        tp, to, tm = step(tp, to, b)
        out.append(({k: float(v) for k, v in tm.items()},
                    {n: (t.full_tensor() if hasattr(t, "full_tensor")
                         else t).numpy().copy() for n, t in TM._leaves(tp)}))
    return out


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """arch -> (reference, port unsharded, the 2x2 ranks' results) of two
    f32 steps; yi-6b's final state saved to a checkpoint."""
    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    out = {}
    for arch in ROWS:
        batches = _batches(trees[arch][1].vocab, arch, STEPS, 50)
        ref = _reference(trees, arch, False, batches)
        port = _port(trees, arch, False, batches)
        res = run_ranks(f"{CASES}:train_steps", WORLD, arch, batches,
                        mesh_shape=MESH, opt=OPT, tree=trees[arch][3],
                        microbatches=MBS,
                        save=str(ckpt) if arch == "yi-6b" else None,
                        timeout=SPAWN_TIMEOUT)
        out[arch] = (ref, port, res)
    return out, ckpt


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch", ROWS)
def test_mesh_step_matches_the_unsharded_steps(runs, arch, step, against):
    ref, port, res = runs[0][arch]
    want_m, want_p = (port if against == "port" else ref)[step]
    for r in res:
        for k in ("loss", "lr", "grad_norm"):
            close(r["metrics"][step][k], want_m[k])
    got = res[0]["params"][step]
    assert set(got) == set(want_p)
    for n, w in want_p.items():
        close(got[n], w)


@pytest.mark.parametrize("arch", ROWS)
def test_mesh_step_lays_parameters_out_by_the_rules(trees, runs, arch):
    """Every rank's parameters after the steps carry the rules' placements
    on the 2 x 2 mesh and hold their share of each dimension (olmoe's
    experts split over model)."""
    from types import SimpleNamespace
    tc = trees[arch][1]
    fake = SimpleNamespace(mesh_dim_names=("data", "model"),
                           mesh=np.zeros(MESH))
    shapes = TM.param_shapes(tc)
    specs = dict(TM._leaves(SH.param_shardings(tc, TM._tree(shapes), fake)))
    for r in runs[0][arch][2]:
        for n, spec in specs.items():
            assert r["placements"][n] == [str(p) for p in
                                          SH.placements(spec, fake)], n
            local = list(shapes[n])
            for d, s in enumerate(spec):
                for a in (s if isinstance(s, tuple) else (s,) if s else ()):
                    local[d] //= MESH[("data", "model").index(a)]
            assert r["local_shapes"][n] == tuple(local), n
    if arch == "olmoe-1b-7b":
        assert specs["groups/pos_0/moe/w_up"][1] == "model"


RECURRENT = {"jamba-v0.1-52b": (4, 64), "xlstm-1.3b": (4, 64)}


@pytest.fixture(scope="module")
def recurrent_runs():
    """arch -> (reference, port unsharded, the 2x2 ranks' results) of one
    f32 step of the reduced recurrent configs."""
    out = {}
    for arch, (B, S) in RECURRENT.items():
        jc, tc = JARCHS[arch].reduced(), ARCHS[arch].reduced()
        jp = JM.init_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
        trees = {arch: (jc, tc, jp, jax.tree.map(np.asarray, jp))}
        rng = np.random.default_rng(53)
        batches = [{k: rng.integers(0, tc.vocab, (B, S)).astype(np.int32)
                    for k in ("tokens", "labels")}]
        res = run_ranks(f"{CASES}:train_steps", WORLD, arch, batches,
                        mesh_shape=MESH, opt=OPT, tree=trees[arch][3],
                        microbatches=MBS, timeout=SPAWN_TIMEOUT)
        out[arch] = (_reference(trees, arch, False, batches),
                     _port(trees, arch, False, batches), res)
    return out


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_mesh_step_of_the_recurrent_mixers_matches_the_unsharded_step(
        recurrent_runs, arch, against):
    """One f32 step of reduced jamba (Mamba channels split over model, its
    4 experts expert-parallel) and xlstm (mLSTM heads split over model, the
    sLSTM recurrence on each rank's rows) on the 2 x 2 mesh, the scans and
    the experts on each rank's shards (``hints.on_ranks``, whose whole
    arguments take partial gradients): loss, lr, grad_norm and every
    parameter within 2e-4 x max(1, max|ref|) of the port's unsharded step
    and of the reference's."""
    ref, port, res = recurrent_runs[arch]
    want_m, want_p = (port if against == "port" else ref)[0]
    for r in res:
        for k in ("loss", "lr", "grad_norm"):
            close(r["metrics"][0][k], want_m[k])
    got = res[0]["params"][0]
    assert set(got) == set(want_p)
    for n, w in want_p.items():
        close(got[n], w)


def test_ranks_import_only_the_port(runs):
    """The spawned ranks load neither jax, nor the reference package, nor
    a test module."""
    for arch in ROWS:
        for r in runs[0][arch][2]:
            assert r["foreign"] == []


@pytest.mark.parametrize("arch", ROWS)
def test_mesh_step_runs_attention_on_local_rows_and_heads(trees, runs,
                                                          arch):
    """The attention kernels' training route (FlashAttention, its plain
    version on the CPU) takes each rank's own rows and heads as plain
    tensors: a microbatch's rows over data, the heads over model."""
    tc = trees[arch][1]
    B, S = ROWS[arch]
    want = [("Tensor", (B // MBS // MESH[0], S, tc.n_heads // MESH[1],
                        tc.hd))]
    for r in runs[0][arch][2]:
        assert r["attention"] == want


def test_mesh_step_with_int8_states_matches_the_reference(trees):
    """One yi-6b step with int8 states (the row maxima of a leaf whose last
    axis is split over model taken over the whole row), two microbatches
    accumulated in bf16.  Against the port's unsharded step: every element
    within 2e-4, but where the reference's own update is amplified past
    AMPLIFIED (at most 5%), there its sign.  Against the reference, as
    tests/test_torch_train.py holds int8: amplified elements to their sign,
    every other within 2e-4, except where the port's unsharded step itself
    stands apart from the reference's (at most 1e-4 of the elements): a
    gradient whose two microbatches cancel to their bf16 rounding residue,
    zero on one side and not on the other, and AdamW's first update is
    sign(g) at any |g| above eps."""
    arch = "yi-6b"
    batches = _batches(trees[arch][1].vocab, arch, 1, 51)
    (jm, jflat), = _reference(trees, arch, True, batches)
    (tm, pflat), = _port(trees, arch, True, batches)
    res = run_ranks(f"{CASES}:train_steps", WORLD, arch, batches,
                    mesh_shape=MESH, opt=dict(OPT, quantize_states=True),
                    tree=trees[arch][3], microbatches=MBS,
                    timeout=SPAWN_TIMEOUT)
    prev = dict(TM._leaves(trees[arch][3]))
    for k in ("loss", "lr", "grad_norm"):
        close(res[0]["metrics"][0][k], jm[k])
        close(res[0]["metrics"][0][k], tm[k])
    n_amp = n_apart = n_all = 0
    for name, want in jflat.items():
        got, p0, port = res[0]["params"][0][name], prev[name], pflat[name]
        decay = 0.1 * p0 if p0.ndim >= 2 else 0.0
        u_ref = (p0 - want) / jm["lr"] - decay
        amp = np.abs(u_ref) > AMPLIFIED
        apart = ~amp & (np.abs(port - want)
                        > TOL * max(1.0, float(np.abs(want).max())))
        n_amp, n_all = n_amp + amp.sum(), n_all + amp.size
        n_apart += apart.sum()
        if amp.any():
            u_got = (p0 - got) / jm["lr"] - decay
            assert (np.sign(u_got[amp]) == np.sign(u_ref[amp])).all(), name
        close(got[~amp & ~apart], want[~amp & ~apart])
        close(got[~amp], port[~amp])
    assert n_amp <= 0.05 * n_all
    assert n_apart <= 1e-4 * n_all


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("arch", ROWS)
def test_one_by_one_mesh_is_bit_for_bit_the_unsharded_step(trees, arch,
                                                           quantize):
    batches = _batches(trees[arch][1].vocab, arch, STEPS, 52)
    plain = _port(trees, arch, quantize, batches)
    meshed = _port(trees, arch, quantize, batches, mesh=make_host_mesh("cpu"))
    for (pm, pp), (mm, mp) in zip(plain, meshed):
        assert pm == mm
        for n in pp:
            assert np.array_equal(pp[n], mp[n]), n


# =============================================================================
# pod compression
# =============================================================================

@pytest.fixture(scope="module")
def pod():
    """The 2 ranks' pod_compress results and its inputs."""
    rng = np.random.default_rng(60)
    grads = rng.standard_normal((2, 16, 16), dtype=np.float32)
    errors = (rng.standard_normal((2, 16, 16), dtype=np.float32)
              * np.float32(0.01))
    w = np.full((16, 16), 0.1, np.float32)
    batch = rng.standard_normal((8, 16), dtype=np.float32)
    res = run_ranks(f"{CASES}:pod_compress", 2, grads, errors, w, batch,
                    timeout=SPAWN_TIMEOUT)
    return grads, errors, w, batch, res


def test_compressed_psum_is_the_references_per_pod(pod):
    """The reference's compressed_psum under jax.vmap(axis_name="pod") on
    the same stacked gradients and errors: every pod's output and new error
    equal the port's rank's, bit for bit (the same f32 operations: a shared
    row scale by MAX, an exact int32 sum, one product and one division)."""
    grads, errors, _, _, res = pod
    jg, je = jax.vmap(lambda g, e: JC.compressed_psum({"w": g}, {"w": e},
                                                      "pod"),
                      axis_name="pod")(jnp.asarray(grads), jnp.asarray(errors))
    for r, out in enumerate(res):
        assert np.array_equal(out["psum"], np.asarray(jg["w"][r]))
        assert np.array_equal(out["error"], np.asarray(je["w"][r]))
    assert np.array_equal(res[0]["psum"], res[1]["psum"])


def test_pod_compressed_gradient_tracks_the_exact_one(pod):
    """The reference test's loss, mean((batch @ w)^2), each pod its half of
    the rows: the compressed gradient within 0.02 of the exact gradient's
    largest value, the loss the pods' mean, the new error exact."""
    _, _, w, batch, res = pod
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(batch)
    loss = ((bt @ wt) ** 2).mean()
    exact, = torch.autograd.grad(loss, [wt])
    exact = exact.numpy()
    for out in res:
        rel = np.abs(out["grads"] - exact).max() / np.abs(exact).max()
        assert rel < 0.02, rel
        np.testing.assert_allclose(out["loss"], float(loss.detach()),
                                   rtol=1e-6)
    # the new error: each pod's own gradient less its int8 payload at the
    # row scale the pods share (the larger of their row maxima)
    amax = np.maximum(*(np.abs(out["own"]).max(-1, keepdims=True)
                        for out in res))
    scale = np.maximum(amax, np.float32(1e-20)) / np.float32(127.0)
    for out in res:
        q = np.clip(np.round(out["own"] / scale), -127, 127)
        assert np.array_equal(out["new_error"], out["own"] - q * scale)


# =============================================================================
# sharded restore
# =============================================================================

@pytest.mark.parametrize("via,world,mesh", [("try_restore", 4, (4, 1)),
                                            ("elastic", 2, (2, 1))],
                         ids=["4x1-try_restore", "world-of-2-elastic"])
def test_sharded_restore_onto_another_mesh(runs, trees, via, world, mesh):
    """The 2 x 2 run's checkpoint (after its two steps) restored onto a
    new device population: every leaf bit for bit the saved one and laid
    out by the new mesh's rules; the loop resumes at next_step."""
    ckpt = runs[1]
    tc = trees["yi-6b"][1]
    res = run_ranks(f"{CASES}:restore", world, "yi-6b", str(ckpt),
                    mesh_shape=mesh, opt=OPT, via=via,
                    timeout=SPAWN_TIMEOUT)
    store = CheckpointStore(str(ckpt))
    tp = TM.init_params(torch.Generator().manual_seed(1), tc)
    template = (tp, TO.init_opt_state(tp, TO.AdamWConfig(**OPT)))
    saved, extra = store.restore(template)
    saved = dict(TM._leaves({"0": saved[0], "1": saved[1]}))
    assert extra["next_step"] == STEPS
    for r in res:
        assert r["next_step"] == STEPS
        assert r["wrong_layout"] == []
    got = res[0]["leaves"]
    assert set(got) == set(saved)
    for n, t in saved.items():
        assert np.array_equal(got[n], t.numpy()), n
