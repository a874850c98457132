"""The port's prefill and decode steps on a device mesh, on the CPU, against
the unsharded steps of both packages.

Ranks are spawned by ``repro_torch.testing.ranks.run_ranks`` (fresh
interpreters joining a gloo process group through a ``file://`` store of
their own, one intra-op thread each) and run
``repro_torch.testing.mesh_cases.serve_steps``: one spawn per scenario,
module-scoped.  Weights are the reference's ``init_params(PRNGKey(0))`` of
the reduced configs, carried to every rank as numpy; prompts and decode
tokens come from seeded numpy generators.

* On a 2 x 2 ("data", "model") mesh, reduced yi-6b and reduced
  jamba-v0.1-52b (its KV pages, Mamba states and experts), at B = 4 (rows
  over data, the KV pages' sequence over model) and at B = 1 (the rows do
  not split: the pages' sequence over data and model, the Mamba state's
  channels over model): one prefill of 16 tokens and 4 decode steps.  The
  last logits, every decode step's logits and every cache leaf after each
  step within 2e-4 x max(1, max|ref|) of the port's unsharded steps and of
  the reference's on its host mesh (the split softmax and FSDP's split sums
  add in another order), and every cache leaf laid out by
  ``cache_shardings`` after each step.
* No decode step gathers a cache leaf: no all-gather or all-to-all takes a
  tensor of a cache leaf's local shape (one group's slice), and a step's
  collective operand bytes, counted by ``launch/hlo_analysis.py``, stay
  below one rank's local cache bytes (``S_MAX`` is a long serving context,
  where the pages outweigh the weights each step gathers over the data
  ranks, FSDP's all-gathers).
* The prefill's ``flash_attention`` runs on each rank's own rows and heads,
  plain tensors.
* A 1 x 1 mesh (``make_host_mesh("cpu")``, in this process) is bit for bit
  the unsharded steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.launch.mesh import make_host_mesh as jhost_mesh  # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.runtime import steps as JS                       # noqa: E402

from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.launch.mesh import make_host_mesh          # noqa: E402
from repro_torch.models import init_cache                   # noqa: E402
from repro_torch.models import model as TM                  # noqa: E402
from repro_torch.models import params_from_numpy            # noqa: E402
from repro_torch.runtime.steps import (make_decode_step,    # noqa: E402
                                       make_prefill_step)
from repro_torch.testing.ranks import run_ranks             # noqa: E402

CASES = "repro_torch.testing.mesh_cases"
TOL = 2e-4
WORLD, MESH = 4, (2, 2)
SPAWN_TIMEOUT = 150
ARCH_NAMES = ("yi-6b", "jamba-v0.1-52b")
BATCHES = (4, 1)
PROMPT = 16
DECODES = 4
S_MAX = 16384


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this process's steps, as each spawned rank
    has."""
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


def _inputs(vocab, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, PROMPT)).astype(np.int32),
            rng.integers(0, vocab, (DECODES, B)).astype(np.int32))


@pytest.fixture(scope="module")
def trees():
    out = {}
    for arch in ARCH_NAMES:
        jc, tc = JARCHS[arch].reduced(), ARCHS[arch].reduced()
        jp = JM.init_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
        out[arch] = (jc, tc, jp, jax.tree.map(np.asarray, jp))
    return out


def _reference(trees, arch, tokens, decode):
    """(logits, flat cache) after the prefill and each decode step of the
    reference's steps on its host mesh."""
    jc, _, jp, _ = trees[arch]
    B = tokens.shape[0]
    with jhost_mesh() as m:
        pf = jax.jit(JS.make_prefill_step(jc, m, B, S_MAX,
                                          dtype=jnp.float32)[0])
        dc = jax.jit(JS.make_decode_step(jc, m, B, S_MAX,
                                         dtype=jnp.float32)[0])
        cache = JM.init_cache(jc, B, S_MAX, dtype=jnp.float32)
        logits, cache = pf(jp, cache, {"tokens": jnp.asarray(tokens)})
        out = [(np.asarray(logits), _jflat(cache))]
        for i, tok in enumerate(decode):
            pos = jnp.full((B,), PROMPT + i, jnp.int32)
            logits, cache = dc(jp, cache, jnp.asarray(tok)[:, None], pos)
            out.append((np.asarray(logits), _jflat(cache)))
    return out


def _port(trees, arch, tokens, decode, mesh=None):
    """The same from the port's steps, unsharded or on ``mesh``."""
    _, tc, _, tree = trees[arch]
    B = tokens.shape[0]
    params = params_from_numpy(tree, tc, "cpu")
    cache = init_cache(tc, B, S_MAX, device="cpu")
    pf = make_prefill_step(tc, B, S_MAX, device="cpu", mesh=mesh)
    dc = make_decode_step(tc, B, S_MAX, device="cpu", mesh=mesh)

    def host(t):
        return (t.full_tensor() if hasattr(t, "full_tensor")
                else t).numpy().copy()

    logits, cache = pf(params, cache, {"tokens": tokens})
    out = [(host(logits), {n: host(t) for n, t in TM._leaves(cache)})]
    for i, tok in enumerate(decode):
        pos = torch.full((B,), PROMPT + i, dtype=torch.long)
        logits, cache = dc(params, cache, torch.as_tensor(tok)[:, None], pos)
        out.append((host(logits), {n: host(t) for n, t in TM._leaves(cache)}))
    return out


@pytest.fixture(scope="module")
def runs(trees):
    """(arch, B) -> (reference, port unsharded, the 2x2 ranks' results)."""
    out = {}
    for arch in ARCH_NAMES:
        for B in BATCHES:
            tokens, decode = _inputs(trees[arch][1].vocab, B, 70 + B)
            ref = _reference(trees, arch, tokens, decode)
            port = _port(trees, arch, tokens, decode)
            res = run_ranks(f"{CASES}:serve_steps", WORLD, arch, tokens,
                            decode, mesh_shape=MESH, s_max=S_MAX,
                            tree=trees[arch][3], timeout=SPAWN_TIMEOUT)
            out[arch, B] = (ref, port, res)
    return out


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("step", range(DECODES + 1))
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_mesh_serve_matches_the_unsharded_steps(runs, arch, B, step,
                                                against):
    """Step 0 the prefill's last logits and cache, then each decode step's
    logits and cache, every rank's logits and rank 0's every cache leaf."""
    ref, port, res = runs[arch, B]
    want_l, want_c = (port if against == "port" else ref)[step]
    for r in res:
        close(r["logits"][step], want_l)
    got = res[0]["cache"][step]
    assert set(got) == set(want_c)
    for n, w in want_c.items():
        close(got[n], w)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_mesh_serve_keeps_the_cache_laid_out_by_the_rules(runs, arch, B):
    """After the prefill and after every decode step each leaf's placements
    are ``cache_shardings``'; at B = 1 the KV pages' sequence is split over
    both axes."""
    res = runs[arch, B][2]
    for r in res:
        assert r["stray"] == [[]] * (DECODES + 1)
    pages = [s for n, s in res[0]["local_shapes"].items()
             if n.endswith("/k")]
    want = (1, B // 2, S_MAX // 2, 2, 16) if B == 4 else \
        (1, 1, S_MAX // 4, 2, 16)
    assert pages and all(s == want for s in pages)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_mesh_decode_gathers_no_cache_leaf(runs, arch, B):
    res = runs[arch, B][2]
    for r in res:
        slices = {s[1:] for s in r["local_shapes"].values()}
        for step in r["collectives"]:
            for kind, shapes in step["operands"]:
                if kind in ("all-gather", "all-to-all"):
                    assert not slices & {tuple(s) for s in shapes}, \
                        (kind, shapes)
            assert step["total_bytes"] < r["local_cache_bytes"], \
                (step["by_kind"], r["local_cache_bytes"])


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_mesh_prefill_runs_attention_on_local_rows_and_heads(trees, runs,
                                                             arch, B):
    """``flash_attention`` (its plain version on the CPU) takes each rank's
    own rows (split over data where B divides) and heads (over model) of
    the prompt, plain tensors."""
    tc = trees[arch][1]
    want = [("Tensor", (B // MESH[0] if B % MESH[0] == 0 else B, PROMPT,
                        tc.n_heads // MESH[1], tc.hd))]
    for r in runs[arch, B][2]:
        assert r["attention"] == want


def test_ranks_import_only_the_port(runs):
    for key in runs:
        for r in runs[key][2]:
            assert r["foreign"] == []


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_one_by_one_mesh_serve_is_bit_for_bit_the_unsharded_steps(trees,
                                                                  arch):
    tokens, decode = _inputs(trees[arch][1].vocab, 2, 80)
    plain = _port(trees, arch, tokens, decode)
    meshed = _port(trees, arch, tokens, decode, mesh=make_host_mesh("cpu"))
    for (pl, pc), (ml, mc) in zip(plain, meshed):
        assert np.array_equal(pl, ml)
        assert set(pc) == set(mc)
        for n in pc:
            assert np.array_equal(pc[n], mc[n]), n
