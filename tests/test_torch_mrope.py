"""The port's M-RoPE family (qwen2-vl) on the CPU against the reference
package.

The model is ``ARCHS["qwen2-vl-72b"].reduced(n_layers=2)`` (2 layers,
d_model 64, 4 query heads and 2 KV heads of 16, M-RoPE sections (4, 2, 2),
8 patch positions), with the reference's ``init_params(PRNGKey(0), cfg,
f32)`` carried into the port by ``params_from_numpy``.  Inputs come from
seeded numpy generators and go to both packages.  Tolerance: rtol = atol =
2e-4, the port's standing f32 tolerance; decode against the full forward
2e-3, the reference's own for that invariant.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.launch.mesh import make_host_mesh                # noqa: E402
from repro.models import attention as JA                    # noqa: E402
from repro.models import common as JC                       # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.runtime import steps as JS                       # noqa: E402
from repro.serving.engine import ServingEngine as JEngine   # noqa: E402

from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.models import attention as TA             # noqa: E402
from repro_torch.models import common as TC                # noqa: E402
from repro_torch.models import model as TM                 # noqa: E402
from repro_torch.models import params_from_numpy           # noqa: E402
from repro_torch.runtime import steps as TS                 # noqa: E402
from repro_torch.serving import ServingEngine              # noqa: E402

TOL = 2e-4
DECODE_TOL = 2e-3
NAME = "qwen2-vl-72b"
CFG = ARCHS[NAME].reduced(n_layers=2)
JCFG = JARCHS[NAME].reduced(n_layers=2)
P = CFG.vlm_patches


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def weights():
    """(reference params, the same as numpy, the port's params)."""
    jp = JM.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return jp, tree, params_from_numpy(tree, CFG, "cpu")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _toks(shape, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, shape)


# =============================================================================
# M-RoPE
# =============================================================================

@pytest.mark.parametrize("sections,D", [((4, 2, 2), 16), ((16, 24, 24), 128)])
def test_apply_mrope_matches_the_reference(sections, D):
    """Three distinct position streams (a patch grid's t, h, w), and the
    text streams, at the reduced and the published sections."""
    B, S = 2, 9
    x = _rand((B, S, 3, D), 0) * 3
    rng = np.random.default_rng(1)
    streams = rng.integers(0, 5000, (3, B, S))
    for pos in (streams, np.asarray(JC.text_mrope_positions(
            jnp.asarray(streams[0])))):
        close(TC.apply_mrope(_t(x), _t(pos), sections, 1e6),
              JC.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                             1e6))
    pos = np.arange(S)[None] + np.array([[0], [700]])
    tp = TC.text_mrope_positions(_t(pos))
    np.testing.assert_array_equal(
        tp.numpy(), np.asarray(JC.text_mrope_positions(jnp.asarray(pos))))
    # for text M-RoPE is RoPE: the three streams rotate alike
    close(TC.apply_mrope(_t(x), tp, sections), TC.apply_rope(_t(x), _t(pos)))
    with pytest.raises(ValueError, match="sections"):
        TC.apply_mrope(_t(x), tp, (1, 2, 3))


@pytest.mark.parametrize("repeat_kv", [False, True])
def test_project_qkv_rotates_by_mrope(weights, repeat_kv):
    jp, _, tp = weights
    jl = jax.tree.map(lambda a: a[1], jp["groups"]["pos_0"])["mixer"]
    tl = TM._group(tp["groups"], 1)["pos_0"]["mixer"]
    x = _rand((2, 11, CFG.d_model), 10)
    pos = np.arange(11)[None] + np.array([[0], [5]])
    want = JA._project_qkv(jl, jnp.asarray(x), JCFG, jnp.asarray(pos),
                           repeat_kv=repeat_kv)
    got = TA._project_qkv(tl, _t(x), CFG, _t(pos), repeat_kv=repeat_kv)
    for g, w in zip(got, want):
        close(g, w)


# =============================================================================
# the model
# =============================================================================

@pytest.mark.parametrize("patches", [True, False], ids=["patches", "text"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_matches_the_reference(weights, patches, use_kernels):
    """Hidden states with and without patch embeddings, then a prefill's
    KV cache and last logits."""
    jp, _, tp = weights
    B, S, s_max = 2, 21, 32
    toks = _toks((B, S), 20)
    pe = _rand((B, P, CFG.d_model), 21) if patches else None
    jkw = {} if pe is None else {"patch_embeds": jnp.asarray(pe)}
    tkw = {} if pe is None else {"patch_embeds": _t(pe)}
    jx, _, _ = JM.forward(jp, JCFG, jnp.asarray(toks, jnp.int32), **jkw)
    tx, _, _ = TM.forward(tp, CFG, _t(toks), use_kernels=use_kernels, **tkw)
    close(tx, jx)
    jx, jcache, _ = JM.forward(jp, JCFG, jnp.asarray(toks, jnp.int32),
                               cache=JM.init_cache(JCFG, B, s_max,
                                                   dtype=jnp.float32), **jkw)
    tx, tcache, _ = TM.forward(tp, CFG, _t(toks),
                               cache=TM.init_cache(CFG, B, s_max,
                                                   device="cpu"),
                               use_kernels=use_kernels, **tkw)
    close(tx, jx)
    for n in ("k", "v"):
        close(tcache["pos_0"][n], jcache["pos_0"][n])
    close(TM.project_logits(tp, CFG, tx[:, -1]),
          JM.project_logits(jp, JCFG, jx[:, -1]))


def test_patch_embeds_replace_the_first_rows(weights):
    _, _, tp = weights
    toks = _t(_toks((1, 12), 30))
    pe = _t(_rand((1, P, CFG.d_model), 31))
    x = TM._embed(tp, CFG, toks, pe)
    assert torch.equal(x[:, :P], pe)
    assert torch.equal(x[:, P:], tp["embed"][toks[:, P:]])


def test_decode_step_logits_over_several_steps(weights):
    jp, _, tp = weights
    B, S, s_max = 2, 10, 24
    toks, pe = _toks((B, S), 40), _rand((B, P, CFG.d_model), 41)
    _, jcache, _ = JM.forward(jp, JCFG, jnp.asarray(toks, jnp.int32),
                              patch_embeds=jnp.asarray(pe),
                              cache=JM.init_cache(JCFG, B, s_max,
                                                  dtype=jnp.float32))
    _, tcache, _ = TM.forward(tp, CFG, _t(toks), patch_embeds=_t(pe),
                              cache=TM.init_cache(CFG, B, s_max,
                                                  device="cpu"))
    tok, pos = toks[:, -1:], np.full(B, S)
    for _ in range(5):
        jl, jcache = JM.decode_step(jp, JCFG, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos, jnp.int32), jcache)
        tl, tcache = TM.decode_step(tp, CFG, _t(tok), _t(pos), tcache)
        close(tl, jl)
        tok, pos = np.asarray(jl).argmax(-1)[:, None], pos + 1
    for n in ("k", "v"):
        close(tcache["pos_0"][n], jcache["pos_0"][n])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_decode_matches_full_forward(weights, use_kernels):
    """Prefill 12 of 16 tokens (the patches inside the prefill), decode the
    rest; each step's logits against the full forward's within 2e-3."""
    _, _, tp = weights
    B, S, pre = 2, 16, 12
    toks, pe = _t(_toks((B, S), 50)), _t(_rand((B, P, CFG.d_model), 51))
    x, _, _ = TM.forward(tp, CFG, toks, patch_embeds=pe,
                         use_kernels=use_kernels)
    full = TM.project_logits(tp, CFG, x)
    _, cache, _ = TM.forward(tp, CFG, toks[:, :pre], patch_embeds=pe,
                             cache=TM.init_cache(CFG, B, S, device="cpu"),
                             use_kernels=use_kernels)
    for t in range(pre, S):
        logits, cache = TM.decode_step(tp, CFG, toks[:, t:t + 1],
                                       torch.full((B,), t), cache)
        close(logits, full[:, t], DECODE_TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_lm_loss_and_gradients_match_the_reference(weights, use_kernels):
    """lm_loss(patch_embeds=) and every gradient leaf against
    jax.value_and_grad; the patches' gradient too."""
    jp, tree, _ = weights
    B, S = 2, 32
    toks, labs = _toks((B, S), 60), _toks((B, S), 61)
    pe = _rand((B, P, CFG.d_model), 62)
    jl, (jg, jpe) = jax.value_and_grad(
        lambda p, e: JM.lm_loss(p, JCFG, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(labs, jnp.int32),
                                patch_embeds=e), argnums=(0, 1))(
        jp, jnp.asarray(pe))
    tp = params_from_numpy(tree, CFG, "cpu")
    leaves = {n: t.requires_grad_(True) for n, t in TM._leaves(tp)}
    tpe = _t(pe).requires_grad_(True)
    loss = TM.lm_loss(TM._tree(leaves), CFG, _t(toks), _t(labs),
                      patch_embeds=tpe, use_kernels=use_kernels)
    grads = torch.autograd.grad(loss, [*leaves.values(), tpe])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    got = dict(zip(leaves, grads))
    assert set(got) == set(want)
    for name, g in want.items():
        close(got[name], g)
    close(grads[-1], jpe)
    # the train step's form: the batch's patches through loss_and_grads
    loss2, grads2 = TS.loss_and_grads(tp, CFG, _t(toks), _t(labs),
                                      remat="none", use_kernels=use_kernels,
                                      patch_embeds=_t(pe))
    assert float(loss2) == float(loss.detach())
    for name, g in TM._leaves(grads2):
        close(g, got[name])


def test_prefill_step_with_patches_matches_the_reference(weights):
    jp, _, tp = weights
    B, S = 1, 24
    toks, pe = _toks((B, S), 70), _rand((B, P, CFG.d_model), 71)
    with make_host_mesh() as mesh:
        jpre, _, _ = JS.make_prefill_step(JCFG, mesh, B, S,
                                          dtype=jnp.float32)
        jl, jcache = jpre(jp, JM.init_cache(JCFG, B, S, dtype=jnp.float32),
                          {"tokens": jnp.asarray(toks, jnp.int32),
                           "patch_embeds": jnp.asarray(pe)})
    tpre = TS.make_prefill_step(CFG, B, S, device="cpu")
    tl, tcache = tpre(tp, TM.init_cache(CFG, B, S, device="cpu"),
                      {"tokens": toks, "patch_embeds": pe})
    close(tl, jl)
    for n in ("k", "v"):
        close(tcache["pos_0"][n], jcache["pos_0"][n])


def test_serving_engine_matches_the_reference(weights):
    """qwen2-vl served as the reference serves it (text positions, no
    patches): 3 requests through 2 slots, the same token streams."""
    jp, _, tp = weights
    kw = dict(max_batch=2, s_max=40)
    rng = np.random.default_rng(80)
    reqs = [(rng.integers(0, CFG.vocab, n), m) for n, m in
            ((5, 6), (17, 4), (9, 5))]
    jeng, teng = JEngine(JCFG, jp, **kw), ServingEngine(CFG, tp,
                                                        device="cpu", **kw)
    jr = [jeng.submit(p, max_new_tokens=m) for p, m in reqs]
    tr = [teng.submit(p, max_new_tokens=m) for p, m in reqs]
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert teng.stats.prefills == 3
