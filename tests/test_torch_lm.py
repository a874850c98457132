"""The port's LM serving path on the CPU against the reference package.

The model is ``ARCHS["yi-6b"].reduced()`` (2 KV heads for 4 query heads,
head_dim 16, vocab 256), with the reference's ``init_params(PRNGKey(0),
cfg, f32)`` carried into the port by ``params_from_numpy``.  Inputs come
from seeded numpy generators and go to both packages.  Tolerance: rtol =
atol = 2e-4 unless a test says otherwise, the port's standing f32 matmul
tolerance (XLA's and PyTorch's CPU matmuls sum in different orders).
"""
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

import repro.launch.serve as jserve_cli                     # noqa: E402
from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.core.compression import bfp8_decode as jbfp8_decode  # noqa: E402
from repro.models import attention as JA                    # noqa: E402
from repro.models import common as JC                       # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.obs.metrics import parse_metrics_text as jparse  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine   # noqa: E402

import repro_torch.launch.serve as tserve_cli               # noqa: E402
import repro_torch.launch.train as ttrain_cli               # noqa: E402
from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.core.compression import bfp8_decode        # noqa: E402
from repro_torch.models import attention as TA             # noqa: E402
from repro_torch.models import common as TC                # noqa: E402
from repro_torch.models import model as TM                 # noqa: E402
from repro_torch.models import params_from_numpy           # noqa: E402
from repro_torch.obs.metrics import parse_metrics_text     # noqa: E402
from repro_torch.serving import ServingEngine              # noqa: E402

TOL = 2e-4
CFG = ARCHS["yi-6b"].reduced()
JCFG = JARCHS["yi-6b"].reduced()


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


# =============================================================================
# components
# =============================================================================

def test_params_from_numpy_carries_every_leaf(weights):
    jp, tree, tp = weights
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_leaves_with_path(jp)}
    tleaves = dict(TM._leaves(tp))
    assert set(tleaves) == set(jleaves) == set(TM.param_shapes(CFG))
    for name, a in jleaves.items():
        assert tleaves[name].dtype == torch.float32
        np.testing.assert_array_equal(tleaves[name].numpy(), a)
    assert TM.param_count(tp) == JM.param_count(jp)
    bad = dict(tree, lm_head=tree["lm_head"][:, :3])
    with pytest.raises(ValueError):
        params_from_numpy(bad, CFG, "cpu")
    with pytest.raises(ValueError):
        params_from_numpy({k: v for k, v in tree.items() if k != "embed"},
                          CFG, "cpu")


def test_rmsnorm_and_rope_match_the_reference():
    x = _rand((2, 7, 4, 16), 0)
    w = _rand((16,), 1)
    close(TC.rmsnorm(_t(x), _t(w)), JC.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.arange(7)[None] + np.array([[0], [5]])
    close(TC.apply_rope(_t(x), _t(pos), 1e6),
          JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def test_unported_families_raise():
    """Every family is served and trained now; what still refuses is
    whisper in the engine and in the train CLI, which have no encoder
    frames to give it (the step builders serve it, make_train_step trains
    it on batches that carry enc_frames)."""
    whisper = ARCHS["whisper-large-v3"].reduced()
    for name in ("whisper-large-v3", "qwen2-vl-72b"):
        cache = TM.init_cache(ARCHS[name].reduced(), 1, 8, device="cpu")
        assert set(cache["pos_0"]) >= {"k", "v"}
    params = TM.init_params(torch.Generator().manual_seed(0), whisper)
    with pytest.raises(ValueError, match="make_train_step.*enc_frames"):
        ttrain_cli.main(["--arch", "whisper-large-v3", "--smoke",
                         "--device", "cpu", "--steps", "1"])
    with pytest.raises(ValueError, match="make_prefill_step"):
        ServingEngine(whisper, params, device="cpu")


# (Sq, Sk, H, KH, chunk, q_chunk, q_offset): S multiple and not of the
# chunk, GQA, a query block offset into the keys
ATTN_CASES = [(64, 64, 4, 2, 16, 16, 0), (48, 48, 4, 4, 32, 16, 0),
              (37, 37, 4, 2, 16, 8, 0), (16, 40, 4, 2, 8, 8, 24),
              (1, 33, 4, 1, 16, 512, 32)]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"Sq{c[0]}Sk{c[1]}H{c[2]}KH{c[3]}c{c[4]}"
                              f"q{c[5]}o{c[6]}" for c in ATTN_CASES])
@pytest.mark.parametrize("causal,skip", [(True, False), (True, True),
                                         (False, False)])
def test_chunked_attention_matches_the_reference(case, causal, skip):
    Sq, Sk, H, KH, chunk, q_chunk, off = case
    q, k, v = (_rand((2, Sq, H, 16), 10), _rand((2, Sk, KH, 16), 11),
               _rand((2, Sk, KH, 16), 12))
    kw = dict(causal=causal, chunk=chunk, q_chunk=q_chunk, q_offset=off,
              skip_masked=skip)
    close(TA.chunked_attention(_t(q), _t(k), _t(v), **kw),
          JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw))


def _layer(weights, g=0):
    jp, tree, tp = weights
    jl = jax.tree.map(lambda a: a[g], jp["groups"]["pos_0"])
    return jl, TM._group(tp["groups"], g)["pos_0"]


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("S", [24, 37])
def test_prefill_attention_matches_the_reference(weights, inference, S):
    jl, tl = _layer(weights)
    x = _rand((2, S, CFG.d_model), 20)
    pos = np.arange(S)[None]
    jout, (jk, jv) = JA.prefill_attention(jl["mixer"], jnp.asarray(x), JCFG,
                                          jnp.asarray(pos),
                                          inference=inference)
    tout, (tk, tv) = TA.prefill_attention(tl["mixer"], _t(x), CFG, _t(pos),
                                          inference=inference)
    close(tout, jout)
    close(tk, jk)
    close(tv, jv)


def test_decode_attention_scatters_at_pos(weights):
    jl, tl = _layer(weights)
    B, S_max = 3, 20
    ck, cv = (_rand((B, S_max, CFG.n_kv_heads, CFG.hd), s) for s in (30, 31))
    x = _rand((B, 1, CFG.d_model), 32)
    pos = np.array([0, 7, 19])
    jout, (jck, jcv) = JA.decode_attention(
        jl["mixer"], jnp.asarray(x), JCFG, (jnp.asarray(ck), jnp.asarray(cv)),
        jnp.asarray(pos))
    tck, tcv = _t(ck), _t(cv)
    tout, (rk, rv) = TA.decode_attention(tl["mixer"], _t(x), CFG, (tck, tcv),
                                         _t(pos))
    assert rk is tck and rv is tcv          # written in place
    close(tout, jout)
    close(tck, jck)
    close(tcv, jcv)
    untouched = np.ones((B, S_max), bool)
    untouched[np.arange(B), pos] = False
    np.testing.assert_array_equal(tck.numpy()[untouched], ck[untouched])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_with_cache_matches_the_reference(weights, use_kernels):
    jp, _, tp = weights
    S, s_max = 21, 32
    toks = np.random.default_rng(40).integers(0, CFG.vocab, (1, S))
    jx, jcache, _ = JM.forward(jp, JCFG, jnp.asarray(toks, jnp.int32),
                               cache=JM.init_cache(JCFG, 1, s_max,
                                                   dtype=jnp.float32))
    tx, tcache, _ = TM.forward(tp, CFG, _t(toks),
                               cache=TM.init_cache(CFG, 1, s_max,
                                                   device="cpu"),
                               use_kernels=use_kernels)
    close(tx, jx)
    for pj in jcache:
        for n in ("k", "v"):
            assert tuple(tcache[pj][n].shape) == jcache[pj][n].shape
            close(tcache[pj][n], jcache[pj][n])
    close(TM.project_logits(tp, CFG, tx[:, -1]),
          JM.project_logits(jp, JCFG, jx[:, -1]))


def test_decode_step_logits_over_several_steps(weights):
    jp, _, tp = weights
    B, S, s_max = 2, 9, 24
    toks = np.random.default_rng(50).integers(0, CFG.vocab, (B, S))
    _, jcache, _ = JM.forward(jp, JCFG, jnp.asarray(toks, jnp.int32),
                              cache=JM.init_cache(JCFG, B, s_max,
                                                  dtype=jnp.float32))
    _, tcache, _ = TM.forward(tp, CFG, _t(toks),
                              cache=TM.init_cache(CFG, B, s_max,
                                                  device="cpu"))
    tok = toks[:, -1:]
    pos = np.full(B, S)
    for step in range(5):
        jl, jcache = JM.decode_step(jp, JCFG, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos, jnp.int32), jcache)
        tl, tcache = TM.decode_step(tp, CFG, _t(tok), _t(pos), tcache)
        close(tl, jl)
        tok = np.asarray(jl).argmax(-1)[:, None]
        pos = pos + 1
    for pj in jcache:
        for n in ("k", "v"):
            close(tcache[pj][n], jcache[pj][n])


# =============================================================================
# the engine end to end
# =============================================================================

ENGINE = dict(max_batch=2, s_max=48, evict_to_host=True, resident_limit=1)


def _requests():
    rng = np.random.default_rng(60)
    return [(rng.integers(0, CFG.vocab, n), m)
            for n, m in ((5, 6), (17, 4), (9, 8), (30, 5))]


def _counters(fams):
    return {(fam, key): val for fam, f in fams.items()
            if fam.endswith("_total") for key, val in f["samples"].items()}


def _one_step_apart(tenc, jenc):
    """Decoded pages within one mantissa step of the larger block scale,
    exponents at most one apart (the standing BFP8 difference: the port's
    inputs differ from the reference's in the last bits)."""
    assert tenc.mantissas.shape == jenc.mantissas.shape
    de = np.abs(tenc.exponents.astype(int) - jenc.exponents.astype(int))
    assert de.max() <= 1
    step = 2.0 ** (np.maximum(tenc.exponents, jenc.exponents).astype(
        np.float64) - 6.0)
    diff = np.abs(bfp8_decode(tenc).astype(np.float64).ravel()
                  - jbfp8_decode(jenc).astype(np.float64).ravel())
    n = diff.size
    bound = np.repeat(step, 32)[:n]
    assert (diff <= bound + 1e-12).all()
    same = de == 0
    dm = np.abs(tenc.mantissas.astype(int) - jenc.mantissas.astype(int))
    assert dm[same].max(initial=0) <= 1


def test_serving_engine_matches_the_reference(weights):
    """4 requests through 2 slots with host eviction and resident_limit=1:
    the same token streams, counters, host store keys and pages (within
    one mantissa step), and both restores."""
    jp, _, tp = weights
    jeng = JEngine(JCFG, jp, **ENGINE)
    teng = ServingEngine(CFG, tp, device="cpu", **ENGINE)
    jreqs = [jeng.submit(p, max_new_tokens=m) for p, m in _requests()]
    treqs = [teng.submit(p, max_new_tokens=m) for p, m in _requests()]
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done for r in treqs)
    want = _counters(jparse(jeng.metrics_text()))
    got = _counters(parse_metrics_text(teng.metrics_text()))
    assert got == want
    assert teng.stats.prefills == 4 and teng.stats.evicted_pages == 6
    # request 2 (8 new tokens) retires last and stays parked
    assert set(teng.host_store) == set(jeng.host_store) == {0, 1, 3}
    assert list(teng.resident_store) == list(jeng.resident_store) == [2]
    for rid, pages in jeng.host_store.items():
        assert set(teng.host_store[rid]) == set(pages) == {"pos_0/k",
                                                           "pos_0/v"}
        for name, enc in pages.items():
            _one_step_apart(teng.host_store[rid][name], enc)

    # restores: the resident page-set exactly, a host one through BFP8
    for rid, slot in ((2, 0), (1, 1)):
        jeng.restore_request(rid, slot)
        teng.restore_request(rid, slot)
    for pj in jeng.cache:
        for n in ("k", "v"):
            j, t = np.asarray(jeng.cache[pj][n]), teng.cache[pj][n].numpy()
            close(t[:, 0], j[:, 0])
            step = np.abs(j[:, 1]).max() / 64
            np.testing.assert_allclose(t[:, 1], j[:, 1], rtol=0,
                                       atol=step)
    assert 1 not in teng.host_store and 2 not in teng.resident_store
    assert teng.stats.restored_pages == jeng.stats.restored_pages == 4


def test_resident_restore_is_bit_exact(weights):
    """A page-set parked on the device restores exactly as it was
    snapshotted, though later decode steps wrote the cache in place."""
    _, _, tp = weights
    eng = ServingEngine(CFG, tp, device="cpu", **ENGINE)
    for p, m in _requests():
        eng.submit(p, max_new_tokens=m)
    eng.run_until_drained()
    (rid, parked), = eng.resident_store.items()
    parked = {k: v.clone() for k, v in parked.items()}
    eng.restore_request(rid, 1)
    for name, c in TM._leaves(eng.cache):
        assert torch.equal(c[:, 1], parked[name])


def test_engine_refuses_params_on_another_device(weights):
    _, _, tp = weights
    with pytest.raises(ValueError):
        ServingEngine(CFG, tp, device="meta")
    with pytest.raises(ValueError):
        ServingEngine(CFG, tp, device="cpu", kernel_mode="cuda")


def _cli_numbers(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    main()
    out = capsys.readouterr().out.splitlines()
    name = out[0].split(":")[0]
    counts = re.findall(r"(prefills|decode_steps)=(\d+)", out[1])
    return name, counts, out[2]


def test_serve_cli_prints_the_reference_counts(capsys, monkeypatch):
    want = _cli_numbers(jserve_cli.main, ["--arch", "yi-6b"], capsys,
                        monkeypatch)
    got = _cli_numbers(tserve_cli.main, ["--arch", "yi-6b", "--device",
                                         "cpu"], capsys, monkeypatch)
    assert got == want
    assert want[1] == [("prefills", "8"), ("decode_steps", "30")]
