"""The port's state-space and recurrent mixers (``models/ssm.py``) and the
two configs built on them, jamba-v0.1-52b (Mamba, attention and a mixture
of experts) and xlstm-1.3b (mLSTM and sLSTM), on the CPU against the
reference package.

The models are ``ARCHS[name].reduced()`` (d_model 64, 4 heads, d_state 8,
one group of 8 layers), with the reference's ``init_params(PRNGKey(0),
cfg, f32)`` carried into the port by ``params_from_numpy``; inputs come
from seeded numpy generators and go to both packages.  Tolerance: rtol =
atol = 2e-4, the port's standing f32 tolerance (XLA's and PyTorch's CPU
matmuls and cumulative sums add in different orders), for the mixers, the
model's forward and decode and the engine's caches; the port's own
decode-equivalence is held to the reference's 2e-3 (its
``test_decode_matches_full_forward``): the chunkwise mLSTM and the
step-by-step decode sum in different orders by construction.  The
mixers' training routes (checkpointed scans) are held to ``jax.vjp`` of
the reference's forwards within the same 2e-4, to the plain scans and to
themselves without checkpoints bit for bit; the whole model's gradients
are ``tests/test_torch_train.py``'s.
"""
import functools
import re
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

import repro.launch.serve as jserve_cli                     # noqa: E402
from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.core.compression import bfp8_decode as jbfp8_decode  # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.models import ssm as JS                          # noqa: E402
from repro.obs.metrics import parse_metrics_text as jparse  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine   # noqa: E402

import repro_torch.launch.serve as tserve_cli               # noqa: E402
from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.core.compression import bfp8_decode        # noqa: E402
from repro_torch.models import model as TM                 # noqa: E402
from repro_torch.models import params_from_numpy           # noqa: E402
from repro_torch.models import ssm as TS                   # noqa: E402
from repro_torch.obs.metrics import parse_metrics_text     # noqa: E402
from repro_torch.serving import ServingEngine              # noqa: E402

TOL = 2e-4
DECODE_TOL = 2e-3
ARCH_NAMES = ("jamba-v0.1-52b", "xlstm-1.3b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs: the recurrent scans and
    small backward loops issue many small ops, and beside the other test
    workers' thread pools each op's pool of 8 stalls (about 400x slower
    on 6 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _rand(shape, seed, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _arch(name):
    """(name, port cfg, reference cfg, reference params, port params)."""
    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return name, cfg, jcfg, jp, tp


@pytest.fixture(params=ARCH_NAMES)
def arch(request):
    return _arch(request.param)


def _mixer(arch, kind):
    """The mixer parameters of the first position of ``kind``, group 0,
    in both packages."""
    _, cfg, _, jp, tp = arch
    j = next(j for j in range(cfg.group_size) if cfg.layer_kind(j) == kind)
    jl = jax.tree.map(lambda a: a[0], jp["groups"][f"pos_{j}"]["mixer"])
    return jl, TM._group(tp["groups"], 0)[f"pos_{j}"]["mixer"]


# =============================================================================
# parameters
# =============================================================================

def test_params_from_numpy_carries_every_leaf(arch):
    name, cfg, _, jp, tp = arch
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_leaves_with_path(jp)}
    tleaves = dict(TM._leaves(tp))
    assert set(tleaves) == set(jleaves) == set(TM.param_shapes(cfg))
    for n, a in jleaves.items():
        np.testing.assert_array_equal(tleaves[n].numpy(), a)


def test_init_params_layout_and_count(arch):
    """The port's own ``init_params`` makes every leaf of the reference's
    tree with its shape, the reference's fixed leaves (A_log, D, the q/k
    transforms, the gate biases) exactly; its count is the reference's, and
    within the reference's 15% of ``ArchConfig.param_counts`` (the formula
    leaves out the norms and some small leaves,
    ``tests/test_archs.py::test_param_counts_match_config_formula``)."""
    name, cfg, _, jp, _ = arch
    tp = TM.init_params(torch.Generator().manual_seed(0), cfg)
    shapes = {n: tuple(t.shape) for n, t in TM._leaves(tp)}
    assert shapes == TM.param_shapes(cfg)
    jleaves = dict(TM._leaves(jax.tree.map(np.asarray, jp)))
    tleaves = dict(TM._leaves(tp))
    assert all(t.dtype == torch.float32 for t in tleaves.values())
    fixed = {"mamba": ("A_log", "D"), "mlstm": ("wq", "wk", "gate_bias"),
             "slstm": ("bias",)}
    for j in range(cfg.group_size):
        for leaf in fixed.get(cfg.layer_kind(j), ()):
            n = f"groups/pos_{j}/mixer/{leaf}"
            np.testing.assert_array_equal(tleaves[n].numpy(), jleaves[n])
    n = TM.param_count(tp)
    assert n == JM.param_count(jp)
    assert cfg.param_counts() == JARCHS[name].reduced().param_counts()
    predicted = cfg.param_counts()["total"]
    assert abs(n - predicted) / predicted < 0.15


# =============================================================================
# the mixers
# =============================================================================

@pytest.mark.parametrize("S", [12, 64, 192])
def test_mlstm_forward_and_decode_match_the_reference(S):
    """One chunk (S = 12, 64) and three chunks carrying (C, n) across
    (S = 192); then a decode step from the forward's state."""
    arch = _arch("xlstm-1.3b")
    cfg, jcfg = arch[1], arch[2]
    jl, tl = _mixer(arch, "mlstm")
    x = _rand((2, S, cfg.d_model), S)
    jy, jst = JS.mlstm_forward(jl, jnp.asarray(x), jcfg)
    ty, tst = TS.mlstm_forward(tl, _t(x), cfg)
    close(ty, jy)
    for n in ("C", "n"):
        assert tst[n].dtype == torch.float32
        close(tst[n], jst[n])
    x1 = _rand((2, 1, cfg.d_model), S + 1)
    jy, jst = JS.mlstm_decode(jl, jnp.asarray(x1), jcfg, jst)
    ty, tst = TS.mlstm_decode(tl, _t(x1), cfg, tst)
    close(ty, jy)
    for n in ("C", "n"):
        close(tst[n], jst[n])


def test_mlstm_refuses_a_length_off_its_chunk():
    arch = _arch("xlstm-1.3b")
    _, cfg, jcfg, _, _ = arch
    jl, tl = _mixer(arch, "mlstm")
    x = _rand((1, 97, cfg.d_model), 1)
    with pytest.raises(AssertionError):
        JS.mlstm_forward(jl, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="97"):
        TS.mlstm_forward(tl, _t(x), cfg)


@pytest.mark.parametrize("kind", ["mamba", "slstm"])
def test_scan_mixers_match_the_reference(kind):
    """Mamba (jamba) and sLSTM (xlstm) at S = 32: the output and the final
    state of the forward, then two decode steps from that state."""
    arch = _arch("jamba-v0.1-52b" if kind == "mamba" else "xlstm-1.3b")
    cfg, jcfg = arch[1], arch[2]
    jl, tl = _mixer(arch, kind)
    x = _rand((2, 32, cfg.d_model), 5)
    jy, jst = getattr(JS, f"{kind}_forward")(jl, jnp.asarray(x), jcfg)
    ty, tst = getattr(TS, f"{kind}_forward")(tl, _t(x), cfg)
    close(ty, jy)
    assert set(tst) == set(jst)
    for n in jst:
        assert tuple(tst[n].shape) == jst[n].shape
        close(tst[n], jst[n])
    for step in range(2):
        x1 = _rand((2, 1, cfg.d_model), 6 + step)
        jy, jst = getattr(JS, f"{kind}_decode")(jl, jnp.asarray(x1), jcfg,
                                                jst)
        ty, tst = getattr(TS, f"{kind}_decode")(tl, _t(x1), cfg, tst)
        close(ty, jy)
        for n in jst:
            close(tst[n], jst[n])


@pytest.mark.parametrize("S", [1, 3, 40])
def test_causal_conv_matches_the_reference(S):
    """The causal conv's output and window, zero-padded and from a state,
    also for S below the window's K - 1."""
    x, w, st = (_rand((2, S, 24), 10), _rand((4, 24), 11),
                _rand((2, 3, 24), 12))
    for state in (None, st):
        jo, js = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 None if state is None else jnp.asarray(state))
        to, ts = TS._causal_conv(_t(x), _t(w),
                                 None if state is None else _t(state))
        close(to, jo)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_mamba_scan_chunks_give_one_scan(monkeypatch):
    """The scan computes its discretisation SCAN_CHUNK steps at a time:
    any chunk gives the one-chunk result bit for bit."""
    cfg = ARCHS["jamba-v0.1-52b"].reduced()
    p = TS.mamba_params(torch.Generator().manual_seed(1), cfg)
    x = _t(_rand((2, 37, cfg.d_model), 13))
    monkeypatch.setattr(TS, "SCAN_CHUNK", 1024)
    want, wst = TS.mamba_forward(p, x, cfg)
    for chunk in (1, 5, 16):
        monkeypatch.setattr(TS, "SCAN_CHUNK", chunk)
        got, gst = TS.mamba_forward(p, x, cfg)
        assert torch.equal(got, want) and torch.equal(gst["h"], wst["h"])


# =============================================================================
# the model: forward with a cache, decode steps, decode equivalence
# =============================================================================

def test_forward_and_decode_match_the_reference(arch):
    """A prefill of 12 tokens (cache leaves and last logits), then five
    decode steps fed the reference's greedy tokens: logits and every cache
    leaf after each."""
    name, cfg, jcfg, jp, tp = arch
    B, S, s_max = 2, 12, 24
    toks = np.random.default_rng(40).integers(0, cfg.vocab, (B, S))
    jx, jcache, jaux = JM.forward(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                  cache=JM.init_cache(jcfg, B, s_max,
                                                      dtype=jnp.float32))
    tx, tcache, taux = TM.forward(tp, cfg, _t(toks),
                                  cache=TM.init_cache(cfg, B, s_max,
                                                      device="cpu"))
    close(tx, jx)
    close(taux, jaux)
    leaves = dict(TM._leaves(tcache))
    jleaves = dict(TM._leaves(jax.tree.map(np.asarray, jcache)))
    assert set(leaves) == set(jleaves)
    for n, a in jleaves.items():
        assert tuple(leaves[n].shape) == a.shape
        close(leaves[n], a)
    tok, pos = toks[:, -1:], np.full(B, S)
    for _ in range(5):
        jl, jcache = JM.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos, jnp.int32), jcache)
        before = dict(TM._leaves(tcache))
        tl, tcache = TM.decode_step(tp, cfg, _t(tok), _t(pos), tcache)
        assert all(t is before[n] for n, t in TM._leaves(tcache))
        close(tl, jl)
        tok, pos = np.asarray(jl).argmax(-1)[:, None], pos + 1
    for n, a in TM._leaves(jax.tree.map(np.asarray, jcache)):
        close(dict(TM._leaves(tcache))[n], a)


def test_decode_matches_the_full_forward(arch):
    """The reference's decode-equivalence invariant in the port: prefill
    S - 4 tokens, decode 4 more, each step's logits the full forward's at
    that position."""
    _, cfg, _, _, tp = arch
    B, S, pre = 2, 16, 12
    toks = _t(np.random.default_rng(3).integers(0, cfg.vocab, (B, S)))
    x, _, _ = TM.forward(tp, cfg, toks)
    full = TM.project_logits(tp, cfg, x)
    cache = TM.init_cache(cfg, B, S, device="cpu")
    _, cache, _ = TM.forward(tp, cfg, toks[:, :pre], cache=cache)
    for t in range(pre, S):
        logits, cache = TM.decode_step(tp, cfg, toks[:, t:t + 1],
                                       torch.full((B,), t), cache)
        close(logits, full[:, t], DECODE_TOL)


def test_init_cache_matches_the_reference(arch):
    _, cfg, jcfg, _, _ = arch
    t = dict(TM._leaves(TM.init_cache(cfg, 3, 20, device="cpu")))
    j = dict(TM._leaves(JM.init_cache(jcfg, 3, 20, dtype=jnp.float32)))
    assert set(t) == set(j)
    for n, a in j.items():
        assert tuple(t[n].shape) == a.shape and not t[n].any()
        assert t[n].dtype == torch.float32 and a.dtype == jnp.float32


# =============================================================================
# the training routes
# =============================================================================

MIXER_ARCH = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-1.3b",
              "slstm": "xlstm-1.3b"}

def _train_leaves(tl, x):
    """Copies of the mixer's parameters and of x that require gradients."""
    return ({n: t.detach().clone().requires_grad_(True)
             for n, t in tl.items()},
            _t(x).requires_grad_(True))


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_gradients_match_jax_vjp(kind):
    """Each mixer's training route at S = 256 (2 Mamba or sLSTM chunks of
    128 steps, 4 mLSTM chunks in 2 outer groups of 2): y, and the gradients
    of x and of every parameter under a seeded cotangent on y, against
    ``jax.vjp`` of the reference's forward."""
    arch = _arch(MIXER_ARCH[kind])
    cfg, jcfg = arch[1], arch[2]
    jl, tl = _mixer(arch, kind)
    x = _rand((2, 256, cfg.d_model), 70)
    dy = _rand((2, 256, cfg.d_model), 71)
    jfn = getattr(JS, f"{kind}_forward")
    jy, vjp = jax.vjp(lambda p, x: jfn(p, x, jcfg)[0], jl, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    tp, tx = _train_leaves(tl, x)
    ty, _ = getattr(TS, f"{kind}_forward")(tp, tx, cfg)
    (ty * _t(dy)).sum().backward()
    close(ty.detach(), jy)
    close(tx.grad, jgx)
    assert set(tp) == set(jgp)
    for n, t in tp.items():
        close(t.grad, jgp[n])


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_checkpoints_change_no_bit(kind, monkeypatch):
    """The training route's y and state are the plain scan's bit for bit
    (S = 300 for Mamba and sLSTM: chunks of 128, 128 and 44; S = 384 for
    mLSTM: 6 chunks in 2 outer groups of 3), and its gradients with the
    checkpoints are those without them bit for bit."""
    arch = _arch(MIXER_ARCH[kind])
    cfg = arch[1]
    _, tl = _mixer(arch, kind)
    fwd = getattr(TS, f"{kind}_forward")
    x = _rand((2, 384 if kind == "mlstm" else 300, cfg.d_model), 72)
    dy = _t(_rand(x.shape, 73))
    with torch.no_grad():
        want_y, want_st = fwd(tl, _t(x), cfg)
    grads = []
    for remat in (True, False):
        if not remat:
            monkeypatch.setattr(TS, "_chunked", lambda fn, remat: fn)
        tp, tx = _train_leaves(tl, x)
        y, st = fwd(tp, tx, cfg)
        assert torch.equal(y.detach(), want_y)
        for n, t in st.items():
            assert torch.equal(t.detach(), want_st[n]), n
        grads.append(torch.autograd.grad(
            (y * dy).sum() + sum(t.sum() for t in st.values()),
            [tx, *tp.values()]))
    for g, g0 in zip(*grads):
        assert torch.equal(g, g0)


def test_serving_takes_the_plain_scans(arch, monkeypatch):
    """A forward with a cache, one without and the engine (grad enabled,
    no leaf requiring a gradient) take the plain scans: every mixer call
    decides against the training route and no checkpoint runs.  The same
    forward on leaves that require gradients decides for it once per
    recurrent layer and runs the scans' checkpoints."""
    _, cfg, _, _, tp = arch
    routes, ckpts = [], []
    real_records, real_ckpt = TS._records, TS.ckpt.checkpoint

    def records(p, x):
        routes.append(real_records(p, x))
        return routes[-1]

    def checkpoint(fn, *a, **k):
        ckpts.append(fn)
        return real_ckpt(fn, *a, **k)
    monkeypatch.setattr(TS, "_records", records)
    monkeypatch.setattr(TS, "ckpt", types.SimpleNamespace(
        checkpoint=checkpoint))
    toks = _t(np.random.default_rng(74).integers(0, cfg.vocab, (2, 64)))
    n_rec = cfg.n_groups * sum(cfg.layer_kind(j) != "attn"
                               for j in range(cfg.group_size))
    assert torch.is_grad_enabled()
    TM.forward(tp, cfg, toks)
    TM.forward(tp, cfg, toks, cache=TM.init_cache(cfg, 2, 64, device="cpu"))
    eng = ServingEngine(cfg, tp, device="cpu", max_batch=2, s_max=48)
    eng.submit(np.arange(1, 20) % cfg.vocab, max_new_tokens=3)
    eng.run_until_drained()
    assert len(routes) == 3 * n_rec and not any(routes) and ckpts == []
    routes.clear()
    leaves = {n: t.detach().requires_grad_(True) for n, t in TM._leaves(tp)}
    TM.forward(TM._tree(leaves), cfg, toks)
    assert routes == [True] * n_rec and ckpts


# =============================================================================
# the engine and the CLI
# =============================================================================

ENGINE = dict(max_batch=2, s_max=48, evict_to_host=True, resident_limit=1)


def _requests(vocab):
    rng = np.random.default_rng(60)
    return [(rng.integers(0, vocab, n), m)
            for n, m in ((5, 6), (17, 4), (9, 8), (30, 5))]


def _counters(fams):
    return {(fam, key): val for fam, f in fams.items()
            if fam.endswith("_total") for key, val in f["samples"].items()}


def _one_step_apart(tenc, jenc):
    """Decoded pages within one mantissa step of the larger block scale,
    exponents at most one apart (the port's inputs differ from the
    reference's in the last bits)."""
    assert tenc.mantissas.shape == jenc.mantissas.shape
    de = np.abs(tenc.exponents.astype(int) - jenc.exponents.astype(int))
    assert de.max() <= 1
    step = 2.0 ** (np.maximum(tenc.exponents, jenc.exponents).astype(
        np.float64) - 6.0)
    diff = np.abs(bfp8_decode(tenc).astype(np.float64).ravel()
                  - jbfp8_decode(jenc).astype(np.float64).ravel())
    assert (diff <= np.repeat(step, 32)[:diff.size] + 1e-12).all()


def test_serving_engine_matches_the_reference(arch):
    """4 requests through 2 slots with host eviction and resident_limit=1:
    the same token streams, counters, host store keys and page names (every
    state leaf), pages within one mantissa step, a resident restore exactly
    the reference's (within TOL) and a host one within one step of the
    page's block scale."""
    _, cfg, jcfg, jp, tp = arch
    jeng = JEngine(jcfg, jp, **ENGINE)
    teng = ServingEngine(cfg, tp, device="cpu", **ENGINE)
    jreqs = [jeng.submit(p, max_new_tokens=m) for p, m in _requests(cfg.vocab)]
    treqs = [teng.submit(p, max_new_tokens=m) for p, m in _requests(cfg.vocab)]
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    want = _counters(jparse(jeng.metrics_text()))
    assert _counters(parse_metrics_text(teng.metrics_text())) == want
    names = {n for n, _ in TM._leaves(TM.init_cache(cfg, 1, 4, device="cpu"))}
    assert teng.stats.evicted_pages == 3 * len(names)
    assert set(teng.host_store) == set(jeng.host_store) == {0, 1, 3}
    assert list(teng.resident_store) == list(jeng.resident_store) == [2]
    for rid, pages in jeng.host_store.items():
        assert set(teng.host_store[rid]) == set(pages) == names
        for n, enc in pages.items():
            _one_step_apart(teng.host_store[rid][n], enc)
    for rid, slot in ((2, 0), (1, 1)):
        jeng.restore_request(rid, slot)
        teng.restore_request(rid, slot)
    for n, j in TM._leaves(jax.tree.map(np.asarray, jeng.cache)):
        t = dict(TM._leaves(teng.cache))[n].numpy()
        close(t[:, 0], j[:, 0])
        step = max(np.abs(j[:, 1]).max() / 64, 1e-30)
        np.testing.assert_allclose(t[:, 1], j[:, 1], rtol=0, atol=step)
    assert teng.stats.restored_pages == jeng.stats.restored_pages \
        == 2 * len(names)


def test_resident_restore_is_bit_exact(arch):
    _, cfg, _, _, tp = arch
    eng = ServingEngine(cfg, tp, device="cpu", **ENGINE)
    for p, m in _requests(cfg.vocab):
        eng.submit(p, max_new_tokens=m)
    eng.run_until_drained()
    (rid, parked), = eng.resident_store.items()
    parked = {k: v.clone() for k, v in parked.items()}
    eng.restore_request(rid, 1)
    for n, c in TM._leaves(eng.cache):
        assert torch.equal(c[:, 1], parked[n])


def _cli_numbers(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    main()
    out = capsys.readouterr().out.splitlines()
    counts = re.findall(r"(prefills|decode_steps)=(\d+)", out[1])
    return out[0].split(":")[0], counts, out[2]


def test_serve_cli_prints_the_reference_counts(arch, capsys, monkeypatch):
    name = arch[0]
    want = _cli_numbers(jserve_cli.main, ["--arch", name], capsys,
                        monkeypatch)
    got = _cli_numbers(tserve_cli.main, ["--arch", name, "--smoke",
                                         "--device", "cpu"], capsys,
                       monkeypatch)
    assert got == want
    assert want[1] == [("prefills", "8"), ("decode_steps", "30")]
