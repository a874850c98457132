"""The port's encoder-decoder (whisper) on the CPU against the reference
package.

The model is ``ARCHS["whisper-large-v3"].reduced(n_layers=2)`` (2 encoder
and 2 decoder layers, d_model 64, 4 heads of 16, 16 encoder frames,
LayerNorm and GELU), with the reference's ``init_params(PRNGKey(0), cfg,
f32)`` carried into the port by ``params_from_numpy``.  Inputs come from
seeded numpy generators and go to both packages.  Tolerance: rtol = atol =
2e-4, the port's standing f32 tolerance (XLA's and PyTorch's CPU matmuls
sum in different orders); decode against the full forward 2e-3, the
reference's own (``tests/test_archs.py::test_decode_matches_full_forward``).
On the CPU the kernel route (``use_kernels=True``) runs
``flash_attention``'s plain version, which the tests hold too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.launch.mesh import make_host_mesh                # noqa: E402
from repro.models import attention as JA                    # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.runtime import steps as JS                       # noqa: E402

import repro_torch.launch.train as ttrain_cli               # noqa: E402
from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.models import attention as TA             # noqa: E402
from repro_torch.models import model as TM                 # noqa: E402
from repro_torch.models import params_from_numpy           # noqa: E402
from repro_torch.runtime import steps as TS                 # noqa: E402
from repro_torch.serving import ServingEngine              # noqa: E402

TOL = 2e-4
DECODE_TOL = 2e-3
NAME = "whisper-large-v3"
CFG = ARCHS[NAME].reduced(n_layers=2)
JCFG = JARCHS[NAME].reduced(n_layers=2)
T = CFG.enc_frames


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def weights():
    """(reference params, the port's params)."""
    jp = JM.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(tree, CFG, "cpu")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _toks(shape, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, shape)


def _layer(tree, g=0):
    """Layer g's leaves of a stacked ``{pos_0: ...}`` group tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    return tree[g]


# =============================================================================
# parameters and cache
# =============================================================================

def test_params_from_numpy_carries_every_leaf(weights):
    jp, tp = weights
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_leaves_with_path(jp)}
    tleaves = dict(TM._leaves(tp))
    assert set(tleaves) == set(jleaves) == set(TM.param_shapes(CFG))
    assert {"groups/pos_0/cross/wq", "groups/pos_0/norm_x/b",
            "encoder/groups/pos_0/ffn/w_up",
            "encoder/final_norm/w"} <= set(tleaves)
    for name, a in jleaves.items():
        np.testing.assert_array_equal(tleaves[name].numpy(), a)
    assert TM.param_count(tp) == JM.param_count(jp)
    # the port's own init draws the same tree
    own = TM.init_params(torch.Generator().manual_seed(0), CFG)
    assert {n: tuple(t.shape) for n, t in TM._leaves(own)} == {
        n: a.shape for n, a in jleaves.items()}


def test_init_cache_has_the_cross_leaves():
    B, s_max = 3, 20
    jc = JM.init_cache(JCFG, B, s_max, dtype=jnp.float32)
    tc = TM.init_cache(CFG, B, s_max, device="cpu")
    assert set(tc["pos_0"]) == set(jc["pos_0"]) == {"k", "v", "xk", "xv"}
    for n, a in jc["pos_0"].items():
        assert tuple(tc["pos_0"][n].shape) == a.shape
    assert tuple(tc["pos_0"]["xk"].shape) == (CFG.n_groups, B, T,
                                              CFG.n_kv_heads, CFG.hd)


# =============================================================================
# attention
# =============================================================================

@pytest.mark.parametrize("use_kernels", [True, False])
def test_encoder_attention_matches_the_reference(weights, use_kernels):
    jp, tp = weights
    jl = _layer(jp["encoder"]["groups"]["pos_0"])["mixer"]
    tl = _layer(tp["encoder"]["groups"]["pos_0"])["mixer"]
    x = _rand((2, T, CFG.d_model), 10)
    pos = np.arange(T)[None]
    close(TA.encoder_attention(tl, _t(x), CFG, _t(pos),
                               use_kernels=use_kernels),
          JA.encoder_attention(jl, jnp.asarray(x), JCFG, jnp.asarray(pos)))


# (decoder rows, encoder frames, KV heads): a prefill and a decode step
# (Sq = 1), frames that no kv block divides and whisper-large-v3's 1500,
# grouped KV heads
CROSS_CASES = [(12, 16, 4), (1, 16, 4), (7, 37, 4), (1, 1500, 4),
               (5, 37, 2)]


@pytest.mark.parametrize("case", CROSS_CASES, ids=[
    f"Sq{c[0]}Sk{c[1]}KH{c[2]}" for c in CROSS_CASES])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_cross_attention_matches_the_reference(weights, case, use_kernels):
    Sq, Sk, KH = case
    jcfg = dataclasses.replace(JCFG, n_kv_heads=KH)
    tcfg = dataclasses.replace(CFG, n_kv_heads=KH)
    d, hd = CFG.d_model, CFG.hd
    p = {"wq": _rand((d, CFG.n_heads * hd), 20) / 8,
         "wk": _rand((d, KH * hd), 21) / 8,
         "wv": _rand((d, KH * hd), 22) / 8,
         "wo": _rand((CFG.n_heads * hd, d), 23) / 8}
    x, enc = _rand((2, Sq, d), 24), _rand((2, Sk, d), 25)
    want = JA.cross_attention({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jnp.asarray(enc), jcfg)
    tp = {k: _t(v) for k, v in p.items()}
    kv = TA.cross_kv(tp, _t(enc), tcfg)
    assert tuple(kv[0].shape) == (2, Sk, KH, hd)
    close(TA.cross_attention(tp, _t(x), kv, tcfg, use_kernels=use_kernels),
          want)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_encoder_forward_matches_the_reference(weights, use_kernels):
    jp, tp = weights
    frames = _rand((2, T, CFG.d_model), 30)
    close(TM._encoder_forward(tp, CFG, _t(frames), use_kernels),
          JM._encoder_forward(jp, JCFG, jnp.asarray(frames)))


# =============================================================================
# the model
# =============================================================================

@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_hidden_states_match_the_reference(weights, use_kernels):
    jp, tp = weights
    toks, frames = _toks((2, 13), 40), _rand((2, T, CFG.d_model), 41)
    jx, _, _ = JM.forward(jp, JCFG, jnp.asarray(toks, jnp.int32),
                          enc_frames=jnp.asarray(frames))
    tx, _, aux = TM.forward(tp, CFG, _t(toks), enc_frames=_t(frames),
                            use_kernels=use_kernels)
    close(tx, jx)
    assert float(aux) == 0.0
    with pytest.raises(ValueError, match="enc_frames"):
        TM.forward(tp, CFG, _t(toks))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_caches_match_the_reference(weights, use_kernels):
    """A prefill writes the prompt's k, v and the encoder's xk, xv."""
    jp, tp = weights
    B, S, s_max = 2, 11, 24
    toks, frames = _toks((B, S), 50), _rand((B, T, CFG.d_model), 51)
    jx, jcache, _ = JM.forward(jp, JCFG, jnp.asarray(toks, jnp.int32),
                               enc_frames=jnp.asarray(frames),
                               cache=JM.init_cache(JCFG, B, s_max,
                                                   dtype=jnp.float32))
    tx, tcache, _ = TM.forward(tp, CFG, _t(toks), enc_frames=_t(frames),
                               cache=TM.init_cache(CFG, B, s_max,
                                                   device="cpu"),
                               use_kernels=use_kernels)
    close(tx, jx)
    for n in ("k", "v", "xk", "xv"):
        assert tuple(tcache["pos_0"][n].shape) == jcache["pos_0"][n].shape
        close(tcache["pos_0"][n], jcache["pos_0"][n])
    close(TM.project_logits(tp, CFG, tx[:, -1]),
          JM.project_logits(jp, JCFG, jx[:, -1]))
    wrong = _t(_rand((B, T + 1, CFG.d_model), 52))
    with pytest.raises(ValueError, match="xk"):
        TM.forward(tp, CFG, _t(toks), enc_frames=wrong,
                   cache=TM.init_cache(CFG, B, s_max, device="cpu"))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_decode_step_logits_over_several_steps(weights, use_kernels):
    """Five decode steps after a prefill, the reference's tokens fed to
    both: logits and the self-attention cache alike; the cross cache read
    and left as the prefill wrote it."""
    jp, tp = weights
    B, S, s_max = 2, 9, 24
    toks, frames = _toks((B, S), 60), _rand((B, T, CFG.d_model), 61)
    _, jcache, _ = JM.forward(jp, JCFG, jnp.asarray(toks, jnp.int32),
                              enc_frames=jnp.asarray(frames),
                              cache=JM.init_cache(JCFG, B, s_max,
                                                  dtype=jnp.float32))
    _, tcache, _ = TM.forward(tp, CFG, _t(toks), enc_frames=_t(frames),
                              cache=TM.init_cache(CFG, B, s_max,
                                                  device="cpu"))
    xk = tcache["pos_0"]["xk"].clone()
    tok, pos = toks[:, -1:], np.full(B, S)
    for _ in range(5):
        jl, jcache = JM.decode_step(jp, JCFG, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos, jnp.int32), jcache)
        tl, tcache = TM.decode_step(tp, CFG, _t(tok), _t(pos), tcache,
                                    use_kernels=use_kernels)
        close(tl, jl)
        tok, pos = np.asarray(jl).argmax(-1)[:, None], pos + 1
    for n in ("k", "v", "xk", "xv"):
        close(tcache["pos_0"][n], jcache["pos_0"][n])
    assert torch.equal(tcache["pos_0"]["xk"], xk)


def test_step_builders_match_the_reference(weights):
    """make_prefill_step / make_decode_step against the reference's on the
    host mesh: last logits, every cache leaf, then three decode steps."""
    jp, tp = weights
    B, S, s_max = 2, 10, 16
    toks, frames = _toks((B, S), 70), _rand((B, T, CFG.d_model), 71)
    with make_host_mesh() as mesh:
        jpre, _, _ = JS.make_prefill_step(JCFG, mesh, B, s_max,
                                          dtype=jnp.float32)
        jdec, _, _ = JS.make_decode_step(JCFG, mesh, B, s_max,
                                         dtype=jnp.float32)
        jl, jcache = jpre(jp, JM.init_cache(JCFG, B, s_max,
                                            dtype=jnp.float32),
                          {"tokens": jnp.asarray(toks, jnp.int32),
                           "enc_frames": jnp.asarray(frames)})
        tpre = TS.make_prefill_step(CFG, B, s_max, device="cpu")
        tdec = TS.make_decode_step(CFG, B, s_max, device="cpu")
        tl, tcache = tpre(tp, TM.init_cache(CFG, B, s_max, device="cpu"),
                          {"tokens": toks, "enc_frames": frames})
        close(tl, jl)
        for n in ("k", "v", "xk", "xv"):
            close(tcache["pos_0"][n], jcache["pos_0"][n])
        tok, pos = np.asarray(jl).argmax(-1)[:, None], np.full(B, S)
        for _ in range(3):
            jl, jcache = jdec(jp, jcache, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos, jnp.int32))
            tl, tcache = tdec(tp, tcache, tok, pos)
            close(tl, jl)
            tok, pos = np.asarray(jl).argmax(-1)[:, None], pos + 1
    with pytest.raises(ValueError):
        tpre(tp, TM.init_cache(CFG, B, s_max, device="cpu"),
             {"tokens": _toks((B, s_max + 1), 72), "enc_frames": frames})
    with pytest.raises(ValueError):
        tdec(tp, tcache, tok[:1], pos[:1])
    # bf16, refused until the port took it: the step builders take it, and
    # a prefill on bf16 weights and cache gives f32 logits, a bf16 cache
    bpre = TS.make_prefill_step(CFG, B, s_max, dtype=torch.bfloat16,
                                device="cpu")
    bp = {n: t.to(torch.bfloat16) for n, t in TM._leaves(tp)}
    bl, bcache = bpre(TM._tree(bp), TM.init_cache(
        CFG, B, s_max, dtype=torch.bfloat16, device="cpu"),
        {"tokens": toks,
         "enc_frames": torch.from_numpy(frames).to(torch.bfloat16)})
    assert bl.dtype == torch.float32 and torch.isfinite(bl).all()
    assert all(t.dtype == torch.bfloat16 for _, t in TM._leaves(bcache))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_decode_matches_full_forward(weights, use_kernels):
    """The reference's decode-equivalence invariant in the port: prefill 12
    of 16 tokens, decode the rest, each step's logits against the full
    forward's within 2e-3; and the full forward against the reference's."""
    jp, tp = weights
    B, S, pre = 2, 16, 12
    toks, frames = _toks((B, S), 80), _rand((B, T, CFG.d_model), 81)
    tx, _, _ = TM.forward(tp, CFG, _t(toks), enc_frames=_t(frames),
                          use_kernels=use_kernels)
    full = TM.project_logits(tp, CFG, tx)
    jx, _, _ = JM.forward(jp, JCFG, jnp.asarray(toks, jnp.int32),
                          enc_frames=jnp.asarray(frames))
    close(full, JM.project_logits(jp, JCFG, jx))
    _, cache, _ = TM.forward(tp, CFG, _t(toks[:, :pre]),
                             enc_frames=_t(frames),
                             cache=TM.init_cache(CFG, B, S, device="cpu"),
                             use_kernels=use_kernels)
    for t in range(pre, S):
        logits, cache = TM.decode_step(tp, CFG, _t(toks[:, t:t + 1]),
                                       torch.full((B,), t), cache,
                                       use_kernels=use_kernels)
        close(logits, full[:, t], DECODE_TOL)


def test_the_encoder_decoder_refuses_what_is_not_ported(weights,
                                                        tmp_path):
    """The engine and the train CLI, which have no encoder frames to give,
    refuse whisper before building anything, naming what serves it
    (make_prefill_step) and what trains it (make_train_step on batches
    that carry enc_frames)."""
    _, tp = weights
    with pytest.raises(ValueError, match="make_prefill_step"):
        ServingEngine(CFG, tp, device="cpu")
    with pytest.raises(ValueError, match="make_train_step.*enc_frames"):
        ttrain_cli.main(["--arch", NAME, "--smoke", "--device", "cpu",
                         "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
