"""The port's training path on the CPU against the reference package.

``lm_loss`` and its gradients (the attention families and the recurrent
mixers of jamba and xlstm), ``FlashAttention``'s plain route (the
forward with its log-sum-exp and the blockwise backward the kernels
compute), ``adamw_update``, ``make_train_step``, the token pipeline, the
checkpoint store (both packages restore each other's checkpoints), the
fault-tolerant loop and the train CLI.  Models are the reduced configs,
weights the reference's ``init_params(PRNGKey(0))`` carried over with
``params_from_numpy``; every other input comes from seeded numpy
generators and goes to both packages.

Tolerances: the loss within rtol 1e-5 and every gradient leaf, metric and
updated parameter within rtol = atol = 2e-4 (XLA's and PyTorch's CPU
matrix products and reductions sum in other orders; the port's standing
f32 tolerance); AdamW's parameters and moments within 2e-6 relative, of
the element or of the leaf's largest value (the same elementwise f32
arithmetic; only ``global_norm``'s sum order differs, and a one-ulp change
of the clip factor it sets moves a moment where ``b1 m`` and ``(1 - b1) g``
cancel by more than its own 2e-6).
"""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402
from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig   # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipeline  # noqa: E402
from repro.data.pipeline import write_token_file            # noqa: E402
from repro.launch.mesh import make_host_mesh                # noqa: E402
from repro.models import attention as JA                    # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.optim import adamw as JO                         # noqa: E402
from repro.runtime.steps import make_train_step as jmake_step  # noqa: E402

import repro_torch.launch.train as ttrain_cli               # noqa: E402
from repro_torch.checkpoint import CheckpointStore          # noqa: E402
from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline      # noqa: E402
from repro_torch.kernels import flash_attention as FA       # noqa: E402
from repro_torch.models import attention as TA              # noqa: E402
from repro_torch.models import model as TM                  # noqa: E402
from repro_torch.models import params_from_numpy            # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry         # noqa: E402
from repro_torch.obs.metrics import parse_metrics_text      # noqa: E402
from repro_torch.optim import adamw as TO                   # noqa: E402
from repro_torch.runtime import fault as TF                 # noqa: E402
from repro_torch.runtime.steps import (accumulate_grads,    # noqa: E402
                                       auto_microbatches, loss_and_grads,
                                       make_train_step)

TOL = 2e-4
RECURRENT = ("jamba-v0.1-52b", "xlstm-1.3b")
ARCH_NAMES = ("yi-6b", "phi4-mini-3.8b", "olmoe-1b-7b") + RECURRENT


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


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= {f"{k}/{n}": t for n, t in _tflat(v).items()}
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def models():
    """arch -> (reference config, port config, reference params, numpy
    tree)."""
    out = {}
    for name in ARCH_NAMES:
        jc, tc = JARCHS[name].reduced(), ARCHS[name].reduced()
        jp = JM.init_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
        out[name] = (jc, tc, jp, jax.tree.map(np.asarray, jp))
    return out


def _batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


# =============================================================================
# lm_loss and its gradients
# =============================================================================

@pytest.fixture(scope="module")
def reference_grads(models):
    """arch -> (tokens, labels, loss, gradients) of the reference's
    lm_loss (its remat changes no value, so one per arch)."""
    out = {}
    for arch, (jc, _, jp, _) in models.items():
        B, S = {"yi-6b": (1, 1024)}.get(
            arch, (2, 256) if arch in RECURRENT else (2, 64))
        toks, labs = _batch(jc.vocab, B, S, 1)
        jl, jg = jax.value_and_grad(lambda p: JM.lm_loss(
            p, jc, jnp.asarray(toks), jnp.asarray(labs)))(jp)
        out[arch] = (toks, labs, jl, jg)
    return out


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_lm_loss_and_gradients_match_the_reference(models, reference_grads,
                                                   arch, remat):
    """Tied embeddings (phi4-mini) get gradients from the lookup and the
    head; olmoe adds 0.01 x its load-balancing loss.  yi-6b's S = 1024
    takes two loss chunks of 512.  jamba (Mamba, attention, experts) and
    xlstm (mLSTM, sLSTM) at S = 256 run every scan over more than one
    checkpointed chunk: 2 Mamba and 2 sLSTM chunks of 128 steps, 4 mLSTM
    chunks of 64 in 2 outer groups of 2, nested in the group's checkpoint
    for remat full and dots."""
    jc, tc, jp, tree = models[arch]
    toks, labs, jl, jg = reference_grads[arch]
    tp = params_from_numpy(tree, tc, "cpu")
    loss, grads = loss_and_grads(tp, tc, torch.from_numpy(toks),
                                 torch.from_numpy(labs), remat=remat)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want, got = _jflat(jg), _tflat(grads)
    assert set(got) == set(want)
    for name in want:
        close(got[name].numpy(), want[name])


def test_lm_loss_kernel_and_plain_routes_agree(models):
    """On the CPU the kernel route is FlashAttention's plain versions; the
    plain route autograd through chunked_attention."""
    jc, tc, _, tree = models["yi-6b"]
    toks, labs = map(torch.from_numpy, _batch(jc.vocab, 2, 96, 2))
    tp = params_from_numpy(tree, tc, "cpu")
    lk, gk = loss_and_grads(tp, tc, toks, labs, use_kernels=True)
    lp, gp = loss_and_grads(tp, tc, toks, labs, use_kernels=False)
    close(lk, lp)
    for name, g in _tflat(gp).items():
        close(_tflat(gk)[name], g)


def test_lm_loss_refuses_a_ragged_chunk(models):
    jc, tc, _, tree = models["yi-6b"]
    tp = params_from_numpy(tree, tc, "cpu")
    toks = torch.zeros((1, 600), dtype=torch.int64)
    with pytest.raises(ValueError, match="chunk"):
        TM.lm_loss(tp, tc, toks, toks)


def test_forward_unbinds_each_stacked_leaf_once(models):
    """One UnbindBackward node per stacked leaf in the graph, and no
    per-group select of a stacked leaf."""
    jc, tc, _, tree = models["olmoe-1b-7b"]
    tp = params_from_numpy(tree, tc, "cpu")
    for t in _tflat(tp).values():
        t.requires_grad_(True)
    toks = torch.zeros((1, 16), dtype=torch.int64)
    x, _, aux = TM.forward(tp, tc, toks)
    seen, names, stack = set(), [], [x.grad_fn, aux.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    n_stacked = sum(1 for n in _tflat(tp) if n.startswith("groups/"))
    assert names.count("UnbindBackward0") == n_stacked


# =============================================================================
# flash attention's gradient, plain route
# =============================================================================

# (B, Sq, Sk, H, D, causal): one S, causal and not, then keys of their own
# length (non-causal: the encoder-decoder's cross attention), Sq 1, 16, 37
# against Sk 1, 33, 130
FLASH_GRAD_CASES = (
    [((B, S, S, H, D), causal) for B, S, H, D in (
        (2, 64, 2, 16), (1, 77, 3, 32), (1, 130, 2, 64), (1, 33, 2, 128))
     for causal in (True, False)]
    + [((2, Sq, Sk, 2, D), False) for Sq in (1, 16, 37) for Sk in (1, 33, 130)
       for D in (16, 64)])
FLASH_GRAD_IDS = [f"S{s[1]}D{s[4]}-{c}" if i < 8 else
                  f"Sq{s[1]}Sk{s[2]}D{s[4]}-{c}"
                  for i, (s, c) in enumerate(FLASH_GRAD_CASES)]


def _qkv_own(shape, seed):
    """q, k, v, dO of (B, Sq, Sk, H, D): q and dO (B, Sq, H, D), k and v
    (B, Sk, H, D); at Sq == Sk the four draws of :func:`_qkv`."""
    B, Sq, Sk, H, D = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, n, H, D), dtype=np.float32)
            for n in (Sq, Sk, Sk, Sq)]


@pytest.mark.parametrize("shape,causal", FLASH_GRAD_CASES,
                         ids=FLASH_GRAD_IDS)
def test_flash_gradient_matches_jax_vjp(shape, causal):
    """FlashAttention on the CPU (chunked_attention with lse, then
    flash_attention_backward_plain) against ``jax.vjp`` of the reference's
    chunked_attention, also over keys of their own length (dK and dV of
    k's shape); and the lse against logsumexp of the scores."""
    q, k, v, do = _qkv_own(shape, shape[1])
    S, Sk, D = shape[1], shape[2], shape[4]

    def jfn(q, k, v):
        return JA.chunked_attention(q, k, v, causal=causal, chunk=Sk)
    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = FA.FlashAttention.apply(tq, tk, tv, causal)
    close(o.detach().numpy(), np.asarray(jo))
    o.backward(torch.from_numpy(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.shape == w.shape
        close(got.numpy(), np.asarray(w))
    # the plain backward called directly, from the plain forward's lse
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o2, lse, _ = FA.flash_attention_lse(t[0], t[1], t[2], causal=causal)
    s = np.einsum("bqhd,bkhd->bhqk", q * np.float32(D ** -0.5), k)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -2.0 ** 30)
    m = s.max(-1, keepdims=True)
    close(lse.numpy(), (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))
          [..., 0])
    for got, w in zip(FA.flash_attention_backward_plain(
            t[0], t[1], t[2], o2, lse, t[3], causal), want):
        close(got.numpy(), np.asarray(w))


def test_flash_gradient_through_gqa_projections():
    """prefill_attention on the training route (inference=False,
    use_kernels=True) on reduced yi-6b, 4 query heads over 2 KV heads: the
    KV weights are repeated to H, so autograd sums dK and dV over the
    copies.  Gradients of x and of wq, wk, wv, wo against jax.grad of the
    reference's prefill_attention."""
    jc, tc = JARCHS["yi-6b"].reduced(), ARCHS["yi-6b"].reduced()
    jp = JA.attn_params(jax.random.PRNGKey(1), jc, jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 48, jc.d_model), dtype=np.float32)
    dy = rng.standard_normal((2, 48, jc.d_model), dtype=np.float32)
    pos = np.arange(48)[None]

    def jfn(p, x):
        out, _ = JA.prefill_attention(p, x, jc, jnp.asarray(pos))
        return jnp.sum(out * jnp.asarray(dy))
    jg_p, jg_x = jax.grad(jfn, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {n: torch.from_numpy(np.array(a)).requires_grad_(True)
          for n, a in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = TA.prefill_attention(tp, tx, tc, torch.from_numpy(pos))
    (out * torch.from_numpy(dy)).sum().backward()
    close(tx.grad.numpy(), np.asarray(jg_x))
    for n in ("wq", "wk", "wv", "wo"):
        close(tp[n].grad.numpy(), np.asarray(jg_p[n]))


class _ExactAttention(torch.autograd.Function):
    """Softmax attention in the inputs' dtype (f64 here) with the lse the
    kernels keep, and flash_attention_backward_plain as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        D, S = q.shape[-1], q.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q * D ** -0.5, k)
        if causal:
            mask = torch.ones(S, S, dtype=torch.bool).tril()
            s = torch.where(mask, s, FA.NEG_INF)
        lse = torch.logsumexp(s, -1)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*FA.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                   ctx.causal), None)


# (causal, Sq, Sk): one S, then keys of their own length (non-causal), more
# and fewer than the queries and one key
GRADCHECK_CASES = [(True, 70, 70), (False, 70, 70), (False, 70, 23),
                   (False, 5, 130), (False, 37, 1)]


@pytest.mark.parametrize("causal,Sq,Sk", GRADCHECK_CASES, ids=[
    str(c) if q == k else f"Sq{q}Sk{k}" for c, q, k in GRADCHECK_CASES])
def test_plain_backward_gradcheck_f64(causal, Sq, Sk):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, n, 1, 8, generator=g, dtype=torch.float64,
                           requires_grad=True) for n in (Sq, Sk, Sk))
    assert torch.autograd.gradcheck(
        lambda q, k, v: _ExactAttention.apply(q, k, v, causal), (q, k, v),
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_flash_backward_refuses_mismatched_shapes():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        FA.flash_attention_backward(q, q[:, :4], q, q, q, q, True)


def test_flash_training_refuses_causal_keys_of_their_own_length():
    """Keys of their own length are non-causal only: a causal call with Sk
    != S is refused by the lse forward, both backward halves and
    FlashAttention; non-causal, dK and dV take k's shape, and o, dO, lse
    and delta must fit q."""
    rng = np.random.default_rng(4)
    q, o, do = (torch.from_numpy(rng.standard_normal(
        (1, 8, 2, 16), dtype=np.float32)) for _ in range(3))
    k, v = (torch.from_numpy(rng.standard_normal(
        (1, 5, 2, 16), dtype=np.float32)) for _ in range(2))
    lse = torch.zeros(1, 2, 8)
    for call in (lambda: FA.flash_attention_lse(q, k, v, causal=True),
                 lambda: FA.flash_attention_bwd_dq(q, k, v, o, do, lse, True),
                 lambda: FA.flash_attention_bwd_dkdv(q, k, v, do, lse, lse,
                                                     True),
                 lambda: FA.FlashAttention.apply(q, k, v, True)):
        with pytest.raises(ValueError, match="shape"):
            call()
    o, lse, _ = FA.flash_attention_lse(q, k, v, causal=False)
    dk, dv = FA.flash_attention_backward(q, k, v, o, lse, do, False)[1:]
    assert dk.shape == dv.shape == k.shape
    for bad in (lambda: FA.flash_attention_bwd_dq(q, k, v, o[:, :5], do,
                                                  lse, False),
                lambda: FA.flash_attention_bwd_dkdv(q, k, v, do[:, :5], lse,
                                                    lse, False),
                lambda: FA.flash_attention_bwd_dkdv(q, k, v, do, lse,
                                                    lse[:, :, :5], False)):
        with pytest.raises(ValueError, match="fit"):
            bad()


# =============================================================================
# AdamW
# =============================================================================

def _opt_tree(seed):
    """A stacked-leaf tree: norms (2, 8) and a projection (2, 8, 16) under
    groups, an embedding (32, 8), final_norm (8,)."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (32, 8), "final_norm": {"w": (8,)},
              "groups": {"pos_0": {"norm1": {"w": (2, 8)},
                                   "mixer": {"wq": (2, 8, 16)}}}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return draw(shapes)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t_tree(tree):
    if isinstance(tree, dict):
        return {k: _t_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_schedule_matches_the_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 105):
        want = float(JO.schedule(JO.AdamWConfig(**cfg), jnp.asarray(step)))
        got = float(TO.schedule(TO.AdamWConfig(**cfg), torch.tensor(step)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("slice_elems", [None, 16], ids=["whole", "sliced"])
@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_adamw_update_matches_the_reference(quantize, slice_elems,
                                            monkeypatch):
    """Three steps across the warmup edge (warmup 2) from the same
    parameters and gradients; weight decay on the stacked norms (2 axes),
    not on final_norm.  ``sliced`` updates 2 rows at a time."""
    if slice_elems:
        monkeypatch.setattr(TO, "SLICE_ELEMS", slice_elems)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, quantize_states=quantize)
    jcfg, tcfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    p0 = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = _t_tree(p0)
    js, ts = JO.init_opt_state(jp, jcfg), TO.init_opt_state(tp, tcfg)
    for i in range(3):
        g = _opt_tree(10 + i)
        jp, js, jm = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                     jcfg)
        tp, ts, tm = TO.adamw_update(tp, _t_tree(g), ts, tcfg)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-6)
        for name, want in _jflat(jp).items():
            np.testing.assert_allclose(_tflat(tp)[name].numpy(), want,
                                       rtol=2e-6,
                                       atol=2e-6 * np.abs(want).max())
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for mv in ("m", "v"):
            want, got = _jflat(js[mv]), _tflat(ts[mv])
            for name in want:
                if not quantize or name.endswith("/s"):
                    np.testing.assert_allclose(
                        got[name].numpy(), want[name], rtol=2e-6,
                        atol=2e-6 * np.abs(want[name]).max())
                else:
                    # mantissas equal, or one apart only at a half-way tie
                    d = got[name].numpy().astype(int) - want[name].astype(int)
                    assert np.abs(d).max() <= 1, name
                    assert (d != 0).mean() < 0.01, name


def test_weight_decay_skips_one_axis_leaves():
    """Zero moments, zero gradients: the update is exactly lr x wd x p on
    leaves of two or more axes and nothing on a vector."""
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3)
    p = {"final_norm": {"w": torch.ones(8)},
         "norm1": {"w": torch.ones(2, 8)}}
    st = TO.init_opt_state(p, cfg)
    g = {"final_norm": {"w": torch.zeros(8)},
         "norm1": {"w": torch.zeros(2, 8)}}
    TO.adamw_update(p, g, st, cfg)
    assert torch.equal(p["final_norm"]["w"], torch.ones(8))
    assert float(p["norm1"]["w"][0, 0]) < 1.0
    assert g["final_norm"]["w"] is None and g["norm1"]["w"] is None


def test_quantized_state_is_int8_and_smaller():
    cfg = TO.AdamWConfig(quantize_states=True)
    params = {"w": torch.ones((4, 256))}
    state = TO.init_opt_state(params, cfg)
    assert state["m"]["w"]["q"].dtype == torch.int8
    assert state["m"]["w"]["s"].shape == (4, 1)
    plain = TO.init_opt_state(params, TO.AdamWConfig())
    assert TO.opt_state_bytes(state) < 0.4 * TO.opt_state_bytes(plain)


# =============================================================================
# the train step
# =============================================================================

#: the largest |update| f32 AdamW gives at step 2 is about 1 (Cauchy-
#: Schwarz over the bias-corrected moments); past it only int8 states reach
AMPLIFIED = 1.5


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("mbs", [1, 2])
def test_train_step_matches_the_reference(models, mbs, quantize):
    """Two steps of make_train_step against the reference's on the host
    mesh (int8 states accumulate microbatches in bf16): loss, lr,
    grad_norm and the new parameters.

    With int8 states the reference's own second update is unbounded where a
    row's int8 v rounds to 0 and m does not: it becomes m / |g| of the new
    gradient (up to 1e5 x lr here), so a last-bit change of a small g, from
    another sum order, moves it by more than any tolerance.  Where the
    reference's |update| exceeds AMPLIFIED (at most 5% of the elements)
    the port's update is held to its sign; every other element to
    2e-4."""
    jc, tc, jp, tree = models["yi-6b"]
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4,
              quantize_states=quantize)
    jcfg, tcfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    with make_host_mesh() as mesh:
        jstep, _, _ = jmake_step(jc, mesh, jcfg, remat="full",
                                 dtype=jnp.float32, microbatches=mbs)
        jstep = jax.jit(jstep)
        jo = JO.init_opt_state(jp, jcfg)
        tp = params_from_numpy(tree, tc, "cpu")
        tstep = make_train_step(tc, tcfg, microbatches=mbs, device="cpu")
        to = TO.init_opt_state(tp, tcfg)
        jpp = jp
        for i in range(2):
            toks, labs = _batch(jc.vocab, 2, 64, 20 + i)
            batch = {"tokens": toks, "labels": labs}
            prev = _jflat(jpp)
            jpp, jo, jm = jstep(jpp, jo, jax.tree.map(jnp.asarray, batch))
            tp, to, tm = tstep(tp, to, batch)
            for k in ("loss", "lr", "grad_norm"):
                close(float(tm[k]), float(jm[k]))
            n_amp = n_all = 0
            for name, want in _jflat(jpp).items():
                got = _tflat(tp)[name].numpy()
                lr, p0 = float(jm["lr"]), prev[name]
                decay = 0.1 * p0 if p0.ndim >= 2 else 0.0
                u_ref = (p0 - want) / lr - decay
                amp = np.abs(u_ref) > AMPLIFIED
                n_amp, n_all = n_amp + amp.sum(), n_all + amp.size
                if amp.any():
                    assert quantize, name
                    u_got = (p0 - got) / lr - decay
                    assert np.isfinite(got).all(), name
                    assert (np.sign(u_got[amp]) == np.sign(u_ref[amp])).all()
                close(got[~amp], want[~amp])
            assert n_amp <= 0.05 * n_all


def test_auto_microbatches():
    assert auto_microbatches(8) == 8
    assert auto_microbatches(8, devices=2) == 4
    assert auto_microbatches(6, devices=4) == 1
    assert auto_microbatches(1) == 1


def test_bf16_is_refused_naming_its_queue_item():
    """bf16 was refused until the port took it; now make_train_step takes
    it: one step on bf16 parameters keeps them bf16 and finite, and moves
    the loss it reports (tests/test_torch_bf16.py holds it to the
    reference)."""
    cfg = ARCHS["yi-6b"].reduced()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.bfloat16)
    opt_cfg = TO.AdamWConfig(warmup_steps=1)
    step = make_train_step(cfg, opt_cfg, dtype=torch.bfloat16, device="cpu")
    toks, labs = _batch(cfg.vocab, 2, 32, 3)
    params, _, m = step(params, TO.init_opt_state(params, opt_cfg),
                        {"tokens": toks, "labels": labs})
    assert np.isfinite(float(m["loss"]))
    for name, t in TM._leaves(params):
        assert t.dtype == torch.bfloat16 and torch.isfinite(t).all(), name


# =============================================================================
# data
# =============================================================================

def test_token_pipeline_batches_are_the_references(tmp_path):
    for cfg in (dict(vocab=64000, seq_len=32, global_batch=3),
                dict(vocab=100, seq_len=8, global_batch=2, seed=7,
                     zipf_a=1.5)):
        a, b = JPipeline(JDataConfig(**cfg)), TokenPipeline(DataConfig(**cfg))
        for step in (0, 1, 17):
            for k in ("tokens", "labels"):
                x, y = a.batch_at(step)[k], b.batch_at(step)[k]
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    path = str(tmp_path / "toks.bin")
    write_token_file(path, np.arange(10_000) % 50)
    kw = dict(vocab=50, seq_len=16, global_batch=2, source="file", path=path)
    a, b = JPipeline(JDataConfig(**kw)), TokenPipeline(DataConfig(**kw))
    assert a.batch_at(3)["tokens"].tobytes() == \
        b.batch_at(3)["tokens"].tobytes()
    it = b.iter_from(5)
    assert next(it)["tokens"].tobytes() == \
        a.batch_at(5)["tokens"].tobytes()
    it.close()


# =============================================================================
# checkpoints
# =============================================================================

def TF_paths(tree):
    """(path, leaf) pairs of a checkpoint tree, in the store's order."""
    from repro_torch.checkpoint.store import _paths
    return list(_paths(tree))


def _ck_trees():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 64)).astype(np.float32)
    c = rng.standard_normal((5, 40)).astype(np.float32)
    q = rng.integers(-127, 128, (4, 8)).astype(np.int8)
    jt = ({"a": jnp.asarray(a), "b": {"c": jnp.asarray(c, jnp.bfloat16)}},
          {"m": {"q": jnp.asarray(q)}, "step": jnp.asarray(3, jnp.int32)})
    tt = ({"a": torch.from_numpy(a),
           "b": {"c": torch.from_numpy(c).to(torch.bfloat16)}},
          {"m": {"q": torch.from_numpy(q)},
           "step": torch.tensor(3, dtype=torch.int32)})
    return jt, tt


@pytest.mark.parametrize("bfp8", [False, True], ids=["raw", "bfp8"])
def test_checkpoints_cross_between_the_packages(tmp_path, bfp8):
    """The port restores the reference's checkpoint and the reference the
    port's (f32, bf16 and int8 leaves; BFP8 mode); the manifests are equal
    key for key and file for file."""
    jt, tt = _ck_trees()
    JStore(str(tmp_path / "j"), bfp8=bfp8).save(7, jt, {"next_step": 8})
    CheckpointStore(str(tmp_path / "t"), bfp8=bfp8).save(7, tt,
                                                         {"next_step": 8})
    mj = json.loads((tmp_path / "j/step_7/manifest.json").read_text())
    mt = json.loads((tmp_path / "t/step_7/manifest.json").read_text())
    assert mj == mt
    assert list(mj["leaves"]) == list(mt["leaves"])
    for f in sorted(p.name for p in (tmp_path / "j/step_7").iterdir()):
        assert (tmp_path / "j/step_7" / f).read_bytes() == \
            (tmp_path / "t/step_7" / f).read_bytes(), f
    t_from_j, extra = CheckpointStore(str(tmp_path / "j")).restore(tt)
    assert extra == {"next_step": 8}
    j_from_t, _ = JStore(str(tmp_path / "t")).restore(jt)
    for got, want in zip(_tflat(dict(enumerate(t_from_j))).items(),
                         _tflat(dict(enumerate(tt))).items()):
        assert got[0] == want[0] and got[1].dtype == want[1].dtype
        if bfp8 and got[1].is_floating_point():
            err = (got[1].float() - want[1].float()).abs().max()
            assert err < want[1].float().abs().max() * 0.02
        else:
            assert torch.equal(got[1], want[1])
    for name, want in _jflat(j_from_t).items():
        got = _tflat(dict(enumerate(t_from_j)))[name]
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))


def test_checkpoint_commit_gc_and_async(tmp_path):
    _, tt = _ck_trees()
    store = CheckpointStore(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        store.save(s, tt)
    assert not list(tmp_path.glob("*.tmp"))
    assert store.steps() == [3, 4] and store.latest_step() == 4
    store.save_async(5, tt, {"next_step": 6})
    store.wait()
    assert store.steps() == [4, 5]
    out, extra = store.restore(tt)
    assert extra == {"next_step": 6}
    assert torch.equal(out[0]["a"], tt[0]["a"])
    assert out[0]["b"]["c"].dtype == torch.bfloat16
    # onto a 1x1 mesh: every leaf a DTensor laid out by its spec, the same
    # bytes
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.sharding import named_shardings
    mesh = make_host_mesh("cpu")
    specs = ({"a": ("data", "model"), "b": {"c": (None, "model")}},
             {"m": {"q": ("model", None)}, "step": ()})
    laid, extra = store.restore(tt, shardings=named_shardings(mesh, specs))
    assert extra == {"next_step": 6}
    for (_, got), (_, want) in zip(TF_paths(laid), TF_paths(tt)):
        assert isinstance(got, DTensor) and got.device_mesh == mesh
        assert tuple(got.placements) == (Replicate(), Replicate())
        assert got.dtype == want.dtype
        assert torch.equal(got.full_tensor(), want)
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path / "empty")).restore(tt)


# =============================================================================
# the fault-tolerant loop (the reference's test_substrates cases)
# =============================================================================

def _loop(tmp_path, fail_at=(), metrics=None):
    store = CheckpointStore(str(tmp_path))
    calls = {}

    def step_fn(state, batch):
        return {"x": state["x"] + batch}

    def injector(step):
        if step in fail_at and not calls.get(step):
            calls[step] = 1
            raise RuntimeError(f"injected fault at {step}")

    return TF.FaultTolerantLoop(step_fn, store,
                                TF.FaultConfig(checkpoint_every=3,
                                               max_retries=1),
                                fault_injector=injector,
                                metrics=metrics), store


def test_fault_loop_clean_run(tmp_path):
    loop, store = _loop(tmp_path)
    out = loop.run({"x": 0}, lambda s: 1, start_step=0, num_steps=10)
    assert out["x"] == 10 and store.latest_step() == 9


def test_fault_loop_transient_fault_retried(tmp_path):
    loop, _ = _loop(tmp_path, fail_at=(4,))
    out = loop.run({"x": 0}, lambda s: 1, start_step=0, num_steps=8)
    assert out["x"] == 8
    assert any(e["kind"] == "retry" for e in loop.events)


def test_fault_loop_restart_resumes_from_checkpoint(tmp_path):
    loop, _ = _loop(tmp_path)
    loop.run({"x": torch.tensor(0)}, lambda s: 1, start_step=0, num_steps=7)
    loop2, _ = _loop(tmp_path)
    state, next_step = loop2.try_restore({"x": torch.tensor(0)})
    assert next_step == 6 and int(state["x"]) == 6
    out = loop2.run(state, lambda s: 1, start_step=next_step, num_steps=4)
    assert int(out["x"]) == 10
    assert [e["kind"] for e in loop2.events][0] == "restore"


def test_fault_loop_rolls_back_when_retries_run_out(tmp_path):
    store = CheckpointStore(str(tmp_path))
    seen = {"n": 0}

    def injector(step):
        if step == 4 and seen["n"] < 2:
            seen["n"] += 1
            raise RuntimeError("down")

    loop = TF.FaultTolerantLoop(lambda s, b: {"x": s["x"] + b}, store,
                                TF.FaultConfig(checkpoint_every=3,
                                               max_retries=1),
                                fault_injector=injector)
    out = loop.run({"x": torch.tensor(0)}, lambda s: 1, start_step=0,
                   num_steps=6)
    kinds = [e["kind"] for e in loop.events]
    assert "rollback" in kinds and int(out["x"]) == 6


def test_fault_loop_straggler_detection(tmp_path):
    import time as _t

    def slow_step(state, batch):
        _t.sleep(0.25 if batch == 9 else 0.01)
        return state

    loop = TF.FaultTolerantLoop(slow_step, CheckpointStore(str(tmp_path)),
                                TF.FaultConfig(straggler_factor=3.0))
    loop.run({}, lambda s: s, start_step=0, num_steps=12)
    assert any(e["kind"] == "straggler" for e in loop.events)


def test_fault_events_land_in_the_metrics_registry(tmp_path):
    from collections import Counter as Tally
    reg = MetricsRegistry()
    loop, _ = _loop(tmp_path, fail_at=(4,), metrics=reg)
    out = loop.run({"x": 0}, lambda s: 1, start_step=0, num_steps=9)
    assert out["x"] == 9
    fam = reg.get("smof_fault_events_total")
    tally = Tally(e["kind"] for e in loop.events)
    assert tally["retry"] == 1 and tally["checkpoint"] >= 2
    for kind, n in tally.items():
        assert fam.labels(kind=kind).value == n
    assert reg.snapshot()["smof_fault_step_seconds_count"] == \
        len(loop.records)
    assert "smof_fault_events_total" in parse_metrics_text(
        reg.metrics_text())


# =============================================================================
# the CLI
# =============================================================================

def test_train_cli_on_the_cpu(tmp_path, capsys):
    ttrain_cli.main(["--arch", "yi-6b", "--device", "cpu", "--smoke",
                     "--steps", "4", "--batch", "2", "--seq", "32",
                     "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    m = re.search(r"yi-6b-smoke: 4 steps, loss ([\d.]+) -> ([\d.]+); "
                  r"events: \['checkpoint', 'checkpoint'\]", out)
    assert m, out
    assert CheckpointStore(str(tmp_path)).steps() == [2, 4]
    ttrain_cli.main(["--arch", "yi-6b", "--device", "cpu", "--smoke",
                     "--steps", "6", "--batch", "2", "--seq", "32",
                     "--ckpt-dir", str(tmp_path), "--restore"])
    out = capsys.readouterr().out
    assert "restored; resuming at step 4" in out
    assert "2 steps, loss" in out


@pytest.mark.parametrize("flags,need", [(["--mesh", "single"], 256),
                                        (["--mesh", "multi"], 512)])
def test_train_cli_refusals_name_their_queue_items(flags, need):
    """The production meshes refuse a world of another size (here a world
    of one), naming the size they need."""
    with pytest.raises(ValueError, match=f"needs a world of {need} ranks; "
                                         f"this one has 1"):
        ttrain_cli.main(["--arch", "yi-6b", "--device", "cpu", "--smoke",
                         *flags])


def test_train_cli_on_the_host_mesh(tmp_path, capsys):
    """--mesh host --device cpu --smoke: the step on make_host_mesh("cpu"),
    a 1x1 mesh over a gloo world of one, with the reference's closing
    line."""
    ttrain_cli.main(["--arch", "yi-6b", "--mesh", "host", "--device", "cpu",
                     "--smoke", "--steps", "2", "--batch", "2", "--seq",
                     "32", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    m = re.search(r"yi-6b-smoke: 2 steps, loss ([\d.]+) -> ([\d.]+); "
                  r"events: \[\]", out)
    assert m, out
    assert all(np.isfinite(float(x)) for x in m.groups())


@pytest.mark.parametrize("arch", RECURRENT)
def test_train_cli_on_the_recurrent_mixers(tmp_path, capsys, arch):
    """The CLI's closing line and checkpoint events on reduced jamba and
    xlstm (the mLSTM chunk rule takes --seq 64)."""
    ttrain_cli.main(["--arch", arch, "--device", "cpu", "--smoke",
                     "--steps", "4", "--batch", "2", "--seq", "64",
                     "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    m = re.search(rf"{arch}-smoke: 4 steps, loss ([\d.]+) -> ([\d.]+); "
                  r"events: \['checkpoint', 'checkpoint'\]", out)
    assert m, out
    assert all(np.isfinite(float(x)) for x in m.groups())
    assert CheckpointStore(str(tmp_path)).steps() == [2, 4]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_train_step_accumulates_and_resumes(models, tmp_path,
                                                       arch):
    """make_train_step on reduced jamba and xlstm with int8 states: a
    batch of 2 takes auto_microbatches' 2, accumulated in bf16 bit for bit
    (0 + g1) + g2, / 2; four steps in FaultTolerantLoop against a run
    saved after step 2 and restored into a fresh loop, whose steps 3-4
    are the uninterrupted run's bit for bit, states included."""
    _, tc, _, tree = models[arch]
    opt_cfg = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4,
                             quantize_states=True)
    data = TokenPipeline(DataConfig(vocab=tc.vocab, seq_len=64,
                                    global_batch=2))
    assert auto_microbatches(2) == 2
    params = params_from_numpy(tree, tc, "cpu")
    b0 = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    _, acc = accumulate_grads(params, tc, b0, 2, torch.bfloat16)
    want = {n: torch.zeros(t.shape, dtype=torch.bfloat16)
            for n, t in TM._leaves(params)}
    for i in range(2):
        _, g = loss_and_grads(params, tc, b0["tokens"][i:i + 1],
                              b0["labels"][i:i + 1])
        for n, t in TM._leaves(g):
            want[n] += t.to(torch.bfloat16)
    for n, t in TM._leaves(acc):
        assert torch.equal(t, want[n] / 2), n
    step = make_train_step(tc, opt_cfg, device="cpu")
    losses = []

    def run(state, batch):
        p, o, m = step(*state, batch)
        losses.append(float(m["loss"]))
        return (p, o)

    def fresh():
        p = params_from_numpy(tree, tc, "cpu")
        return (p, TO.init_opt_state(p, opt_cfg))

    whole = TF.FaultTolerantLoop(run, CheckpointStore(str(tmp_path / "a"))
                                 ).run(fresh(), data.batch_at, start_step=0,
                                       num_steps=4)
    assert len(losses) == 4 and all(np.isfinite(losses))
    store = CheckpointStore(str(tmp_path / "b"))
    TF.FaultTolerantLoop(run, store, TF.FaultConfig(checkpoint_every=2)).run(
        fresh(), data.batch_at, start_step=0, num_steps=2)
    again = TF.FaultTolerantLoop(run, store)
    state, start = again.try_restore(fresh())
    assert start == 2
    resumed = again.run(state, data.batch_at, start_step=2, num_steps=2)
    for (n, a), (_, b) in zip(TM._leaves({"p": whole[0], "o": whole[1]}),
                              TM._leaves({"p": resumed[0], "o": resumed[1]})):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_train_cli_with_int8_states_and_tied_embeddings(tmp_path, capsys):
    ttrain_cli.main(["--arch", "phi4-mini-3.8b", "--device", "cpu",
                     "--smoke", "--steps", "2", "--batch", "2", "--seq",
                     "16", "--quantize-opt", "--remat", "dots",
                     "--ckpt-dir", str(tmp_path)])
    assert "2 steps, loss" in capsys.readouterr().out
