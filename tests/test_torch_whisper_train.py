"""Training the port's encoder-decoder (whisper) on the CPU against the
reference package.

The model is ``ARCHS["whisper-large-v3"].reduced(n_layers=2)`` (2 encoder
and 2 decoder layers, d_model 64, 4 heads of 16, 16 encoder frames), with
the reference's ``init_params(PRNGKey(0), cfg, f32)`` carried into the
port by ``params_from_numpy``; tokens, labels and frame embeddings come
from seeded numpy generators and go to both packages.  The gradient flows
through the encoder's self-attention and the decoder's cross attention,
which on the kernel route (``use_kernels=True``) run ``FlashAttention``
non-causal over keys of their own length (on the CPU its plain versions,
``chunked_attention(return_lse=True)`` and the blockwise backward).

Tolerances: the loss within rtol 1e-5 and every gradient leaf, metric and
updated parameter within rtol = atol = 2e-4, the port's standing f32
tolerance and ``tests/test_torch_train.py``'s (XLA's and PyTorch's CPU
matrix products sum in other orders); gradient accumulation over
microbatches bit for bit its definition (the same operations in the same
order).
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
from repro.optim import adamw as JO                         # noqa: E402
from repro.runtime.steps import make_train_step as jmake_step  # noqa: E402

from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.models import attention as TA              # noqa: E402
from repro_torch.models import model as TM                  # noqa: E402
from repro_torch.models import params_from_numpy            # noqa: E402
from repro_torch.optim import adamw as TO                   # noqa: E402
from repro_torch.runtime.steps import (accumulate_grads,    # noqa: E402
                                       loss_and_grads, make_train_step)

TOL = 2e-4
NAME = "whisper-large-v3"
CFG = ARCHS[NAME].reduced(n_layers=2)
JCFG = JARCHS[NAME].reduced(n_layers=2)
T = CFG.enc_frames


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree) -> dict:
    return {n: t.detach() for n, t in TM._leaves(tree)}


@pytest.fixture(scope="module")
def weights():
    """(reference params, their numpy tree)."""
    jp = JM.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _batch(B, S, seed) -> dict:
    """Tokens, labels (B, S) and frame embeddings (B, T, d_model)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, CFG.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, CFG.vocab, (B, S)).astype(np.int32),
            "enc_frames": rng.standard_normal((B, T, CFG.d_model),
                                              dtype=np.float32)}


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference_grads(weights):
    """(batch, loss, gradients) of the reference's lm_loss(enc_frames=) on
    a batch of 2 x 24 tokens over 2 x 16 frames (its remat changes no
    value, so one)."""
    jp, _ = weights
    batch = _batch(2, 24, 1)
    jl, jg = jax.value_and_grad(lambda p: JM.lm_loss(
        p, JCFG, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]),
        enc_frames=jnp.asarray(batch["enc_frames"])))(jp)
    return batch, float(jl), _jflat(jg)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_loss_and_gradients_match_the_reference(weights, reference_grads,
                                                   remat, use_kernels):
    """The loss and every gradient leaf, the encoder's included, against
    jax.value_and_grad of the reference's lm_loss; remat governs the
    decoder's groups only (the encoder keeps its activations, as the
    reference's plain scan)."""
    _, tree = weights
    batch, jl, want = reference_grads
    tb = _t(batch)
    loss, grads = loss_and_grads(params_from_numpy(tree, CFG, "cpu"), CFG,
                                 tb["tokens"], tb["labels"], remat=remat,
                                 use_kernels=use_kernels,
                                 enc_frames=tb["enc_frames"])
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    got = _tflat(grads)
    assert set(got) == set(want) == set(TM.param_shapes(CFG))
    assert {"encoder/groups/pos_0/mixer/wq", "encoder/final_norm/w",
            "groups/pos_0/cross/wk"} <= set(got)
    for name in want:
        close(got[name].numpy(), want[name])


def test_the_encoder_runs_outside_the_group_remat(weights):
    """With remat "full" the encoder's layers run once (their activations
    kept) and each decoder group twice (forward and recompute):
    encoder_attention called E times, cross_attention 2 L times."""
    _, tree = weights
    calls = {"encoder_attention": 0, "cross_attention": 0}
    tb = _t(_batch(1, 8, 2))

    def counted(name):
        fn = getattr(TA, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    mp = pytest.MonkeyPatch()
    for name in calls:
        mp.setattr(TA, name, counted(name))
    try:
        loss_and_grads(params_from_numpy(tree, CFG, "cpu"), CFG,
                       tb["tokens"], tb["labels"], remat="full",
                       enc_frames=tb["enc_frames"])
    finally:
        mp.undo()
    assert calls == {"encoder_attention": CFG.encoder_layers,
                     "cross_attention": 2 * CFG.n_layers}


@pytest.mark.parametrize("KH", [4, 2], ids=["KH4", "KH2"])
def test_cross_and_encoder_attention_gradients_match_jax(KH):
    """The gradients of x, the encoder output and every projection of the
    cross attention (and of x and the projections of the encoder's
    self-attention) on the kernel route against jax.grad of the
    reference's, also with the KV heads grouped (KH = 2 of 4 heads: the
    repeat to H sums dK and dV back over the copies)."""
    jcfg = dataclasses.replace(JCFG, n_kv_heads=KH)
    tcfg = dataclasses.replace(CFG, n_kv_heads=KH)
    d, hd, H = CFG.d_model, CFG.hd, CFG.n_heads
    rng = np.random.default_rng(30 + KH)

    def rand(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    p = {"wq": rand(d, H * hd) / 8, "wk": rand(d, KH * hd) / 8,
         "wv": rand(d, KH * hd) / 8, "wo": rand(H * hd, d) / 8}
    x, enc = rand(2, 7, d), rand(2, 37, d)
    dy_x, dy_e = rand(2, 7, d), rand(2, 37, d)
    pos = np.arange(37)[None]

    def jfn(p, x, enc):
        cross = JA.cross_attention(p, x, enc, jcfg)
        self_ = JA.encoder_attention(p, enc, jcfg, jnp.asarray(pos))
        return (jnp.sum(cross * jnp.asarray(dy_x))
                + jnp.sum(self_ * jnp.asarray(dy_e)))
    jg = jax.grad(jfn, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(enc))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx, te = (torch.from_numpy(a).requires_grad_(True) for a in (x, enc))
    cross = TA.cross_attention(tp, tx, TA.cross_kv(tp, te, tcfg), tcfg)
    self_ = TA.encoder_attention(tp, te, tcfg, torch.from_numpy(pos))
    ((cross * torch.from_numpy(dy_x)).sum()
     + (self_ * torch.from_numpy(dy_e)).sum()).backward()
    for n in p:
        close(tp[n].grad.numpy(), np.asarray(jg[0][n]))
    close(tx.grad.numpy(), np.asarray(jg[1]))
    close(te.grad.numpy(), np.asarray(jg[2]))


def test_accumulate_grads_slices_the_frames_with_the_rows(weights):
    """Two microbatches of a batch of 4: each takes its rows' tokens,
    labels and frames, in order; the accumulated gradients are bit for bit
    (0 + g1) + g2, / 2, of loss_and_grads on those rows, and the loss
    their mean.  A step without the frames is refused."""
    _, tree = weights
    tp = params_from_numpy(tree, CFG, "cpu")
    tb = _t(_batch(4, 8, 3))
    loss, acc = accumulate_grads(tp, CFG, tb, 2, torch.float32)
    want = {n: torch.zeros(t.shape) for n, t in TM._leaves(tp)}
    losses = []
    for sl in (slice(0, 2), slice(2, 4)):
        l, g = loss_and_grads(tp, CFG, tb["tokens"][sl], tb["labels"][sl],
                              enc_frames=tb["enc_frames"][sl])
        losses.append(l)
        for n, t in TM._leaves(g):
            want[n] += t
    assert float(loss) == float(torch.stack(losses).mean())
    for n, t in TM._leaves(acc):
        assert torch.equal(t, want[n] / 2), n
    with pytest.raises(ValueError, match="enc_frames"):
        accumulate_grads(tp, CFG, {"tokens": tb["tokens"],
                                   "labels": tb["labels"]}, 2, torch.float32)


@pytest.mark.parametrize("mbs", [1, 2])
def test_train_step_matches_the_reference(weights, mbs):
    """Two steps of make_train_step against the reference's on the host
    mesh, f32 AdamW states, batches that carry enc_frames: the loss, lr and
    grad_norm, and every parameter after each step, the encoder's
    included (AdamW updates every leaf _leaves gives it)."""
    jp, tree = weights
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jcfg, tcfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    with make_host_mesh() as mesh:
        jstep, _, _ = jmake_step(JCFG, mesh, jcfg, remat="full",
                                 dtype=jnp.float32, microbatches=mbs)
        jstep = jax.jit(jstep)
        jo = JO.init_opt_state(jp, jcfg)
        tp = params_from_numpy(tree, CFG, "cpu")
        tstep = make_train_step(CFG, tcfg, microbatches=mbs, device="cpu")
        to = TO.init_opt_state(tp, tcfg)
        before = _tflat(tp)
        before = {n: t.clone() for n, t in before.items()}
        jpp = jp
        for i in range(2):
            batch = _batch(2, 16, 20 + i)
            jpp, jo, jm = jstep(jpp, jo, jax.tree.map(jnp.asarray, batch))
            tp, to, tm = tstep(tp, to, batch)
            for k in ("loss", "lr", "grad_norm"):
                close(float(tm[k]), float(jm[k]))
            got = _tflat(tp)
            for name, want in _jflat(jpp).items():
                close(got[name].numpy(), want)
    moved = [n for n, t in _tflat(tp).items() if n.startswith("encoder/")
             and not torch.equal(t, before[n])]
    assert len(moved) == sum(n.startswith("encoder/") for n in before)
