"""The port's bf16 LM path on the CPU against the reference package in
bf16, the reference's default working type.

The models are every family's ``ARCHS[name].reduced()``, weights the
reference's ``init_params(PRNGKey(0), cfg, bf16)`` carried into the port by
``params_from_numpy`` (bf16 leaves stay bf16, the f32 routers and gates
stay f32); every other input comes from a seeded numpy generator.  Covered:
``forward`` one layer at a time on the reference's own inputs and whole,
``decode_step`` from the reference's cache, ``flash_attention`` /
``FlashAttention`` plain routes against the Pallas kernel in interpret
mode, ``chunked_attention`` and ``jax.vjp``, ``make_train_step(dtype=
bf16)`` against the reference's on ``make_host_mesh()``, ``ServingEngine(
dtype=bf16)``, bf16 checkpoints across the two packages, and the train CLI
with ``--dtype bfloat16``.

Tolerances, from bf16's unit round-off U = 2^-8 (a rounding to bf16 moves
a value x by at most U |x|; one bf16 ulp of x is at most 2 U |x|) and the
depth, never from an observed gap:

* Same rounding points (the attention plain routes against the reference's
  ``chunked_attention``): the two sides compute one f32 value in different
  orders and round it once, so they differ by at most one bf16 ulp of the
  reference's value, plus the f32 difference itself, at most S 2^-24 of
  the largest magnitude for sums of S <= 4096 terms: F32_SLACK = 2^-12.
* One extra rounding on one side: 1 ulp more, per rounding (the Pallas
  kernel keeps q D^-1/2 in f32 where the port rounds q^ to bf16; XLA's
  gradient rounds dQ twice, d(q^) then its product by the scale).
* A layer, on the reference's own input: the two packages round the same
  tensors, except that XLA expands an activation into one rounding per
  operation (silu: neg, exp, add, divide, multiply) where PyTorch rounds it
  once.  A layer's longest path passes at most ROUNDINGS = 20 bf16
  roundings (norm, q projection, rotary, q^, attention output, output
  projection, residual; norm, up and gate projections, five in the
  activation, their product, down projection, expert combine, residual), so
  the branch it adds to its input x differs by at most 2 ROUNDINGS U of
  the branch's largest magnitude (each side up to ROUNDINGS U of it), and
  the output by that plus one ulp of its own: LAYER_TOL.
* A whole model of L layers: L times the layer bound would reach the
  output's own size at L = 8, so the whole model is held to the rounding
  noise U leaves at its depth instead, read off the reference itself:
  e = max|r - r32|, r32 being the reference run in f32 on the same
  bf16-valued weights, inputs and cache, which rounds nothing to bf16 after
  them.  The port rounds at the same points with the same U, so its own
  distance from r32 is of e's size, and |port - r| <= |port - r32| +
  |r32 - r|: 2 e, each side's largest error given one rounding more
  (U max|r|) because e is the largest of one draw of the noise.  Logits
  of zeros and an off-by-one position miss it (a test holds that).
* The rounding points themselves: a port computing in f32 throughout sits
  as close to r as the bf16 port does, at the layer's and at the whole
  model's size, so no bound from U can part the two there.  The attention
  pages can: one rounding of the same f32 value on both sides, they are
  held within one ulp, and the f32 control misses that by tens of ulps (a
  test holds that too).  The recurrent states are held to their types and
  within LAYER_TOL.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402
from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.kernels.flash_attention import (                 # noqa: E402
    flash_attention as jflash)
from repro.launch.mesh import make_host_mesh                # noqa: E402
from repro.models import attention as JA                    # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.obs.metrics import parse_metrics_text as jparse  # noqa: E402
from repro.optim import adamw as JO                         # noqa: E402
from repro.runtime.steps import make_train_step as jmake_step  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine   # noqa: E402

import repro_torch.launch.train as ttrain_cli               # noqa: E402
from repro_torch.checkpoint import CheckpointStore          # noqa: E402
from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.kernels import flash_attention as FA       # noqa: E402
from repro_torch.models import attention as TA              # noqa: E402
from repro_torch.models import model as TM                  # noqa: E402
from repro_torch.models import params_from_numpy            # noqa: E402
from repro_torch.obs.metrics import parse_metrics_text      # noqa: E402
from repro_torch.optim import adamw as TO                   # noqa: E402
from repro_torch.runtime import steps as TS                 # noqa: E402
from repro_torch.serving import ServingEngine               # noqa: E402

U = 2.0 ** -8
F32_SLACK = 2.0 ** -12
ROUNDINGS = 20
LAYER_TOL = 2 * ROUNDINGS * U
BF16 = torch.bfloat16


def ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each element of x (f32): 2^(e - 7) for |x| in
    [2^e, 2^(e + 1)), the smallest normal's below it."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def within_ulps(got, want, n: int = 1, atol: float = 0.0) -> None:
    """Elementwise within n bf16 ulps of want, plus F32_SLACK of its
    largest magnitude, plus ``atol``."""
    g, w = f32(got), f32(want)
    bound = n * ulp(w) + F32_SLACK * np.abs(w).max() + atol
    bad = np.abs(g - w) > bound
    assert not bad.any(), (f"{bad.sum()} of {bad.size} elements past {n} "
                           f"ulp(s); worst {np.abs(g - w).max():.3e}")


def within(got, want, tol: float) -> None:
    """max |got - want| <= tol."""
    err = np.abs(f32(got) - f32(want)).max()
    assert err <= tol, f"max abs err {err:.4e} past {tol:.4e}"


def _t(a) -> torch.Tensor:
    """A reference array (bf16 through its uint16 bits) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(BF16)
    return torch.from_numpy(a.copy())


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


ARCH_NAMES = tuple(ARCHS)


def _arch(name):
    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jcfg, jp, tp


@pytest.fixture(scope="module")
def archs():
    return {n: _arch(n) for n in ARCH_NAMES}


def _inputs(cfg, B, S, seed):
    """tokens and the extras a family's forward takes (enc_frames,
    patch_embeds), as (numpy tokens, port kwargs, reference kwargs)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    tkw, jkw = {}, {}
    if cfg.is_encdec:
        fr = rng.standard_normal((B, cfg.enc_frames, cfg.d_model),
                                 dtype=np.float32)
        jkw["enc_frames"] = jnp.asarray(fr, jnp.bfloat16)
        tkw["enc_frames"] = _t(np.asarray(jkw["enc_frames"]))
    if cfg.vlm_patches:
        pa = rng.standard_normal((B, cfg.vlm_patches, cfg.d_model),
                                 dtype=np.float32)
        jkw["patch_embeds"] = jnp.asarray(pa, jnp.bfloat16)
        tkw["patch_embeds"] = _t(np.asarray(jkw["patch_embeds"]))
    return toks, tkw, jkw


def _flat_ref(jp):
    return dict(TM._leaves(jax.tree.map(np.asarray, jp)))


def test_params_from_numpy_keeps_bf16(archs):
    """bf16 leaves arrive as torch.bfloat16 bit for bit, the reference's
    f32 leaves (routers, gates, state scales) as f32."""
    for name, (_, _, jp, tp) in archs.items():
        want = _flat_ref(jp)
        for n, t in TM._leaves(tp):
            assert t.dtype == (BF16 if want[n].dtype.name == "bfloat16"
                               else torch.float32), (name, n)
            np.testing.assert_array_equal(f32(t),
                                          want[n].astype(np.float32))


PAGES = ("k", "v", "xk", "xv")
ATTN_NAMES = tuple(n for n in ARCH_NAMES if any(
    ARCHS[n].reduced().layer_kind(j) == "attn"
    for j in range(ARCHS[n].reduced().group_size)))


def _widen(tree):
    return {k: _widen(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _layer_runs(arch, mode, dtype=BF16):
    """Every layer of ``mode`` run by both packages on the reference's own
    input, encoder output and cache: "full", a prefill of 2 x 16 tokens
    into an empty cache; "decode", one token from the reference's prefill
    cache.  The port computes in ``dtype``; torch.float32 is the control,
    the reference's bf16 weights, input and cache widened.  Yields (x, (y,
    the reference's new cache), (the port's output, its new cache))."""
    cfg, jcfg, jp, tp = arch
    if dtype != BF16:
        tp = _widen(tp)
    B, S, s_max = 2, 16, 24
    toks, tkw, jkw = _inputs(cfg, B, S, 1)
    jc = JM.init_cache(jcfg, B, s_max, dtype=jnp.bfloat16)
    enc = tenc = None
    if mode == "full":
        x = JM._embed(jp, jcfg, jnp.asarray(toks), jkw.get("patch_embeds"))
        jpos, pos = jnp.arange(S)[None], torch.arange(S)[None]
        if cfg.is_encdec:
            enc = JM._encoder_forward(jp, jcfg, jkw["enc_frames"])
            tenc = _t(np.asarray(enc)).to(dtype)
    else:
        _, jc, _ = JM.forward(jp, jcfg, jnp.asarray(toks), cache=jc, **jkw)
        tok = np.random.default_rng(3).integers(0, cfg.vocab, (B, 1))
        x = jnp.take(jp["embed"], jnp.asarray(tok, jnp.int32), axis=0)
        jpos, pos = jnp.full(B, S, jnp.int32), torch.full((B,), S)
    for g in range(cfg.n_groups):
        for j in range(cfg.group_size):
            jlp = jax.tree.map(lambda a: a[g], jp["groups"][f"pos_{j}"])
            jlc = jax.tree.map(lambda a: a[g], jc[f"pos_{j}"])
            lp = TM._group(tp["groups"], g)[f"pos_{j}"]
            lc = {n: _t(np.asarray(c)).to(dtype) for n, c in jlc.items()}
            got = TM._apply_layer(lp, _t(np.asarray(x)).to(dtype), cfg, j,
                                  pos=pos, enc=tenc, cache=lc, mode=mode)
            y, wc, _ = JM._apply_layer(jlp, x, jcfg, j, pos=jpos, enc=enc,
                                       cache=jlc, mode=mode)
            yield x, (y, wc), got[:2]
            x = y


def _hold_layer(x, want, got) -> None:
    """A layer's output within LAYER_TOL of the branch it adds plus one
    ulp of its own; its attention pages (k, v, and the cross xk, xv), one
    rounding of the same f32 value on both sides, within one ulp; a
    recurrent state within LAYER_TOL of its largest magnitude."""
    (y, wc), (t, tc) = want, got
    branch = np.abs(f32(y) - f32(x)).max()
    within(t, y, LAYER_TOL * branch + 2 * U * np.abs(f32(y)).max())
    for n, w in wc.items():
        if n in PAGES:
            within_ulps(tc[n], w)
        else:
            within(tc[n], w, LAYER_TOL * np.abs(f32(w)).max())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_layers_match_the_reference_on_its_inputs(archs, name):
    """Every layer of a prefill (forward's full mode, the cache it writes)
    on the reference's own bf16 input and encoder output, against the
    reference's layer (_hold_layer); an encoder-decoder's encoder within
    its depth's bound."""
    cfg, jcfg, jp, tp = archs[name]
    if cfg.is_encdec:
        _, tkw, jkw = _inputs(cfg, 2, 16, 1)
        enc = JM._encoder_forward(jp, jcfg, jkw["enc_frames"])
        tenc = TM._encoder_forward(tp, cfg, tkw["enc_frames"])
        within(tenc, enc, LAYER_TOL * cfg.encoder_layers
               * float(np.abs(f32(enc)).max()))
    for x, want, got in _layer_runs(archs[name], "full"):
        assert got[0].dtype == BF16
        _hold_layer(x, want, got)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_layers_match_the_reference_on_its_inputs(archs, name):
    """Every layer of a decode step on the reference's own bf16 input and
    its prefill's cache, against the reference's layer (_hold_layer): the
    attention pages written at the step's position, the recurrent states
    advanced by one token."""
    for x, want, got in _layer_runs(archs[name], "decode"):
        assert got[0].dtype == BF16
        _hold_layer(x, want, got)


@pytest.mark.parametrize("mode", ["full", "decode"])
@pytest.mark.parametrize("name", ATTN_NAMES)
def test_an_f32_port_fails_the_layer_checks(archs, name, mode):
    """The control: the port run in f32 throughout, on the reference's bf16
    weights, input and cache widened, misses the reference's rounding
    points, and the layer checks see it in the attention pages (the norm
    and the projections not rounded: tens of ulps off)."""
    with pytest.raises(AssertionError, match="ulp"):
        for x, want, got in _layer_runs(archs[name], mode, torch.float32):
            _hold_layer(x, want, got)


def _to_f32(tree):
    """The reference's tree with every bf16 leaf widened to f32."""
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, tree)


def within_noise(got, want, want32) -> None:
    """got within 2 (e + U max|want|) of the reference's bf16 want, where
    e = max|want - want32| is the reference's own bf16 rounding noise at
    this depth (module docstring)."""
    w = f32(want)
    e = np.abs(w - f32(want32)).max()
    within(got, want, 2 * (e + U * np.abs(w).max()))


def _whole(arch):
    """A prefill of 2 x 16 tokens through forward (the last position's
    logits, the cache) and one decode_step from the reference's cache
    (logits, cache), by the port in bf16, the reference in bf16 and the
    reference in f32 on the same bf16 values."""
    cfg, jcfg, jp, tp = arch
    B, S, s_max = 2, 16, 24
    toks, tkw, jkw = _inputs(cfg, B, S, 2)
    jc0 = JM.init_cache(jcfg, B, s_max, dtype=jnp.bfloat16)
    tc0 = TM.init_cache(cfg, B, s_max, dtype=BF16, device="cpu")
    jx, jcache, _ = JM.forward(jp, jcfg, jnp.asarray(toks), cache=jc0,
                               **jkw)
    fx, fcache, _ = JM.forward(_to_f32(jp), jcfg, jnp.asarray(toks),
                               cache=_to_f32(jc0), **_to_f32(jkw))
    tx, tcache, _ = TM.forward(tp, cfg, torch.from_numpy(toks).long(),
                               cache=tc0, **tkw)
    assert tx.dtype == BF16
    jl = JM.project_logits(jp, jcfg, jx[:, -1])
    fl = JM.project_logits(_to_f32(jp), jcfg, fx[:, -1])
    tl = TM.project_logits(tp, cfg, tx[:, -1])
    tok = jnp.asarray(np.asarray(jl).argmax(-1)[:, None], jnp.int32)
    pos = jnp.full(B, S, jnp.int32)
    jd, jdc = JM.decode_step(jp, jcfg, tok, pos, jcache)
    fd, fdc = JM.decode_step(_to_f32(jp), jcfg, tok, pos, _to_f32(jcache))
    td, tdc = TM.decode_step(tp, cfg, _t(np.asarray(tok)).long(),
                             _t(np.asarray(pos)).long(), _tree(jcache))
    return {"prefill": (tl, jl, fl, tx[:, -2]),
            "cache": (tcache, jcache, fcache),
            "decode": (td, jd, fd), "decode cache": (tdc, jdc, fdc)}


def _caches(got, want, want32):
    for pj, leaves in want.items():
        for n, w in leaves.items():
            yield (pj, n), got[pj][n], w, want32[pj][n]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_and_decode_match_the_reference(archs, name):
    """A prefill through forward (the logits, the cache it writes) and one
    decode_step from the reference's cache (the logits, the cache it
    advances), each within the reference's own bf16 noise at this depth
    (within_noise); the cache's leaves in the reference's types."""
    r = _whole(archs[name])
    tl, jl, fl = r["prefill"][:3]
    assert tl.dtype == torch.float32
    within_noise(tl, jl, fl)
    for part in ("cache", "decode cache"):
        for at, got, want, want32 in _caches(*r[part]):
            assert got.dtype == (BF16 if want.dtype == jnp.bfloat16
                                 else torch.float32), at
            within_noise(got, want, want32)
    within_noise(*r["decode"])


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_the_whole_model_bound_catches_wrong_outputs(archs, name):
    """The controls: logits of zeros, and the last position's logits
    taken from the one before it (an off-by-one), each miss the bound
    test_forward_and_decode_match_the_reference holds the port to."""
    cfg, _, jp, tp = archs[name]
    r = _whole(archs[name])
    tl, jl, fl, t_prev = r["prefill"]
    shifted = TM.project_logits(tp, cfg, t_prev)
    for wrong in (torch.zeros_like(tl), shifted):
        with pytest.raises(AssertionError, match="max abs err"):
            within_noise(wrong, jl, fl)


# =============================================================================
# attention: the plain routes of the bf16 kernel instances
# =============================================================================

def _qkv(shape, seed, Sk=None):
    rng = np.random.default_rng(seed)
    B, S, H, D = shape
    q = rng.standard_normal(shape, dtype=np.float32)
    k, v = (rng.standard_normal((B, Sk or S, H, D), dtype=np.float32)
            for _ in range(2))
    return tuple(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))


SHAPES = [(2, 256, 2, 64), (1, 128, 4, 128), (1, 77, 2, 32)]


@pytest.mark.parametrize("shape", SHAPES, ids=["S256D64", "S128D128",
                                               "S77D32"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_route_in_bf16(shape, causal):
    """flash_attention and flash_attention_lse on bf16 CPU tensors: one
    ulp of the reference's chunked_attention in bf16 (the same rounding
    points), the lse within F32_SLACK; the Pallas kernel in interpret mode
    (where its blocks divide S), which keeps q D^-1/2 in f32, within the
    port's rounding of q^ (U of each q^ d k_d term: at most 2 U
    sum_d |q^_d k_d| max|v| on the output) plus one ulp."""
    q, k, v = _qkv(shape, 5)
    tq, tk, tv = (_t(np.asarray(a)) for a in (q, k, v))
    want = JA.chunked_attention(q, k, v, causal=causal,
                                chunk=min(1024, shape[1]))
    got = FA.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == BF16
    within_ulps(got, want)
    o, lse, _ = FA.flash_attention_lse(tq, tk, tv, causal=causal)
    within_ulps(o, want)
    assert lse.dtype == torch.float32
    # the reference's lse: m + log(l) of its scaled scores, in f32
    qs = f32((q * (shape[3] ** -0.5)).astype(jnp.bfloat16))
    s = np.einsum("bqhd,bkhd->bhqk", qs, f32(k))
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -2.0 ** 30)
    m = s.max(-1)
    want_lse = m + np.log(np.exp(s - m[..., None]).sum(-1))
    within(lse, want_lse, F32_SLACK * np.abs(want_lse).max())
    if shape[1] % 64 == 0:
        pallas = jflash(q, k, v, causal=causal, bq=64, bk=64,
                        interpret=True)
        assert pallas.dtype == jnp.bfloat16
        s_abs = np.einsum("bqhd,bkhd->bhqk", np.abs(qs), np.abs(f32(k)))
        bound = (2 * U * s_abs.max() * np.abs(f32(v)).max()
                 + ulp(f32(pallas)) + F32_SLACK)
        assert (np.abs(f32(got) - f32(pallas)) <= bound).all()


# (causal, (B, S, H, D), Sk): one S, causal and not, then keys of their own
# length (non-causal), Sq 1, 16, 37 against Sk 1, 33, 130
BF16_GRAD_CASES = (
    [(c, shape, None) for c in (True, False)
     for shape in ((2, 64, 2, 16), (1, 77, 3, 32), (1, 256, 2, 64))]
    + [(False, (2, Sq, 2, D), Sk) for Sq in (1, 16, 37) for Sk in (1, 33, 130)
       for D in (16, 64)])
BF16_GRAD_IDS = [f"{c}-shape{i % 3}" if Sk is None else
                 f"{c}-Sq{shape[1]}Sk{Sk}D{shape[3]}"
                 for i, (c, shape, Sk) in enumerate(BF16_GRAD_CASES)]


@pytest.mark.parametrize("causal,shape,Sk", BF16_GRAD_CASES,
                         ids=BF16_GRAD_IDS)
def test_flash_gradient_in_bf16_matches_jax_vjp(causal, shape, Sk):
    """FlashAttention's plain route in bf16 (the forward with its lse, the
    blockwise backward in f32, each output rounded once) against jax.vjp
    of the reference's chunked_attention in bf16 (one query block: S <=
    512, and one key block of all Sk keys, so XLA sums dK and dV in f32),
    also over keys of their own length (non-causal, Sk != S): o within one
    ulp, dK and dV
    within one ulp more than that (XLA rounds each once too, after a sum in
    another order), dQ within two more (XLA rounds d(q^), then its product
    by the scale).  Besides, dS = P (dP - D), D = rowsum(dO o O), cancels
    where attention is near uniform (with one key exactly): both sides take
    D from the f32 o (FlashAttention keeps it, as autodiff of the plain
    route does), and a move of D by at most U sum_d |dO_d O_d| =: U d_abs
    bounds what cancellation leaves of either side's f32 sums, so dS moves
    by P U d_abs, dQ = dS K D^-1/2 by at most D^-1/2 U max d_abs max|k| (P
    sums to 1 along a row) and dK = dS^T q^ by at most U max d_abs max|q^|
    times P's largest column sum; dV = P^T dO takes no D.  (D from the
    bf16 o would move by up to that much itself, several times the bf16
    noise of a near-uniform layer's q and k projections:
    test_whisper_gradient_in_bf16_where_attention_is_near_uniform.)"""
    q, k, v = _qkv(shape, 6, Sk)
    do = jnp.asarray(np.random.default_rng(7).standard_normal(
        shape, dtype=np.float32), jnp.bfloat16)
    out, vjp = jax.vjp(lambda a, b, c: JA.chunked_attention(
        a, b, c, causal=causal, chunk=k.shape[1]), q, k, v)
    dq, dk, dv = vjp(do)
    tq, tk, tv = (_t(np.asarray(a)).requires_grad_(True)
                  for a in (q, k, v))
    o = FA.FlashAttention.apply(tq, tk, tv, causal)
    o.backward(_t(np.asarray(do)))
    within_ulps(o, out)
    scale = float(jnp.asarray(shape[3] ** -0.5, jnp.bfloat16))
    qs = f32((q * (shape[3] ** -0.5)).astype(jnp.bfloat16))
    s = np.einsum("bqhd,bkhd->bhqk", qs, f32(k))
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    d_abs = np.abs(f32(do) * f32(o)).sum(-1).max()
    a_q = scale * U * d_abs * np.abs(f32(k)).max()
    a_k = U * d_abs * np.abs(qs).max() * p.sum(-2).max()
    for got, want, n, a in ((tq.grad, dq, 3, a_q), (tk.grad, dk, 2, a_k),
                            (tv.grad, dv, 2, 0.0)):
        assert got.dtype == BF16
        within_ulps(got, want, n, a)


def test_flash_backward_plain_rounds_once():
    """At D = 64 the scale 1/8 is exact in bf16, so q^ = q / 8 needs no
    rounding and flash_attention_backward_plain on bf16 operands is its f32
    version on the same values with each output rounded once to bf16: bit
    for bit."""
    q, k, v, do = (_t(np.asarray(a)) for a in _qkv((1, 96, 2, 64), 8)
                   + (_qkv((1, 96, 2, 64), 9)[0],))
    o, lse, _ = FA.flash_attention_lse(q, k, v, causal=True)
    got = FA.flash_attention_backward_plain(q, k, v, o, lse, do, True)
    want = FA.flash_attention_backward_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), True)
    for g, w in zip(got, want):
        assert g.dtype == BF16
        assert torch.equal(g, w.to(BF16))


@pytest.mark.parametrize("S,Sk,D,causal", [
    (128, 128, 64, True), (128, 128, 64, False), (96, 96, 128, True),
    (96, 96, 128, False), (64, 80, 32, False)], ids=[
    "S128-causal", "S128", "S96D128-causal", "S96D128", "Sk80"])
def test_f32_slack_bounds_the_plain_routes_sums(S, Sk, D, causal):
    """testing.ulp.f32_slack, the per-element slack the card holds the
    bf16 kernel instances with: each bf16 output of the plain routes lies
    within half an ulp (its one rounding) plus that slack of the exact
    value, worked out in f64 from the same bf16 operands (and, for the
    backward, the same stored o and lse), a single causal row's exact-0 dQ
    included."""
    from repro_torch.testing.ulp import bf16_ulp, f32_slack
    g = torch.Generator().manual_seed(80)
    q, do = (torch.randn(2, S, 2, D, generator=g).to(BF16) for _ in "qd")
    k, v = (torch.randn(2, Sk, 2, D, generator=g).to(BF16) for _ in "kv")
    sl = f32_slack(q, k, v, causal, do if S == Sk else None)
    sc = float(torch.tensor(D ** -0.5, dtype=BF16))
    qh = (q * sc).to(BF16).double()
    s = torch.einsum("bqhd,bkhd->bhqk", qh, k.double())
    if causal:
        s = s.masked_fill(~torch.ones(S, Sk, dtype=torch.bool).tril(),
                          -np.inf)
    p = torch.softmax(s, -1)

    def held(got, exact, slack):
        half = torch.maximum(bf16_ulp(got), bf16_ulp(exact)) / 2
        assert ((got.double() - exact).abs() <= half + slack).all()
    want = torch.einsum("bhqk,bkhd->bqhd", p, v.double())
    if S != Sk:
        held(FA.flash_attention(q, k, v, causal=causal), want, sl["o"])
        return
    o, lse, _ = FA.flash_attention_lse(q, k, v, causal=causal)
    held(o, want, sl["o"])
    dq, delta = FA.flash_attention_bwd_dq_plain(q, k, v, o, do, lse, causal)
    dk, dv = FA.flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                               causal)
    dd = do.double()
    dp = torch.einsum("bqhd,bkhd->bhqk", dd, v.double())
    ds = p * (dp - (dd * o.double()).sum(-1).transpose(1, 2)[..., None])
    held(dq, torch.einsum("bhqk,bkhd->bqhd", ds, k.double()) * sc,
         sl["dq"])
    held(dk, torch.einsum("bhqk,bqhd->bkhd", ds, qh), sl["dk"])
    held(dv, torch.einsum("bhqk,bqhd->bkhd", p, dd), sl["dv"])


#: the bf16 shapes chip_smoke.py's phase 4 holds the bf16 backward kernels
#: at, causal and not, and yi-6b's train shape (causal)
BWD_BF16_CASES = ([(s, c) for s in ((2, 1, 3, 16), (1, 63, 4, 64),
                                    (2, 300, 2, 16), (1, 77, 32, 128),
                                    (1, 1000, 2, 64), (1, 130, 2, 32))
                   for c in (True, False)] + [((1, 1024, 32, 128), True)])


def _bwd_bf16_emulated(q, k, v, do, lse, delta, causal, pieces):
    """(dq, dk, dv) as ``csrc/flash_attention_bwd_bf16.cu`` computes them,
    in plain PyTorch: s = q^ k^T and dP = dO v^T from bf16 operands (each
    product exact in f32) summed in f32; P = exp(s - lse), dS = P (dP -
    delta); dQ, dK and dV as the sum over the ``pieces`` bf16 pieces of dS
    or P (``ref.bf16_pieces``, the smallest first) of that piece's product
    with the bf16 operand, in f32; dQ times bf16(D^-1/2); each output
    rounded once."""
    from repro_torch.kernels import ref
    S, D = q.shape[1], q.shape[3]
    sc = FA._scale(D, q.dtype)

    def f(t):
        return t.float().transpose(1, 2)
    qh, kk, vv, dd = f(q * sc), f(k), f(v), f(do)
    s = qh @ kk.transpose(-1, -2)
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          FA.NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (dd @ vv.transpose(-1, -2) - delta[..., None])

    def prod(a, b):
        return sum(x @ b for x in reversed(ref.bf16_pieces(a, pieces)))

    def back(t):
        return t.transpose(1, 2).to(BF16)
    return (back(prod(ds, kk) * sc), back(prod(ds.transpose(-1, -2), qh)),
            back(prod(p.transpose(-1, -2), dd)))


def _bwd_bf16_past(shape, causal, pieces, seed=81):
    """How many of the emulated (dq, dk, dv) lie past one bf16 ulp of the
    plain versions plus twice their f32 slack (``testing.ulp``, the rule
    phase 4 holds the kernels to), on seeded bf16 operands."""
    from repro_torch.testing.ulp import f32_slack, past_one_ulp
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to(BF16) for _ in "qkvd")
    o, lse, _ = FA.flash_attention_lse(q, k, v, causal=causal)
    dq, delta = FA.flash_attention_bwd_dq_plain(q, k, v, o, do, lse, causal)
    dk, dv = FA.flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                               causal)
    sl = f32_slack(q, k, v, causal, do)
    got = _bwd_bf16_emulated(q, k, v, do, lse, delta, causal, pieces)
    return {n: past_one_ulp(g_, w, sl[n])
            for n, g_, w in zip(("dq", "dk", "dv"), got, (dq, dk, dv))}


@pytest.mark.parametrize("pieces", [2, 3], ids=["two-pieces", "three"])
@pytest.mark.parametrize("shape,causal", BWD_BF16_CASES, ids=[
    f"{'x'.join(map(str, s))}{'-causal' if c else ''}"
    for s, c in BWD_BF16_CASES])
def test_bf16_backward_pieces_hold_the_ulp_rule(shape, causal, pieces):
    """The bf16 backward kernels' arithmetic, emulated, within the rule
    phase 4 holds them to (testing.ulp.past_one_ulp with f32_slack,
    both unchanged) at every bf16 shape phase 4 takes.  Three pieces
    carry P and dS exactly, so they differ from the plain f32 products
    only in the order of the sums; two pieces leave up to 2^-16 of each
    term, and hold the rule here too, at every shape, the ragged ones and
    S = 1 included: the kernels take two (three products would cost 8
    bf16 products in dkdv where two cost 6)."""
    assert _bwd_bf16_past(shape, causal, pieces) == dict.fromkeys(
        ("dq", "dk", "dv"), 0)


def test_one_bf16_piece_misses_the_ulp_rule():
    """The control: P and dS rounded once to bf16 (one piece) before their
    products miss the same rule by many elements, so the rule does tell
    the pieces apart."""
    past = _bwd_bf16_past((1, 63, 4, 64), True, 1)
    assert past["dv"] > 100 and past["dq"] > 0 and past["dk"] > 0


#: the bf16 shapes (B, Sq, Sk, H, D) chip_smoke.py's phase 4 holds the bf16
#: forward kernels at: ragged S at every head width, causal and not; keys of
#: their own length against a decode row and a 64-token prompt; a 512-token
#: prefill of yi-6b and its train shape (causal)
FWD_BF16_CASES = ([((B, S, S, H, D), c)
                   for B, S, H, D in ((2, 1, 3, 16), (1, 63, 4, 64),
                                      (2, 300, 2, 16), (1, 77, 32, 128),
                                      (1, 1000, 2, 64), (1, 130, 2, 32))
                   for c in (True, False)]
                  + [((4, Sq, Sk, 20, 64), False) for Sq in (1, 64)
                     for Sk in (1, 37, 1499)]
                  + [((1, 512, 512, 32, 128), True),
                     ((1, 1024, 1024, 32, 128), True)])


#: log2(e) as the bf16 forward kernels round it to f32
LOG2E = float(np.float32(1.4426950408889634))


def _fwd_bf16_emulated(q, k, v, causal, pieces):
    """(o, lse) as ``csrc/flash_attention_bf16.cu`` computes them, in plain
    PyTorch: s = q^ k^T from bf16 operands (each product exact in f32)
    summed in f32, one key tile of ``FA.BF16_FORWARD_TILE`` at a time in
    the kernel's order, the online softmax in f32 (m, the alpha = exp(m_old
    - m_new) rescale of l and o, P = 2^(s log2(e) - m_new log2(e)) with the
    exponent rounded once, as the kernel's fmaf and ex2 take it), l
    summed from the f32 P, P v as the sum over the ``pieces`` bf16 pieces
    of P (``ref.bf16_pieces``, the smallest first) of that piece's product
    with v in f32; o times the reciprocal of max(l, 1e-30), rounded once."""
    from repro_torch.kernels import ref
    S, Sk, D = q.shape[1], k.shape[1], q.shape[3]

    def f(t):
        return t.float().transpose(1, 2)
    qh, kk, vv = f(q * FA._scale(D, q.dtype)), f(k), f(v)
    m = torch.full(qh.shape[:3], FA.NEG_INF)
    l = torch.zeros(qh.shape[:3])
    o = torch.zeros(qh.shape)
    for k0 in range(0, Sk, FA.BF16_FORWARD_TILE):
        k1 = min(k0 + FA.BF16_FORWARD_TILE, Sk)
        s = qh @ kk[:, :, k0:k1].transpose(-1, -2)
        if causal:
            s = torch.where(torch.arange(S)[:, None]
                            >= torch.arange(k0, k1)[None, :], s, FA.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        ml = -m_new * LOG2E
        p = torch.exp2((s.double() * LOG2E + ml[..., None].double()).float())
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + sum(
            x @ vv[:, :, k0:k1]
            for x in reversed(ref.bf16_pieces(p, pieces)))
        m = m_new
    den = torch.clamp(l, min=1e-30)
    return ((o * (1.0 / den)[..., None]).transpose(1, 2).to(BF16),
            m + torch.log(den))


def _fwd_bf16_past(shape, causal, pieces, seed=82):
    """How many elements of the emulated o lie past one bf16 ulp of the
    plain route's plus twice its f32 slack (the rule phase 4 holds the
    kernels to), and the emulated lse's largest error as a fraction of
    phase 4's 2e-4 x max(1, max|plain|), on seeded bf16 operands."""
    from repro_torch.models.attention import chunked_attention
    from repro_torch.testing.ulp import f32_slack, past_one_ulp
    B, Sq, Sk, H, D = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g).to(BF16)
    k, v = (torch.randn(B, Sk, H, D, generator=g).to(BF16) for _ in "kv")
    o, lse = _fwd_bf16_emulated(q, k, v, causal, pieces)
    want = chunked_attention(q, k, v, causal=causal, chunk=min(1024, Sk),
                             skip_masked=causal, return_lse=Sq == Sk)
    if Sq == Sk:
        want, want_lse, _ = want
        lse_frac = float((lse - want_lse).abs().max()
                         / (2e-4 * max(1.0, float(want_lse.abs().max()))))
    else:
        lse_frac = 0.0
    return past_one_ulp(o, want, f32_slack(q, k, v, causal)["o"]), lse_frac


@pytest.mark.parametrize("pieces", [2, 3], ids=["two-pieces", "three"])
@pytest.mark.parametrize("shape,causal", FWD_BF16_CASES, ids=[
    f"{'x'.join(map(str, s))}{'-causal' if c else ''}"
    for s, c in FWD_BF16_CASES])
def test_bf16_forward_pieces_hold_the_ulp_rule(shape, causal, pieces):
    """The bf16 forward kernels' arithmetic, emulated, within the rule
    phase 4 holds them to (testing.ulp.past_one_ulp with f32_slack, both
    unchanged; lse within 2e-4 x max(1, max|plain|)) at every bf16 forward
    shape phase 4 takes.  Three pieces carry P exactly, so o differs from
    the plain route only in the order of its sums; two leave up to 2^-16 of
    each term and hold the rule too, at every shape, S = 1 and Sk = 1
    included: the kernels take two (three products a tile where three
    pieces would take four)."""
    past, lse_frac = _fwd_bf16_past(shape, causal, pieces)
    assert past == 0 and lse_frac <= 1.0, (past, lse_frac)


def test_one_bf16_piece_misses_the_ulp_rule_in_the_forward():
    """The control: P rounded once to bf16 (one piece) before P v misses
    the same rule by many elements, so the rule tells the pieces apart in
    the forward too."""
    past, _ = _fwd_bf16_past((1, 300, 300, 4, 64), True, 1)
    assert past > 100


# =============================================================================
# the train step, the engine, checkpoints, the CLI
# =============================================================================

#: the largest |update| f32 AdamW gives at step 2 is about 1; past it only
#: int8 states reach (tests/test_torch_train.py)
AMPLIFIED = 1.5


def test_train_step_in_bf16_matches_the_reference():
    """Two steps of make_train_step(dtype=bf16) with int8 states (bf16
    microbatch accumulation, two microbatches) against the reference's on
    the host mesh.  The loss, lr and grad_norm within one layer's bound
    (the reduced yi-6b has 1 layer, LAYER_TOL of their size); every new bf16
    parameter within 2 lr (1 + 0.1 |p|) (each side's update, at most 1
    plus the decay a step, lr times) plus 2 ulps (each side rounds p - lr u
    once), except where either side's update is amplified past AMPLIFIED
    (int8 v rounded to 0: m / |g|, unbounded; at most 5% of the elements),
    held only to be finite: which rows' v rounds to 0, and the sign of m
    there, follow gradients small enough that their bf16 roundings decide
    them (the f32 test holds the reference's sign)."""
    name = "yi-6b"
    cfg, jcfg, jp, tp = _arch(name)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4, quantize_states=True)
    jo_cfg, to_cfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    with make_host_mesh() as mesh:
        jstep, _, _ = jmake_step(jcfg, mesh, jo_cfg, remat="full",
                                 dtype=jnp.bfloat16, microbatches=2)
        jstep = jax.jit(jstep)
        jo = JO.init_opt_state(jp, jo_cfg)
        tstep = TS.make_train_step(cfg, to_cfg, dtype=BF16, microbatches=2,
                                   device="cpu")
        to = TO.init_opt_state(tp, to_cfg)
        jpp = jp
        for i in range(2):
            rng = np.random.default_rng(30 + i)
            toks, labs = (rng.integers(0, cfg.vocab, (2, 64)).astype(
                np.int32) for _ in range(2))
            prev = _flat_ref(jpp)
            jpp, jo, jm = jstep(jpp, jo, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labs)})
            tp, to, tm = tstep(tp, to, {"tokens": toks, "labels": labs})
            for k in ("loss", "lr", "grad_norm"):
                within(float(tm[k]), float(jm[k]),
                       LAYER_TOL * abs(float(jm[k])))
            n_amp = n_all = 0
            for n, want in _flat_ref(jpp).items():
                got = dict(TM._leaves(tp))[n]
                assert got.dtype == (BF16 if want.dtype.name == "bfloat16"
                                     else torch.float32), n
                lr = float(jm["lr"])
                p0, w = prev[n].astype(np.float32), want.astype(np.float32)
                decay = 0.1 * np.abs(p0) if p0.ndim >= 2 else 0.0
                # a bf16 parameter moves in whole ulps: an update is
                # amplified where its move exceeds one ulp of p more than
                # AMPLIFIED lr and the decay could give, on either side
                g = f32(got)
                assert np.isfinite(g).all(), n
                lim = ulp(p0) + lr * (AMPLIFIED + decay)
                amp = (np.abs(p0 - w) > lim) | (np.abs(p0 - g) > lim)
                n_amp, n_all = n_amp + amp.sum(), n_all + amp.size
                # each side moves p by at most lr (1 + decay) and rounds
                bound = 2 * ulp(w) + 2 * lr * (1 + decay)
                assert (np.abs(g - w)[~amp] <= bound[~amp]).all(), n
            assert n_amp <= 0.05 * n_all


@pytest.mark.parametrize("use_kernels", [True, False])
def test_whisper_gradient_in_bf16_within_the_references_noise(archs,
                                                             use_kernels):
    """Reduced whisper trained in bf16: lm_loss(enc_frames=) and every
    gradient leaf, the encoder's included (on the kernel route the encoder's
    and the cross attention's gradient through FlashAttention over keys of
    their own length), each within the reference's own bf16 noise
    (within_noise: e from the reference's value_and_grad in f32 on the same
    bf16-valued weights and inputs), every leaf of its parameter's type."""
    cfg, jcfg, jp, tp = archs["whisper-large-v3"]
    toks, tkw, jkw = _inputs(cfg, 2, 16, 40)
    labs = np.random.default_rng(41).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)

    def ref(p, kw):
        return jax.value_and_grad(lambda p: JM.lm_loss(
            p, jcfg, jnp.asarray(toks), jnp.asarray(labs), **kw))(p)
    jl, jg = ref(jp, jkw)
    fl, fg = ref(_to_f32(jp), _to_f32(jkw))
    tl, tg = TS.loss_and_grads(tp, cfg, torch.from_numpy(toks),
                               torch.from_numpy(labs),
                               use_kernels=use_kernels, **tkw)
    within_noise(tl, jl, fl)
    want, want32, got = _flat_ref(jg), _flat_ref(fg), dict(TM._leaves(tg))
    assert set(got) == set(want) and any(n.startswith("encoder/")
                                         for n in got)
    for n, w in want.items():
        assert got[n].dtype == dict(TM._leaves(tp))[n].dtype, n
        within_noise(got[n], w, want32[n])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_whisper_gradient_in_bf16_where_attention_is_near_uniform(
        use_kernels):
    """Whisper at 4 encoder and 4 decoder layers, d_model 128, 4 heads of
    32, 2 x 256 tokens (its reduced form widened): in the last decoder
    layer attention over 256 positions is near uniform, so dS = P (dP - D)
    cancels to a fraction of its terms, and that layer's q and k projection
    gradients are sums far below their terms.  The port's bf16 gradient,
    every layer's slice of every leaf, within the reference's own bf16
    noise (within_noise).  D taken from the bf16 o in place of the f32 o
    puts the last layer's wq and wk at about 1.5 times that bound (the
    worst slice reads about 0.66 of it with the f32 o)."""
    import dataclasses
    wide = dict(d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256)
    cfg = dataclasses.replace(ARCHS["whisper-large-v3"].reduced(n_layers=4),
                              **wide)
    jcfg = dataclasses.replace(JARCHS["whisper-large-v3"].reduced(
        n_layers=4), **wide)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks, tkw, jkw = _inputs(cfg, 2, 256, 42)
    labs = np.random.default_rng(43).integers(0, cfg.vocab, (2, 256)).astype(
        np.int32)

    def ref(p, kw):
        return jax.value_and_grad(lambda p: JM.lm_loss(
            p, jcfg, jnp.asarray(toks), jnp.asarray(labs), **kw))(p)
    jl, jg = ref(jp, jkw)
    fl, fg = ref(_to_f32(jp), _to_f32(jkw))
    tl, tg = TS.loss_and_grads(tp, cfg, torch.from_numpy(toks),
                               torch.from_numpy(labs),
                               use_kernels=use_kernels, **tkw)
    within_noise(tl, jl, fl)
    want, want32, got = _flat_ref(jg), _flat_ref(fg), dict(TM._leaves(tg))
    for n, w in want.items():
        # a stacked leaf layer by layer: the last layer's cancelling sums
        # are far below the leaf's largest values
        for g in range(w.shape[0]) if "groups/" in n else [...]:
            within_noise(got[n][g], w[g], want32[n][g])


def test_adamw_update_in_bf16_matches_the_reference_where_it_amplifies():
    """The bf16 update with int8 states, on the same bf16 parameters and
    gradients on both sides, over three steps: every parameter within one
    ulp of the reference's (each side rounds the same f32 p - lr u once;
    u's f32 operations are the reference's, in its order), amplified
    elements included.  The gradients span four decades within a row, so
    that int8 v rounds to 0 where a row's gradient is small: the update
    there is m / (sqrt(v) + eps) with v from this step's gradient alone,
    and where that gradient is far smaller than the last, past AMPLIFIED;
    the test asserts such elements occur."""
    rng = np.random.default_rng(70)
    shapes = {"embed": (64, 32), "final_norm": {"w": (32,)},
              "groups": {"pos_0": {"mixer": {"wq": (2, 32, 48)}}}}

    def draw(shape, spread):
        a = rng.standard_normal(shape) * 10.0 ** rng.uniform(-spread, 0,
                                                              shape)
        return jnp.asarray(a, jnp.bfloat16)

    def tree(spread, scale=1.0):
        def go(sh):
            return {k: go(v) for k, v in sh.items()} if isinstance(
                sh, dict) else draw(sh, spread) * scale
        return go(shapes)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3, quantize_states=True)
    jcfg, tcfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jp = tree(0, 0.02)
    tp = _tree(jax.tree.map(np.asarray, jp))
    js, ts = JO.init_opt_state(jp, jcfg), TO.init_opt_state(tp, tcfg)
    n_amp = 0
    for i in range(3):
        g = tree(4, 1e-3)
        prev = _flat_ref(jp)
        jp, js, jm = JO.adamw_update(jp, g, js, jcfg)
        tp, ts, _ = TO.adamw_update(tp, _tree(jax.tree.map(np.asarray, g)),
                                    ts, tcfg)
        lr = float(jm["lr"])
        for n, want in _flat_ref(jp).items():
            got = dict(TM._leaves(tp))[n]
            assert got.dtype == BF16, n
            w, p0 = want.astype(np.float32), prev[n].astype(np.float32)
            within_ulps(got, want)
            n_amp += int((np.abs(w - p0) > ulp(p0) + lr * (
                AMPLIFIED + 0.1 * np.abs(p0))).sum())
    assert n_amp > 0


def test_serving_engine_in_bf16():
    """ServingEngine(dtype=bf16) against the reference's engine in bf16:
    the cache, a prefill's cache and the parked pages bf16 (the logits
    f32), the counters equal, a parked restore bit for bit and a host one
    through the BFP8 codec."""
    cfg, jcfg, jp, tp = _arch("yi-6b")
    eng_kw = dict(max_batch=2, s_max=48, evict_to_host=True,
                  resident_limit=1)
    jeng = JEngine(jcfg, jp, dtype=jnp.bfloat16, **eng_kw)
    teng = ServingEngine(cfg, tp, dtype=BF16, device="cpu", **eng_kw)
    rng = np.random.default_rng(60)
    reqs = [(rng.integers(0, cfg.vocab, n), m)
            for n, m in ((5, 6), (17, 4), (9, 8), (30, 5))]
    for p, m in reqs:
        jeng.submit(p, max_new_tokens=m)
        teng.submit(p, max_new_tokens=m)
    assert all(c.dtype == BF16 for _, c in TM._leaves(teng.cache))
    for p, _ in reqs:
        tl, tc = teng.run_prefill(p)
        assert tl.dtype == torch.float32
        assert all(c.dtype == BF16 for _, c in TM._leaves(tc))
    jeng.run_until_drained()
    teng.run_until_drained()
    keys = lambda text, parse: {  # noqa: E731
        (f, k): v for f, fam in parse(text).items() if f.endswith("_total")
        for k, v in fam["samples"].items()}
    assert (keys(teng.metrics_text(), parse_metrics_text)
            == keys(jeng.metrics_text(), jparse))
    (rid, parked), = teng.resident_store.items()
    assert all(t.dtype == BF16 for t in parked.values())
    parked = {k: v.clone() for k, v in parked.items()}
    teng.restore_request(rid, 0)
    for n, c in TM._leaves(teng.cache):
        assert torch.equal(c[:, 0], parked[n])
    host = next(iter(teng.host_store))
    teng.restore_request(host, 1)
    assert teng.stats.restored_pages == 4


@pytest.mark.parametrize("bfp8", [False, True], ids=["raw", "bfp8"])
def test_bf16_checkpoints_cross_between_the_packages(tmp_path, bfp8):
    """A bf16 parameter tree saved by either package restores in the
    other: raw bit for bit, BFP8 equal to the other package's own
    restore."""
    cfg, jcfg, jp, tp = _arch("olmoe-1b-7b")
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    JStore(str(jdir), bfp8=bfp8).save(3, jp)
    CheckpointStore(str(tdir), bfp8=bfp8).save(3, tp)
    t_from_j, _ = CheckpointStore(str(jdir)).restore(tp)
    t_from_t, _ = CheckpointStore(str(tdir)).restore(tp)
    j_from_t, _ = JStore(str(tdir)).restore(jp)
    j_from_j, _ = JStore(str(jdir)).restore(jp)
    ref = _flat_ref(jp)
    for n, t in TM._leaves(t_from_j):
        assert t.dtype == dict(TM._leaves(tp))[n].dtype, n
        np.testing.assert_array_equal(f32(t), f32(dict(
            TM._leaves(t_from_t))[n]))
        if not bfp8:
            np.testing.assert_array_equal(f32(t), ref[n].astype(np.float32))
    jt, jj = _flat_ref(j_from_t), _flat_ref(j_from_j)
    for n, a in jt.items():
        assert a.dtype == ref[n].dtype, n
        np.testing.assert_array_equal(a.astype(np.float32),
                                      jj[n].astype(np.float32))


def test_train_cli_in_bf16_on_the_cpu(tmp_path, capsys):
    ttrain_cli.main(["--arch", "yi-6b", "--device", "cpu", "--smoke",
                     "--dtype", "bfloat16", "--steps", "4", "--batch", "2",
                     "--seq", "32", "--ckpt-dir", str(tmp_path),
                     "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "yi-6b-smoke: 4 steps, loss" in out, out
    params = TM.init_params(torch.Generator().manual_seed(0),
                            ARCHS["yi-6b"].reduced(), dtype=BF16)
    (restored, _), _ = CheckpointStore(str(tmp_path)).restore(
        (params, TO.init_opt_state(params, TO.AdamWConfig())))
    assert restored["embed"].dtype == BF16


def test_step_builders_take_bf16():
    cfg = ARCHS["yi-6b"].reduced()
    for make in (TS.make_prefill_step, TS.make_decode_step):
        make(cfg, 1, 16, dtype=BF16, device="cpu")
    TS.make_train_step(cfg, TO.AdamWConfig(), dtype=BF16, device="cpu")
    with pytest.raises(ValueError):
        TS.make_train_step(cfg, TO.AdamWConfig(), dtype=torch.float16,
                           device="cpu")
