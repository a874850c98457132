"""bf16 training on the recurrent mixers against the reference package in
bf16, on the CPU: reduced jamba-v0.1-52b (Mamba, attention and experts)
and xlstm-1.3b (mLSTM and sLSTM) through the checkpointed training scans,
held as ``tests/test_torch_bf16.py`` holds the attention families' bf16
gradient and train step (its helpers, its bounds from bf16's unit
round-off and the reference's own noise; see its docstring), with the
reference compiled as written (``AS_WRITTEN``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.launch.mesh import make_host_mesh                # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.optim import adamw as JO                         # noqa: E402
from repro.runtime.steps import make_train_step as jmake_step  # noqa: E402

from repro_torch.models import model as TM                  # noqa: E402
from repro_torch.optim import adamw as TO                   # noqa: E402
from repro_torch.runtime import steps as TS                 # noqa: E402

from test_torch_bf16 import (AMPLIFIED, BF16, _arch, _flat_ref,  # noqa: E402
                             _inputs, _to_f32, f32, ulp, within_noise)


RECURRENT = ("jamba-v0.1-52b", "xlstm-1.3b")
#: leaves the reference keeps in f32 under a bf16 tree (the Mamba decay and
#: skip, the mLSTM gates, the sLSTM bias, the experts' router): their
#: gradients are f32 too
F32_LEAVES = ("A_log", "D", "gate_proj", "gate_bias", "bias", "router")
#: XLA:CPU by default may keep a bf16 intermediate in f32 inside a fused
#: computation (excess precision), so the reference's bf16 run skips
#: roundings its program asks for and its noise reads low: on reduced
#: jamba, layer 5's Mamba skip D gradient e is 0.61 of the port's own
#: distance from its f32 run.  The recurrent references are compiled whole
#: with it off, rounding wherever their program says, as the port does.
AS_WRITTEN = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs: the recurrent scans issue
    many small ops, and beside the other test workers' thread pools each
    op's pool stalls (as tests/test_torch_train.py sets)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def archs():
    return {n: _arch(n) for n in RECURRENT}


@pytest.fixture(scope="module")
def recurrent_grads(archs):
    """arch -> (tokens, labels, (loss, grads) of the reference's lm_loss in
    bf16 and in f32 on the same bf16 values), at 2 x 256 tokens (4 mLSTM
    chunks of 64, 2 Mamba and sLSTM scan chunks of 128)."""
    out = {}
    for name in RECURRENT:
        cfg, jcfg, jp, _ = archs[name]
        toks, _, _ = _inputs(cfg, 2, 256, 44)
        labs = np.random.default_rng(45).integers(
            0, cfg.vocab, (2, 256)).astype(np.int32)
        f = jax.value_and_grad(lambda p, jcfg=jcfg, toks=toks, labs=labs:
                               JM.lm_loss(p, jcfg, jnp.asarray(toks),
                                          jnp.asarray(labs)))
        out[name] = (toks, labs,
                     jax.jit(f, compiler_options=AS_WRITTEN)(jp),
                     jax.jit(f)(_to_f32(jp)))
    return out


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_gradient_in_bf16_within_the_references_noise(
        archs, recurrent_grads, name, use_kernels):
    """Reduced jamba (Mamba, attention and experts) and xlstm (mLSTM and
    sLSTM) trained in bf16 through the recurrent mixers' checkpointed
    training scans: lm_loss and every gradient leaf within the reference's
    own bf16 noise (within_noise: e from the reference's value_and_grad
    in f32 on the same bf16-valued weights; the reference rounding as
    written, AS_WRITTEN), every leaf of its parameter's type and the
    reference's: bf16, but F32_LEAVES f32."""
    cfg, _, _, tp = archs[name]
    toks, labs, (jl, jg), (fl, fg) = recurrent_grads[name]
    tl, tg = TS.loss_and_grads(tp, cfg, torch.from_numpy(toks),
                               torch.from_numpy(labs),
                               use_kernels=use_kernels)
    within_noise(tl, jl, fl)
    want, want32, got = _flat_ref(jg), _flat_ref(fg), dict(TM._leaves(tg))
    assert set(got) == set(want)
    kinds = {n.split("/")[-1] for n in got if got[n].dtype == torch.float32}
    assert kinds and kinds <= set(F32_LEAVES), kinds
    for n, w in want.items():
        want_dtype = (torch.float32 if n.split("/")[-1] in F32_LEAVES
                      else BF16)
        assert (w.dtype.name == "bfloat16") == (want_dtype == BF16), n
        assert got[n].dtype == dict(TM._leaves(tp))[n].dtype == want_dtype, n
        within_noise(got[n], w, want32[n])


def test_recurrent_train_step_in_bf16_matches_the_reference():
    """One make_train_step(dtype=bf16) step on reduced jamba with int8
    states (two microbatches accumulated in bf16) against the reference's
    on the host mesh, compiled AS_WRITTEN: the loss and grad_norm within
    the reference's own bf16 noise (within_noise, e from the same step on
    the bf16 values in f32), lr exactly; every new parameter held as
    test_train_step_in_bf16_matches_the_reference holds yi-6b's (each
    side's update and two ulps, amplified elements finite), of the
    reference's type.  At the first step AdamW's update is sign(g) where g
    is above eps, so where a gradient of the bf16 noise's size flips sign
    the two parameters land 2 lr apart, on either side of p0: the ulps are
    those of the larger of the two."""
    cfg, jcfg, jp, tp = _arch("jamba-v0.1-52b")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4, quantize_states=True)
    jo_cfg, to_cfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    rng = np.random.default_rng(46)
    toks, labs = (rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32)
                  for _ in range(2))
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    with make_host_mesh() as mesh:
        jm = {}
        for key, p, opts in (("bf16", jp, AS_WRITTEN),
                             ("f32", _to_f32(jp), {})):
            jstep, _, _ = jmake_step(jcfg, mesh, jo_cfg, remat="full",
                                     dtype=jnp.bfloat16, microbatches=2)
            out = jax.jit(jstep, compiler_options=opts)(
                p, JO.init_opt_state(p, jo_cfg), batch)
            jm[key] = out if key == "bf16" else out[2]
    jpp, _, jmet = jm["bf16"]
    tstep = TS.make_train_step(cfg, to_cfg, dtype=BF16, microbatches=2,
                               device="cpu")
    prev = {n: f32(t) for n, t in TM._leaves(tp)}
    tp, _, tm = tstep(tp, TO.init_opt_state(tp, to_cfg),
                      {"tokens": toks, "labels": labs})
    for k in ("loss", "grad_norm"):
        within_noise(float(tm[k]), float(jmet[k]), float(jm["f32"][k]))
    assert float(tm["lr"]) == float(jmet["lr"])
    lr = float(jmet["lr"])
    n_amp = n_all = 0
    for n, want in _flat_ref(jpp).items():
        got = dict(TM._leaves(tp))[n]
        assert got.dtype == (BF16 if want.dtype.name == "bfloat16"
                             else torch.float32), n
        p0, w, g = prev[n], want.astype(np.float32), f32(got)
        assert np.isfinite(g).all(), n
        decay = 0.1 * np.abs(p0) if p0.ndim >= 2 else 0.0
        lim = ulp(p0) + lr * (AMPLIFIED + decay)
        amp = (np.abs(p0 - w) > lim) | (np.abs(p0 - g) > lim)
        n_amp, n_all = n_amp + amp.sum(), n_all + amp.size
        # each side's update moves p by at most lr (1 + decay), a sign
        # of g decided by one rounding flips it (the two land 2 lr apart),
        # and each side rounds its own p - lr u once: an ulp of the larger
        bound = 2 * ulp(np.maximum(np.abs(w), np.abs(g))) + 2 * lr * (
            1 + decay)
        assert (np.abs(g - w)[~amp] <= bound[~amp]).all(), n
    assert n_amp <= 0.05 * n_all
