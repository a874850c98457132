"""The port's staged LM executor (``runtime/reconfigure.py``: one stage's
weights on the device at a time, the boundary activation through the BFP8
codec, Eq. 5's accounting) on the CPU against the reference package's.

The reference's own tests (``tests/test_substrates.py``,
``TestStagedExecutor``) ported as they are, then the port's executor held
to the reference's on reduced yi-6b with the reference's weights carried
over by ``params_from_numpy``: the stage ranges, the number of timings and
the boundary byte counts exactly; the logits within rtol = atol = 2e-4 in
f32 (the port's standing f32 tolerance: XLA's and PyTorch's CPU products
sum in other orders).  In bf16 the logits are held to the reference's
within the whole-model bound of ``tests/test_torch_bf16.py`` (4 layers:
4 x 2 x 20 x 2^-8 of their largest magnitude); the stages change nothing
there, so the staged logits also equal the port's own monolithic forward
bit for bit with the codec off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.runtime.reconfigure import (                     # noqa: E402
    StagedExecutor as JStaged)

from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.models import (forward, init_params,       # noqa: E402
                                params_from_numpy, project_logits)
from repro_torch.runtime.reconfigure import (               # noqa: E402
    StagedExecutor, split_group_stages)

TOL = 2e-4
BF16_WHOLE_MODEL = 4 * 2 * 20 * 2.0 ** -8


def _params(cfg, seed=1):
    return init_params(torch.Generator().manual_seed(seed), cfg)


class TestStagedExecutor:
    def test_split_balanced(self):
        assert split_group_stages(8, 3) == [(0, 3), (3, 6), (6, 8)]
        assert split_group_stages(4, 8) == [(0, 1), (1, 2), (2, 3), (3, 4)]

    def test_staged_matches_monolithic(self):
        cfg = ARCHS["yi-6b"].reduced(n_layers=4)
        params = _params(cfg)
        toks = torch.randint(0, cfg.vocab, (2, 16),
                             generator=torch.Generator().manual_seed(2))
        x, _, _ = forward(params, cfg, toks)
        want = project_logits(params, cfg, x)
        ex = StagedExecutor(cfg, params, n_stages=2, compress_boundary=False,
                            device="cpu")
        got = ex.forward_logits(toks)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        assert len(ex.timings) == 2

    def test_boundary_compression_small_error(self):
        cfg = ARCHS["yi-6b"].reduced(n_layers=4)
        params = _params(cfg)
        toks = torch.randint(0, cfg.vocab, (1, 16),
                             generator=torch.Generator().manual_seed(2))
        plain = StagedExecutor(cfg, params, n_stages=2,
                               compress_boundary=False, device="cpu")
        comp = StagedExecutor(cfg, params, n_stages=2,
                              compress_boundary=True, device="cpu")
        a = plain.forward_logits(toks).numpy()
        b = comp.forward_logits(toks).numpy()
        # BFP8 boundary: small perturbation, same argmax almost everywhere
        agree = (a.argmax(-1) == b.argmax(-1)).mean()
        assert agree > 0.9
        eq5 = comp.eq5_latency(batch=1)
        assert eq5["boundary_compression"] < 0.6

    def test_eq5_accounting(self):
        cfg = ARCHS["yi-6b"].reduced(n_layers=4)
        params = _params(cfg)
        toks = torch.zeros((1, 8), dtype=torch.long)
        ex = StagedExecutor(cfg, params, n_stages=4, device="cpu")
        ex.forward_logits(toks)
        eq5 = ex.eq5_latency(batch=1)
        assert eq5["n_stages"] == 4
        assert eq5["total_s"] >= eq5["compute_s"]


@pytest.mark.parametrize("n_groups,n_stages", [(1, 1), (4, 2), (5, 3),
                                               (32, 4), (3, 7)])
def test_split_is_the_references(n_groups, n_stages):
    from repro.runtime.reconfigure import split_group_stages as jsplit
    assert split_group_stages(n_groups, n_stages) == jsplit(n_groups,
                                                            n_stages)


def _both(dtype, jdtype):
    cfg = ARCHS["yi-6b"].reduced(n_layers=4)
    jcfg = JARCHS["yi-6b"].reduced(n_layers=4)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg, dtype=jdtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    return cfg, jcfg, jp, tp, toks


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "bfp8"])
@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_staged_matches_the_reference_in_f32(compress, n_stages):
    cfg, jcfg, jp, tp, toks = _both(torch.float32, jnp.float32)
    jex = JStaged(jcfg, jp, n_stages=n_stages, compress_boundary=compress)
    tex = StagedExecutor(cfg, tp, n_stages=n_stages,
                         compress_boundary=compress, device="cpu")
    want = jex.forward_logits(jnp.asarray(toks))
    got = tex.forward_logits(toks)
    assert tex.stages == jex.stages
    assert len(tex.timings) == len(jex.timings) == len(jex.stages)
    assert ([(t.stage, t.boundary_bytes_raw, t.boundary_bytes_sent)
             for t in tex.timings]
            == [(t.stage, t.boundary_bytes_raw, t.boundary_bytes_sent)
                for t in jex.timings])
    if compress:
        # a BFP8 mantissa may step where the two inputs differ in their
        # last f32 bits; the argmax agrees almost everywhere, as the
        # reference's own check of the codec
        assert (got.numpy().argmax(-1) == _f32(want).argmax(-1)).mean() > 0.9
    else:
        np.testing.assert_allclose(got.numpy(), _f32(want), rtol=TOL,
                                   atol=TOL)
    jq, tq = jex.eq5_latency(batch=2), tex.eq5_latency(batch=2)
    assert set(tq) == set(jq)
    for k in ("n_stages", "boundary_raw_bytes", "boundary_sent_bytes",
              "boundary_compression"):
        assert tq[k] == jq[k], k


def test_staged_matches_the_reference_in_bf16():
    cfg, jcfg, jp, tp, toks = _both(torch.bfloat16, jnp.bfloat16)
    jex = JStaged(jcfg, jp, n_stages=2, compress_boundary=False,
                  dtype=jnp.bfloat16)
    tex = StagedExecutor(cfg, tp, n_stages=2, compress_boundary=False,
                         dtype=torch.bfloat16, device="cpu")
    want = _f32(jex.forward_logits(jnp.asarray(toks)))
    got = tex.forward_logits(toks)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= (BF16_WHOLE_MODEL
                                               * np.abs(want).max())
    assert ([t.boundary_bytes_raw for t in tex.timings]
            == [t.boundary_bytes_raw for t in jex.timings])
    # the stages and the exact round trip change nothing: the port's own
    # monolithic forward, bit for bit
    x, _, _ = forward(tp, cfg, torch.from_numpy(toks).long())
    assert torch.equal(got, project_logits(tp, cfg, x))


def test_stages_hold_one_stage_of_weights():
    """Each stage's tensors are copies of the host's slice; the host tree
    is kept as it was given (CPU tensors, no copy)."""
    cfg = ARCHS["yi-6b"].reduced(n_layers=4)
    params = _params(cfg)
    ex = StagedExecutor(cfg, params, n_stages=4, device="cpu")
    assert ex.host_params["embed"].data_ptr() == params["embed"].data_ptr()
    gp = ex._stage_params(2)
    assert gp["pos_0"]["mixer"]["wq"].shape[0] == 1
    torch.testing.assert_close(gp["pos_0"]["mixer"]["wq"][0],
                               params["groups"]["pos_0"]["mixer"]["wq"][2],
                               rtol=0, atol=0)


def test_refusals():
    cfg = ARCHS["yi-6b"].reduced()
    with pytest.raises(ValueError):
        StagedExecutor(cfg, _params(cfg), n_stages=1, dtype=torch.bfloat16,
                       device="cpu")
    wcfg = ARCHS["whisper-large-v3"].reduced()
    with pytest.raises(ValueError):
        StagedExecutor(wcfg, {}, n_stages=1, device="cpu")
