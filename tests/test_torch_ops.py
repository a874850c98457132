"""The port's last public names against the reference package: the
façade's 22 names, ``Compiled.__call__``, ``SpillRecord.ratio`` and
``kernels.ops.fragmented_matmul`` (on the CPU its ``streamed_matmul``
runs the plain version).

Tolerances: ``fragmented_matmul`` within rtol = atol = 1e-4 of the
reference's Pallas kernel in interpret mode and of ``x @ w``, the
reference's own test's (f32 sums in another order); ``compiled(x)`` bit
for bit ``compiled.run(x)`` (one call); the spill ratios exactly.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                # noqa: E402

import repro_torch                                          # noqa: E402
from repro_torch import api as tapi                         # noqa: E402
from repro_torch import memory as tmemory                   # noqa: E402
from repro_torch import obs as tobs                         # noqa: E402
from repro_torch.kernels import ops as tops                 # noqa: E402
from repro_torch.kernels.library import launches, reset_launches  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRACTIONS = (0.0, 0.25, 0.5, 1.0)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- fragmented_matmul --------------------------------------------------------

@pytest.mark.parametrize("static_fraction", FRACTIONS)
def test_fragmented_matmul_is_the_references(static_fraction):
    """At the reference test's shapes (128 x 512 @ 512 x 256): the fraction
    moves no value, and the product is the reference's."""
    from repro.kernels.ops import fragmented_matmul as j_frag
    x, w = _rand(1, 128, 512), _rand(2, 512, 256)
    want = np.asarray(j_frag(x, w, static_fraction=static_fraction,
                             interpret=True))
    got = tops.fragmented_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 static_fraction=static_fraction).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-4)


def test_fragmented_matmul_at_one_tile_of_k_is_a_plain_product():
    from repro.kernels.ops import fragmented_matmul as j_frag
    x, w = _rand(3, 128, 128), _rand(4, 128, 256)
    want = np.asarray(j_frag(x, w, static_fraction=0.5, interpret=True))
    got = tops.fragmented_matmul(torch.from_numpy(x),
                                 torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("static_fraction,ks", [
    (0.0, 128), (0.1, 128), (0.25, 128), (0.5, 256), (0.75, 384),
    (1.0, 384)])
def test_fragmented_matmul_splits_where_the_reference_does(
        static_fraction, ks, monkeypatch):
    """The split row at K = 512: round(f K / 128) 128, clamped to
    [128, K - 128], as the reference's; one ``streamed_matmul`` call."""
    calls = []
    real = tops.streamed_matmul

    def spy(x, ws, wd):
        calls.append((ws.shape[0], wd.shape[0]))
        return real(x, ws, wd)
    monkeypatch.setattr(tops, "streamed_matmul", spy)
    x, w = torch.from_numpy(_rand(5, 128, 512)), torch.from_numpy(
        _rand(6, 512, 128))
    reset_launches()
    tops.fragmented_matmul(x, w, static_fraction=static_fraction)
    assert calls == [(ks, 512 - ks)]
    assert not any(launches().values())        # the CPU launches no kernel


# -- Compiled.__call__ --------------------------------------------------------

@pytest.mark.parametrize("mode", ["staged", "pipelined"])
def test_calling_the_artifact_is_run(mode):
    c = repro_torch.compile(repro_torch.CompileSpec(
        model="unet_exec", device="u200", mode=mode, microbatches=4,
        torch_device="cpu"))
    x = torch.from_numpy(_rand(7, *c.input_shape()))
    a, b = c(x), c.run(x)
    assert a.shape == b.shape
    assert torch.equal(a, b)


# -- SpillRecord.ratio --------------------------------------------------------

def _bfp8_skip_plan(core, plan_mod, g):
    """The reference test's hand-written plan: every edge deeper than 4096
    words evicted through BFP8."""
    layers = {v.name: plan_mod.LayerPlan(name=v.name) for v in g.vertices()}
    streams = []
    for e in g.edges():
        evict = e.buffer_depth > 4096.0
        streams.append(plan_mod.StreamPlan(e.src, e.dst, evicted=evict,
                                           codec="bfp8" if evict else "none"))
    return plan_mod.ExecutionPlan(model=g.name, device="tiny", n_stages=1,
                                  layers=layers, streams=streams)


def test_spill_ratios_are_the_references():
    from repro import core as jcore
    from repro.core import plan as jplan
    from repro.runtime.executor import lower_plan as j_lower
    from repro_torch import core as tcore
    from repro_torch.core import plan as tplan
    from repro_torch.core.compression import bfp8_ratio
    from repro_torch.runtime.executor import lower_plan as t_lower

    def ratios(core, plan_mod, lower, **kw):
        g = core.build_unet_exec()
        g.compute_buffer_depths()
        low = lower(g, _bfp8_skip_plan(core, plan_mod, g),
                    kernel_mode="reference", **kw)
        return [(s.src, s.dst, s.reason, s.exact, s.ratio)
                for s in low.report.spills]

    want = ratios(jcore, jplan, j_lower)
    got = ratios(tcore, tplan, t_lower, device="cpu")
    assert got == want
    evicted = [r for r in got if r[2] == "evicted"]
    assert evicted
    for *_, exact, ratio in evicted:
        assert exact
        assert ratio == bfp8_ratio(16, block=32) == (8 + 8 / 32) / 16


# -- the façade ---------------------------------------------------------------

FACADE = ([(n, tapi) for n in repro_torch._API_NAMES]
          + [(n, tobs) for n in repro_torch._OBS_NAMES]
          + [(n, tmemory) for n in repro_torch._MEMORY_NAMES])


def test_the_facade_has_the_references_22_names():
    import repro
    assert len(FACADE) == 22
    assert repro_torch.__all__ == repro.__all__
    assert set(repro.__all__) <= set(dir(repro_torch))


@pytest.mark.parametrize("name,sub", FACADE, ids=[n for n, _ in FACADE])
def test_facade_name_is_its_subpackages(name, sub):
    assert getattr(repro_torch, name) is getattr(sub, name)


def test_facade_loads_neither_jax_nor_repro_and_core_no_executor():
    code = textwrap.dedent("""
        import sys
        import repro_torch.core
        assert not [m for m in sys.modules if "executor" in m], "executor"
        import repro_torch
        for n in repro_torch.__all__:
            getattr(repro_torch, n)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
