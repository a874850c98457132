"""The whole slice on the CPU: DSE plan -> the port's staged executor, held
against the reference package's ``lower_plan`` with the same weights
(carried across by ``params_from_numpy``) and the same input.

* the SpillReport is equal field for field;
* a lossless plan is within rtol = atol = 2e-4 (f32 sums in another order);
* a BFP8 plan is within 2e-2 x max|reference| at every vertex (the
  codec's exponent and scale are exact in the port and not in the
  reference — see test_torch_kernels.py — so a value may move by one
  mantissa step of its block); a failure names the first vertex that
  leaves the reference.
"""
import dataclasses
import weakref

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402
import torch                                                # noqa: E402

from repro.core import DSEConfig as JDSEConfig              # noqa: E402
from repro.core import builders as jbuilders                # noqa: E402
from repro.core.dse import run_dse as jrun_dse              # noqa: E402
from repro.core.plan import plan_from_dse as jplan_from_dse  # noqa: E402
from repro.core.resources import Device as JDevice          # noqa: E402
from repro.runtime.executor import lower_plan as jlower_plan  # noqa: E402

import repro_torch                                          # noqa: E402
from repro_torch.core import DSEConfig as TDSEConfig        # noqa: E402
from repro_torch.core import builders as tbuilders          # noqa: E402
from repro_torch.core.resources import Device as TDevice    # noqa: E402
from repro_torch.runtime import executor as tex             # noqa: E402
from repro_torch.runtime.executor import (init_params,      # noqa: E402
                                          params_from_numpy,
                                          reference_pipeline)

_TINY = dict(name="tiny_stream", compute_units=4096, onchip_bits=300_000,
             offchip_gbps=64.0, freq_mhz=500.0, reconfig_s=0.0)
SLICE_UNET = dict(positions=64, base=64, levels=3)
LOSSLESS_TOL = 2e-4
BFP8_TOL = 2e-2


def _dse(codecs):
    return dict(batch=1, codecs=codecs, word_bits=16, cut_kinds=("output",))


def _reference(builder, kwargs, codecs, kernel_mode):
    """The reference package's lowered pipeline for the tiny-device plan."""
    jg = getattr(jbuilders, builder)(**kwargs)
    dev = JDevice(**_TINY)
    plan = jplan_from_dse(jg.name, dev.name,
                          jrun_dse(jg, dev, JDSEConfig(**_dse(codecs))),
                          microbatch=8)
    interpret = True if kernel_mode == "pallas" else None
    return jlower_plan(jg, plan, kernel_mode=kernel_mode, interpret=interpret)


def _port(builder, kwargs, codecs, jlp, kernel_mode="auto"):
    """The port compiled through its façade on the CPU, with the
    reference's weights."""
    g = getattr(tbuilders, builder)(**kwargs)
    c = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device=TDevice(**_TINY), dse=TDSEConfig(**_dse(codecs)),
        kernel_mode=kernel_mode, torch_device="cpu"))
    c.executor.params = params_from_numpy(
        {k: np.asarray(v) for k, v in jlp.params.items()})
    return c


def _frame(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _first_divergence(tvals, jvals, tol_of):
    for name, jv in jvals.items():
        jv = np.asarray(jv)
        tv = tvals[name].numpy()
        if tv.shape != jv.shape:
            return f"{name}: shape {tv.shape} vs {jv.shape}"
        err = float(np.abs(tv - jv).max(initial=0.0))
        if err > tol_of(jv):
            return f"{name}: max err {err:.3e} > {tol_of(jv):.3e}"
    return None


def _spills(report):
    return [dataclasses.asdict(s) for s in report.spills]


@pytest.fixture(scope="module")
def slice_bfp8():
    jlp = _reference("build_unet_exec", SLICE_UNET, ("none", "bfp8"),
                     "pallas")
    return jlp, _port("build_unet_exec", SLICE_UNET, ("none", "bfp8"), jlp)


def test_slice_plan_evicts_and_fragments(slice_bfp8):
    _, c = slice_bfp8
    assert sum(s.codec == "bfp8" for s in c.executor.report.spills) == 1
    assert all(lp.weight_static_fraction == 0.0
               for n, lp in c.plan.layers.items()
               if n.startswith(("conv", "deconv")))


def test_slice_spill_report_equals_reference(slice_bfp8):
    jlp, c = slice_bfp8
    assert _spills(c.executor.report) == _spills(jlp.report)
    assert c.executor.report.summary() == jlp.report.summary()
    assert c.report()["traffic"] == jlp.report.summary()


def test_slice_bfp8_every_vertex_within_tolerance(slice_bfp8):
    jlp, c = slice_bfp8
    x = _frame(c.input_shape())
    jvals = jlp.run_intermediates(jnp.asarray(x))
    tvals = c.executor.run_intermediates(torch.from_numpy(x))
    assert list(tvals) == list(jvals)
    bad = _first_divergence(
        tvals, jvals, lambda r: BFP8_TOL * float(np.abs(r).max(initial=0.0)))
    assert bad is None, f"first vertex off the reference: {bad}"
    out = c.run(x)
    np.testing.assert_array_equal(out.numpy(),
                                  tvals[list(tvals)[-1]].numpy())


def test_slice_lossless_within_tolerance():
    jlp = _reference("build_unet_exec", SLICE_UNET, ("none",), "pallas")
    c = _port("build_unet_exec", SLICE_UNET, ("none",), jlp)
    assert _spills(c.executor.report) == _spills(jlp.report)
    assert any(s.codec == "none" for s in c.executor.report.spills)
    x = _frame(c.input_shape(), seed=1)
    np.testing.assert_allclose(c.run(x).numpy(),
                               np.asarray(jlp(jnp.asarray(x))),
                               rtol=LOSSLESS_TOL, atol=LOSSLESS_TOL)


def test_kernel_route_equals_reference_route(slice_bfp8):
    """On the CPU the kernel route runs the kernels' plain versions; it
    computes the same composition as the reference route, bit for bit."""
    jlp, c = slice_bfp8
    ref = _port("build_unet_exec", SLICE_UNET, ("none", "bfp8"), jlp,
                kernel_mode="reference")
    x = _frame(c.input_shape(), seed=2)
    np.testing.assert_array_equal(c.run(x).numpy(), ref.run(x).numpy())


@pytest.mark.parametrize("builder", ["build_unet_exec",
                                     "build_yolo_head_exec",
                                     "build_x3d_exec"])
def test_exec_models_match_reference(builder):
    """Every executable model at its default size, BFP8 plan on the tiny
    device, against the reference's reference-mode pipeline."""
    jlp = _reference(builder, {}, ("none", "bfp8"), "reference")
    c = _port(builder, {}, ("none", "bfp8"), jlp)
    assert _spills(c.executor.report) == _spills(jlp.report)
    x = _frame(c.input_shape(), seed=3)
    jvals = jlp.run_intermediates(jnp.asarray(x))
    tvals = c.executor.run_intermediates(torch.from_numpy(x))
    bad = _first_divergence(
        tvals, jvals, lambda r: BFP8_TOL * float(np.abs(r).max(initial=0.0)))
    assert bad is None, f"first vertex off the reference: {bad}"


def test_dense_reference_pipeline_and_params():
    g = tbuilders.build_unet_exec()
    lp = reference_pipeline(g, seed=3, device="cpu")
    assert lp.report.spills == [] and lp.report.streamed_weight_bits == 0
    again = init_params(g, seed=3)
    assert set(again) == set(lp.params)
    for k, w in again.items():
        assert torch.equal(w, lp.params[k])
    assert not torch.equal(init_params(g, seed=4)["conv_2"], again["conv_2"])
    with pytest.raises(ValueError, match="input shape"):
        lp(torch.zeros(3, 3))


class _WatchingHop:
    """An off-chip hop that keeps its own copy of each spill and notes, when
    a consumer brings one back, whether the tensor evicted is still held."""

    def __init__(self):
        self.held_at_restore = []

    def evict(self, key, tensors):
        return ([t.clone() for t in tensors],
                [weakref.ref(t) for t in tensors])

    def restore(self, handle):
        copies, refs = handle
        self.held_at_restore.append(any(r() is not None for r in refs))
        return tuple(copies)


@pytest.mark.parametrize("codecs", [("none",), ("none", "bfp8")])
def test_forward_holds_no_spilled_stream_while_it_waits(codecs):
    """On the forward path a producer's output is dropped once its last
    on-device reader has run, so an evicted stream is held off the device
    only; ``keep_all`` (run_intermediates) keeps every output."""
    g = tbuilders.build_unet_exec(**SLICE_UNET)
    c = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device=TDevice(**_TINY), dse=TDSEConfig(**_dse(codecs)),
        torch_device="cpu"))
    an = tex.analyze_plan(g, c.plan, use_kernels=True)
    assert an.spills
    x = torch.from_numpy(_frame(c.input_shape(), seed=4))
    hop = _WatchingHop()
    out, pays = tex.run_vertices(g, an, c.executor.params, x, hop,
                                 keep_all=False)
    assert list(out) == [an.topo[-1]] and pays == {}
    assert hop.held_at_restore and not any(hop.held_at_restore)
    every, _ = tex.run_vertices(g, an, c.executor.params, x, _WatchingHop())
    assert list(every) == an.topo
    assert torch.equal(out[an.topo[-1]], every[an.topo[-1]])
    assert torch.equal(c.run(x), out[an.topo[-1]])
