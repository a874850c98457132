"""The ring placement of the port's pipelined streamer on the CPU
(``lower_plan_pipelined(placement="shard_map")``: one stage per device).

* the reference's ``test_ring_pipeline_matches_sequential`` ported: the
  UNet in 3 stages (a third of the topological order each), edges deeper
  than 4096 words BFP8-evicted, 6 microbatches, the ring on
  ``devices=["cpu"] * 3`` against the port's staged executor per microbatch
  (rtol 1e-5, atol 1e-6, the reference's) and bit for bit against the
  port's interleave;
* the same plan, and a lossless one, through the reference's own ring: a
  subprocess with 4 host devices runs ``repro``'s ``lower_plan_pipelined``
  (which must choose ``shard_map``) and writes its weights and outputs;
  the port's ring, on those weights (``params_from_numpy``), is held within
  ``tests/test_torch_pipeline.py``'s tolerances: rtol = atol = 2e-4
  lossless, 2e-2 x max|reference| with BFP8;
* the reference's rules for choosing the ring and refusing it, its report
  and its refusal of traced execution; ``measured_stage_latencies``,
  ``measure_pipelined_fps``, ``GraphStreamServer`` and ``Compiled.save`` /
  ``load`` on a ring.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

import jax                                                  # noqa: E402
import torch                                                # noqa: E402

from repro.core import builders as jbuilders                # noqa: E402
from repro.core.plan import ExecutionPlan as JPlan          # noqa: E402
from repro.runtime.streamer import \
    lower_plan_pipelined as jlower_plan_pipelined           # noqa: E402

import repro_torch                                          # noqa: E402
from repro_torch.core import builders as tbuilders          # noqa: E402
from repro_torch.core.plan import (ExecutionPlan,      # noqa: E402
                                   hand_cut_plan)
from repro_torch.optim.autotune import measure_pipelined_fps  # noqa: E402
from repro_torch.runtime.executor import (init_params,      # noqa: E402
                                          lower_plan, params_from_numpy)
from repro_torch.runtime.streamer import (              # noqa: E402
    lower_plan_pipelined, measured_stage_latencies)
from repro_torch.serving import GraphStreamServer           # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
S = 3
B = 6
LOSSLESS_TOL = 2e-4
BFP8_TOL = 2e-2
RING = ["cpu"] * S


def _ring_plan(g, *, bfp8: bool = True) -> ExecutionPlan:
    """The reference test's plan: stages by thirds of the topological order,
    every edge deeper than 4096 words evicted (BFP8, or raw words)."""
    return hand_cut_plan(g, S, evict_codec="bfp8" if bfp8 else "none",
                         device="t")


def _stream(seed: int = 1) -> torch.Tensor:
    xs = np.random.default_rng(seed).normal(size=(B, 64, 32))
    return torch.from_numpy(xs.astype(np.float32))


@pytest.fixture(scope="module")
def unet():
    g = tbuilders.build_unet_exec()
    return g, _ring_plan(g)


# =============================================================================
# the reference's test_ring_pipeline_matches_sequential, ported
# =============================================================================

@pytest.mark.parametrize("kernel_mode", ["reference", "auto"])
def test_ring_pipeline_matches_sequential(unet, kernel_mode):
    g, plan = unet
    xs = _stream()
    sx = lower_plan_pipelined(g, plan, microbatches=B,
                              kernel_mode=kernel_mode, placement="shard_map",
                              devices=RING)
    assert sx.placement == "shard_map"
    assert sx.devices == [torch.device("cpu")] * S
    assert sx.streams is None               # no stage streams on the CPU
    low = lower_plan(g, plan, kernel_mode=kernel_mode, device="cpu")
    want = torch.stack([low(xs[b]) for b in range(B)])
    got = sx(xs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # only when a stage runs changes, never what it computes
    il = lower_plan_pipelined(g, plan, microbatches=B,
                              kernel_mode=kernel_mode,
                              placement="interleave", device="cpu")
    assert il.placement == "interleave"
    assert torch.equal(got, il(xs))
    assert got.device == sx.out_device


@pytest.fixture(scope="module")
def reference_ring(unet, tmp_path_factory):
    """The reference's own ring on 4 host devices over the BFP8 plan and a
    lossless one: its weights and outputs, and the stream, from a
    subprocess."""
    g, plan = unet
    out = tmp_path_factory.mktemp("reference_ring")
    np.save(out / "xs.npy", _stream().numpy())
    (out / "bfp8.plan.json").write_text(plan.to_json())
    lossless = _ring_plan(tbuilders.build_unet_exec(), bfp8=False)
    (out / "lossless.plan.json").write_text(lossless.to_json())
    code = textwrap.dedent(f"""
        import pathlib, sys
        import numpy as np, jax, jax.numpy as jnp
        from repro.core import build_unet_exec
        from repro.core.plan import ExecutionPlan
        from repro.runtime.streamer import lower_plan_pipelined
        out = pathlib.Path(sys.argv[1])
        assert len(jax.devices()) >= {S}, jax.devices()
        g = build_unet_exec()
        xs = jnp.asarray(np.load(out / "xs.npy"))
        for tag in ("bfp8", "lossless"):
            plan = ExecutionPlan.from_json(
                (out / (tag + ".plan.json")).read_text())
            sx = lower_plan_pipelined(g, plan, microbatches={B},
                                      kernel_mode="reference")
            assert sx.placement == "shard_map", sx.placement
            assert sx.report.placement == "shard_map"
            np.savez(out / (tag + ".params.npz"),
                     **{{k: np.asarray(v) for k, v in sx.params.items()}})
            np.save(out / (tag + ".ys.npy"), np.asarray(sx(xs)))
        print("OK")
    """)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-c", code, str(out)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "OK" in run.stdout
    return out, {"bfp8": plan, "lossless": lossless}


@pytest.mark.parametrize("kernel_mode", ["reference", "auto"])
@pytest.mark.parametrize("tag", ["bfp8", "lossless"])
def test_ring_matches_the_reference_ring(unet, reference_ring, tag,
                                         kernel_mode):
    g, _ = unet
    out, plans = reference_ring
    sx = lower_plan_pipelined(g, plans[tag], microbatches=B,
                              kernel_mode=kernel_mode, placement="shard_map",
                              devices=RING)
    with np.load(out / f"{tag}.params.npz") as arrays:
        sx.params = params_from_numpy(dict(arrays), device=sx.vertex_devices)
    want = np.load(out / f"{tag}.ys.npy")
    got = sx(torch.from_numpy(np.load(out / "xs.npy"))).numpy()
    assert got.shape == want.shape == (B, 2048)
    if tag == "bfp8":
        # the port's codec is exact and the reference's is not
        tol = BFP8_TOL * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        np.testing.assert_allclose(got, want, rtol=LOSSLESS_TOL,
                                   atol=LOSSLESS_TOL)


# =============================================================================
# choosing the ring, refusing it, and its report
# =============================================================================

def test_auto_interleaves_on_the_cpu(unet):
    g, plan = unet
    sx = lower_plan_pipelined(g, plan, microbatches=B, device="cpu")
    assert sx.placement == sx.report.placement == "interleave"
    assert sx.devices == [torch.device("cpu")] * S
    # the reference chooses alike on its one host device
    if len(jax.devices()) < S:
        jg = jbuilders.build_unet_exec()
        jsx = jlower_plan_pipelined(jg, JPlan.from_json(plan.to_json()),
                                    microbatches=B, kernel_mode="reference")
        assert jsx.placement == "interleave"


@pytest.mark.parametrize("device,have", [("cpu", 1), ("cuda", None)])
def test_shard_map_refused_without_devices(unet, device, have):
    g, plan = unet
    if have is None:
        have = torch.cuda.device_count()
        if have >= S:
            pytest.skip("the host has a GPU a stage")
    with pytest.raises(ValueError, match="devices") as info:
        lower_plan_pipelined(g, plan, microbatches=B, placement="shard_map",
                             device=device)
    assert str(info.value) == (f"shard_map placement needs >= {S} devices, "
                               f"have {have}")


def test_shard_map_refusal_is_the_references(unet):
    if len(jax.devices()) >= S:
        pytest.skip("host has a device a stage")
    g, plan = unet
    with pytest.raises(ValueError) as jinfo:
        jlower_plan_pipelined(jbuilders.build_unet_exec(),
                              JPlan.from_json(plan.to_json()),
                              microbatches=B, kernel_mode="reference",
                              placement="shard_map")
    n = len(jax.devices())
    with pytest.raises(ValueError) as tinfo:
        lower_plan_pipelined(g, plan, microbatches=B, placement="shard_map",
                             devices=["cpu"] * n)
    assert str(tinfo.value) == str(jinfo.value)


@pytest.mark.parametrize("kw,match", [
    (dict(placement="shard_map", devices=["cpu"] * (S - 1)),
     f"needs >= {S} devices, have {S - 1}"),
    (dict(placement="shard_map", devices=["cpu", "cuda:0", "cpu"]),
     "all on CUDA devices or all on the CPU"),
    (dict(placement="shard_map", devices=["cuda:4096"] * S),
     "not among the host's"),
    (dict(placement="interleave", devices=RING), "devices= places"),
    (dict(placement="auto", devices=RING), "devices= places"),
    (dict(placement="shard_map", devices=RING, kernel_mode="cuda"),
     "needs a CUDA device"),
])
def test_ring_device_refusals(unet, kw, match):
    g, plan = unet
    with pytest.raises(ValueError, match=match):
        lower_plan_pipelined(g, plan, microbatches=B, device="cpu", **kw)


def test_one_stage_ring_runs_on_the_one_device():
    g = tbuilders.build_unet_exec()
    plan = hand_cut_plan(tbuilders.build_unet_exec(), 1, device="tiny")
    xs = _stream(2)
    sx = lower_plan_pipelined(g, plan, microbatches=B, device="cpu",
                              placement="shard_map")
    assert sx.placement == sx.report.placement == "shard_map"
    assert sx.devices == [torch.device("cpu")]
    il = lower_plan_pipelined(g, plan, microbatches=B, device="cpu",
                              placement="interleave")
    assert torch.equal(sx(xs), il(xs))


def test_ring_report_and_traced_refusal(unet):
    g, plan = unet
    sx = lower_plan_pipelined(g, plan, microbatches=B, placement="shard_map",
                              devices=RING)
    il = lower_plan_pipelined(g, plan, microbatches=B, device="cpu",
                              placement="interleave")
    assert sx.report.placement == "shard_map"
    summary, want = sx.report.summary(), il.report.summary()
    assert summary.pop("placement") == "shard_map"
    assert want.pop("placement") == "interleave"
    assert summary == want
    with pytest.raises(NotImplementedError,
                       match="traced execution requires 'interleave' "
                             "placement, this executor is 'shard_map'"):
        sx.run_traced(_stream())


def test_ring_weights_lie_on_their_stage_devices(unet):
    g, plan = unet
    sx = lower_plan_pipelined(g, plan, microbatches=B, placement="shard_map",
                              devices=RING)
    vd = sx.vertex_devices
    assert set(vd) == set(sx._stage_of)
    assert all(vd[v] == sx.devices[j] for v, j in sx._stage_of.items())
    want = init_params(g, seed=0, device="cpu")
    assert sx.params.keys() == want.keys()
    assert all(torch.equal(sx.params[k], want[k]) for k in want)
    again = init_params(g, seed=0, device=vd)
    assert all(torch.equal(again[k], want[k]) for k in want)


# =============================================================================
# timing hooks, the server and the artifact on a ring
# =============================================================================

def test_stage_latencies_and_fps_on_a_ring(unet):
    g, plan = unet
    sx = lower_plan_pipelined(g, plan, microbatches=B, placement="shard_map",
                              devices=RING)
    xs = _stream()
    lat = measured_stage_latencies(sx, xs[0], repeats=1, warmup=0)
    assert len(lat) == S and all(np.isfinite(t) and t > 0 for t in lat)
    fps = measure_pipelined_fps(sx, xs, repeats=1, warmup=0)
    assert np.isfinite(fps) and fps > 0


def test_server_over_a_ring(unet):
    g, plan = unet
    sx = lower_plan_pipelined(g, plan, microbatches=B, placement="shard_map",
                              devices=RING)
    il = lower_plan_pipelined(g, plan, microbatches=B, device="cpu",
                              placement="interleave")
    srv = GraphStreamServer(executor=sx, resident_limit=2)
    assert srv.device == srv.out_device == torch.device("cpu")
    xs = _stream(3)
    frames = list(xs) + list(xs[:2])          # one full stream, one padded
    tickets = [srv.submit(f) for f in frames]
    srv.flush()
    want = torch.cat([il(xs), il(torch.cat([xs[:2], xs.new_zeros(
        (B - 2,) + tuple(xs.shape[1:]))]))[:2]])
    for i, t in enumerate(tickets):
        assert torch.equal(srv.result(t), want[i])


def test_artifact_keeps_the_ring(tmp_path):
    g = tbuilders.build_unet_exec()
    plan = hand_cut_plan(tbuilders.build_unet_exec(), 1, device="tiny")
    c = repro_torch.compile(repro_torch.CompileSpec(
        model=g, strategy="manual-plan", plan=plan, mode="pipelined",
        microbatches=B, placement="shard_map", torch_device="cpu"))
    assert c.executor.placement == "shard_map"
    path = c.save(tmp_path / "ring.smof.json")
    again = repro_torch.Compiled.load(path, torch_device="cpu")
    assert again.spec.placement == "shard_map"
    assert again.executor.placement == "shard_map"
    xs = _stream(4)
    assert torch.equal(again.run(xs), c.run(xs))
