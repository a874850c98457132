"""The PyTorch port's package boundary and its copy of the DSE.

* ``repro_torch`` imports neither ``jax`` nor the ``repro`` package, in a
  fresh interpreter and by a scan of every import statement;
* the port's copy of the graph/DSE core searches byte-for-byte the same
  ``ExecutionPlan`` as the reference package;
* the compile façade's knobs and the launch plan of the main path.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

import repro.api as japi                                    # noqa: E402
from repro.core import DSEConfig as JDSEConfig              # noqa: E402
from repro.core import builders as jbuilders                # noqa: E402
from repro.core.dse import run_dse as jrun_dse              # noqa: E402
from repro.core.plan import plan_from_dse as jplan_from_dse  # noqa: E402
from repro.core.resources import Device as JDevice          # noqa: E402
from repro.core.resources import get_device as jget_device  # noqa: E402

import repro_torch                                          # noqa: E402
import repro_torch.api as tapi                              # noqa: E402
from repro_torch.core import DSEConfig as TDSEConfig        # noqa: E402
from repro_torch.core import builders as tbuilders          # noqa: E402
from repro_torch.core.dse import run_dse as trun_dse        # noqa: E402
from repro_torch.core.plan import plan_from_dse as tplan_from_dse  # noqa: E402
from repro_torch.core.resources import Device as TDevice    # noqa: E402
from repro_torch.core.resources import get_device as tget_device  # noqa: E402
from repro_torch.runtime import executor as tex             # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

# the memory-starved device of benchmarks/e2e_executor.py (TINY_STREAM)
_TINY = dict(name="tiny_stream", compute_units=4096, onchip_bits=300_000,
             offchip_gbps=64.0, freq_mhz=500.0, reconfig_s=0.0)
PAPER_UNET = dict(positions=368 * 480, base=64, levels=5)


def _cfg(pkg_cfg, device_kind):
    if device_kind == "u200":
        return pkg_cfg(batch=1, codecs=("none", "bfp8"), word_bits=16,
                       cut_kinds=("pool", "conv"))
    return pkg_cfg(batch=1, codecs=("none", "bfp8"), word_bits=16,
                   cut_kinds=("output",))


def _plans(builder, kwargs, device_kind):
    """(reference plan JSON, port plan JSON, port plan, port graph)."""
    jdev = jget_device("u200") if device_kind == "u200" else JDevice(**_TINY)
    tdev = tget_device("u200") if device_kind == "u200" else TDevice(**_TINY)
    jg = getattr(jbuilders, builder)(**kwargs)
    tg = getattr(tbuilders, builder)(**kwargs)
    jp = jplan_from_dse(jg.name, jdev.name,
                        jrun_dse(jg, jdev, _cfg(JDSEConfig, device_kind)),
                        microbatch=8)
    tp = tplan_from_dse(tg.name, tdev.name,
                        trun_dse(tg, tdev, _cfg(TDSEConfig, device_kind)),
                        microbatch=8)
    return jp.to_json(), tp.to_json(), tp, tg


@pytest.fixture(scope="module")
def paper_unet_plans():
    return _plans("build_unet_exec", PAPER_UNET, "u200")


# =============================================================================
# package boundary
# =============================================================================

def test_import_leaves_jax_and_repro_out():
    """Every submodule of repro_torch imports in a fresh interpreter without
    pulling in jax or the reference package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        import repro_torch.api
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len(names), bad)
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20          # core, kernels, runtime, api


@pytest.mark.parametrize("module", ["repro_torch.runtime.streamer",
                                    "repro_torch.memory", "repro_torch.obs",
                                    "repro_torch.serving",
                                    "repro_torch.testing"])
def test_streamer_packages_leave_jax_and_repro_out(module):
    """The pipelined streamer, its copies of the reference's memory and obs
    layers (the metrics registry, SLO scoring and flight recorder among
    them), the serving front end and the conformance harness, each
    imported first in a fresh interpreter, with its submodules."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        mod = importlib.import_module({module!r})
        for m in pkgutil.walk_packages(mod.__path__, {module!r} + "."):
            importlib.import_module(m.name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_repro(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


# =============================================================================
# the port's DSE is the reference's
# =============================================================================

@pytest.mark.parametrize("builder", ["build_unet_exec",
                                     "build_yolo_head_exec"])
@pytest.mark.parametrize("device_kind", ["u200", "tiny"])
def test_plan_json_equals_reference(builder, device_kind):
    jjson, tjson, _, _ = _plans(builder, {}, device_kind)
    assert tjson == jjson


def test_paper_width_unet_plan_equals_reference(paper_unet_plans):
    jjson, tjson, plan, _ = paper_unet_plans
    assert tjson == jjson
    evicted = [(s.src, s.dst) for s in plan.streams if s.evicted]
    assert len(evicted) == 4 and plan.n_stages == 1
    assert all(s.codec == "bfp8" for s in plan.streams if s.evicted)
    assert all(lp.weight_static_fraction == 0.0
               for lp in plan.layers.values()
               if lp.name.startswith(("conv", "deconv")))


def test_facade_build_plan_equals_reference():
    """The façades stamp their own name into the provenance and nothing
    else differs."""
    jp, _ = japi.build_plan(japi.CompileSpec(model="unet_exec"))
    tp = tapi.build_plan(tapi.CompileSpec(model="unet_exec"))
    assert tp.provenance.pop("compiled_by") == "repro_torch.api.compile"
    assert jp.provenance.pop("compiled_by") == "repro.api.compile"
    assert tp.to_json() == jp.to_json()


def test_device_sheets_are_the_fpga_ones():
    from repro.core.resources import FPGA_DEVICES
    from repro_torch.core.resources import ALL_DEVICES
    assert set(ALL_DEVICES) == set(FPGA_DEVICES)
    for name, dev in FPGA_DEVICES.items():
        assert dataclasses.asdict(ALL_DEVICES[name]) == dataclasses.asdict(dev)


# =============================================================================
# the launch plan of the main path
# =============================================================================

def test_main_path_launches_four_kernels(paper_unet_plans):
    """The paper-width UNet on u200 runs, per frame, streamed_matmul 8x
    (K > 128), act_relu 9x (4 with the egress encode of a skip), pool 4x and
    bfp8_dequant 4x (one per skip concat) — and no other kernel."""
    _, _, plan, g = paper_unet_plans
    an = tex.analyze_plan(g, plan, use_kernels=True)
    counts = dict.fromkeys(("streamed_matmul", "plain_dot", "act_relu",
                            "act_relu_encode", "pool", "bfp8_dequant"), 0)
    for name in an.topo:
        v, lv = g.vertex(name), tex._lower_vertex(g, name, an)
        assert lv.fuse_in is None
        counts["bfp8_dequant"] += sum(
            (e.src, name) in an.bfp8_edges for e in g.in_edges(name))
        if v.kind in tex.WEIGHT_KINDS:
            assert an.frac[name] < 1.0            # never the conv2d kernel
            k = "streamed_matmul" if v.meta["exec"]["cin"] > 128 \
                else "plain_dot"
            counts[k] += 1
        elif v.kind == "act":
            counts["act_relu_encode" if lv.fuse_out else "act_relu"] += 1
        elif v.kind == "pool":
            assert v.meta["exec"]["m"] == 2 * v.meta["exec"]["m_out"]
            counts["pool"] += 1
        else:
            assert v.kind in ("input", "upsample", "concat", "output")
    assert counts == {"streamed_matmul": 8, "plain_dot": 6, "act_relu": 5,
                      "act_relu_encode": 4, "pool": 4, "bfp8_dequant": 4}


# =============================================================================
# façade knobs
# =============================================================================

@pytest.mark.parametrize("kw,err", [
    (dict(mode="pipelined", placement="shard_map"), NotImplementedError),
    (dict(strategy="autotune"), NotImplementedError),
    (dict(kernel_mode="pallas"), ValueError),
    (dict(mode="bogus"), ValueError),
    (dict(strategy="manual-plan"), ValueError),
    (dict(kernel_mode="cuda", torch_device="cpu"), ValueError),
    (dict(mode="pipelined", placement="ring"), ValueError),
])
def test_compile_spec_refuses(kw, err):
    with pytest.raises(err):
        repro_torch.compile(repro_torch.CompileSpec(model="unet_exec", **kw))


def test_reference_mode_report_on_cpu():
    c = repro_torch.compile(repro_torch.CompileSpec(
        model="unet_exec", mode="reference", torch_device="cpu"))
    rep = c.report()
    assert c.plan is None and rep["n_stages"] == 1
    assert rep["torch_device"] == "cpu"
    assert rep["traffic"]["n_spilled_edges"] == 0
