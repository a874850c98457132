"""The port's LM layer graphs (``core/lm_graph.py``) and Algorithm 1 on the
H100's runtime sheet, against the reference package on the CPU.

``build_lm_graph`` must give the reference's graph for every arch, vertex
for vertex and edge for edge; the DSE must give byte-identical plans on
``H100_RUNTIME`` (the reference's ``run_dse`` on a ``Device`` of the same
fields), and, as ``tests/test_lm_graph.py`` holds for the reference's
sheet, olmoe-1b-7b stays resident on one card while grok-1-314b needs
off-chip.  Both models are cut to 8 layers, as there.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.core import DSEConfig as JDSEConfig              # noqa: E402
from repro.core import Device as JDevice                    # noqa: E402
from repro.core import plan_from_dse as jplan_from_dse      # noqa: E402
from repro.core import run_dse as jrun_dse                  # noqa: E402
from repro.core.lm_graph import build_lm_graph as jbuild    # noqa: E402

from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.core import (ALL_DEVICES, DSEConfig, H100_KERNEL,  # noqa: E402
                              H100_RUNTIME, plan_from_dse, run_dse)
from repro_torch.core.lm_graph import build_lm_graph        # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _dump(g) -> str:
    return json.dumps(g.to_json_dict(), sort_keys=True)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_graph_equals_the_reference(name, kind):
    tg = build_lm_graph(ARCHS[name], batch=4, seq=2048, kind=kind)
    jg = jbuild(JARCHS[name], batch=4, seq=2048, kind=kind)
    assert tg.name == jg.name
    assert _dump(tg) == _dump(jg)
    assert ([(e.src, e.dst, e.buffer_depth) for e in tg.edges()]
            == [(e.src, e.dst, e.buffer_depth) for e in jg.edges()])


# each model's cut kind, as tests/test_lm_graph.py cuts grok-1
DSE_CASES = {"olmoe-1b-7b": "expert", "grok-1-314b": "expert"}


def _dse_cfg(pkg_cfg, cut: str):
    return pkg_cfg(batch=1, word_bits=16, frag_step=0.25, cut_kinds=(cut,),
                   max_iters=20)


@pytest.fixture(scope="module", params=sorted(DSE_CASES))
def dse(request):
    """(name, port result, port plan JSON, reference plan JSON) on the
    H100 runtime sheet, 8 layers, batch 1, seq 2048, prefill."""
    name = request.param
    cut = DSE_CASES[name]
    tcfg = dataclasses.replace(ARCHS[name], n_layers=8)
    jcfg = dataclasses.replace(JARCHS[name], n_layers=8)
    tg = build_lm_graph(tcfg, batch=1, seq=2048, kind="prefill")
    jg = jbuild(jcfg, batch=1, seq=2048, kind="prefill")
    tres = run_dse(tg, H100_RUNTIME, _dse_cfg(DSEConfig, cut))
    jdev = JDevice(**dataclasses.asdict(H100_RUNTIME))
    jres = jrun_dse(jg, jdev, _dse_cfg(JDSEConfig, cut))
    tplan = plan_from_dse(tcfg.name, H100_RUNTIME.name, tres)
    jplan = jplan_from_dse(jcfg.name, jdev.name, jres)
    return name, tres, tplan.to_json(), jplan.to_json()


def test_dse_plan_equals_the_reference(dse):
    _, _, tjson, jjson = dse
    assert tjson == jjson


def test_olmoe_stays_resident_and_grok_goes_off_chip(dse):
    name, res, _, _ = dse
    g = res.partitioning.graph
    fragged = any(v.frag_ratio > 0 for v in g.vertices())
    assert res.feasible
    if name == "olmoe-1b-7b":
        assert res.partitioning.n == 1 and not fragged
    else:
        assert res.partitioning.n > 1 or fragged


def test_h100_sheets():
    """The two views of one card: shared memory over HBM, HBM over the host
    link; both out of ``ALL_DEVICES`` (the FPGA sheets the CNN paths plan
    on)."""
    assert H100_KERNEL.onchip_bits == 132 * 228 * 1024 * 8
    assert H100_KERNEL.offchip_gbps == 3.35e12 * 8 / 1e9
    assert H100_RUNTIME.onchip_bits > 80e9 * 8 * 0.9
    assert H100_RUNTIME.offchip_gbps < H100_KERNEL.offchip_gbps
    for dev in (H100_KERNEL, H100_RUNTIME):
        assert dev.compute_units * 2 * dev.cycles_per_s == pytest.approx(
            67e12)
        assert dev.luts == 0.0
        assert dev.name not in ALL_DEVICES
    assert H100_KERNEL.freq_mhz == H100_RUNTIME.freq_mhz


def test_lm_graph_import_leaves_jax_and_repro_out():
    code = textwrap.dedent("""
        import sys
        import repro_torch.core.lm_graph
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
