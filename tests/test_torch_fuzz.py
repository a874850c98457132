"""The port's conformance fuzzer on the CPU, held against the reference
package's.

* the generator is the reference's: ``random_case(seed, index, cfg)``
  serialises byte for byte the same for seeds 0-1 x indices 0-39, under
  the default population and the conformance suite's ``SMALL`` one;
* the port's ``check_case`` passes on ``SMALL`` cases (every relation bit
  for bit on the CPU, ``kernel_parity`` included: there the kernel route
  runs the kernels' plain versions), and the driver runs clean;
* on the same cases the port's staged outputs are the reference's, with
  the reference's weights: within rtol = atol = 2e-4 on a lossless plan
  (f32 matmuls summed in another order) and 2e-2 x max|reference| with a
  BFP8 stream (one mantissa step of a block, as in
  ``tests/test_torch_codec.py``);
* each planted fault of ``oracle.FAULTS`` is caught on the case the
  reference's suite calibrated it on, and the reference's committed
  repros replay in the port as they do in the reference's suite;
* the act decode-alone launches that ``chip_smoke.py`` holds its fuzz phase
  to are the lowering's count over the same cases.
"""
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

import repro                                                # noqa: E402
from repro.testing import gen as jgen                       # noqa: E402

import repro_torch                                          # noqa: E402
from repro_torch.runtime.executor import (_lower_vertex,    # noqa: E402
                                          analyze_plan, params_from_numpy)
from repro_torch.testing import gen as tgen                 # noqa: E402
from repro_torch.testing import oracle                      # noqa: E402
from repro_torch.testing.fuzz import (main, replay,         # noqa: E402
                                      run_case)

ROOT = pathlib.Path(__file__).resolve().parent.parent
REPRO_FILES = sorted((ROOT / "tests" / "repros").glob("*.json"))
LOSSLESS_TOL = 2e-4
BFP8_TOL = 2e-2


def _small(mod):
    """The conformance suite's SMALL population (tests/test_conformance.py)
    in either package."""
    return mod.GenConfig(min_blocks=2, max_blocks=4, positions=(8, 16),
                         max_positions=32, channels=(8, 16, 32), max_stages=3,
                         max_microbatches=3)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("population", ["default", "small"])
def test_generator_is_the_reference_byte_for_byte(population, seed):
    jcfg = _small(jgen) if population == "small" else jgen.GenConfig()
    tcfg = _small(tgen) if population == "small" else tgen.GenConfig()
    for i in range(40):
        want = json.dumps(jgen.case_to_json_dict(
            jgen.random_case(seed, i, jcfg)))
        got = json.dumps(tgen.case_to_json_dict(
            tgen.random_case(seed, i, tcfg)))
        assert got == want, (seed, i)


SMALL_CASES = [(3, i) for i in range(6)]


@pytest.mark.parametrize("seed,index", SMALL_CASES)
def test_check_case_passes_on_the_cpu(seed, index):
    case = tgen.random_case(seed, index, _small(tgen))
    report = oracle.check_case(case, torch_device="cpu")
    assert {"lossless_exact", "staged_vs_pipelined", "traced_parity",
            "serve_vs_run", "artifact_roundtrip"} <= set(report.oracles)
    assert ("kernel_parity" in report.oracles) == (case.kernel_mode
                                                   == "pallas")


@pytest.mark.parametrize("seed,index", SMALL_CASES)
def test_staged_outputs_equal_reference(seed, index):
    """The port's staged executor on the case's kernel route, with the
    reference's weights, against the reference's staged executor on the
    same plan and frames."""
    jcase = jgen.random_case(seed, index, _small(jgen))
    tcase = tgen.random_case(seed, index, _small(tgen))
    jc = repro.compile(repro.CompileSpec(
        model=jcase.graph, device="u200", strategy="manual-plan",
        mode="staged", plan=jcase.plan, kernel_mode="reference",
        seed=jcase.seed))
    tc = repro_torch.compile(repro_torch.CompileSpec(
        model=tcase.graph, device="u200", strategy="manual-plan",
        mode="staged", plan=tcase.plan, seed=tcase.seed,
        kernel_mode=(repro_torch.api.kernel_route("cpu")
                     if tcase.kernel_mode == "pallas" else "reference"),
        torch_device="cpu"))
    tc.executor.params = params_from_numpy(
        {k: np.asarray(v) for k, v in jc.executor.params.items()})
    lossy = any(s.evicted and s.codec == "bfp8" for s in tcase.plan.streams)
    m, c = tcase.input_shape
    xs = np.random.default_rng(tcase.seed).normal(size=(2, m, c)).astype(
        np.float32)
    for x in xs:
        want = np.asarray(jc.run(jnp.asarray(x)))
        got = tc.run(x).numpy()
        assert got.shape == want.shape
        if lossy:
            assert np.abs(got - want).max() <= BFP8_TOL * np.abs(want).max()
        else:
            np.testing.assert_allclose(got, want, rtol=LOSSLESS_TOL,
                                       atol=LOSSLESS_TOL)


# (fault, population, seed, index, oracles that may catch it): the cases
# tests/test_conformance.py calibrated each fault on; default (0, 0) draws
# the kernel route, with fused egress encodes
FAULT_CASES = [
    ("skip-bfp8-decode", "default", 0, 0,
     ("staged_vs_pipelined", "bfp8_bounded")),
    ("undersize-queues", "small", 0, 9, ("modelcheck",)),
    ("oversubscribe-channel", "default", 0, 1,
     ("modelcheck", "channel_model")),
    ("skew-fused-quant", "default", 0, 0, ("kernel_parity",)),
]


@pytest.mark.parametrize("fault,population,seed,index,caught_by",
                         FAULT_CASES, ids=[f[0] for f in FAULT_CASES])
def test_planted_fault_is_caught(fault, population, seed, index, caught_by):
    assert set(oracle.FAULTS) == {f[0] for f in FAULT_CASES}
    cfg = _small(tgen) if population == "small" else tgen.GenConfig()
    case = tgen.random_case(seed, index, cfg)
    if fault == "skew-fused-quant":
        assert case.kernel_mode == "pallas"
    v = run_case(case, fault, torch_device="cpu")
    assert v is not None and v.oracle in caught_by, v
    if fault == "oversubscribe-channel":
        assert "capacity" in str(v)
    assert run_case(case, None, torch_device="cpu") is None


@pytest.mark.parametrize("path", REPRO_FILES, ids=lambda p: p.stem)
def test_reference_repros_replay_as_in_the_reference_suite(path):
    """A clean repro replays clean; a planted-fault repro, with its fault
    re-injected, keeps failing on its recorded oracle."""
    d = json.loads(path.read_text())
    if d.get("inject_fault"):
        with pytest.raises(oracle.OracleViolation) as exc:
            replay(path, torch_device="cpu")
        assert exc.value.oracle == d["oracle"]
    else:
        assert replay(path, torch_device="cpu").oracles


def test_fuzz_driver_runs_clean(tmp_path):
    rc = main(["--torch-device", "cpu", "--budget", "2", "--seed", "5",
               "--out", str(tmp_path), "--max-blocks", "4",
               "--max-stages", "3", "--max-microbatches", "3"])
    assert rc == 0
    assert list(tmp_path.glob("*.json")) == []


def test_planted_fault_is_shrunk_to_a_replayable_repro(tmp_path):
    rc = main(["--torch-device", "cpu", "--budget", "1", "--seed", "0",
               "--out", str(tmp_path), "--inject-fault", "skip-bfp8-decode",
               "--max-shrink-runs", "6"])
    assert rc == 1
    (path,) = tmp_path.glob("*.json")
    d = json.loads(path.read_text())
    assert d["kind"] == "smof-fuzz-repro" and d["version"] == 1
    assert d["inject_fault"] == "skip-bfp8-decode"
    assert d["shrunk"]["to_vertices"] <= d["shrunk"]["from_vertices"]
    with pytest.raises(oracle.OracleViolation) as exc:
        replay(path, torch_device="cpu")
    assert exc.value.oracle == d["oracle"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_act_decode_launches_are_the_lowering_count():
    """The fuzz phase of ``chip_smoke.py`` (seed 0, every case on the
    kernel route) launches ``act_relu_decode`` once per kernel-route frame
    for every act whose single in-edge is BFP8-evicted while none of its
    out-edges is: the staged ``kernel_parity`` run, B frames a case."""
    cs = _chip_smoke()
    cfg = tgen.GenConfig(p_pallas=cs.FUZZ_P_PALLAS)
    total = 0
    for i in range(cs.FUZZ_CASES):
        case = tgen.random_case(cs.FUZZ_SEED, i, cfg)
        assert case.kernel_mode == "pallas"
        an = analyze_plan(case.graph, case.plan, use_kernels=True)
        n = 0
        for v in case.graph.vertices():
            lv = _lower_vertex(case.graph, v.name, an)
            if v.kind == "act" and lv.fuse_in is not None and not lv.fuse_out:
                n += 1
        total += n * max(2, case.plan.microbatch)
    assert total > 0
    assert total == cs.FUZZ_ACT_DECODE_LAUNCHES
