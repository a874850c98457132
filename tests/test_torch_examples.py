"""The walkthroughs on the port (``examples/torch_*.py``) on the CPU, held
to the reference package's examples at the same arguments.

The reference's ``quickstart.py``, ``serve_batched.py`` (both paths) and
``train_small.py`` run in one subprocess started when the module starts,
beside the port's runs in this process.  Held:

* the quickstart's DSE block (the design point, the evicted edges, the
  fragmented layers, the ``ExecutionPlan`` line) and its off-chip channel
  block line for line; the provenance names the package that compiled
  the plan (``repro.api.compile`` / ``repro_torch.api.compile``), and
  only that differs;
* the LM serving counters the schedule fixes (prefills, decode steps,
  generated tokens, evicted pages) and the graph server's frames and
  channel block;
* ``train_small``'s restore step; each package's example asserts its own
  loss falls across the restart;
* ``long_context`` runs (the reference's on JAX is not run: it prints
  timings only).
"""
import contextlib
import importlib.util
import io
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAPH = ["--channel", "weighted-fair", "--channel-gbps", "0.5",
         "--onchip-kbits", "300"]
QUICKSTART = ["--model", "unet_exec", "--mode", "pipelined",
              "--execute"] + GRAPH
SERVE_LM = ["--arch", "yi-6b", "--requests", "4", "--max-new", "4"]
SERVE_GRAPH = ["--model", "unet_exec"] + GRAPH
TRAIN = ["--steps", "40", "--batch", "2", "--seq", "32"]

# (key, reference example, its arguments); the port's walkthrough takes the
# same arguments and its own device flag
RUNS = (("quickstart", "quickstart", QUICKSTART),
        ("serve_lm", "serve_batched", SERVE_LM),
        ("serve_graph", "serve_batched", SERVE_GRAPH),
        ("train", "train_small", TRAIN))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference examples' output by run key, from one subprocess
    started here and read when a test first asks for it."""
    ckpt = tmp_path_factory.mktemp("ref_ckpt")
    runs = [(k, ex, argv + (["--ckpt-dir", str(ckpt)] if k == "train"
                            else [])) for k, ex, argv in RUNS]
    code = textwrap.dedent(f"""
        import runpy, sys
        for key, ex, argv in {runs!r}:
            print("==== " + key, flush=True)
            sys.argv = [ex] + argv
            runpy.run_path("examples/" + ex + ".py", run_name="__main__")
    """)
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    out: dict = {}

    def get(key: str) -> str:
        if not out:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            for chunk in stdout.split("==== ")[1:]:
                name, _, text = chunk.partition("\n")
                out[name] = text
        return out[key]
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference):
    """Start the reference's subprocess before the first test."""


def run_walkthrough(name: str, argv: list[str]) -> str:
    """``examples/<name>.py``'s ``main(argv)`` in this process; its stdout."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return buf.getvalue()


def block(text: str, first: str, last: str) -> list[str]:
    """The lines from the one starting with ``first`` through the next one
    starting with ``last``."""
    lines = text.splitlines()
    i = next(n for n, ln in enumerate(lines) if ln.startswith(first))
    j = next(n for n, ln in enumerate(lines[i:], i) if ln.startswith(last))
    return lines[i:j + 1]


def line(text: str, start: str) -> str:
    return next(ln for ln in text.splitlines() if ln.startswith(start))


def test_long_context_runs_on_the_cpu():
    """On jamba, whose attention layers' caches must hold the prompt, the
    warm-up step and the 8 timed steps (the card runs xlstm)."""
    out = run_walkthrough("torch_long_context",
                          ["--arch", "jamba-v0.1-52b", "--device", "cpu"])
    assert [ln.split(":")[0] for ln in out.splitlines()
            if ln.startswith("  ctx=")] == [
        "  ctx=   64", "  ctx=  256", "  ctx= 1024"]
    assert "  stages=1 " in out


def test_quickstart_prints_the_references_design(reference):
    out = run_walkthrough("torch_quickstart",
                          QUICKSTART + ["--torch-device", "cpu"])
    want = reference("quickstart")
    ours = block(out, "DSE result on", "ExecutionPlan:")
    theirs = block(want, "DSE result on", "ExecutionPlan:")
    assert "repro.api.compile" in theirs[-1]
    theirs[-1] = theirs[-1].replace("repro.api.compile",
                                    "repro_torch.api.compile")
    assert ours == theirs
    assert any(ln.startswith("    evicted: ") for ln in ours)
    assert (block(out, "off-chip channel", "  contended Eq.6")
            == block(want, "off-chip channel", "  contended Eq.6"))
    assert line(out, "executed (pipelined)") == line(want,
                                                     "executed (pipelined)")


def test_serve_batched_counters_are_the_references(reference):
    out = run_walkthrough("torch_serve_batched",
                          SERVE_LM + ["--torch-device", "cpu"])
    want = reference("serve_lm")
    for start in ("serving ", "  prefills", "  decode steps"):
        assert line(out, start) == line(want, start)
    pages = line(out, "  evicted pages").split("(")[0]
    assert pages == line(want, "  evicted pages").split("(")[0]
    assert int(pages.split(":")[1]) > 0


def test_serve_batched_graph_path_is_the_references(reference):
    out = run_walkthrough("torch_serve_batched",
                          SERVE_GRAPH + ["--torch-device", "cpu"])
    want = reference("serve_graph")
    assert (line(out, "served ").split(" in ")[0]
            == line(want, "served ").split(" in ")[0])
    assert (block(out, "off-chip channel", "  contended Eq.6")
            == block(want, "off-chip channel", "  contended Eq.6"))


def test_train_small_restores_at_the_references_step(reference, tmp_path):
    out = run_walkthrough("torch_train_small",
                          TRAIN + ["--ckpt-dir", str(tmp_path),
                                   "--device", "cpu"])
    want = reference("train")
    assert line(out, "  restored at step") == line(want, "  restored at step")
    assert line(out, "  restored at step") == "  restored at step 20"
