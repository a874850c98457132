"""The two checks that hold the kernel route to reference mode on the card
(``repro_torch.testing.oracle``), exercised on the CPU.

* ``vertex_parity`` holds every vertex of a kernel-route executor to its
  plain version on the kernel route's own inputs.  On the CPU the kernel
  route runs the kernels' plain versions, so it reads exactly 0.0 on the
  DSE plans of the registry's executable models and on the hand-cut
  3-stage YOLO plan, whose BFP8 edges are chained; a fault planted in one
  call of a kernel wrapper is caught at that vertex and at no other.
* ``frame_bound`` is ``KERNEL_PARITY_TOL`` x max|ref| where reference
  mode's own change under a one-ulp move of its input (S) is smaller, and
  2 S where it is larger; ``stream_bounds`` gives each microbatch the bound
  ``frame_bound`` gives it alone.
* ``hold_to_reference`` applies both to one frame: it passes the kernel
  route on the CPU, and fails a frame whose output is off its bound, not
  finite or of another shape, and a vertex off in the values it is given.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch                                          # noqa: E402
from repro_torch.core import build_yolo_head_exec, hand_cut_plan  # noqa: E402
from repro_torch.kernels import streaming_conv as SC        # noqa: E402
from repro_torch.runtime.executor import WEIGHT_KINDS       # noqa: E402
from repro_torch.testing import oracle                      # noqa: E402


def _pair(model, plan=None):
    """(kernel route, reference mode) of one plan on the CPU, sharing
    weights: the DSE plan of ``model`` on the u200 sheet, or ``plan``."""
    spec = dict(device="u200", torch_device="cpu")
    if plan is None:
        main = repro_torch.compile(repro_torch.CompileSpec(model=model,
                                                           **spec))
    else:
        main = repro_torch.compile(repro_torch.CompileSpec(
            model=model, strategy="manual-plan", plan=plan, **spec))
    ref = repro_torch.compile(repro_torch.CompileSpec(
        model=main.graph, strategy="manual-plan", plan=main.plan,
        kernel_mode="reference", **spec))
    ref.executor.params = main.executor.params
    return main, ref


def _frame(main, seed=0):
    return torch.randn(main.input_shape(),
                       generator=torch.Generator().manual_seed(seed))


def _downstream(g, name):
    seen, todo = set(), [name]
    while todo:
        for s in g.successors(todo.pop()):
            if s not in seen:
                seen.add(s)
                todo.append(s)
    return seen | {name}


def _three_stage():
    g = build_yolo_head_exec()
    return g, hand_cut_plan(g)


@pytest.mark.parametrize("model", ["unet_exec", "x3d_exec", "yolo_head_exec",
                                   "yolo-3stage"])
def test_vertex_parity_reads_zero_on_the_cpu(model):
    if model == "yolo-3stage":
        g, plan = _three_stage()
        main, ref = _pair(g, plan)
        bfp8 = main.executor.analysis.bfp8_edges
        # chained: a path of the graph crosses two BFP8 edges
        assert any(s2 in _downstream(g, d) for (_, d) in bfp8
                   for (s2, _) in bfp8)
    else:
        main, ref = _pair(model)
    for seed in (0, 1):
        worst, _ = oracle.vertex_parity(main.executor, ref.executor,
                                        _frame(main, seed))
        assert worst == 0.0


@pytest.mark.parametrize("model,call", [("x3d_exec", 1), ("x3d_exec", 5),
                                        ("yolo-3stage", 2)])
def test_vertex_parity_names_the_vertex_of_a_faulty_launch(monkeypatch,
                                                           model, call):
    """``SC.conv2d`` adds 1e-3 x max|y| to its output on its ``call``-th
    call of a frame (y alone where the call also encodes, so the payload
    stays the codec's of the true y): vertex_parity fails at the vertex
    that call computed, the ``call``-th un-fragmented weight vertex in
    topological order, and teacher-forcing keeps every later vertex
    clean."""
    if model == "yolo-3stage":
        main, ref = _pair(*_three_stage())
    else:
        main, ref = _pair(model)
    an, g = main.executor.analysis, main.graph
    convs = [n for n in an.topo if g.vertex(n).kind in WEIGHT_KINDS
             and an.frac.get(n, 1.0) == 1.0]
    x = _frame(main)
    assert oracle.vertex_parity(main.executor, ref.executor, x)[0] == 0.0
    real, seen = SC.conv2d, []

    def faulty(*a, **kw):
        out = real(*a, **kw)
        seen.append(1)
        if len(seen) != call + 1:
            return out
        y, pay = out if isinstance(out, tuple) else (out, None)
        y = y + 1e-3 * max(1.0, float(y.abs().max()))
        return y if pay is None else (y, pay)
    monkeypatch.setattr(SC, "conv2d", faulty)
    with pytest.raises(oracle.OracleViolation) as exc:
        oracle.vertex_parity(main.executor, ref.executor, x)
    assert exc.value.oracle == "vertex_parity"
    assert f"vertex {convs[call]!r}" in str(exc.value)


def test_vertex_parity_refuses_executors_of_other_routes_or_plans():
    main, ref = _pair("unet_exec")
    x = _frame(main)
    with pytest.raises(ValueError):
        oracle.vertex_parity(ref.executor, main.executor, x)
    other, other_ref = _pair(*_three_stage())
    with pytest.raises(ValueError):
        oracle.vertex_parity(main.executor, other_ref.executor, x)


class _Stub:
    """A reference executor whose output moves by ``step`` wherever its
    input moved at all."""

    def __init__(self, step: float):
        self.step = step
        self.x = None

    def __call__(self, x):
        y = x.sum(dim=-1)
        if self.x is not None and not torch.equal(x, self.x):
            y = y + self.step
        return y


@pytest.mark.parametrize("step,binds", [(0.0, "tol"), (1e-6, "tol"),
                                        (5.0, "2S"), (0.5, "2S")])
def test_frame_bound_is_the_larger_of_the_tolerance_and_twice_s(step, binds):
    x = torch.ones(4, 8)
    ref = _Stub(step)
    ref.x = x
    y_ref = ref(x)                          # 8.0 in every element
    bound, s = oracle.frame_bound(ref, x, y_ref)
    assert s == pytest.approx(step, abs=1e-6)
    tol = oracle.KERNEL_PARITY_TOL * 8.0
    want = tol if binds == "tol" else 2.0 * s
    assert bound == pytest.approx(want)
    assert bound == pytest.approx(max(tol, 2.0 * s))


def test_frame_bound_moves_every_input_one_ulp_up():
    seen = {}

    def ref(x):
        seen["x"] = x
        return x.reshape(-1)
    x = torch.tensor([[0.0, -1.0], [1.0, 3.0e38]])
    oracle.frame_bound(ref, x, x.reshape(-1))
    assert torch.equal(seen["x"], torch.nextafter(x, torch.full_like(
        x, float("inf"))))
    assert bool((seen["x"] > x).all())


def test_stream_bounds_are_each_microbatch_frame_bound():
    """On the 3-stage YOLO plan in reference mode: the per-microbatch bounds
    of one stream pass equal each microbatch's frame_bound through the
    staged reference, S included."""
    g, plan = _three_stage()
    spec = dict(model=g, device="u200", strategy="manual-plan", plan=plan,
                kernel_mode="reference", torch_device="cpu")
    pipe = repro_torch.compile(repro_torch.CompileSpec(
        mode="pipelined", microbatches=3, **spec))
    staged = repro_torch.compile(repro_torch.CompileSpec(**spec))
    staged.executor.params = pipe.executor.params
    xs = torch.randn((3,) + pipe.input_shape(),
                     generator=torch.Generator().manual_seed(7))
    ys = pipe.run(xs)
    got = oracle.stream_bounds(pipe.run, xs, ys)
    for b in range(3):
        assert got[b] == oracle.frame_bound(staged.run, xs[b], ys[b])


def test_hold_to_reference_passes_the_kernel_route_on_the_cpu():
    main, ref = _pair(*_three_stage())
    x = _frame(main)
    y, y_ref = main.run(x), ref.run(x)
    h = oracle.hold_to_reference(main.executor, ref.executor, ref.run, x, y,
                                 y_ref)
    assert h.err == 0.0 and h.worst == 0.0
    assert h.tol == oracle.KERNEL_PARITY_TOL * float(y_ref.abs().max())
    assert h.bound == max(h.tol, 2.0 * h.s)


@pytest.mark.parametrize("fault", ["off_bound", "nan", "shape"])
def test_hold_to_reference_fails_an_output_off_its_bound(fault):
    """With every vertex clean, the output alone fails: by 1.5 x the bound
    given (a stream's), a NaN, or another shape."""
    main, ref = _pair("yolo_head_exec")
    x = _frame(main)
    y_ref = ref.run(x)
    bound = (1e-3, 0.0)
    y = {"off_bound": lambda: y_ref + 1.5e-3,
         "nan": lambda: y_ref.clone().index_fill_(0, torch.tensor([0]),
                                                 float("nan")),
         "shape": lambda: y_ref[:-1]}[fault]()
    with pytest.raises(oracle.OracleViolation) as exc:
        oracle.hold_to_reference(main.executor, ref.executor, ref.run, x, y,
                                 y_ref, bound=bound)
    assert exc.value.oracle == "frame_bound"
    oracle.hold_to_reference(main.executor, ref.executor, ref.run, x, y_ref,
                             y_ref, bound=bound)


def test_hold_to_reference_checks_the_values_it_is_given():
    """``values`` stands for the kernel route's run: a vertex moved in them
    fails vertex_parity at that vertex, before the output is looked at."""
    main, ref = _pair("x3d_exec")
    x = _frame(main)
    vals = main.executor.run_intermediates(x)
    name = main.executor.analysis.topo[3]
    vals[name] = vals[name] + 1e-3 * max(1.0, float(vals[name].abs().max()))
    y_ref = ref.run(x)
    with pytest.raises(oracle.OracleViolation) as exc:
        oracle.hold_to_reference(main.executor, ref.executor, ref.run, x,
                                 y_ref, y_ref, values=vals)
    assert exc.value.oracle == "vertex_parity"
    assert f"vertex {name!r}" in str(exc.value)
