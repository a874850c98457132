"""The port's mixture of experts on the CPU against the reference package.

``models.moe`` (the router's choices, capacity drops, dispatch / combine,
the expert products), the LM forward and decode with MoE layers,
``ServingEngine`` and ``params_from_numpy`` on the reduced olmoe-1b-7b and
grok-1-314b, with the reference's weights carried into the port.  The
reduced configs set ``capacity_factor=4``, under which no pair is ever
dropped, so the cases that must drop ask for a smaller factor.  Inputs
come from seeded numpy generators and go to both packages.  Tolerance:
rtol = atol = 2e-4 unless a test says otherwise, the port's standing f32
tolerance (XLA's and PyTorch's CPU matmuls sum in different orders).
"""
import dataclasses
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

import repro.launch.serve as jserve_cli                     # noqa: E402
from repro.configs import ARCHS as JARCHS                   # noqa: E402
from repro.models import MoECfg as JMoECfg                  # noqa: E402
from repro.models import model as JM                        # noqa: E402
from repro.models import moe as JMoE                        # noqa: E402
from repro.obs.metrics import parse_metrics_text as jparse  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine   # noqa: E402

import repro_torch.launch.serve as tserve_cli               # noqa: E402
from repro_torch.configs import ARCHS                       # noqa: E402
from repro_torch.models import MoECfg, params_from_numpy    # noqa: E402
from repro_torch.models import model as TM                 # noqa: E402
from repro_torch.models import moe as TMoE                 # noqa: E402
from repro_torch.obs.metrics import parse_metrics_text     # noqa: E402
from repro_torch.serving import ServingEngine              # noqa: E402
from repro_torch.testing.routing import (RoutingTape,       # noqa: E402
                                         hold_routing)

TOL = 2e-4


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def configs(name: str, moe: dict | None = None, **fields):
    """(the port's, the reference's) reduced ``name``, its MoE fields and
    other fields replaced alike."""
    out = []
    for archs, moe_cls in ((ARCHS, MoECfg), (JARCHS, JMoECfg)):
        cfg = archs[name].reduced()
        if moe is not None:
            fields = dict(fields, moe=moe_cls(**(dataclasses.asdict(cfg.moe)
                                                 | moe)))
        out.append(dataclasses.replace(cfg, **fields))
    return tuple(out)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))




# =============================================================================
# route
# =============================================================================

def _tie_inputs():
    """Small integers over 8: every product and sum exact in f32 in any
    order, so both packages see the same logits.  Experts 1 and 2 have
    equal router columns: the lower index must win every tie."""
    rng = np.random.default_rng(7)
    x = rng.integers(-2, 3, (2, 16, 64)).astype(np.float32) / 8
    w = rng.integers(-2, 3, (64, 4)).astype(np.float32) / 8
    w[:, 2] = w[:, 1]
    return x, w


ROUTE_CASES = {
    # (config, x, router): no drops; drops (T = 4 tokens, 64 experts top 8,
    # capacity 1); exact ties
    "no-drops": (dict(name="olmoe-1b-7b"),
                 lambda: (_rand((2, 16, 64), 1), _rand((64, 4), 2, 0.5))),
    "drops": (dict(name="olmoe-1b-7b",
                   moe=dict(n_experts=64, top_k=8, capacity_factor=1.0)),
              lambda: (_rand((3, 4, 64), 3), _rand((64, 64), 4, 0.5))),
    "ties": (dict(name="olmoe-1b-7b"), _tie_inputs),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_matches_the_reference(case):
    kw, inputs = ROUTE_CASES[case]
    cfg, jcfg = configs(**kw)
    x, w = inputs()
    jd, jc, ja = JMoE.route(jnp.asarray(x), jnp.asarray(w), jcfg)
    td, tc, ta = TMoE.route(_t(x), _t(w), cfg)
    assert td.shape == jd.shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    close(tc, jc, 1e-6)
    close(ta, ja)
    r = TMoE.gate(_t(x), _t(w), cfg)
    if case == "drops":
        assert r.capacity == 1 and r.dropped > 0
    else:
        assert r.dropped == 0
    if case == "ties":
        idx = r.gate_idx.numpy()
        # where both tied experts are chosen, 1 ranks first; where one is,
        # it is 1
        for row in idx.reshape(-1, idx.shape[-1]).tolist():
            if 2 in row:
                assert 1 in row and row.index(1) < row.index(2)
        assert (idx == 1).sum() > (idx == 2).sum() > 0


def test_top_k_orders_ties_as_the_reference():
    p = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(p), 4)
    tv, ti = TMoE.top_k(_t(p), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2, 4, 3]]


@pytest.mark.parametrize("name,fields", [("olmoe-1b-7b", {}),
                                         ("grok-1-314b", {}),
                                         ("olmoe-1b-7b", {"act": "gelu"})],
                         ids=["swiglu", "geglu", "gelu"])
def test_apply_moe_matches_the_reference(name, fields):
    cfg, jcfg = configs(name, **fields)
    jp = JMoE.moe_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    assert set(tp) == ({"router", "w_up", "w_down"}
                       | ({"w_gate"} if cfg.act != "gelu" else set()))
    x = _rand((2, 12, cfg.d_model), 5)
    jy, ja = JMoE.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, ta = TMoE.apply_moe(tp, _t(x), cfg)
    close(ty, jy)
    close(ta, ja)


def test_moe_params_shapes_and_router_dtype():
    cfg, _ = configs("grok-1-314b")
    p = TMoE.moe_params(torch.Generator().manual_seed(0), cfg,
                        dtype=torch.float64, lead=(3,))
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (3, d, E), "w_up": (3, E, d, f), "w_gate": (3, E, d, f),
        "w_down": (3, E, f, d)}
    assert p["router"].dtype == torch.float32
    assert p["w_up"].dtype == torch.float64


# =============================================================================
# the near-tie rule between two routes
# =============================================================================

def _routing(rows, cf=4.0):
    """The router's decision on logits ``rows`` (one group of tokens, 4
    experts top 2): the identity router over x = the logits."""
    cfg, _ = configs("olmoe-1b-7b", moe=dict(capacity_factor=cf))
    x = torch.tensor([rows], dtype=torch.float32)
    return TMoE.gate(x, torch.eye(4), cfg)


def test_hold_routing_accepts_a_near_tie_flip():
    plain = _routing([[1.0, 0.5, 0.5 + 1e-6, 0.0], [0.0, 1.0, 0.2, 0.1]])
    kernel = _routing([[1.0, 0.5 + 1e-6, 0.5, 0.0], [0.0, 1.0, 0.2, 0.1]])
    assert plain.gate_idx[0, 0].tolist() == [0, 2]
    assert kernel.gate_idx[0, 0].tolist() == [0, 1]
    assert hold_routing([plain], [plain], TOL).parted is None
    # the layer after the one that parted is not compared
    other = _routing([[0.0, 0.0, 3.0, 9.0], [9.0, 0.0, 0.0, 3.0]])
    hold = hold_routing([kernel, other], [plain, plain], TOL)
    assert hold.parted == 0
    (flip,) = hold.flips
    assert (flip.token, flip.rank, flip.plain, flip.kernel) == (0, 1, 2, 1)
    assert flip.gap < flip.limit == pytest.approx(TOL)


def test_hold_routing_refuses_a_flip_past_a_near_tie():
    plain = _routing([[1.0, 0.5, 0.4, 0.0]])
    kernel = _routing([[1.0, 0.4, 0.5, 0.0]])
    with pytest.raises(AssertionError, match="token 0: rank 1"):
        hold_routing([kernel], [plain], TOL)
    with pytest.raises(AssertionError, match="MoE layers"):
        hold_routing([kernel], [plain, plain], TOL)


def test_hold_routing_measures_its_near_ties():
    """measured: a flip is a near-tie within twice the routes' largest
    router-logit difference, which is itself held within tol x max|plain|
    of the layer."""
    plain = _routing([[1.0, 0.5, 0.5 + 1e-6, 0.0], [0.0, 1.0, 0.2, 0.1]])
    kernel = _routing([[1.0, 0.5 + 1e-6, 0.5, 0.0], [0.0, 1.0, 0.2, 0.1]])
    hold = hold_routing([kernel], [plain], TOL, measured=True)
    (flip,) = hold.flips
    assert hold.delta == pytest.approx(1e-6, rel=0.1)
    assert flip.gap <= flip.limit == 2 * hold.delta
    # the same flip beside a router logit that moved past tol is refused
    moved = _routing([[1.0, 0.5 + 1e-6, 0.5, 0.0], [0.0, 1.0, 0.3, 0.1]])
    with pytest.raises(AssertionError, match="router logits"):
        hold_routing([moved], [plain], TOL, measured=True)


def test_hold_routing_orders_capacity_changes_after_choices():
    """Capacity 1 a expert (cf 1, 2 tokens): token 1's pair on expert 0
    drops.  A changed verdict with no earlier changed choice is refused;
    after a near-tie flip of token 0 it is the flip's consequence."""
    rows = [[1.0, 0.5, 0.5 + 1e-6, 0.0], [1.0, 0.0, 0.2, 0.3]]
    plain = _routing(rows, cf=1.0)
    assert plain.capacity == 1 and plain.dropped == 1
    forged = dataclasses.replace(plain, keep=~plain.keep)
    with pytest.raises(AssertionError, match="before any choice changed"):
        hold_routing([forged], [plain], TOL)
    flipped = _routing([[1.0, 0.5 + 1e-6, 0.5, 0.0], [1.0, 0.0, 0.2, 0.3]],
                       cf=1.0)
    late = dataclasses.replace(flipped, keep=flipped.keep.clone())
    late.keep[0, 1, 1] = ~late.keep[0, 1, 1]
    hold = hold_routing([late], [plain], TOL)
    assert hold.parted == 0 and hold.keep_changes == 1


# =============================================================================
# the model
# =============================================================================

MODEL_CASES = {
    "olmoe": dict(name="olmoe-1b-7b"),
    "grok": dict(name="grok-1-314b"),
    # decode drops: 6 rows, 4 experts top 2, capacity ceil(3.75) = 4
    "olmoe-cf1.25": dict(name="olmoe-1b-7b", moe=dict(capacity_factor=1.25)),
}


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def model(request):
    """(case, port cfg, reference cfg, reference params, numpy tree, the
    port's params)."""
    cfg, jcfg = configs(**MODEL_CASES[request.param])
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return (request.param, cfg, jcfg, jp, tree,
            params_from_numpy(tree, cfg, "cpu"))


def test_params_from_numpy_carries_every_moe_leaf(model):
    _, cfg, _, jp, tree, tp = model
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_leaves_with_path(jp)}
    tleaves = dict(TM._leaves(tp))
    assert set(tleaves) == set(jleaves) == set(TM.param_shapes(cfg))
    moe = {n for n in jleaves if "/moe/" in n}
    assert {n.rsplit("/", 1)[1] for n in moe} >= {"router", "w_up",
                                                  "w_down", "w_gate"}
    for name, a in jleaves.items():
        np.testing.assert_array_equal(tleaves[name].numpy(), a)
    assert TM.param_count(tp) == JM.param_count(jp)
    layer = dict(tree["groups"]["pos_0"])
    layer["moe"] = {k: v for k, v in layer["moe"].items() if k != "w_gate"}
    bad = dict(tree, groups={"pos_0": layer})
    with pytest.raises(ValueError, match="moe/w_gate"):
        params_from_numpy(bad, cfg, "cpu")


def test_forward_and_decode_match_the_reference(model):
    """A prefill of 6 prompts with the cache (hidden, every KV page, aux),
    then 6 decode steps of the 6 rows (logits and pages); the capacity-1.25
    case drops pairs at decode."""
    case, cfg, jcfg, jp, _, tp = model
    B, S, s_max = 6, 11, 24
    with RoutingTape() as tape:
        _forward_and_decode(cfg, jcfg, jp, tp, B, S, s_max)
    decode = tape.calls[cfg.n_layers:]
    assert len(decode) == 6 * cfg.n_layers
    assert (sum(r.dropped for r in decode) > 0) == (case == "olmoe-cf1.25")


def _forward_and_decode(cfg, jcfg, jp, tp, B, S, s_max):
    toks = np.random.default_rng(40).integers(0, cfg.vocab, (B, S))
    jx, jcache, jaux = JM.forward(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                  cache=JM.init_cache(jcfg, B, s_max,
                                                      dtype=jnp.float32))
    tx, tcache, taux = TM.forward(tp, cfg, _t(toks),
                                  cache=TM.init_cache(cfg, B, s_max,
                                                      device="cpu"))
    close(tx, jx)
    close(taux, jaux)
    assert float(taux) > 0
    for pj in jcache:
        for n in ("k", "v"):
            close(tcache[pj][n], jcache[pj][n])
    tok = np.asarray(JM.project_logits(jp, jcfg, jx[:, -1])).argmax(-1)[:, None]
    pos = np.full(B, S)
    for _ in range(6):
        jl, jcache = JM.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos, jnp.int32), jcache)
        tl, tcache = TM.decode_step(tp, cfg, _t(tok), _t(pos), tcache)
        close(tl, jl)
        tok = np.asarray(jl).argmax(-1)[:, None]
        pos = pos + 1
    for pj in jcache:
        for n in ("k", "v"):
            close(tcache[pj][n], jcache[pj][n])


def test_forward_without_cache_sums_aux_over_layers():
    """grok-1 reduced at two layers: aux is the sum of each MoE layer's."""
    cfg, jcfg = configs("grok-1-314b", n_layers=2)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(41).integers(0, cfg.vocab, (2, 8))
    jx, _, jaux = JM.forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    tx, tc, taux = TM.forward(tp, cfg, _t(toks))
    assert tc is None
    close(tx, jx)
    close(taux, jaux)


# =============================================================================
# the engine
# =============================================================================

ENGINE = dict(max_batch=4, s_max=48, evict_to_host=True, resident_limit=1)


def _requests(vocab):
    rng = np.random.default_rng(60)
    # five requests through four slots: the last steps run one or two live
    # rows beside idle ones (token 0 at position 0), which take part in the
    # routing and compete for capacity
    return [(rng.integers(0, vocab, n), m)
            for n, m in ((5, 6), (17, 4), (9, 9), (30, 3), (12, 7))]


def _counters(fams):
    return {(fam, key): val for fam, f in fams.items()
            if fam.endswith("_total") for key, val in f["samples"].items()}


def test_serving_engine_matches_the_reference():
    cfg, jcfg = configs("olmoe-1b-7b", moe=dict(capacity_factor=1.25))
    jp = JM.init_params(jax.random.PRNGKey(2), jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jeng = JEngine(jcfg, jp, **ENGINE)
    teng = ServingEngine(cfg, tp, device="cpu", **ENGINE)
    jreqs = [jeng.submit(p, max_new_tokens=m) for p, m in _requests(cfg.vocab)]
    treqs = [teng.submit(p, max_new_tokens=m) for p, m in _requests(cfg.vocab)]
    jeng.run_until_drained()
    idle = []
    with RoutingTape() as tape:
        for _ in range(100):
            live = teng.step()
            if live == 0 and teng.queue.empty():
                break
            idle.append(ENGINE["max_batch"] - live)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done for r in treqs)
    assert _counters(parse_metrics_text(teng.metrics_text())) == _counters(
        jparse(jeng.metrics_text()))
    # idle rows at the tail, and decode steps that dropped pairs
    assert max(idle) >= 2
    decode = [r for r in tape.calls if r.gate_idx.shape[1] == 4]
    assert len(decode) == teng.stats.decode_steps
    assert sum(r.dropped for r in decode) > 0
    assert all(r.capacity == 3 for r in decode)


def test_a_prompt_off_the_dispatch_group_is_refused():
    """700 tokens do not split into groups of 512: both packages refuse."""
    cfg, jcfg = configs("olmoe-1b-7b")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompt = np.random.default_rng(70).integers(0, cfg.vocab, 700)
    kw = dict(max_batch=1, s_max=1024)
    jeng = JEngine(jcfg, jp, **kw)
    jeng.submit(prompt, max_new_tokens=2)
    with pytest.raises(AssertionError):
        jeng.step()
    teng = ServingEngine(cfg, tp, device="cpu", **kw)
    teng.submit(prompt, max_new_tokens=2)
    with pytest.raises(ValueError, match="groups of 512"):
        teng.step()


def _cli_numbers(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    main()
    out = capsys.readouterr().out.splitlines()
    name = out[0].split(":")[0]
    counts = re.findall(r"(prefills|decode_steps)=(\d+)", out[1])
    return name, counts, out[2]


def test_serve_cli_serves_olmoe_with_the_reference_counts(capsys,
                                                          monkeypatch):
    """``--arch olmoe-1b-7b`` (the reduced form, as ``--smoke``): the
    reference CLI's lines and counts."""
    want = _cli_numbers(jserve_cli.main, ["--arch", "olmoe-1b-7b"], capsys,
                        monkeypatch)
    got = _cli_numbers(tserve_cli.main, ["--arch", "olmoe-1b-7b", "--smoke",
                                         "--device", "cpu"], capsys,
                       monkeypatch)
    assert got == want
    assert want[0] == "olmoe-1b-7b-smoke"
    assert want[1] == [("prefills", "8"), ("decode_steps", "30")]
