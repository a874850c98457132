"""The mixture-of-experts router's choices on two routes of one model.

The kernel route's attention (``flash_attention``) sums in another order
than the plain route's, so the hidden states that reach a router differ in
their last bits.  Where two router scores nearly tie, that may pick
another expert, or give a (token, k) pair another queue slot and so
another capacity drop: such a flip moves the layer's output by far more
than the f32 tolerance, and the residual streams of the two routes part
there.

:class:`RoutingTape` records every ``models.moe.gate`` call while it is
installed; :func:`hold_routing` holds one forward's records on the kernel
route to the plain route's: the layers before the first that differs
choose alike and keep alike; in that layer every changed choice is a
near-tie on the plain route (the plain route's router logits of the two
experts within ``tol`` x max |router logit| of the token; or, ``measured``,
within twice the largest difference delta between the two routes' router
logits in that layer, delta itself within ``tol`` x max |plain router
logit| of the layer: a choice can swap two experts only where their gap
is at most the two logits' moves together), and a changed
capacity verdict (``keep``) comes at or after the first changed choice of
its group in the (T * k) priority order, since queue slots follow from the
choices.  Past that layer the two routes no longer compute on like inputs,
and nothing more is compared.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import moe as M
from ..models.moe import Routing


class RoutingTape:
    """Records every :func:`repro_torch.models.moe.gate` call while
    installed (a context manager; ``take`` hands the records over and
    starts a new list)."""

    def __init__(self) -> None:
        self.calls: list[Routing] = []
        self._gate = None

    def __enter__(self) -> "RoutingTape":
        self._gate = gate = M.gate

        def recording(*args):
            r = gate(*args)
            self.calls.append(r)
            return r
        M.gate = recording
        return self

    def __exit__(self, *exc) -> None:
        M.gate = self._gate

    def take(self) -> list[Routing]:
        out, self.calls = self.calls, []
        return out


@dataclasses.dataclass(frozen=True)
class Flip:
    """One changed choice: rank ``rank`` of token ``token`` in group
    ``group`` of MoE layer ``layer`` took expert ``kernel`` on the kernel
    route and ``plain`` on the plain route; ``gap`` is the plain route's
    |logit(plain) - logit(kernel)|, held below ``limit``."""
    layer: int
    group: int
    token: int
    rank: int
    plain: int
    kernel: int
    gap: float
    limit: float


@dataclasses.dataclass(frozen=True)
class RoutingHold:
    """``parted``: the first MoE layer whose routing differs (None where
    every layer routes alike); its ``flips``, the count of changed
    capacity verdicts there and, when measured, the largest difference
    ``delta`` between the two routes' router logits in it."""
    parted: int | None
    flips: tuple[Flip, ...] = ()
    keep_changes: int = 0
    delta: float | None = None


def hold_routing(kernel: list[Routing], plain: list[Routing],
                 tol: float, measured: bool = False) -> RoutingHold:
    """Hold one forward's MoE layers on the kernel route to the plain
    route's (the rule of the module docstring; ``measured`` takes the
    near-tie limit from the two routes' router logits).  Raises
    AssertionError naming the layer, group and token of a flip past it."""
    if len(kernel) != len(plain):
        raise AssertionError(f"{len(kernel)} MoE layers on the kernel "
                             f"route, {len(plain)} on the plain route")
    for layer, (k, p) in enumerate(zip(kernel, plain)):
        ki, pi = k.gate_idx.cpu(), p.gate_idx.cpu()
        kk, pk = k.keep.cpu(), p.keep.cpu()
        if torch.equal(ki, pi) and torch.equal(kk, pk):
            continue
        logits = p.logits.float().cpu()
        delta = None
        if measured:
            delta = float((k.logits.float().cpu() - logits).abs().max())
            top = float(logits.abs().max())
            if not delta <= tol * top:
                raise AssertionError(
                    f"MoE layer {layer}: the routes' router logits "
                    f"{delta:.3e} apart, past {tol} x max|plain| "
                    f"({tol * top:.3e})")
        flips = []
        for g, t, j in (ki != pi).nonzero().tolist():
            row = logits[g, t]
            a, b = int(pi[g, t, j]), int(ki[g, t, j])
            gap = float((row[a] - row[b]).abs())
            lim = 2 * delta if measured else tol * float(row.abs().max())
            flips.append(Flip(layer, g, t, j, a, b, gap, lim))
            if not (gap <= lim if measured else gap < lim):
                raise AssertionError(
                    f"MoE layer {layer}, group {g}, token {t}: rank {j} "
                    f"took expert {b} on the kernel route, {a} on the plain "
                    f"route, whose logits there are {gap:.3e} apart (a "
                    f"near-tie is below {lim:.3e})")
        G, T, K = pi.shape
        chosen = (ki != pi).reshape(G, T * K)
        kept = (kk != pk).reshape(G, T * K)
        for g in range(G):
            changed = kept[g].nonzero()
            if not changed.numel():
                continue
            first = chosen[g].nonzero()
            at = int(changed.min())
            if not first.numel() or at < int(first.min()):
                raise AssertionError(
                    f"MoE layer {layer}, group {g}: the capacity verdict of "
                    f"pair {at} (token {at // K}, rank {at % K}) changed "
                    f"before any choice changed")
        return RoutingHold(layer, tuple(flips), int(kept.sum()), delta)
    return RoutingHold(None)
