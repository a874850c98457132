"""Graph builders for the paper's evaluated CNNs (Table III).

Structurally faithful reconstructions of UNet, UNet3D, YOLOv8n and X3D-M as
SMOF layer graphs — most importantly with the *long skip connections* whose
deep synchronisation buffers the eviction mechanism targets.  Channel
configurations follow the original papers; Table III's MAC/param counts are
matched by `benchmarks/table3_models.py` within a small tolerance (the paper
itself notes "optimised UNet architectures tailored to the HW design
(variations in MACs)").
"""
from __future__ import annotations

import math
from typing import Callable

from .graph import Graph, Vertex


class _B:
    """Small chain-building helper."""

    def __init__(self, g: Graph, word_bits: int = 8, weight_bits: int = 8):
        self.g = g
        self.wb = word_bits
        self.qb = weight_bits
        self.n = 0

    def _name(self, kind: str) -> str:
        self.n += 1
        return f"{kind}_{self.n}"

    def conv(self, prev: str | None, cin: int, cout: int, spatial: tuple[int, ...],
             k: int = 3, stride: int = 1, kind: str = "conv",
             groups: int = 1) -> tuple[str, tuple[int, ...]]:
        out_sp = tuple(max(s // stride, 1) for s in spatial)
        vol_out = math.prod(out_sp)
        kd = k ** len(spatial)
        macs = kd * (cin // groups) * cout * vol_out
        weights = kd * (cin // groups) * cout
        v = Vertex(self._name(kind), kind,
                   work_macs=macs, weight_words=weights,
                   in_words=cin * math.prod(spatial), out_words=cout * vol_out,
                   word_bits=self.wb, weight_bits=self.qb,
                   base_depth=k * out_sp[-1] * max(cin // groups, 1),
                   max_par=min(kd * cin * cout, 16384))
        self.g.add(v)
        if prev:
            self.g.connect(prev, v.name)
        return v.name, out_sp

    def simple(self, prev: str | list[str] | None, kind: str, cin: int,
               spatial: tuple[int, ...], cout: int | None = None,
               out_spatial: tuple[int, ...] | None = None,
               max_par: int = 64) -> tuple[str, tuple[int, ...]]:
        cout = cout or cin
        out_sp = out_spatial or spatial
        v = Vertex(self._name(kind), kind,
                   in_words=cin * math.prod(spatial),
                   out_words=cout * math.prod(out_sp),
                   word_bits=self.wb, base_depth=2.0, max_par=max_par)
        self.g.add(v)
        preds = [prev] if isinstance(prev, str) else (prev or [])
        for p in preds:
            self.g.connect(p, v.name)
        return v.name, out_sp


# -----------------------------------------------------------------------------
# UNet (Ronneberger et al.) — input (3, 368, 480); 4 skip connections
# -----------------------------------------------------------------------------

def build_unet(input_hw: tuple[int, int] = (368, 480), cin: int = 3,
               base: int = 64, levels: int = 5, n_classes: int = 32) -> Graph:
    g = Graph("unet")
    b = _B(g)
    inp, sp = b.simple(None, "input", cin, input_hw)
    skips: list[tuple[str, int, tuple[int, int]]] = []
    prev, c = inp, cin
    # encoder
    for lv in range(levels):
        cout = base * (2 ** lv)
        prev, sp = b.conv(prev, c, cout, sp)
        prev, sp = b.simple(prev, "act", cout, sp)
        prev, sp = b.conv(prev, cout, cout, sp)
        prev, sp = b.simple(prev, "act", cout, sp)
        c = cout
        if lv < levels - 1:
            skips.append((prev, c, sp))
            prev, sp = b.simple(prev, "pool", c, sp,
                                out_spatial=tuple(s // 2 for s in sp))
    # decoder with long skips
    for lv in reversed(range(levels - 1)):
        cout = base * (2 ** lv)
        prev, sp = b.conv(prev, c, cout, sp, k=2, kind="deconv")
        sp = tuple(s * 2 for s in sp)
        g.vertex(prev).out_words = cout * math.prod(sp)
        skip, sc, ssp = skips.pop()
        prev, sp = b.simple([skip, prev], "concat", cout + sc, sp)
        prev, sp = b.conv(prev, cout + sc, cout, sp)
        prev, sp = b.simple(prev, "act", cout, sp)
        prev, sp = b.conv(prev, cout, cout, sp)
        prev, sp = b.simple(prev, "act", cout, sp)
        c = cout
    prev, sp = b.conv(prev, c, n_classes, sp, k=1)
    b.simple(prev, "output", n_classes, sp)
    return g


# -----------------------------------------------------------------------------
# UNet3D (Cicek et al.) — input (4, 155, 240, 240)
# -----------------------------------------------------------------------------

def build_unet3d(input_dhw: tuple[int, int, int] = (155, 240, 240), cin: int = 4,
                 base: int = 10, levels: int = 5, max_ch: int = 160,
                 n_classes: int = 3) -> Graph:
    g = Graph("unet3d")
    b = _B(g)
    inp, sp = b.simple(None, "input", cin, input_dhw)
    skips: list[tuple[str, int, tuple[int, ...]]] = []
    prev, c = inp, cin
    for lv in range(levels):
        c1 = min(base * (2 ** lv), max_ch)
        c2 = min(c1 * 2, max_ch)
        prev, sp = b.conv(prev, c, c1, sp)
        prev, sp = b.simple(prev, "act", c1, sp)
        prev, sp = b.conv(prev, c1, c2, sp)
        prev, sp = b.simple(prev, "act", c2, sp)
        c = c2
        if lv < levels - 1:
            skips.append((prev, c, sp))
            prev, sp = b.simple(prev, "pool", c, sp,
                                out_spatial=tuple(max(s // 2, 1) for s in sp))
    for lv in reversed(range(levels - 1)):
        cout = min(base * (2 ** lv) * 2, max_ch)
        prev, sp = b.conv(prev, c, c, sp, k=2, kind="deconv")
        sp = tuple(s * 2 for s in sp)
        g.vertex(prev).out_words = c * math.prod(sp)
        skip, sc, ssp = skips.pop()
        sp = ssp
        prev, sp = b.simple([skip, prev], "concat", c + sc, sp)
        prev, sp = b.conv(prev, c + sc, cout, sp)
        prev, sp = b.simple(prev, "act", cout, sp)
        prev, sp = b.conv(prev, cout, cout, sp)
        prev, sp = b.simple(prev, "act", cout, sp)
        c = cout
    prev, sp = b.conv(prev, c, n_classes, sp, k=1)
    b.simple(prev, "output", n_classes, sp)
    return g


# -----------------------------------------------------------------------------
# YOLOv8n — input (3, 640, 640); CSP backbone + PAN neck (branchy)
# -----------------------------------------------------------------------------

def _c2f(b: _B, prev: str, c: int, sp, n: int = 1) -> tuple[str, tuple]:
    """C2f block: split, n bottlenecks with residual adds, concat, fuse."""
    half = max(c // 2, 8)
    top, _ = b.conv(prev, c, half, sp, k=1)
    bot, _ = b.conv(prev, c, half, sp, k=1)
    feats = [top, bot]
    cur = bot
    for _ in range(n):
        h1, _ = b.conv(cur, half, half, sp)
        h1, _ = b.simple(h1, "act", half, sp)
        h2, _ = b.conv(h1, half, half, sp)
        cur, _ = b.simple([cur, h2], "add", half, sp)
        feats.append(cur)
    cat, _ = b.simple(feats, "concat", half * len(feats), sp)
    out, sp = b.conv(cat, half * len(feats), c, sp, k=1)
    return out, sp


def build_yolov8n(input_hw: tuple[int, int] = (640, 640), cin: int = 3,
                  widths=(16, 32, 64, 128, 256), n_classes: int = 80) -> Graph:
    g = Graph("yolov8n")
    b = _B(g)
    inp, sp = b.simple(None, "input", cin, input_hw)
    prev, c = inp, cin
    pyramid: list[tuple[str, int, tuple]] = []
    for i, w in enumerate(widths):
        prev, sp = b.conv(prev, c, w, sp, stride=2)
        prev, sp = b.simple(prev, "act", w, sp)
        c = w
        if i >= 1:
            prev, sp = _c2f(b, prev, c, sp, n=2 if i in (2, 3) else 1)
        if i >= 2:
            pyramid.append((prev, c, sp))
    # SPPF: 1x1 squeeze, cascaded pools re-concatenated, 1x1 fuse
    p3, p4, p5 = pyramid
    sq, _ = b.conv(p5[0], p5[1], p5[1] // 2, p5[2], k=1)
    pools = [sq]
    cur = sq
    for _ in range(3):
        cur, _ = b.simple(cur, "pool", p5[1] // 2, p5[2])
        pools.append(cur)
    cat, _ = b.simple(pools, "concat", p5[1] * 2, p5[2])
    sppf, _ = b.conv(cat, p5[1] * 2, p5[1], p5[2], k=1)
    p5 = (sppf, p5[1], p5[2])
    # PAN neck: top-down then bottom-up with skip concats (long branches)
    up5, _ = b.simple(p5[0], "upsample", p5[1], p5[2],
                      out_spatial=tuple(s * 2 for s in p5[2]))
    cat4, _ = b.simple([p4[0], up5], "concat", p4[1] + p5[1], p4[2])
    n4, _ = _c2f(b, cat4, p4[1], p4[2])
    up4, _ = b.simple(n4, "upsample", p4[1], p4[2],
                      out_spatial=tuple(s * 2 for s in p4[2]))
    cat3, _ = b.simple([p3[0], up4], "concat", p3[1] + p4[1], p3[2])
    n3, _ = _c2f(b, cat3, p3[1], p3[2])
    d3, _ = b.conv(n3, p3[1], p3[1], p3[2], stride=2)
    cat4b, _ = b.simple([d3, n4], "concat", p3[1] + p4[1], p4[2])
    n4b, _ = _c2f(b, cat4b, p4[1], p4[2])
    d4, _ = b.conv(n4b, p4[1], p4[1], p4[2], stride=2)
    cat5, _ = b.simple([d4, p5[0]], "concat", p4[1] + p5[1], p5[2])
    n5, _ = _c2f(b, cat5, p5[1], p5[2])
    # decoupled detect head: box + cls branch per scale
    outs = []
    hw_box, hw_cls = 64, 64
    for hd, cch, hsp in ((n3, p3[1], p3[2]), (n4b, p4[1], p4[2]), (n5, p5[1], p5[2])):
        bx, _ = b.conv(hd, cch, hw_box, hsp)
        bx, _ = b.conv(bx, hw_box, hw_box, hsp)
        bx, _ = b.conv(bx, hw_box, 4 * 16, hsp, k=1)
        cl, _ = b.conv(hd, cch, hw_cls, hsp)
        cl, _ = b.conv(cl, hw_cls, n_classes, hsp, k=1)
        o, _ = b.simple([bx, cl], "concat", 64 + n_classes, hsp)
        outs.append(o)
    b.simple(outs, "output", 3 * (64 + n_classes), p3[2])
    return g


# -----------------------------------------------------------------------------
# X3D-M — input (3, 16, 256, 256); mobile inverted-bottleneck 3D stages
# -----------------------------------------------------------------------------

def build_x3d_m(frames: int = 16, hw: int = 256, cin: int = 3,
                stage_channels=(24, 48, 96, 192), stage_depths=(3, 5, 11, 7),
                expansion: float = 2.25, n_classes: int = 101) -> Graph:
    g = Graph("x3d_m")
    b = _B(g)
    sp = (frames, hw, hw)
    inp, sp = b.simple(None, "input", cin, sp)
    # stem: 1x3x3 spatial + 3x1x1 temporal (approximated as two convs)
    prev, sp = b.conv(inp, cin, 24, (sp[1], sp[2]), stride=2)
    sp = (frames, hw // 2, hw // 2)
    g.vertex(prev).out_words = 24 * math.prod(sp)
    c = 24
    for ci, (w, d) in enumerate(zip(stage_channels, stage_depths)):
        for blk in range(d):
            stride = 2 if blk == 0 else 1          # every stage downsamples
            mid = int(w * expansion)
            res = prev
            h, _ = b.conv(prev, c, mid, sp, k=1)
            h, _ = b.simple(h, "act", mid, sp)
            out_sp = (sp[0], max(sp[1] // stride, 1), max(sp[2] // stride, 1))
            h, _ = b.conv(h, mid, mid, sp, k=3, stride=1, kind="dwconv", groups=mid)
            g.vertex(h).out_words = mid * math.prod(out_sp)
            sp2 = out_sp
            h, _ = b.simple(h, "act", mid, sp2)
            if blk % 2 == 0:                       # SE on alternate blocks
                se1, _ = b.conv(h, mid, max(mid // 16, 4), (1, 1, 1), k=1)
                se2, _ = b.conv(se1, max(mid // 16, 4), mid, (1, 1, 1), k=1)
                h, _ = b.simple([h, se2], "add", mid, sp2)
            h, _ = b.conv(h, mid, w, sp2, k=1)
            if stride == 1 and c == w:
                prev, _ = b.simple([res, h], "add", w, sp2)
            else:
                prev = h
            sp, c = sp2, w
    prev, _ = b.conv(prev, c, int(c * expansion), sp, k=1)
    c = int(c * expansion)
    prev, _ = b.simple(prev, "pool", c, sp, out_spatial=(1, 1, 1))
    prev, _ = b.conv(prev, c, 2048, (1, 1, 1), k=1)
    prev, _ = b.conv(prev, 2048, n_classes, (1, 1, 1), k=1)
    b.simple(prev, "output", n_classes, (1, 1, 1))
    return g


# -----------------------------------------------------------------------------
# Executable graphs (runtime/executor.py targets)
#
# The builders above are *cost-model* reconstructions at paper scale; the
# ``*_exec`` builders below emit small graphs whose vertices additionally
# carry ``meta["exec"]`` — the channel spec the executable lowering needs.
# Tensors flow as (positions, channels) f32 stripes; conv acts as a 1x1
# channel-mixing matmul, pool/upsample halve/double the position axis, and
# the long encoder->decoder skips create exactly the deep synchronisation
# buffers the paper's eviction mechanism attacks (§III-A).
#
# Channels are kept multiples of the BFP8 block (32) so an evicted stream's
# spill traffic hits the compile-time c_bar = (8 + 8/32)/word_bits exactly.
# -----------------------------------------------------------------------------

class _XB(_B):
    """Chain builder that also records the executable channel spec."""

    def xconv(self, prev: str | None, cin: int, cout: int, m: int,
              kind: str = "conv") -> str:
        name, _ = self.conv(prev, cin, cout, (m,), k=1, kind=kind)
        self.g.vertex(name).meta["exec"] = {"cin": cin, "cout": cout, "m": m}
        return name

    def xsimple(self, prev, kind: str, c: int, m: int, cout: int | None = None,
                m_out: int | None = None) -> str:
        name, _ = self.simple(prev, kind, c, (m,), cout=cout,
                              out_spatial=(m_out,) if m_out else None)
        self.g.vertex(name).meta["exec"] = {
            "cin": c, "cout": cout or c, "m": m, "m_out": m_out or m}
        return name

    def xdwconv(self, prev: str, c: int, m: int, taps: int = 3) -> str:
        """Depthwise temporal conv: per-channel mixing of ``taps`` adjacent
        positions (the 3x1x1 temporal kernel of X3D's 3D blocks, with the
        frame axis flattened into the position axis)."""
        name, _ = self.conv(prev, c, c, (m,), k=taps, kind="dwconv",
                            groups=c)
        self.g.vertex(name).meta["exec"] = {"cin": c, "cout": c, "m": m,
                                            "taps": taps}
        return name


def build_unet_exec(positions: int = 64, cin: int = 32, base: int = 32,
                    levels: int = 3, n_classes: int = 32) -> Graph:
    """UNet-style encoder/decoder with long skip concats, executable form.

    ``positions`` is the flattened spatial extent at full resolution; each
    pool halves it, each decoder upsample doubles it back, and every
    encoder level's output rides a long skip to the matching decoder
    concat — the topology whose synchronisation buffers SMOF evicts.
    """
    assert positions % (2 ** (levels - 1)) == 0
    g = Graph("unet_exec")
    b = _XB(g, word_bits=16, weight_bits=16)
    m = positions
    prev = b.xsimple(None, "input", cin, m)
    skips: list[tuple[str, int, int]] = []
    c = cin
    for lv in range(levels):
        cout = base * (2 ** lv)
        prev = b.xconv(prev, c, cout, m)
        prev = b.xsimple(prev, "act", cout, m)
        c = cout
        if lv < levels - 1:
            skips.append((prev, c, m))
            prev = b.xsimple(prev, "pool", c, m, m_out=m // 2)
            m //= 2
    for lv in reversed(range(levels - 1)):
        cout = base * (2 ** lv)
        prev = b.xsimple(prev, "upsample", c, m, m_out=m * 2)
        m *= 2
        prev = b.xconv(prev, c, cout, m, kind="deconv")
        skip, sc, sm = skips.pop()
        assert sm == m, (sm, m)
        prev = b.xsimple([skip, prev], "concat", sc + cout, m)
        prev = b.xconv(prev, sc + cout, cout, m)
        prev = b.xsimple(prev, "act", cout, m)
        c = cout
    prev = b.xconv(prev, c, n_classes, m)
    b.xsimple(prev, "output", n_classes, m)
    return g


def build_yolo_head_exec(positions: int = 64,
                         widths: tuple[int, int, int] = (32, 64, 128),
                         head: int = 32) -> Graph:
    """YOLO-style multi-scale detection head, executable form.

    A small backbone emits a three-level pyramid (P3/P4/P5); the PAN-style
    neck runs top-down then bottom-up with cross-scale concats, so pyramid
    features persist across many downstream layers — long branches with
    deep buffers, like the UNet skips but re-converging at several scales.
    """
    assert positions % 4 == 0
    g = Graph("yolo_head_exec")
    b = _XB(g, word_bits=16, weight_bits=16)
    m = positions
    prev = b.xsimple(None, "input", widths[0], m)
    pyramid: list[tuple[str, int, int]] = []
    c = widths[0]
    for i, w in enumerate(widths):
        prev = b.xconv(prev, c, w, m)
        prev = b.xsimple(prev, "act", w, m)
        c = w
        pyramid.append((prev, c, m))
        if i < len(widths) - 1:
            prev = b.xsimple(prev, "pool", c, m, m_out=m // 2)
            m //= 2
    (p3, c3, m3), (p4, c4, m4), (p5, c5, m5) = pyramid
    # top-down
    up5 = b.xsimple(p5, "upsample", c5, m5, m_out=m4)
    cat4 = b.xsimple([p4, up5], "concat", c4 + c5, m4)
    n4 = b.xconv(cat4, c4 + c5, c4, m4)
    up4 = b.xsimple(n4, "upsample", c4, m4, m_out=m3)
    cat3 = b.xsimple([p3, up4], "concat", c3 + c4, m3)
    n3 = b.xconv(cat3, c3 + c4, c3, m3)
    # bottom-up
    d3 = b.xsimple(n3, "pool", c3, m3, m_out=m4)
    cat4b = b.xsimple([d3, n4], "concat", c3 + c4, m4)
    n4b = b.xconv(cat4b, c3 + c4, c4, m4)
    d4 = b.xsimple(n4b, "pool", c4, m4, m_out=m5)
    cat5 = b.xsimple([d4, p5], "concat", c4 + c5, m5)
    n5 = b.xconv(cat5, c4 + c5, c5, m5)
    # decoupled per-scale heads
    outs = []
    for hd, cch, hm in ((n3, c3, m3), (n4b, c4, m4), (n5, c5, m5)):
        h1 = b.xconv(hd, cch, head, hm)
        h1 = b.xsimple(h1, "act", head, hm)
        h2 = b.xconv(h1, head, head, hm)
        outs.append(h2)
    out = b.xsimple(outs, "output", head, m3)
    # the sink consumes all three scales, not just the m3 stripe
    g.vertex(out).in_words = head * (m3 + m4 + m5)
    return g


def build_x3d_exec(positions: int = 64, cin: int = 32,
                   widths: tuple[int, ...] = (32, 64), depth: int = 2,
                   expansion: int = 2, n_classes: int = 32) -> Graph:
    """X3D-style temporal residual network, executable form.

    The position axis is the flattened (frames, spatial) extent; each stage
    is a chain of mobile-inverted-bottleneck blocks — 1x1 expand, depthwise
    *temporal* conv (``dwconv`` mixes adjacent positions per channel),
    squeeze-excitation (global pool -> bottleneck -> broadcast ``mul``), 1x1
    project — with residual adds.  Two long-buffer topologies for eviction
    to attack: the SE side branches re-converge after the whole excitation
    chain, and the stem output rides a temporal-feature-bank skip across
    every stage to a final concat (the deepest synchronisation buffer, like
    UNet's encoder->decoder skips but over the time axis).

    Channels stay multiples of the BFP8 block (32) so evicted streams hit
    the compile-time ``c_bar`` exactly.
    """
    assert positions % (2 ** (len(widths) - 1)) == 0
    g = Graph("x3d_exec")
    b = _XB(g, word_bits=16, weight_bits=16)
    m = positions
    inp = b.xsimple(None, "input", cin, m)
    # stem: 1x1 channel mix + temporal dwconv
    prev = b.xconv(inp, cin, widths[0], m)
    prev = b.xdwconv(prev, widths[0], m)
    stem = prev = b.xsimple(prev, "act", widths[0], m)
    c = widths[0]
    for si, w in enumerate(widths):
        if si > 0:                               # downsample between stages
            prev = b.xsimple(prev, "pool", c, m, m_out=m // 2)
            m //= 2
        mid = w * expansion
        for blk in range(depth):
            res = prev
            h = b.xconv(prev, c, mid, m)
            h = b.xsimple(h, "act", mid, m)
            h = b.xdwconv(h, mid, m)
            if blk % 2 == 0:                     # SE on alternate blocks
                se = b.xsimple(h, "pool", mid, m, m_out=1)      # global pool
                se = b.xconv(se, mid, 32, 1)
                se = b.xsimple(se, "act", 32, 1)
                se = b.xconv(se, 32, mid, 1)
                h = b.xsimple([h, se], "mul", mid, m)           # broadcast
            h = b.xconv(h, mid, w, m)
            prev = b.xsimple([res, h], "add", w, m) if c == w else h
            c = w
    # temporal feature bank: the stem output skips every stage, pooled down
    # to the final temporal resolution, and fuses by concat
    bank = stem
    bm = positions
    while bm > m:
        bank = b.xsimple(bank, "pool", widths[0], bm, m_out=bm // 2)
        bm //= 2
    prev = b.xsimple([bank, prev], "concat", widths[0] + c, m)
    prev = b.xconv(prev, widths[0] + c, n_classes, m)
    b.xsimple(prev, "output", n_classes, m)
    return g


EXEC_MODELS = {
    "unet_exec": build_unet_exec,
    "yolo_head_exec": build_yolo_head_exec,
    "x3d_exec": build_x3d_exec,
}


PAPER_MODELS = {
    "unet": build_unet,
    "unet3d": build_unet3d,
    "yolov8n": build_yolov8n,
    "x3d_m": build_x3d_m,
}


def get_model(name: str, registry: dict | None = None) -> Callable[..., Graph]:
    """The one registry lookup: executable (``*_exec``) and paper-scale
    cost-model builders by name, with a helpful error.

    ``registry`` narrows the search to one family (``EXEC_MODELS`` /
    ``PAPER_MODELS``); by default both are searched, exec first.
    """
    spaces = [registry] if registry is not None else [EXEC_MODELS, PAPER_MODELS]
    for space in spaces:
        if name in space:
            return space[name]
    known = sorted(set().union(*spaces))
    raise KeyError(f"unknown model {name!r}; known models: {', '.join(known)}")


def exec_input_shape(g: Graph) -> tuple[int, int]:
    """The (positions, channels) input stripe shape of an executable graph."""
    for v in g.vertices():
        if v.kind == "input":
            spec = v.meta.get("exec")
            if spec is None:
                raise ValueError(
                    f"graph {g.name!r} has no executable input spec — use a "
                    f"build_*_exec builder (see EXEC_MODELS)")
            return (spec["m"], spec["cin"])
    raise ValueError(f"graph {g.name!r} has no input vertex")

# Table III reference values (MACs in G, params in M) for validation.
TABLE3 = {
    "yolov8n": {"macs_g": 4.37, "params_m": 3.16, "layers": 115, "convs": 63},
    "unet": {"macs_g": 130.12, "params_m": 28.96, "layers": 53, "convs": 23},
    "unet3d": {"macs_g": 918.64, "params_m": 5.65, "layers": 52, "convs": 19},
    "x3d_m": {"macs_g": 6.97, "params_m": 3.82, "layers": 396, "convs": 115},
}
