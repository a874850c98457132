"""LM architectures as SMOF graphs — the paper's DSE driving the GPU runtime.

Each transformer/SSM layer becomes a vertex chain (qkv -> attn -> o -> ffn /
router -> experts), KV caches and long-lived streams become edges with deep
buffers, and the device is H100_RUNTIME (on-chip = HBM, off-chip = host
memory over the host link).  The DSE's outputs map onto runtime knobs via
core.plan:

  subgraph partition  -> StagedExecutor stages
  fragmentation m     -> host weight streaming fraction / streamed_matmul
                         static fraction
  eviction flags      -> KV / boundary-stream host offload (+BFP8 codec)

Word units: one "word" = one bf16 element; one cycle = 1/f at the device's
clock.  The port's copy of the reference package's ``core/lm_graph.py``,
changed only in its imports and this docstring.
"""
from __future__ import annotations

from ..models.config import ArchConfig

from .graph import Graph, Vertex


def _tokens(batch: int, seq: int) -> int:
    return batch * seq


def build_lm_graph(cfg: ArchConfig, *, batch: int, seq: int,
                   kind: str = "prefill") -> Graph:
    """Layer-level SMOF graph for one (arch x shape) workload.

    ``kind``: prefill | decode.  Decode models one token against a cache of
    ``seq`` (the cache is the deep "buffer" an eviction can spill).
    """
    g = Graph(f"{cfg.name}:{kind}")
    d, hd = cfg.d_model, cfg.hd
    toks = _tokens(batch, seq if kind == "prefill" else 1)
    cache_words = batch * seq * cfg.n_kv_heads * hd * 2

    inp = g.add(Vertex("input", "input", in_words=toks * d,
                       out_words=toks * d, word_bits=16))
    emb = g.add(Vertex("embed", "embed", work_macs=0,
                       weight_words=cfg.vocab * d, weight_bits=16,
                       in_words=toks, out_words=toks * d,
                       base_depth=2, max_par=4096))
    g.connect("input", "embed", words=toks)
    prev = emb.name

    for i in range(cfg.n_layers):
        kind_i = cfg.layer_kind(i)
        lid = f"L{i}"
        if kind_i == "attn":
            qkv_w = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
            qkv = g.add(Vertex(f"{lid}.qkv", "matmul",
                               work_macs=toks * qkv_w, weight_words=qkv_w,
                               weight_bits=16, in_words=toks * d,
                               out_words=toks * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd,
                               base_depth=d, max_par=1 << 17))
            g.connect(prev, qkv.name)
            att_macs = (toks * seq * cfg.n_heads * hd * 2 if kind == "prefill"
                        else toks * seq * cfg.n_heads * hd * 2)
            att = g.add(Vertex(f"{lid}.attn", "attention",
                               work_macs=att_macs,
                               in_words=toks * cfg.n_heads * hd,
                               out_words=toks * cfg.n_heads * hd,
                               base_depth=seq, max_par=1 << 15))
            e = g.connect(qkv.name, att.name)
            # the KV cache is THE deep buffer of LM serving: its residency
            # is what eviction trades against host bandwidth
            e.buffer_depth = float(cache_words)
            o = g.add(Vertex(f"{lid}.o", "matmul",
                             work_macs=toks * cfg.n_heads * hd * d,
                             weight_words=cfg.n_heads * hd * d,
                             weight_bits=16,
                             in_words=toks * cfg.n_heads * hd,
                             out_words=toks * d, base_depth=d,
                             max_par=1 << 17))
            g.connect(att.name, o.name)
            prev = o.name
        else:   # mamba / mlstm / slstm: one fused mixer vertex
            mix_w = cfg._mixer_params(kind_i)
            mix = g.add(Vertex(f"{lid}.{kind_i}", "ssm_scan",
                               work_macs=toks * mix_w, weight_words=mix_w,
                               weight_bits=16, in_words=toks * d,
                               out_words=toks * d, base_depth=d,
                               max_par=1 << 16))
            g.connect(prev, mix.name)
            prev = mix.name

        if cfg.d_ff > 0:
            mult = 3 if cfg.act in ("swiglu", "geglu") else 2
            if cfg.layer_is_moe(i):
                m = cfg.moe
                rt = g.add(Vertex(f"{lid}.router", "router",
                                  work_macs=toks * d * m.n_experts,
                                  weight_words=d * m.n_experts,
                                  weight_bits=16, in_words=toks * d,
                                  out_words=toks * m.n_experts,
                                  base_depth=2, max_par=4096))
                g.connect(prev, rt.name)
                exp_w = m.n_experts * mult * d * cfg.d_ff
                ex = g.add(Vertex(f"{lid}.experts", "expert",
                                  work_macs=toks * m.top_k * mult * d * cfg.d_ff,
                                  weight_words=exp_w, weight_bits=16,
                                  in_words=toks * d, out_words=toks * d,
                                  base_depth=cfg.d_ff, max_par=1 << 18))
                g.connect(rt.name, ex.name)
                # router->experts is bursty: deep reorder buffer
                g.edge(rt.name, ex.name).buffer_depth = float(
                    toks * m.top_k)
                prev = ex.name
            else:
                ff = g.add(Vertex(f"{lid}.ffn", "matmul",
                                  work_macs=toks * mult * d * cfg.d_ff,
                                  weight_words=mult * d * cfg.d_ff,
                                  weight_bits=16, in_words=toks * d,
                                  out_words=toks * d, base_depth=cfg.d_ff,
                                  max_par=1 << 18))
                g.connect(prev, ff.name)
                prev = ff.name

    head = g.add(Vertex("lm_head", "matmul",
                        work_macs=toks * d * cfg.vocab,
                        weight_words=(0 if cfg.tie_embeddings
                                      else cfg.vocab * d),
                        weight_bits=16, in_words=toks * d,
                        out_words=toks * cfg.vocab, base_depth=d,
                        max_par=1 << 17))
    g.connect(prev, head.name)
    out = g.add(Vertex("output", "output", in_words=toks * cfg.vocab,
                       out_words=toks * cfg.vocab))
    g.connect(head.name, out.name)
    return g
