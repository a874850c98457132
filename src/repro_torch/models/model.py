"""Model assembly on PyTorch tensors: parameter init, the full-sequence
forward (serving prefill and training), the single-token decode and the
training loss — the counterparts of the reference package's
``models/model.py``.

Parameters keep the reference's pytree layout, stacked over *layer groups*
(one period of the layer pattern): ``{"embed", "groups": {"pos_j": {...}},
"final_norm", "lm_head"}`` with a leading group axis on every leaf under
``groups``, and for an encoder-decoder (whisper) each decoder layer's
``norm_x`` and ``cross`` attention and ``"encoder": {"groups",
"final_norm"}``, so a tree from the reference's ``init_params`` carries
over leaf for leaf (:func:`params_from_numpy`).  The cache keeps the
reference's layout too, ``{"pos_j": {...}}`` with a leading group axis on
every leaf: an attention position's ``{"k", "v"}`` of shape ``(n_groups,
B, s_max, KH, D)`` (and an encoder-decoder's cross ``{"xk", "xv"}`` of
``(n_groups, B, enc_frames, KH, D)``), a Mamba, mLSTM or sLSTM position's
recurrent state (``models/ssm.py``), so its pages compare 1:1.  The
reference scans over the groups; here a Python loop runs them in the same
order, each stacked leaf unbound once per forward (``unbind``'s backward
stacks the group slices' gradients once, where a per-group index would add
a zero-filled copy of the whole leaf per group).

Each position's mixer is attention, Mamba, mLSTM or sLSTM, by the layer
pattern (the dense families, olmoe, grok-1, the hybrid jamba, xlstm), and a
dense FFN or a mixture of experts follows it where the config has one;
``forward`` returns the experts' load-balancing loss summed over layers,
as the reference does.  An encoder-decoder (whisper) runs its encoder over
the given frame embeddings first (``forward(enc_frames=)``), and each
decoder layer attends to the encoder's keys and values after its
self-attention, a prefill writing them to the cache once and a decode
reading them; a VLM (qwen2-vl, M-RoPE) takes patch embeddings in place of
its first token embeddings (``forward(patch_embeds=)``).  Training runs
every family, the recurrent mixers through their checkpointed training
scans (``models/ssm.py``), the encoder-decoder through the gradient of its
encoder's and its cross attention (``lm_loss(enc_frames=)``).
:func:`lm_loss` is the reference's chunked next-token cross-entropy, and
``remat`` its rematerialisation of each decoder layer group (the encoder
runs outside it and keeps its activations, as the reference's plain scan
over the encoder layers): ``"full"`` recomputes a group in the
backward (``torch.utils.checkpoint``), ``"dots"`` keeps the outputs of the
unbatched matrix products (selective checkpointing), as
``dots_with_no_batch_dims_saveable``.  Either nests the scans' own
checkpoints inside the group's, as the reference nests its
``jax.checkpoint``s.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..runtime.hints import constrain
from . import attention as A
from . import moe as M
from . import ssm as S
from .common import apply_norm, dense_init, norm_params
from .config import ArchConfig

Params = dict
LOSS_CHUNK = 512
REMAT = ("none", "full", "dots")


MIXERS = ("attn", "mamba", "mlstm", "slstm")


def _check_supported(cfg: ArchConfig) -> None:
    kinds = {cfg.layer_kind(j) for j in range(cfg.group_size)}
    if not kinds <= set(MIXERS):
        raise ValueError(f"{cfg.name}: unknown mixers "
                         f"{sorted(kinds - set(MIXERS))}")


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder stack's config: attention layers with a dense FFN, as
    the reference's."""
    return dataclasses.replace(cfg, pattern=("attn",), moe=None,
                               encoder_layers=0)


def _mixer_params(gen: torch.Generator, kind: str, cfg: ArchConfig, dtype,
                  lead: tuple) -> dict:
    if kind == "attn":
        return A.attn_params(gen, cfg, dtype, lead)
    return getattr(S, f"{kind}_params")(gen, cfg, dtype, lead)


# =============================================================================
# init
# =============================================================================

def _stack(gen: torch.Generator, cfg: ArchConfig, dtype, n_groups: int,
           cross: bool) -> dict:
    """``{pos_j: layer}`` with every leaf stacked over ``n_groups``."""
    dev = gen.device
    lead = (n_groups,)
    groups = {}
    for j in range(cfg.group_size):
        lp = {"norm1": norm_params(cfg.norm, cfg.d_model, dtype, dev, lead),
              "mixer": _mixer_params(gen, cfg.layer_kind(j), cfg, dtype,
                                     lead)}
        if cross:
            lp["norm_x"] = norm_params(cfg.norm, cfg.d_model, dtype, dev,
                                       lead)
            lp["cross"] = A.attn_params(gen, cfg, dtype, lead)
        if cfg.d_ff > 0:
            lp["norm2"] = norm_params(cfg.norm, cfg.d_model, dtype, dev,
                                      lead)
            # position j of every group is layer g * group_size + j, and
            # group_size is a multiple of the MoE cadence
            if cfg.layer_is_moe(j):
                lp["moe"] = M.moe_params(gen, cfg, dtype, lead)
            else:
                lp["ffn"] = M.dense_ffn_params(gen, cfg, dtype, lead)
        groups[f"pos_{j}"] = lp
    return groups


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> Params:
    """Random parameters drawn from ``gen`` on its device, in the
    reference's layout and with its initialisers (truncated-normal fan-in,
    0.02 for the embeddings, ones for the norms).  A torch generator gives
    other numbers than the reference's key from the same seed; to run the
    reference's weights, carry them over with :func:`params_from_numpy`."""
    _check_supported(cfg)
    dev = gen.device
    p: Params = {"embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype,
                                     scale=0.02),
                 "groups": _stack(gen, cfg, dtype, cfg.n_groups,
                                  cross=cfg.is_encdec),
                 "final_norm": norm_params(cfg.norm, cfg.d_model, dtype,
                                           dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.vocab, cfg.d_model), dtype,
                                  scale=0.02)
    if cfg.is_encdec:
        p["encoder"] = {
            "groups": _stack(gen, _encoder_cfg(cfg), dtype,
                             cfg.encoder_layers, cross=False),
            "final_norm": norm_params(cfg.norm, cfg.d_model, dtype, dev)}
    return p


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name + "/")
        else:
            yield name, v


def _tree(flat: dict) -> dict:
    """Nested dicts from ``"/"``-joined paths (the inverse of
    :func:`_leaves`)."""
    out: dict = {}
    for name, leaf in flat.items():
        node = out
        *path, key = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[key] = leaf
    return out


def _mixer_shapes(kind: str, cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """The shapes of one mixer's parameters, as ``models/ssm.py`` and
    ``attention.attn_params`` make them."""
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    di, ds = cfg.d_inner, cfg.d_state
    if kind == "attn":
        return {"wq": (d, H * hd), "wk": (d, cfg.n_kv_heads * hd),
                "wv": (d, cfg.n_kv_heads * hd), "wo": (H * hd, d)}
    if kind == "mamba":
        dt_rank = max(di // 16, 1)
        return {"in_proj": (d, 2 * di), "conv_w": (cfg.d_conv, di),
                "x_proj": (di, dt_rank + 2 * ds), "dt_proj": (dt_rank, di),
                "A_log": (di, ds), "D": (di,), "out_proj": (di, d)}
    if kind == "mlstm":
        return {"in_proj": (d, 2 * di), "wq": (di,), "wk": (di,),
                "gate_proj": (d, 2 * H), "gate_bias": (2 * H,),
                "out_proj": (di, d)}
    dh = d // H                                          # slstm
    return {"w_in": (d, 4 * d), "r": (H, dh, 4 * dh), "bias": (4 * d,),
            "out_proj": (d, d)}


def _stack_shapes(cfg: ArchConfig, n_groups: int, cross: bool
                  ) -> dict[str, tuple[int, ...]]:
    """:func:`_stack`'s leaves, ``pos_j/...`` paths with their shapes."""
    d = cfg.d_model

    def norm(name):
        return {f"{name}/w": (d,)} | ({f"{name}/b": (d,)}
                                      if cfg.norm == "layernorm" else {})
    gated = cfg.act in ("swiglu", "geglu")
    ffn = {"ffn/w_up": (d, cfg.d_ff), "ffn/w_down": (cfg.d_ff, d)}
    if gated:
        ffn["ffn/w_gate"] = (d, cfg.d_ff)
    moe = {}
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        moe = {"moe/router": (d, E), "moe/w_up": (E, d, cfg.d_ff),
               "moe/w_down": (E, cfg.d_ff, d)}
        if gated:
            moe["moe/w_gate"] = (E, d, cfg.d_ff)
    out = {}
    for j in range(cfg.group_size):
        leaves = norm("norm1") | {
            f"mixer/{k}": s for k, s in
            _mixer_shapes(cfg.layer_kind(j), cfg).items()}
        if cross:
            leaves |= norm("norm_x") | {
                f"cross/{k}": s for k, s in _mixer_shapes("attn", cfg).items()}
        if cfg.d_ff > 0:
            leaves |= norm("norm2") | (moe if cfg.layer_is_moe(j) else ffn)
        out |= {f"pos_{j}/{k}": (n_groups,) + s for k, s in leaves.items()}
    return out


def param_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's ``"/"``-joined tree path and shape."""
    _check_supported(cfg)
    d = cfg.d_model
    final = {"w": (d,)} | ({"b": (d,)} if cfg.norm == "layernorm" else {})
    out = {"embed": (cfg.vocab, d)}
    out |= {f"groups/{k}": s for k, s in
            _stack_shapes(cfg, cfg.n_groups, cfg.is_encdec).items()}
    out |= {f"final_norm/{k}": s for k, s in final.items()}
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.vocab, d)
    if cfg.is_encdec:
        out |= {f"encoder/groups/{k}": s for k, s in _stack_shapes(
            _encoder_cfg(cfg), cfg.encoder_layers, False).items()}
        out |= {f"encoder/final_norm/{k}": s for k, s in final.items()}
    return out


def params_from_numpy(tree: dict, cfg: ArchConfig,
                      device: str | torch.device = "cuda") -> Params:
    """The reference's ``init_params`` tree, as nested dicts of numpy
    arrays, as the port's parameters on ``device`` in the same layout: a
    bf16 leaf (ml_dtypes' ``bfloat16``, which numpy has not: carried by its
    ``uint16`` bits) as ``torch.bfloat16``, every other leaf as f32, as the
    reference keeps its routers, gates and state scales in f32 under a bf16
    tree.  Every leaf :func:`param_shapes` names must be there with its
    shape, and no other."""
    want = param_shapes(cfg)
    got = dict(_leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter tree differs: missing "
                         f"{sorted(set(want) - set(got))}, unknown "
                         f"{sorted(set(got) - set(want))}")
    out = {}
    for name, a in got.items():
        a = np.asarray(a)
        if a.shape != want[name]:
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{want[name]}")
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
        out[name] = t.to(device)
    return _tree(out)


def param_count(params: Params) -> int:
    return sum(t.numel() for _, t in _leaves(params))


# =============================================================================
# layer application
# =============================================================================

def _rows(out: torch.Tensor) -> torch.Tensor:
    """A sublayer's output (B, S, d) before it joins the residual stream:
    on a mesh laid out ("dp", None, None), its partial sums over the model
    axis reduced whole (else DTensor may scatter them over the sequence,
    a split no later view of the rows can take)."""
    return constrain(out, "dp", None, None)


def _apply_layer(lp: dict, x: torch.Tensor, cfg: ArchConfig, layer_idx: int,
                 *, pos: torch.Tensor, enc: torch.Tensor | None = None,
                 cache: dict | None = None, mode: str,
                 use_kernels: bool = True):
    """One layer: its mixer, its cross attention to the encoder output
    ``enc`` where it has one, then its FFN or mixture of experts.  mode:
    "full" (prefill) | "decode".  Returns (x, new_cache, aux): aux is the
    MoE load-balancing loss, None for a dense layer.  A decode writes the
    cache in place: attention at ``pos``, the recurrent mixers their whole
    state (``copy_``), so the caller's tensors stay the cache; the cross
    keys and values (``xk``, ``xv``), written by the prefill, are only
    read."""
    kind = cfg.layer_kind(layer_idx)
    aux = None
    h = apply_norm(cfg.norm, x, lp["norm1"])
    new_cache: dict = {}
    if kind != "attn":
        if mode == "full":
            out, st = getattr(S, f"{kind}_forward")(lp["mixer"], h, cfg)
            if cache is not None:
                new_cache = {n: t.to(cache[n].dtype) for n, t in st.items()}
        else:
            out, st = getattr(S, f"{kind}_decode")(lp["mixer"], h, cfg,
                                                   cache)
            for n, t in st.items():
                cache[n].copy_(t)
            new_cache = cache
    elif mode == "full":
        # cache production == serving prefill == forward-only: the
        # causal-block-skipping attention (and its kernel) is safe
        out, kv = A.prefill_attention(
            lp["mixer"], h, cfg, pos, inference=cache is not None,
            use_kernels=use_kernels,
            pages=None if cache is None else (cache["k"], cache["v"]))
        if cache is not None:
            new_cache = {"k": kv[0], "v": kv[1]}
    else:
        out, (ck, cv) = A.decode_attention(
            lp["mixer"], h, cfg, (cache["k"], cache["v"]), pos)
        new_cache = {"k": ck, "v": cv}
    x = x + _rows(out)
    if "cross" in lp:
        hx = apply_norm(cfg.norm, x, lp["norm_x"])
        if mode == "full":
            # projected once, for the attention and the cache alike
            kv = A.cross_kv(lp["cross"], enc, cfg)
            if cache is not None:
                for name, t in zip(("xk", "xv"), kv):
                    if t.shape != cache[name].shape:
                        raise ValueError(f"cross {name} {tuple(t.shape)} "
                                         f"does not fit the cache's "
                                         f"{tuple(cache[name].shape)}")
                    new_cache[name] = t.to(cache[name].dtype)
        else:
            kv = (cache["xk"], cache["xv"])
            new_cache |= {"xk": cache["xk"], "xv": cache["xv"]}
        x = x + _rows(A.cross_attention(lp["cross"], hx, kv, cfg,
                                        use_kernels=use_kernels))
    if cfg.d_ff > 0:
        h2 = apply_norm(cfg.norm, x, lp["norm2"])
        if "moe" in lp:
            out2, aux = M.apply_moe(lp["moe"], h2, cfg)
        else:
            out2 = M.apply_dense_ffn(lp["ffn"], h2, cfg)
        x = x + _rows(out2)
    return x, new_cache, aux


def _group(tree: dict, g: int) -> dict:
    """Group ``g``'s slice of every leaf (views)."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def _unbind(tree: dict, n: int) -> list[dict]:
    """Every leaf unbound once along its group axis: ``n`` trees of
    views."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind(v, n) if isinstance(v, dict) else v.unbind(0)
        for g in range(n):
            out[g][k] = parts[g]
    return out


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the unbatched matrix products' outputs, recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` rematerialised in the backward as ``remat`` asks."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat {remat!r} not in {REMAT}")


# =============================================================================
# cache construction
# =============================================================================

def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               dtype=torch.float32, device: str | torch.device = "cuda"
               ) -> dict:
    """Stacked-over-groups cache, zeros: ``{pos_j: state}``, every leaf
    with the leading axis n_groups; an attention position's ``{"k", "v"}``
    (n_groups, batch, s_max, KH, D) of ``dtype`` (an encoder-decoder's also
    ``{"xk", "xv"}``, (n_groups, batch, enc_frames, KH, D)), a recurrent
    mixer's state as ``models/ssm.py``'s ``*_cache`` makes it (f32, Mamba's
    ``conv`` window of ``dtype``)."""
    _check_supported(cfg)
    cache = {}
    for j in range(cfg.group_size):
        kind = cfg.layer_kind(j)
        if kind == "attn":
            shape = (batch, s_max, cfg.n_kv_heads, cfg.hd)
            c = {n: torch.zeros(shape, dtype=dtype, device=device)
                 for n in ("k", "v")}
            if cfg.is_encdec:
                shape = (batch, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
                c |= {n: torch.zeros(shape, dtype=dtype, device=device)
                      for n in ("xk", "xv")}
        else:
            c = getattr(S, f"{kind}_cache")(batch, cfg, dtype, device)
        cache[f"pos_{j}"] = {n: t.new_zeros((cfg.n_groups,) + t.shape)
                             for n, t in c.items()}
    return cache


# =============================================================================
# forward passes
# =============================================================================

def _embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
           patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The token embeddings, the first P replaced by ``patch_embeds`` (B,
    P, d) where the config takes patches (qwen2-vl)."""
    # on a mesh the rows are looked up in the whole table: a lookup in a
    # vocab-sharded one leaves a masked partial sum that neither the
    # reference (its sharded step fails at this gather) nor DTensor reduces
    x = F.embedding(tokens, constrain(params["embed"], None, None))
    if patch_embeds is not None and cfg.vlm_patches:
        P = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


def _encoder_forward(params: Params, cfg: ArchConfig, frames: torch.Tensor,
                     use_kernels: bool = True) -> torch.Tensor:
    """The whisper encoder over precomputed frame embeddings (B, T, d):
    norm, non-causal self-attention and dense FFN in each of the
    ``encoder_layers``, then the final norm."""
    enc_cfg = _encoder_cfg(cfg)
    pos = torch.arange(frames.shape[1], device=frames.device)[None]
    x = frames
    for gp in _unbind(params["encoder"]["groups"], cfg.encoder_layers):
        lp = gp["pos_0"]
        h = apply_norm(cfg.norm, x, lp["norm1"])
        x = x + _rows(A.encoder_attention(lp["mixer"], h, enc_cfg, pos,
                                          use_kernels=use_kernels))
        h2 = apply_norm(cfg.norm, x, lp["norm2"])
        x = x + _rows(M.apply_dense_ffn(lp["ffn"], h2, enc_cfg))
    return apply_norm(cfg.norm, x, params["encoder"]["final_norm"])


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            enc_frames: torch.Tensor | None = None,
            patch_embeds: torch.Tensor | None = None,
            cache: dict | None = None, pos_offset: torch.Tensor | None = None,
            use_kernels: bool = True, remat: str = "none"):
    """Full-sequence forward.  Returns (hidden, new_cache, aux_loss).

    tokens: (B, S) int.  With ``cache`` given (prefill), new per-layer KV
    caches of its shapes are returned, the prompt's keys and values in the
    first S positions and zeros after (and an encoder-decoder's cross keys
    and values of the encoder output).  ``enc_frames``: (B, enc_frames, d),
    the encoder's input, which an encoder-decoder needs; ``patch_embeds``:
    (B, P, d), in place of the first P token embeddings of a VLM.
    ``pos_offset``: (B,) start positions.  ``use_kernels`` lets the
    attention take the kernel route (``flash_attention`` in a prefill and
    in the encoder's and the cross attention, ``FlashAttention`` in the
    decoder's self-attention otherwise; ``FlashAttention`` in the encoder's
    and the cross attention too where a gradient is wanted).  ``remat``
    (one of :data:`REMAT`) rematerialises each decoder layer group in the
    backward (not the encoder, as the reference's); a prefill (``cache``
    given) ignores it.
    """
    _check_supported(cfg)
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    B, Sq = tokens.shape
    x = _embed(params, cfg, tokens, patch_embeds)
    pos = torch.arange(Sq, device=x.device)[None]
    if pos_offset is not None:
        pos = pos + pos_offset[:, None]
    enc = None
    if cfg.is_encdec:
        if enc_frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward takes "
                             f"enc_frames of (B, {cfg.enc_frames}, "
                             f"{cfg.d_model})")
        enc = _encoder_forward(params, cfg, enc_frames, use_kernels)
    gs = cfg.group_size
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    groups = _unbind(params["groups"], cfg.n_groups)
    if cache is None:
        for gp in groups:
            def group_body(x, aux, gp=gp):
                for j in range(gs):
                    x, _, a = _apply_layer(gp[f"pos_{j}"], x, cfg, j,
                                           pos=pos, enc=enc, mode="full",
                                           use_kernels=use_kernels)
                    if a is not None:
                        aux = aux + a
                return x, aux
            x, aux = _remat(group_body, remat)(x, aux)
        return apply_norm(cfg.norm, x, params["final_norm"]), None, aux
    per_group = []
    for g, gp in enumerate(groups):
        gc = _group(cache, g)
        new_gc = {}
        for j in range(gs):
            x, nc, a = _apply_layer(gp[f"pos_{j}"], x, cfg, j, pos=pos,
                                    enc=enc, cache=gc[f"pos_{j}"],
                                    mode="full", use_kernels=use_kernels)
            new_gc[f"pos_{j}"] = nc
            if a is not None:
                aux = aux + a
        per_group.append(new_gc)
    x = apply_norm(cfg.norm, x, params["final_norm"])
    new_cache = {pj: {n: torch.stack([pg[pj][n] for pg in per_group])
                      for n in leaves} for pj, leaves in cache.items()}
    return x, new_cache, aux


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                pos: torch.Tensor, cache: dict, use_kernels: bool = True):
    """One decode step.  token: (B, 1); pos: (B,).  Returns (logits,
    cache); the cache's tensors are updated in place (attention's at
    ``pos``, a recurrent mixer's whole state).  ``use_kernels`` lets an
    encoder-decoder's cross attention over the cached encoder keys take
    the ``flash_attention`` kernel; the self-attention decode is plain, as
    the reference's."""
    _check_supported(cfg)
    x = F.embedding(token, constrain(params["embed"], None, None))
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        gc = _group(cache, g)
        for j in range(cfg.group_size):
            x, _, _ = _apply_layer(gp[f"pos_{j}"], x, cfg, j, pos=pos,
                                   cache=gc[f"pos_{j}"], mode="decode",
                                   use_kernels=use_kernels)
    x = apply_norm(cfg.norm, x, params["final_norm"])
    return project_logits(params, cfg, x[:, 0]), cache


def project_logits(params: Params, cfg: ArchConfig, x: torch.Tensor
                   ) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return (x @ head.T).float()


def lm_loss(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            labels: torch.Tensor, *, enc_frames: torch.Tensor | None = None,
            patch_embeds: torch.Tensor | None = None, remat: str = "none",
            use_kernels: bool = True) -> torch.Tensor:
    """Next-token cross-entropy, computed in sequence chunks of
    ``min(LOSS_CHUNK, S)`` rows, each recomputed in the backward, so the
    full (B, S, V) logits tensor never materialises; plus 0.01 times the
    experts' load-balancing loss, as the reference's.  ``enc_frames`` and
    ``patch_embeds`` as :func:`forward`'s."""
    x, _, aux = forward(params, cfg, tokens, enc_frames=enc_frames,
                        patch_embeds=patch_embeds, remat=remat,
                        use_kernels=use_kernels)
    B, Sq, _ = x.shape
    C = min(LOSS_CHUNK, Sq)
    if Sq % C:
        raise ValueError(f"lm_loss: sequence length {Sq} is not a multiple "
                         f"of its chunk {C}")
    labels = labels.long()

    def chunk_loss(xb, lb):
        # on a mesh the vocab axis is gathered for the row's log-sum-exp
        # and gold logit (a no-op outside the step's hints)
        logits = constrain(project_logits(params, cfg, xb),
                           "dp", None, None)                   # (B, C, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lb[..., None])[..., 0]
        return (lse - gold).sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(Sq // C):
        tot = tot + ckpt.checkpoint(chunk_loss, x[:, i * C:(i + 1) * C],
                                    labels[:, i * C:(i + 1) * C],
                                    use_reentrant=False)
    return tot / (B * Sq) + 0.01 * aux
