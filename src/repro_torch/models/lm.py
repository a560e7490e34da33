"""Language model of the port (``repro.models.lm``): ``attn`` (global),
``local`` (sliding window) and ``xattn`` (gated cross-attention to the
image embeddings, projected once per forward through ``vision_proj``:
Llama-3.2-Vision) blocks, each followed by a dense MLP or a
GShard MoE (``ffn="moe"``: top-k experts under a per-group capacity, plus
``n_shared_experts`` always-on experts as one wider MLP); ``mamba``
(Mamba2, no FFN) and ``rwkv`` (RWKV6 time-mix and channel-mix) blocks
from ``models/ssm.py``; with ``shared_attn_every`` (Zamba2) one shared,
unstacked attention + MLP block (``params["shared"]``) applied after each
unit's blocks, its KV in ``cache["shared"]``; ``n_codebooks > 1`` sums
one embedding per codebook and gives each its head (MusicGen's token
frames (b, l, C)).

A model is a unit ``pattern`` of block kinds tiled ``n_repeats`` times.
Parameters keep the JAX tree's layout: unit leaves are stacked along a
leading repeats axis under ``params["stage"]``, keyed ``b{i}_{kind}``.
Where JAX scans over the repeats, the port loops in Python over per-layer
views of the stacked leaves (``layer_params``).

Entry points: ``lm_init`` (random weights from a seed, on a device),
``lm_forward`` / ``lm_loss`` (the training forward, with activation
recomputation per layer when ``cfg.remat``; ``attn_chunk`` streams the
attention over key chunks, ``logit_chunk`` runs the head and CE chunk by
chunk), ``lm_prefill`` (forward that
fills the decode cache), ``lm_prefill_chunk`` (one chunk of a prompt
against a partial cache) and ``lm_decode`` (one token against a ring
cache, or against the paged pool through block tables); ``cache_insert``
/ ``cache_insert_paged`` place a one-request cache into the scheduler's
slot rows or pool blocks, ``quantize_cache`` converts a dense cache to
codes.  The caches are updated in place.  ``LMConfig.act_fmt``
fake-quantizes the two normed inputs of every block (RTN, one scale per
batch row, straight-through in backward) in the full-sequence forward
only, as JAX does (on attention blocks; the SSM blocks and the shared
block take their normed inputs as they are): prefill, chunked prefill and
decode ignore it.  Recurrent blocks carry a state per batch row
(``{"conv", "ssm"}`` or ``{"shift_tm", "shift_cm", "wkv"}``, stacked
(repeats, batch, ...)) that decode updates in place; they consume left
pads as tokens (no ``prompt_lens`` masking reaches them), and chunked
prefill and paged decode refuse them, as in JAX.  An ``xattn`` block adds
``tanh(xattn_gate)`` times its attention output to the residual (the gate
starts at zero, so at init the image changes nothing); its cache holds
the cross K/V of the image tokens, dense in ``dtype`` whatever
``kv_quant`` says, written by prefill and only read after.  A config with
``n_image_tokens`` needs ``image_embeds`` (b, n_image_tokens, d_vision)
in every forward and prefill.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from .. import resolve_device
from ..core.qtensor import QTensor
from ..core.policy import tree_leaves, tree_map_multi, tree_map_with_path
from ..distributed.context import constrain, constrain_tree
from . import layers
from .layers import (AttnSpec, MLPSpec, MoESpec, attn_apply,
                     attn_chunk_apply, attn_decode, attn_decode_paged,
                     attn_init, dense_init, init_leaf, matmul, mlp_apply,
                     mlp_init, moe_apply, moe_init, rms_norm)
from .ssm import (Mamba2Spec, RWKV6Spec, mamba2_apply, mamba2_decode,
                  mamba2_init, mamba2_init_state, rwkv6_channel_mix,
                  rwkv6_channel_mix_init, rwkv6_init_state, rwkv6_time_mix,
                  rwkv6_time_mix_decode, rwkv6_time_mix_init)

ATTN_KINDS = ("attn", "local", "xattn")


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ('float32', ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...] = ("attn",)
    head_dim: Optional[int] = None
    mlp_kind: str = "swiglu"
    ffn: str = "dense"                    # dense | moe
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None   # gemma3 local layers
    window: Optional[int] = None
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    qk_norm: bool = False
    use_post_norm: bool = False           # gemma2/3 sandwich norms
    emb_scale: bool = False               # multiply embeddings by sqrt(d)
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    shared_attn_every: int = 0
    # RWKV
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 16
    # Vision / audio stubs
    n_image_tokens: int = 0
    d_vision: int = 0
    n_codebooks: int = 1
    # activation fake-quantization of the training forward (RTN, STE)
    act_fmt: Optional[str] = None
    # misc
    max_seq: int = 8192
    remat: bool = True                    # recompute each layer in backward
    sub_quadratic: bool = False
    dtype: Any = torch.bfloat16           # torch dtype or its name

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"unit length {len(self.pattern)}")
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_spec(self, kind: str) -> AttnSpec:
        local = kind == "local"
        theta = (self.rope_theta_local if (local and self.rope_theta_local)
                 else self.rope_theta)
        return AttnSpec(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            rope_theta=theta, window=self.window if local else None,
            softcap=self.softcap_attn, qk_norm=self.qk_norm,
            is_cross=(kind == "xattn"))

    def mlp_spec(self) -> MLPSpec:
        return MLPSpec(d_model=self.d_model, d_ff=self.d_ff, kind=self.mlp_kind)

    def moe_spec(self) -> MoESpec:
        return MoESpec(d_model=self.d_model, d_ff=self.d_ff,
                       n_experts=self.n_experts, top_k=self.top_k,
                       kind=self.mlp_kind,
                       capacity_factor=self.capacity_factor)

    def shared_mlp_spec(self) -> MLPSpec:
        """The shared experts, one MLP ``n_shared_experts`` times wider."""
        return MLPSpec(self.d_model, self.d_ff * self.n_shared_experts,
                       self.mlp_kind)

    def mamba_spec(self) -> Mamba2Spec:
        return Mamba2Spec(d_model=self.d_model, d_state=self.ssm_state,
                          head_dim=self.ssm_head_dim, chunk=self.ssm_chunk)

    def rwkv_spec(self) -> RWKV6Spec:
        return RWKV6Spec(d_model=self.d_model, head_dim=self.rwkv_head_dim,
                         chunk=self.rwkv_chunk)


# ==========================================================================
# Parameter init
# ==========================================================================

def _block_init(gen, cfg: LMConfig, kind: str, device, r: int):
    lead = (r,)

    def ones():
        return init_leaf(torch.ones(lead + (cfg.d_model,), device=device))

    p: Dict[str, Any] = {"pre_norm_scale": ones()}
    if kind == "mamba":
        p["mamba"] = mamba2_init(gen, cfg.mamba_spec(), device, lead)
        return p
    if kind == "rwkv":
        p["tm"] = rwkv6_time_mix_init(gen, cfg.rwkv_spec(), device, lead)
        p["cm_norm_scale"] = ones()
        p["cm"] = rwkv6_channel_mix_init(gen, cfg.d_model, cfg.d_ff, device,
                                         lead)
        return p
    p["attn"] = attn_init(gen, cfg.attn_spec(kind), device, lead)
    if kind == "xattn":
        p["xattn_gate"] = init_leaf(torch.zeros(lead, device=device))
    p["ffn_norm_scale"] = ones()
    if cfg.ffn == "moe":
        p["moe"] = moe_init(gen, cfg.moe_spec(), device, lead)
        if cfg.n_shared_experts:
            p["shared_mlp"] = mlp_init(gen, cfg.shared_mlp_spec(), device,
                                       lead)
    else:
        p["mlp"] = mlp_init(gen, cfg.mlp_spec(), device, lead)
    if cfg.use_post_norm:
        p["post_norm_scale"] = ones()
        p["ffn_post_norm_scale"] = ones()
    return p


def lm_init(cfg: LMConfig, seed: int = 0, device=None,
            shardings=None) -> Dict[str, Any]:
    """Random fp32 weights with the JAX tree's shapes and init scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (default ``"cuda"``; on ``"meta"`` nothing is drawn or allocated: the
    shapes alone).  The numbers differ from ``jax.random``'s; tests that
    compare with JAX move JAX's weights over with ``bridge``.

    With ``shardings`` (the parameter tree's ``NamedSharding``s,
    ``distributed.sharding.params_shardings``) every leaf is drawn whole,
    in the usual order, and only this rank's block of it is kept before
    the next draw: a rank holds at most one full leaf beyond its blocks,
    and its blocks are bitwise those of the one-device init."""
    device = resolve_device(device)
    if shardings is not None:
        return _init_sharded(cfg, seed, device, shardings)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    params: Dict[str, Any] = {
        "embed": init_leaf(torch.randn(books + (cfg.vocab, cfg.d_model),
                                       generator=gen, device=device) * 0.02)}
    r = cfg.n_repeats
    params["stage"] = {f"b{i}_{kind}": _block_init(gen, cfg, kind, device, r)
                       for i, kind in enumerate(cfg.pattern)}
    if cfg.shared_attn_every:
        # one unstacked block, applied after every unit's blocks
        d = cfg.d_model
        params["shared"] = {
            "pre_norm_scale": init_leaf(torch.ones((d,), device=device)),
            "attn": attn_init(gen, cfg.attn_spec("attn"), device),
            "ffn_norm_scale": init_leaf(torch.ones((d,), device=device)),
            "mlp": mlp_init(gen, cfg.mlp_spec(), device)}
    if cfg.n_image_tokens:
        params["vision_proj"] = dense_init(gen, (cfg.d_vision, cfg.d_model),
                                           device)
    params["final_norm_scale"] = init_leaf(torch.ones((cfg.d_model,),
                                                      device=device))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, books + (cfg.d_model, cfg.vocab),
                                       device)
    return params


def _init_sharded(cfg: LMConfig, seed: int, device, shardings):
    """``lm_init`` keeping each leaf's block: a run on the meta device
    records the order in which the init functions finish the leaves
    (``layers.init_leaf``), then the real run hands each finished leaf to
    ``sharding.shard`` with that leaf's sharding."""
    from ..distributed.sharding import shard, tree_leaves_with_path
    finished: List[torch.Tensor] = []

    def record(x):
        finished.append(x)
        return x

    prev = layers._LEAF_HOOK
    try:
        layers._LEAF_HOOK = record
        meta = lm_init(cfg, seed, "meta")
        path_of = {id(x): p for p, x in tree_leaves_with_path(meta)}
        order = [path_of.get(id(x)) for x in finished]
        if None in order or len(set(order)) != len(path_of):
            raise AssertionError("lm_init: a parameter leaf was not "
                                 "finished through layers.init_leaf")
        sh_of = dict(tree_leaves_with_path(shardings))
        it = iter(order)
        layers._LEAF_HOOK = lambda x: shard(x, sh_of[next(it)])
        return lm_init(cfg, seed, device)
    finally:
        layers._LEAF_HOOK = prev


def layer_params(stage, r: int):
    """Per-layer view of the stacked unit parameters (index r of every
    leaf; a stacked QTensor gives its 2-D ``layer(r)``)."""
    return tree_map_with_path(
        lambda p, x: x.layer(r) if isinstance(x, QTensor) else x[r], stage)


def unbind_stage(stage) -> List[Dict[str, Any]]:
    """All per-layer views of the stacked unit parameters at once, from
    one ``torch.unbind`` per leaf.  Under autograd the backward of
    ``unbind`` is one stack per leaf; indexing ``leaf[r]`` per layer would
    instead zero-fill a full-size gradient of the leaf for every layer."""
    def views(x):
        if isinstance(x, QTensor):
            return [x.layer(r) for r in range(x.codes.shape[0])]
        return torch.unbind(x, 0)

    per_leaf = tree_map_with_path(lambda p, x: views(x), stage)
    n = len(tree_leaves(per_leaf)[0])
    return [tree_map_with_path(lambda p, views_of_leaf: views_of_leaf[r],
                               per_leaf) for r in range(n)]


def _embed(params, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (b, l, d) in the compute dtype; with codebooks,
    tokens (b, l, C) and the sum of the C tables' rows, in codebook order
    (the tables stay dense: the packer converts 2-D embeds only)."""
    emb = constrain(params["embed"], "embed")
    if cfg.n_codebooks > 1:
        x = emb[0][tokens[..., 0]]
        for c in range(1, cfg.n_codebooks):
            x = x + emb[c][tokens[..., c]]
    else:
        x = emb.take(tokens) if isinstance(emb, QTensor) else emb[tokens]
    x = x.to(cfg.dtype)
    if cfg.emb_scale:
        # JAX multiplies by a NumPy float32 scalar, which promotes bf16 to
        # fp32; keep that promotion
        x = x.to(torch.promote_types(x.dtype, torch.float32)) * float(
            np.sqrt(cfg.d_model).astype(np.float32))
    return x


def _head(params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits (b, l, vocab) fp32, or (b, l, C, vocab) with codebooks."""
    x = constrain(x, "head_in")
    x = rms_norm(x, constrain(params["final_norm_scale"], "final_norm_scale"))
    w = (constrain(params["embed"], "embed") if cfg.tie_embeddings
         else constrain(params["lm_head"], "lm_head"))
    if cfg.n_codebooks > 1:
        if isinstance(w, QTensor):
            # JAX's head is an einsum on the dense (C, ...) stack too
            raise ValueError(f"{cfg.name}: the {cfg.n_codebooks}-codebook "
                             f"head is served dense; quantize it with "
                             f"include_embeddings=False")
        eq = "bld,cvd->blcv" if cfg.tie_embeddings else "bld,cdv->blcv"
        logits = torch.einsum(eq, x, w.to(x.dtype))
    elif isinstance(w, QTensor):
        logits = matmul(x, w)           # out-major (vocab, d) either way
    else:
        logits = x @ (w.T if cfg.tie_embeddings else w).to(x.dtype)
    logits = constrain(logits.to(torch.float32), "logits")
    if cfg.softcap_final is not None:
        logits = cfg.softcap_final * torch.tanh(logits / cfg.softcap_final)
    return logits


def _act_q(cfg: LMConfig, h: torch.Tensor) -> torch.Tensor:
    """``cfg.act_fmt``'s straight-through RTN fake-quant of a normed block
    input (b, l, d): one scale per batch row (the trailing (l, d) axes),
    through the ``quant`` kernel in ``h``'s dtype."""
    if cfg.act_fmt is None:
        return h
    from ..core.ste import fake_quant_rtn
    return fake_quant_rtn(h.contiguous(), cfg.act_fmt, -1)


def _apply_ffn(p, cfg: LMConfig, x: torch.Tensor, o: torch.Tensor,
               quantize_acts: bool = False,
               token_mask: Optional[torch.Tensor] = None):
    """Residual add of the attention output ``o``, then the MLP or MoE
    sub-block (its normed input fake-quantized under ``cfg.act_fmt`` when
    ``quantize_acts``: the full-sequence forward only, before the router
    too).  ``token_mask`` (b,) reaches the MoE dispatch: decode under
    continuous batching drops dead rows from it."""
    if cfg.use_post_norm:
        o = rms_norm(o, p["post_norm_scale"])
    x = x + o
    h = rms_norm(x, p["ffn_norm_scale"])
    if quantize_acts:
        h = _act_q(cfg, h)
    if cfg.ffn == "moe":
        hm, _ = moe_apply(p["moe"], cfg.moe_spec(), h, token_mask=token_mask)
        if cfg.n_shared_experts:
            hm = hm + mlp_apply(p["shared_mlp"], cfg.shared_mlp_spec(), h)
        h = hm
    else:
        h = mlp_apply(p["mlp"], cfg.mlp_spec(), h)
    if cfg.use_post_norm:
        h = rms_norm(h, p["ffn_post_norm_scale"])
    return x + h


def xattn_gate(p, dtype: torch.dtype) -> torch.Tensor:
    """The factor of an ``xattn`` block's attention output:
    ``tanh(xattn_gate)`` in the compute dtype."""
    return torch.tanh(p["xattn_gate"]).to(dtype)


def image_context(params, cfg: LMConfig,
                  image_embeds: Optional[torch.Tensor]):
    """The cross-attention context (b, n_image_tokens, d_model): the image
    embeddings in the compute dtype through ``vision_proj`` (a QTensor
    when packed), once per forward; None for a config without image
    tokens.  Raises where the config needs images and none are given (the
    JAX package fails there with an AttributeError)."""
    if not cfg.n_image_tokens:
        return None
    if image_embeds is None:
        raise ValueError(
            f"{cfg.name} cross-attends to {cfg.n_image_tokens} image tokens: "
            f"pass image_embeds (b, {cfg.n_image_tokens}, {cfg.d_vision})")
    return matmul(image_embeds.to(cfg.dtype),
                  constrain(params["vision_proj"], "vision_proj"))


# ==========================================================================
# Training forward and loss
# ==========================================================================

def _apply_block(p, cfg: LMConfig, kind: str, x: torch.Tensor,
                 positions: torch.Tensor,
                 attn_chunk: Optional[int] = None,
                 ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block, full sequence: attention (cross-attention to ``ctx``,
    gated, for ``xattn``) and its MLP (the normed inputs of both
    fake-quantized under ``cfg.act_fmt``; ``attn_chunk`` streams the
    attention over key chunks), Mamba2, or RWKV6's time-mix and
    channel-mix."""
    if kind == "mamba":
        h = rms_norm(x, p["pre_norm_scale"])
        return x + mamba2_apply(p["mamba"], cfg.mamba_spec(), h)
    if kind == "rwkv":
        h = rms_norm(x, p["pre_norm_scale"])
        x = x + rwkv6_time_mix(p["tm"], cfg.rwkv_spec(), h)
        return x + rwkv6_channel_mix(p["cm"], rms_norm(x, p["cm_norm_scale"]))
    h = _act_q(cfg, rms_norm(x, p["pre_norm_scale"]))
    o = attn_apply(p["attn"], cfg.attn_spec(kind), h, positions,
                   chunk=attn_chunk, ctx=ctx if kind == "xattn" else None)
    if kind == "xattn":
        o = xattn_gate(p, x.dtype) * o
    return _apply_ffn(p, cfg, x, o, quantize_acts=True)


def _shared_ffn(p, cfg: LMConfig, x: torch.Tensor,
                o: torch.Tensor) -> torch.Tensor:
    """The shared block's residual add of its attention output ``o``, then
    its MLP (no post norms, no MoE, no activation fake-quant, as JAX)."""
    x = x + o
    return x + mlp_apply(p["mlp"], cfg.mlp_spec(),
                         rms_norm(x, p["ffn_norm_scale"]))


def _apply_shared(p, cfg: LMConfig, x: torch.Tensor, positions: torch.Tensor,
                  attn_chunk: Optional[int] = None) -> torch.Tensor:
    """The shared (Zamba2) attention + MLP block, full sequence."""
    o = attn_apply(p["attn"], cfg.attn_spec("attn"),
                   rms_norm(x, p["pre_norm_scale"]), positions,
                   chunk=attn_chunk)
    return _shared_ffn(p, cfg, x, o)


def _trunk(params, cfg: LMConfig, tokens: torch.Tensor,
           attn_chunk: Optional[int] = None,
           image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding + all blocks; returns final hidden states (b, l, d).
    With ``cfg.remat`` each layer is recomputed in backward
    (``torch.utils.checkpoint``), which keeps one layer's activations
    alive instead of all of them."""
    ctx = image_context(params, cfg, image_embeds)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def unit_body(x, unit_p):
        # the unit's leaves where they are read (and read again in the
        # recomputation under remat)
        unit_p = constrain_tree(unit_p, "stage_params")
        for i, kind in enumerate(cfg.pattern):
            x = _apply_block(unit_p[f"b{i}_{kind}"], cfg, kind, x, positions,
                             attn_chunk, ctx)
        if cfg.shared_attn_every:
            x = _apply_shared(constrain_tree(params["shared"], "shared"), cfg,
                              x, positions, attn_chunk)
        return x

    for unit_p in unbind_stage(params["stage"]):
        x = constrain(x, "residual")
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(unit_body, x, unit_p,
                                                  use_reentrant=False)
        else:
            x = unit_body(x, unit_p)
    return x


def lm_forward(params, cfg: LMConfig, tokens: torch.Tensor,
               attn_chunk: Optional[int] = None,
               image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training forward: logits (b, l, [C,] vocab) in fp32."""
    return _head(params, cfg, _trunk(params, cfg, tokens, attn_chunk,
                                     image_embeds))


def _head_ce(params, cfg: LMConfig, x: torch.Tensor, labels: torch.Tensor):
    """The head and CE terms of hidden states x: (mean CE, (b,) per
    example mean CE)."""
    from ..train.loop import _ce_terms
    terms = _ce_terms(_head(params, cfg, x), labels)
    return torch.mean(terms), torch.mean(terms, dim=tuple(
        range(1, terms.ndim)))


def lm_loss(params, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor, attn_chunk: Optional[int] = None,
            logit_chunk: Optional[int] = None, per_example: bool = False,
            image_embeds: Optional[torch.Tensor] = None):
    """Mean next-token CE.  With ``logit_chunk`` < l the head and CE run
    chunk by chunk over the sequence, each chunk recomputed in backward
    (``torch.utils.checkpoint``, JAX's rematerialized scan), so one (b,
    logit_chunk, vocab) slice of logits lives at a time; the loss is the
    mean of the chunks' means (l must be a multiple of ``logit_chunk``).
    ``per_example=True`` also returns the (b,) per-example mean CE (the
    raw material of the skip gate) as ``(ce, ce_ex)``, from the same
    elementwise terms as ``ce``.  ``image_embeds`` (b, n_image_tokens,
    d_vision) feed the cross-attention blocks."""
    x = _trunk(params, cfg, tokens, attn_chunk, image_embeds)
    l = tokens.shape[1]
    if logit_chunk is None or logit_chunk >= l:
        ce, ce_ex = _head_ce(params, cfg, x, labels)
    else:
        if l % logit_chunk:
            raise ValueError(f"logit_chunk {logit_chunk} must divide the "
                             f"sequence length {l}")
        n_chunks = l // logit_chunk
        ce = torch.zeros((), dtype=torch.float32, device=x.device)
        ce_ex = torch.zeros((tokens.shape[0],), dtype=torch.float32,
                            device=x.device)
        for i in range(n_chunks):
            sl = slice(i * logit_chunk, (i + 1) * logit_chunk)
            if torch.is_grad_enabled():
                c, c_ex = torch.utils.checkpoint.checkpoint(
                    _head_ce, params, cfg, x[:, sl], labels[:, sl],
                    use_reentrant=False)
            else:
                c, c_ex = _head_ce(params, cfg, x[:, sl], labels[:, sl])
            ce, ce_ex = ce + c, ce_ex + c_ex
        n = torch.full((), float(n_chunks), dtype=torch.float32,
                       device=x.device)
        ce, ce_ex = ce / n, ce_ex / n
    return (ce, ce_ex) if per_example else ce


# ==========================================================================
# Decode cache
# ==========================================================================

def _kv_zeros(shape, dtype, kv_quant, device):
    bits = layers.kv_bits(kv_quant)
    if bits:
        cshape = shape[:-1] + (shape[-1] // 2,) if bits == 4 else shape
        cdtype = torch.uint8 if bits == 4 else torch.int8
        return {"codes": torch.zeros(cshape, dtype=cdtype, device=device),
                "scale": torch.ones(shape[:-1] + (1,), device=device)}
    return torch.zeros(shape, dtype=dtype, device=device)


def init_cache(cfg: LMConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, kv_quant=False, device=None):
    """Cache tree stacked over repeats: ``{"unit": {name: {"k", "v"}}}``;
    global layers hold ``cache_len`` slots, local layers a ring of
    ``window``; ``kv_quant`` stores int8 / int4 codes + fp32 scales.
    Cross-attention blocks hold the dense cross K/V of
    ``max(n_image_tokens, 1)`` context tokens in ``dtype`` (never codes).
    Recurrent blocks hold their state instead (mamba ``{"conv": (r, b,
    d_conv - 1, conv_dim) in ``dtype``, "ssm": fp32}``, rwkv ``{"shift_tm",
    "shift_cm", "wkv"}`` fp32), and ``shared_attn_every`` adds
    ``cache["shared"]``, one global ring per unit, quantized as the others.
    The paged pool is the same tree with ``batch`` = n_blocks and
    ``cache_len`` = block_size: leaves (r, n_blocks, block_size, kvh, ...).
    """
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    r = cfg.n_repeats

    def ring(length):
        shape = (r, batch, length, cfg.n_kv_heads, cfg.hd)
        return {"k": _kv_zeros(shape, dtype, kv_quant, device),
                "v": _kv_zeros(shape, dtype, kv_quant, device)}

    def stacked(state):
        return {k: v.new_zeros((r,) + tuple(v.shape))
                for k, v in state.items()}

    unit = {}
    for i, kind in enumerate(cfg.pattern):
        name = f"b{i}_{kind}"
        if kind == "mamba":
            unit[name] = stacked(mamba2_init_state(cfg.mamba_spec(), batch,
                                                   dtype, device))
        elif kind == "rwkv":
            unit[name] = stacked(rwkv6_init_state(cfg.rwkv_spec(), batch,
                                                  device))
        elif kind == "xattn":
            shape = (r, batch, max(cfg.n_image_tokens, 1), cfg.n_kv_heads,
                     cfg.hd)
            unit[name] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
        else:
            unit[name] = ring(min(cfg.window or cache_len, cache_len)
                              if kind == "local" else cache_len)
    cache = {"unit": unit}
    if cfg.shared_attn_every:
        cache["shared"] = ring(cache_len)
    return cache


def _kv_to_cache(k, v, kind: str, cfg: LMConfig, cache_len: int,
                 kv_quant=False, pads: Optional[torch.Tensor] = None):
    """Pack full-sequence (k, v) (b, l, kvh, hd) into one layer's decode
    cache.  With ``pads`` (b,) (left-pad widths of ragged prompts) row i's
    column c holds position c - pads[i] and lands at ring slot
    ``pos % ring_len``; pad columns and positions older than the ring go
    to a dump row that is sliced off.  The cross K/V of an ``xattn``
    block are stored whole, in ``cfg.dtype``, never quantized."""
    if kind == "xattn":
        return {"k": k.to(cfg.dtype), "v": v.to(cfg.dtype)}
    b, l = k.shape[0], k.shape[1]
    bits = layers.kv_bits(kv_quant)
    dev = k.device

    def store(x):
        return layers.kv_quantize(x, bits) if bits else x.to(cfg.dtype)

    if pads is not None:
        ring_len = (min(cfg.window or cache_len, cache_len)
                    if kind == "local" else cache_len)
        positions = torch.arange(l, device=dev)[None, :] - pads[:, None]
        length = l - pads
        keep = (positions >= 0) & (positions >= length[:, None] - ring_len)
        slots = torch.where(keep, torch.remainder(positions, ring_len),
                            ring_len)
        bidx = torch.arange(b, device=dev)[:, None]

        def one(vals, fill):
            buf = torch.full((b, ring_len + 1) + tuple(vals.shape[2:]), fill,
                             dtype=vals.dtype, device=dev)
            buf[bidx, slots] = vals
            return buf[:, :ring_len]

        def scatter(t):
            s = store(t)
            if bits:
                return {"codes": one(s["codes"], 0),
                        "scale": one(s["scale"], 1.0)}
            return one(s, 0)

        return {"k": scatter(k), "v": scatter(v)}

    if kind == "local":
        wl = min(cfg.window or cache_len, cache_len)
        take = min(wl, l)
        slots = torch.remainder(torch.arange(l - take, l, device=dev), wl)

        def ring(t):
            vals = store(t[:, l - take:])
            if bits:
                codes = torch.zeros((b, wl) + tuple(vals["codes"].shape[2:]),
                                    dtype=vals["codes"].dtype, device=dev)
                scale = torch.ones((b, wl) + tuple(t.shape[2:-1]) + (1,),
                                   device=dev)
                codes[:, slots] = vals["codes"]
                scale[:, slots] = vals["scale"]
                return {"codes": codes, "scale": scale}
            out = torch.zeros((b, wl) + tuple(t.shape[2:]), dtype=cfg.dtype,
                              device=dev)
            out[:, slots] = vals
            return out

        return {"k": ring(k), "v": ring(v)}

    pad = cache_len - l

    def pad_one(a, fill):
        return torch.nn.functional.pad(
            a, (0, 0) * (a.ndim - 2) + (0, pad), value=fill)

    def pad_store(t):
        s = store(t)
        if bits:
            return {"codes": pad_one(s["codes"], 0),
                    "scale": pad_one(s["scale"], 1.0)}
        return pad_one(s, 0)

    return {"k": pad_store(k), "v": pad_store(v)}


def _stack_caches(per_layer):
    """List (over repeats) of one-layer caches -> the stacked cache."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack_caches([c[k] for c in per_layer]) for k in first}
    return torch.stack(per_layer)


# ==========================================================================
# Prefill (fills cache) and decode (one token)
# ==========================================================================

def lm_prefill(params, cfg: LMConfig, tokens: torch.Tensor,
               attn_chunk: Optional[int] = None,
               cache_len: Optional[int] = None, kv_quant=False,
               prompt_lens: Optional[torch.Tensor] = None,
               image_embeds: Optional[torch.Tensor] = None):
    """Forward + cache fill in one pass.  Returns (last logits (b, 1, V)
    fp32, cache).  ``attn_chunk`` streams the attention over key chunks.
    ``image_embeds`` (b, n_image_tokens, d_vision): the context of the
    cross-attention blocks, whose K/V the cache keeps.

    ``prompt_lens`` (b,): real prompt length per row of a left-padded
    ragged batch; rows get per-row positions ``col - pad``, pad keys are
    masked out of every score, and the KV cache is written at
    position-indexed ring slots, so a row's generation does not depend on
    its batchmates."""
    b, l = tokens.shape[0], tokens.shape[1]
    cache_len = cache_len or l
    dev = tokens.device
    ctx = image_context(params, cfg, image_embeds)
    x = _embed(params, cfg, tokens)
    pads = None
    if prompt_lens is None:
        positions = torch.arange(l, device=dev)
    else:
        pads = (l - prompt_lens).to(torch.int64)
        positions = torch.arange(l, device=dev)[None, :] - pads[:, None]

    per_layer = {f"b{i}_{kind}": [] for i, kind in enumerate(cfg.pattern)}
    shared = []
    for r in range(cfg.n_repeats):
        # the roles JAX's prefill applies at the top of its unit body
        x = constrain(x, "residual")
        unit_p = constrain_tree(layer_params(params["stage"], r),
                                "stage_params")
        for i, kind in enumerate(cfg.pattern):
            name = f"b{i}_{kind}"
            p = unit_p[name]
            h = rms_norm(x, p["pre_norm_scale"])
            if kind == "mamba":
                o, st = mamba2_apply(p["mamba"], cfg.mamba_spec(), h,
                                     return_state=True)
                per_layer[name].append(st)
                x = x + o
                continue
            if kind == "rwkv":
                o, st = rwkv6_time_mix(p["tm"], cfg.rwkv_spec(), h,
                                       return_state=True)
                x = x + o
                h2 = rms_norm(x, p["cm_norm_scale"])
                per_layer[name].append({
                    "shift_tm": st["shift_tm"],
                    "shift_cm": h2[:, -1].to(torch.float32),
                    "wkv": st["wkv"]})
                x = x + rwkv6_channel_mix(p["cm"], h2)
                continue
            o, (k, v) = attn_apply(p["attn"], cfg.attn_spec(kind), h,
                                   positions, chunk=attn_chunk,
                                   return_kv=True,
                                   ctx=ctx if kind == "xattn" else None)
            per_layer[name].append(_kv_to_cache(k, v, kind, cfg, cache_len,
                                                kv_quant, pads=pads))
            if kind == "xattn":
                o = xattn_gate(p, x.dtype) * o
            x = _apply_ffn(p, cfg, x, o)
        if cfg.shared_attn_every:
            sp = constrain_tree(params["shared"], "shared")
            o, (k, v) = attn_apply(sp["attn"], cfg.attn_spec("attn"),
                                   rms_norm(x, sp["pre_norm_scale"]),
                                   positions, chunk=attn_chunk,
                                   return_kv=True)
            shared.append(_kv_to_cache(k, v, "attn", cfg, cache_len,
                                       kv_quant, pads=pads))
            x = _shared_ffn(sp, cfg, x, o)
    cache = {"unit": {name: _stack_caches(c) for name, c in per_layer.items()}}
    if shared:
        cache["shared"] = _stack_caches(shared)
    return _head(params, cfg, x[:, -1:]), cache


def _layer_cache(leaf, r: int):
    if isinstance(leaf, dict):
        return {k: v[r] for k, v in leaf.items()}
    return leaf[r]


def _write_state(c, r: int, state) -> None:
    """Layer r's new recurrent state into its slice of the stacked cache
    leaves, in place (after every read of the old state)."""
    for k, v in state.items():
        c[k][r].copy_(v)


def cache_insert(pool_cache, row_cache, slot: int):
    """Copy a one-request cache (batch 1, the same ``cache_len``) into
    batch row ``slot`` of the scheduler's slot cache, IN PLACE: every leaf
    (KV rings, codes and scales, recurrent states, the shared rings) is
    stacked (repeats, batch, ...), so row ``slot`` of axis 1 is the
    request's, and its whole previous content is replaced.  Leaves pair
    by their keys.  Returns ``pool_cache``."""
    def one(path, pool, row):
        pool[:, slot] = row[:, 0].to(pool.dtype)

    tree_map_multi(one, pool_cache, row_cache)
    return pool_cache


def cache_insert_paged(pool_cache, row_cache, table: torch.Tensor,
                       write_mask: torch.Tensor):
    """Scatter a one-request cache row into the paged pool, IN PLACE.

    ``pool_cache`` leaves are (r, n_blocks, bs, ...), ``row_cache`` leaves
    (r, 1, bps*bs, ...) in the same layout; chunk i of the row (ring slots
    [i*bs, (i+1)*bs)) goes to block ``table[i]``.  Chunks whose
    ``write_mask`` is False (prefix blocks shared from the trie, whose
    bytes are already in the pool) go to the reserved dump block 0
    instead, several at once: block 0 is never read.  Returns
    ``pool_cache``."""
    bids = torch.where(write_mask, table, 0).long()
    bps = table.shape[0]

    for pool, row in zip(tree_leaves(pool_cache), tree_leaves(row_cache)):
        row = row[:, 0]
        row = row.reshape((row.shape[0], bps, pool.shape[2])
                          + tuple(row.shape[2:]))
        pool[:, bids] = row.to(pool.dtype)
    return pool_cache


def quantize_cache(cfg: LMConfig, cache, kv_quant):
    """A dense cache (``init_cache(..., kv_quant=False)`` layout) in the
    quantized layout ``init_cache(..., kv_quant=...)`` builds, as a new
    tree.  Chunked prefill keeps its partial cache dense and quantizes it
    once, at insert: per-vector absmax over the written values is the
    quantizer of a monolithic prefill, and unwritten (zero) slots become
    codes 0 with scale 1, the ``init_cache`` fill."""
    bits = layers.kv_bits(kv_quant)
    if not bits:
        return cache

    def q(leaf):
        return {"k": layers.kv_quantize(leaf["k"], bits),
                "v": layers.kv_quantize(leaf["v"], bits)}

    unit = dict(cache["unit"])
    for i, kind in enumerate(cfg.pattern):
        if kind in ("attn", "local"):
            unit[f"b{i}_{kind}"] = q(unit[f"b{i}_{kind}"])
    out = {"unit": unit}
    if cfg.shared_attn_every:
        out["shared"] = q(cache["shared"])
    return out


def lm_prefill_chunk(params, cfg: LMConfig, cache, tokens: torch.Tensor,
                     start_pos: torch.Tensor,
                     chunk_lens: Optional[torch.Tensor] = None):
    """Advance a partial prefill by one chunk of prompt tokens.

    tokens (b, cw): the next chunk of each row, right-padded to the chunk
    width; start_pos (b,): absolute position of column 0 (the tokens
    already in the cache); chunk_lens (b,): real tokens this chunk (None:
    all).  ``cache`` is a dense partial cache holding every position
    below start_pos; the chunk's K/V are ring-written into it IN PLACE
    (``quantize_cache`` is the deferred kv-quant step); cross-attention
    blocks read their cached cross K/V and write nothing.
    Attention-family blocks only.  Returns (logits of each row's last
    real token (b, 1, vocab) fp32, cache)."""
    for kind in cfg.pattern:
        if kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"chunked prefill needs attention-family blocks; {cfg.name} "
                f"has {kind!r} (recurrent state is not threaded across "
                f"chunks — use monolithic prefill)")
    if cfg.shared_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: the shared block is not ported to chunked prefill")
    b, cw = tokens.shape[0], tokens.shape[1]
    dev = tokens.device
    if chunk_lens is None:
        chunk_lens = torch.full((b,), cw, dtype=torch.int64, device=dev)
    positions = start_pos[:, None] + torch.arange(cw, device=dev)[None, :]
    x = _embed(params, cfg, tokens)
    for r in range(cfg.n_repeats):
        # each leaf whole where it is read (a no-op with nothing installed)
        unit_p = constrain_tree(layer_params(params["stage"], r),
                                "stage_params")
        for i, kind in enumerate(cfg.pattern):
            name = f"b{i}_{kind}"
            p = unit_p[name]
            c = cache["unit"][name]
            h = rms_norm(x, p["pre_norm_scale"])
            o, _, _ = attn_chunk_apply(p["attn"], cfg.attn_spec(kind), h,
                                       positions, chunk_lens,
                                       _layer_cache(c["k"], r),
                                       _layer_cache(c["v"], r))
            if kind == "xattn":
                o = xattn_gate(p, x.dtype) * o
            x = _apply_ffn(p, cfg, x, o)
    # the head reads each row's last real column only (pads are garbage)
    last = torch.clamp(chunk_lens - 1, min=0).long()
    x_last = torch.take_along_dim(
        x, last[:, None, None].expand(b, 1, x.shape[-1]), dim=1)
    return _head(params, cfg, x_last), cache


def lm_decode(params, cfg: LMConfig, cache, tokens: torch.Tensor,
              pos: torch.Tensor, token_mask: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              block_size: int = 0):
    """One-token decode.  tokens (b, 1), pos (b,) current positions.

    The cache is updated IN PLACE: each layer writes its new K/V into its
    slice of the stacked cache tensors (JAX carries the cache through a
    scan with a dynamic update instead).  With ``block_tables`` (b, bps)
    int32, ``cache`` is the paged pool (leaves (r, n_blocks, block_size,
    kvh, ...), shared by every row) and attention reads and writes go
    through the tables.  ``token_mask`` (b,) marks the live rows under
    continuous batching; only the MoE dispatch reads it (dead rows take
    no expert capacity).  Recurrent blocks write their new state into
    their slice of the stacked state leaves, and the shared block its K/V
    into ``cache["shared"]``; paged decode refuses recurrent and
    cross-attention patterns.  Cross-attention blocks attend their cached
    cross K/V (in the compute dtype) and write nothing.
    With codebooks tokens are (b, 1, C).  Returns
    (logits (b, 1, [C,] V) fp32, cache) with ``cache`` the same object
    that was passed in."""
    if block_tables is not None:
        bad = [k for k in cfg.pattern if k not in ("attn", "local")]
        if bad:
            raise ValueError(f"paged decode requires attn/local-only "
                             f"patterns, got {bad}")
        first = next(iter(cache["unit"].values()))["k"]
        pool_bs = (first["codes"] if isinstance(first, dict)
                   else first).shape[2]
        if block_size < 1 or block_size != pool_bs:
            raise ValueError(f"paged decode needs block_size equal to the "
                             f"pool's block length {pool_bs}, got "
                             f"{block_size}")
    x = _embed(params, cfg, tokens)
    for r in range(cfg.n_repeats):
        # each leaf whole where it is read (a no-op with nothing installed)
        unit_p = constrain_tree(layer_params(params["stage"], r),
                                "stage_params")
        for i, kind in enumerate(cfg.pattern):
            name = f"b{i}_{kind}"
            p = unit_p[name]
            c = cache["unit"][name]
            h = rms_norm(x, p["pre_norm_scale"])
            if kind == "mamba":
                o, st = mamba2_decode(p["mamba"], cfg.mamba_spec(), h,
                                      _layer_cache(c, r))
                _write_state(c, r, st)
                x = x + o
                continue
            if kind == "rwkv":
                o, st = rwkv6_time_mix_decode(
                    p["tm"], cfg.rwkv_spec(), h,
                    {"shift_tm": c["shift_tm"][r], "wkv": c["wkv"][r]})
                x = x + o
                h2 = rms_norm(x, p["cm_norm_scale"])
                xx = c["shift_cm"][r].to(x.dtype)[:, None, :]
                x = x + rwkv6_channel_mix(p["cm"], h2, xx=xx)
                st["shift_cm"] = h2[:, 0].to(torch.float32)
                _write_state(c, r, st)
                continue
            ck, cv = _layer_cache(c["k"], r), _layer_cache(c["v"], r)
            if block_tables is not None:
                o, _, _ = attn_decode_paged(p["attn"], cfg.attn_spec(kind), h,
                                            pos, ck, cv, block_tables,
                                            block_size)
            elif kind == "xattn":
                o, _, _ = attn_decode(p["attn"], cfg.attn_spec(kind), h, pos,
                                      ck, cv, cross_kv=(ck.to(x.dtype),
                                                        cv.to(x.dtype)))
                o = xattn_gate(p, x.dtype) * o
            else:
                o, _, _ = attn_decode(p["attn"], cfg.attn_spec(kind), h, pos,
                                      ck, cv)
            x = _apply_ffn(p, cfg, x, o, token_mask=token_mask)
        if cfg.shared_attn_every:
            sp, c = constrain_tree(params["shared"], "shared"), cache["shared"]
            o, _, _ = attn_decode(sp["attn"], cfg.attn_spec("attn"),
                                  rms_norm(x, sp["pre_norm_scale"]), pos,
                                  _layer_cache(c["k"], r),
                                  _layer_cache(c["v"], r))
            x = _shared_ffn(sp, cfg, x, o)
    return _head(params, cfg, x), cache
