"""Static-batch serving engine of the port (``repro.serve.engine``).

Prompts are left-padded into one batch, one ``lm_prefill`` fills the KV
cache, then ``lm_decode`` runs once per new token with greedy or
temperature sampling.  Weights are served as ``fp32`` (the dense tree as
given) or ``rtn:`` / ``rr:`` casts: for int8 and int4 the codes are
STORED as QTensors (the RR cast made in the stored orientation) and every
weight matmul streams them through the ``wqt_matmul`` kernel; formats
without QTensor storage (fp4) and ``quantized_storage=False`` serve the
dense cast of ``cast_params`` (through the ``quant`` kernel); with ``act_fmt="int8"`` (W4A8) prefill and decode run under
``qtensor_act_fmt``, so every QTensor matmul row-quantizes its activations
and runs the ``wqt_matmul_a8`` kernel instead.  ``kv_quant="int8"`` /
``"int4"`` keeps the KV cache as codes and decode attention runs the
``decode_attn`` kernel.

Mechanics, as in JAX: sampled tokens accumulate on the device and cross
to the host once; ``max_new_tokens`` / ``eos_id`` may be per request (the
batch decodes the longest budget, rows are truncated); attention-only
patterns mask left pads (per-row ``prompt_lens``), so a request's tokens
do not depend on its batchmates; ``cache_len`` is bucketed to the next
power of two.

RR draws come from a generator seeded with ``ServeConfig.seed`` (not
JAX's bits), or from explicit uniforms keyed by path.  The
continuous-batching scheduler is ``serve/scheduler.py``.

On a device mesh (``shardings``: the NamedShardings of ``params``, each
rank's blocks, as ``launch/serve.py --mesh`` places and quantizes them
with ``distributed.sharding.quantize_params_on_blocks``) the engine keeps
the blocks and installs ``sharding.serve_roles`` around each generation,
so the model gathers every leaf whole where it reads it.  The batch is
cut over the data axes where ``sharding.rows_sharding`` allows (each
rank decodes its rows of the globally left-padded batch) and the tokens
are gathered back; otherwise every rank decodes every row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import resolve_device
from ..core import QuantPolicy, cast_params, quantize_params
from ..core.formats import IntFormat, get_format
from ..core.qtensor import QTensor, _check_act_fmt, qtensor_act_fmt
from ..core.policy import tree_map_with_path
from ..distributed import sharding as shd
from ..distributed.context import constraints
from ..models.lm import ATTN_KINDS, LMConfig, lm_decode, lm_prefill
from .slots import RejectedError, request_problem


@dataclasses.dataclass
class ServeConfig:
    weights: str = "fp32"          # fp32 | rtn:<fmt> | rr:<fmt>
    block_size: int = -1
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 => greedy
    seed: int = 0
    # Quantized STORAGE: None = auto (QTensor codes for int4/int8)
    quantized_storage: Optional[bool] = None
    # quantize the embedding table / tied head too
    include_embeddings: bool = False
    # kernel dispatch: None = the tensors' device decides (kernels on the
    # card, plain versions on the CPU); False is refused on the card and
    # True on the CPU, because the port has no switch that hides the kernel
    use_kernel: Optional[bool] = None
    # KV cache: False = dense (model dtype), "int8" / "int4" = codes
    kv_quant: Union[bool, str] = False
    act_fmt: Optional[str] = None
    policy: Optional[QuantPolicy] = None


def bucket_cache_len(n: int, floor: int = 16) -> int:
    """Next power of two >= n (min ``floor``)."""
    return max(floor, 1 << max(n - 1, 1).bit_length())


def attn_only(cfg: LMConfig) -> bool:
    """True when per-row ``prompt_lens`` masking makes generations
    pad-invariant: attention-family blocks only and a dense FFN."""
    return (all(kind in ATTN_KINDS for kind in cfg.pattern)
            and cfg.ffn != "moe")


def full_ring(cfg: LMConfig, cache_len: int) -> Optional[str]:
    """None when every block's KV ring covers ``cache_len``, else why not."""
    for kind in cfg.pattern:
        ring = (min(cfg.window or cache_len, cache_len)
                if kind == "local" else cache_len)
        if kind not in ("attn", "local"):
            return f"block kind {kind!r} has no position-keyed KV ring"
        if ring != cache_len:
            return (f"block kind {kind!r} ring {ring} < cache_len "
                    f"{cache_len} (window wraps)")
    return None


def refuse_images(cfg: LMConfig, who: str) -> None:
    """``Engine`` and ``Scheduler`` take token prompts only, as the JAX
    package's do; a config that cross-attends to image embeddings is
    served through ``lm_prefill(image_embeds=...)`` and ``lm_decode``."""
    if cfg.n_image_tokens or "xattn" in cfg.pattern:
        raise ValueError(
            f"{who} cannot serve {cfg.name}: its cross-attention blocks read "
            f"image embeddings, which {who} never passes (the JAX package's "
            f"{who} fails there too); the JAX package serves it only through "
            f"lm_prefill(image_embeds=...) and lm_decode, and so does this "
            f"one")


def _check_scfg(scfg: ServeConfig, device: torch.device) -> None:
    if scfg.use_kernel is False and device.type == "cuda":
        raise ValueError("use_kernel=False on a CUDA device: the port always "
                         "runs its kernels on the card (no plain fallback)")
    if scfg.use_kernel is True and device.type != "cuda":
        raise ValueError(f"use_kernel=True needs a CUDA device, got {device}")
    _check_act_fmt(scfg.act_fmt)


def _to_device(params, device):
    return tree_map_with_path(
        lambda p, x: x.to(device) if isinstance(x, (QTensor, torch.Tensor))
        else x, params)


def prepare_params(params, scfg: ServeConfig, device=None,
                   uniforms: Optional[Dict[str, torch.Tensor]] = None):
    """Apply the ServeConfig weight representation to a dense fp32 tree on
    ``device`` (default ``"cuda"``): identity for fp32, QTensor storage for
    int8 / int4 (unless ``quantized_storage=False``), the dense RTN/RR cast
    otherwise.  ``rr:`` takes ``uniforms`` (``{path_str: tensor}`` in the
    shape each cast sees) or draws from a generator seeded with
    ``scfg.seed``.  Shared by the static Engine and the Scheduler."""
    device = resolve_device(device)
    params = _to_device(params, device)
    w = scfg.weights
    if w == "fp32":
        return params
    mode, fmt_name = w.split(":")
    fmt = get_format(fmt_name)
    policy = scfg.policy if scfg.policy is not None else \
        QuantPolicy(include_embeddings=scfg.include_embeddings)
    gen = (torch.Generator(device=device).manual_seed(scfg.seed)
           if uniforms is None else None)
    storage = scfg.quantized_storage
    if storage is None:
        storage = isinstance(fmt, IntFormat) and fmt.bits in (4, 8)
    if storage:
        return quantize_params(params, fmt, policy, scfg.block_size,
                               mode=mode, uniforms=uniforms, generator=gen)
    return cast_params(params, fmt, policy, scfg.block_size, mode=mode,
                       uniforms=uniforms, generator=gen)


def sample_token(logits: torch.Tensor, gen: Optional[torch.Generator],
                 temperature: float) -> torch.Tensor:
    """Greedy argmax (``temperature <= 0``, first maximum, as jnp.argmax)
    or temperature sampling from ``gen`` (not JAX's bits)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def _per_request(value, default, b: int) -> List:
    """Normalize a scalar-or-sequence request option to a per-row list."""
    if value is None:
        value = default
    if isinstance(value, (int, np.integer)) or value is None:
        return [value] * b
    value = list(value)
    if len(value) != b:
        raise ValueError(f"per-request option has {len(value)} entries "
                         f"for a batch of {b}")
    return value


def truncate_output(tokens: Sequence[int], mnt: int,
                    eos_id: Optional[int]) -> List[int]:
    """At most ``mnt`` tokens, stopping at (and including) ``eos_id``."""
    out = list(tokens[:max(mnt, 0)])
    if eos_id is not None and eos_id in out:
        out = out[:out.index(eos_id) + 1]
    return out


def check_placed(scfg: ServeConfig, shardings, who: str) -> None:
    """Blocks on a mesh arrive weight-prepared (``weights="fp32"`` keeps
    them as they are): a cast there would read each block as a leaf."""
    if shardings is not None and scfg.weights != "fp32":
        raise ValueError(
            f"{who} on a mesh takes parameters already cast on their blocks "
            f"(distributed.sharding.quantize_params_on_blocks) and "
            f"weights='fp32', got weights={scfg.weights!r}")


class Engine:
    def __init__(self, cfg: LMConfig, params, scfg: ServeConfig,
                 device=None, shardings=None):
        refuse_images(cfg, "Engine")
        self.device = resolve_device(device)
        _check_scfg(scfg, self.device)
        check_placed(scfg, shardings, "Engine")
        # the JAX reference contracts in fp32: keep fp32 matmuls and
        # convolutions out of TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.scfg = scfg
        self.params = prepare_params(params, scfg, self.device)
        self._mask_pads = attn_only(cfg)
        self.shardings = shardings
        self.mesh = shd.mesh_of(shardings)
        self._roles = (shd.serve_roles(shardings) if shardings is not None
                       else {})
        # the last decode step's logits (b, 1, vocab), every row
        self.last_logits: Optional[torch.Tensor] = None

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Union[int, Sequence[int], None] = None,
                 eos_id: Union[int, Sequence[int], None] = None,
                 ) -> List[List[int]]:
        """Greedy/temperature generation for a batch of token prompts;
        per-request ``max_new_tokens`` / ``eos_id`` truncate each row."""
        b = len(prompts)
        mnts = _per_request(max_new_tokens, self.scfg.max_new_tokens, b)
        eoss = _per_request(eos_id, None, b)
        for p, m in zip(prompts, mnts):
            problem = request_problem(p, m, None, self.cfg.vocab)
            if problem is not None:
                raise RejectedError(*problem)
        mnt = max(mnts)
        if mnt <= 0:
            return [[] for _ in prompts]
        dev = self.device
        max_len = max(len(p) for p in prompts)
        cache_len = bucket_cache_len(max_len + mnt)
        toks = np.zeros((b, max_len), np.int64)
        for i, p in enumerate(prompts):
            toks[i, max_len - len(p):] = p
        lens = (torch.tensor([len(p) for p in prompts], dtype=torch.int64,
                             device=dev) if self._mask_pads else None)
        rows = shd.rows_sharding(self.mesh, self.cfg, b, max_len)
        if rows is not None:
            # this rank's rows of the globally left-padded batch
            toks = shd.shard(toks, rows)
            prompts = list(prompts)[shd.shard_slices(rows, (b,))[0]]
            lens = shd.shard(lens, rows) if lens is not None else None
        with qtensor_act_fmt(self.scfg.act_fmt), constraints(**self._roles):
            out = self._generate(prompts, toks, lens, cache_len, mnt)
        if rows is not None:
            out = shd.gather(out, rows)
            self.last_logits = shd.gather(self.last_logits, rows)
        out = out.cpu().numpy()                           # one transfer
        return [truncate_output(row.tolist(), m, e)
                for row, m, e in zip(out, mnts, eoss)]

    def _generate(self, prompts, toks, lens, cache_len: int,
                  mnt: int) -> torch.Tensor:
        dev = self.device
        b, max_len = toks.shape
        logits, cache = lm_prefill(self.params, self.cfg,
                                   torch.as_tensor(toks, device=dev),
                                   cache_len=cache_len,
                                   kv_quant=self.scfg.kv_quant,
                                   prompt_lens=lens)
        gen = None
        if self.scfg.temperature > 0:
            gen = torch.Generator(device=dev).manual_seed(self.scfg.seed + 1)
        if self._mask_pads:
            pos = torch.tensor([len(p) - 1 for p in prompts],
                               dtype=torch.int64, device=dev)
        else:
            pos = torch.full((b,), max_len - 1, dtype=torch.int64, device=dev)
        tok = sample_token(logits[:, 0], gen, self.scfg.temperature)
        steps = [tok]                  # accumulated on the device
        for _ in range(mnt - 1):
            pos = pos + 1
            logits, cache = lm_decode(self.params, self.cfg, cache,
                                      tok[:, None].long(), pos)
            tok = sample_token(logits[:, 0], gen, self.scfg.temperature)
            steps.append(tok)
        self.last_logits = logits
        return torch.stack(steps, dim=1)
