"""Static-batch serving engine of the port (``repro.serve.engine``).

Prompts are left-padded into one batch, one ``lm_prefill`` fills the KV
cache, then ``lm_decode`` runs once per new token with greedy or
temperature sampling.  Weights are served as ``fp32`` (the dense tree as
given) or ``rtn:int8`` / ``rtn:int4``: the RTN codes are STORED as
QTensors and every weight matmul streams them through the ``wqt_matmul``
kernel.  ``kv_quant="int8"`` / ``"int4"`` keeps the KV cache as codes and
decode attention runs the ``decode_attn`` kernel.

Mechanics, as in JAX: sampled tokens accumulate on the device and cross
to the host once; ``max_new_tokens`` / ``eos_id`` may be per request (the
batch decodes the longest budget, rows are truncated); attention-only
patterns mask left pads (per-row ``prompt_lens``), so a request's tokens
do not depend on its batchmates; ``cache_len`` is bucketed to the next
power of two.

Not in this slice: ``rr:`` casts, codebook formats (fp4), activation
quantization (``act_fmt``), the dense-cast path (``quantized_storage=
False``), and the continuous-batching scheduler.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import resolve_device
from ..core import QuantPolicy, quantize_params
from ..core.formats import IntFormat, get_format
from ..core.qtensor import QTensor
from ..core.policy import tree_map_with_path
from ..models.lm import ATTN_KINDS, LMConfig, check_ported, lm_decode, lm_prefill
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


def _check_scfg(scfg: ServeConfig, device: torch.device) -> None:
    if scfg.use_kernel is False and device.type == "cuda":
        raise ValueError("use_kernel=False on a CUDA device: the port always "
                         "runs its kernels on the card (no plain fallback)")
    if scfg.use_kernel is True and device.type != "cuda":
        raise ValueError(f"use_kernel=True needs a CUDA device, got {device}")
    if scfg.act_fmt is not None:
        raise NotImplementedError(
            f"act_fmt={scfg.act_fmt!r} (W4A8 serving) is not ported yet: "
            f"ROADMAP Queue 2 #3 (wqt_matmul_a8)")


def _to_device(params, device):
    return tree_map_with_path(
        lambda p, x: x.to(device) if isinstance(x, (QTensor, torch.Tensor))
        else x, params)


def prepare_params(params, scfg: ServeConfig, device=None):
    """Apply the ServeConfig weight representation to a dense fp32 tree on
    ``device`` (default ``"cuda"``): identity for fp32, QTensor storage for
    ``rtn:int8`` / ``rtn:int4``."""
    device = resolve_device(device)
    params = _to_device(params, device)
    w = scfg.weights
    if w == "fp32":
        return params
    mode, fmt_name = w.split(":")
    if mode == "rr":
        raise NotImplementedError(
            "rr: weights (randomized-rounding cast) are not ported yet: "
            "ROADMAP Queue 1 item 2 (core/quantize.py cast_rr)")
    fmt = get_format(fmt_name)
    policy = scfg.policy if scfg.policy is not None else \
        QuantPolicy(include_embeddings=scfg.include_embeddings)
    storage = scfg.quantized_storage
    if storage is None:
        storage = isinstance(fmt, IntFormat) and fmt.bits in (4, 8)
    if not storage:
        raise NotImplementedError(
            "the dense-cast serving path (quantized_storage=False) is not "
            "ported yet: ROADMAP Queue 1 item 2 (core/modes.py cast_params)")
    return quantize_params(params, fmt, policy, scfg.block_size, mode=mode)


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


class Engine:
    def __init__(self, cfg: LMConfig, params, scfg: ServeConfig,
                 device=None):
        check_ported(cfg)
        self.device = resolve_device(device)
        _check_scfg(scfg, self.device)
        # the JAX reference contracts in fp32: keep fp32 matmuls and
        # convolutions out of TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.scfg = scfg
        self.params = prepare_params(params, scfg, self.device)
        self._mask_pads = attn_only(cfg)

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
        out = torch.stack(steps, dim=1).cpu().numpy()  # one transfer
        return [truncate_output(row.tolist(), m, e)
                for row, m, e in zip(out, mnts, eoss)]
