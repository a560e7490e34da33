"""Request validation at the door (the part of ``repro.serve.slots`` that
the static engine uses).  The continuous-batching lifecycle and slot pool
are not in this slice of the port."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


class RejectedError(ValueError):
    """Typed early rejection: the request can never be served as posed.
    ``reason`` is the machine-readable tag."""

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


def request_problem(prompt: Sequence[int], max_new_tokens: int,
                    cache_len: Optional[int],
                    vocab: Optional[int]) -> Optional[Tuple[str, str]]:
    """``(reason, message)`` for a malformed request, else None: empty
    prompts, out-of-vocab or non-integer tokens, and prompts that cannot
    fit ``cache_len`` with their token budget."""
    if len(prompt) == 0:
        return ("empty_prompt", "empty prompt: prefill needs at least one "
                                "real token")
    if vocab is not None:
        for t in prompt:
            if not isinstance(t, (int,)) or isinstance(t, bool):
                try:
                    t = int(t)
                except (TypeError, ValueError):
                    return ("oov_token",
                            f"non-integer prompt token {t!r}")
            if t < 0 or t >= vocab:
                return ("oov_token",
                        f"prompt token {t} outside vocab [0, {vocab})")
    if cache_len is not None and len(prompt) + max_new_tokens > cache_len:
        return ("over_cache_len",
                f"request needs {len(prompt)} + {max_new_tokens} cache "
                f"slots but the pool was built with cache_len={cache_len}")
    return None
