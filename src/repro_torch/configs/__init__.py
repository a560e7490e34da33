"""Architecture configs of the port's slice: ``config()`` is the full
published configuration, ``smoke_config()`` the reduced same-family one
used by the CPU tests (both copied from ``repro.configs``)."""

from __future__ import annotations

import importlib

from repro_torch.models.lm import LMConfig

ARCHS = ["granite_3_2b", "gemma2_2b"]


def _norm(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "p")


def _module(arch_id: str):
    name = _norm(arch_id)
    if name not in ARCHS:
        raise NotImplementedError(
            f"config {arch_id!r} is not ported yet (have {ARCHS}): ROADMAP "
            f"Queue 1 item 7")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> LMConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> LMConfig:
    return _module(arch_id).smoke_config()
