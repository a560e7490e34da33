"""Serving of the port: the static-batch engine and request validation."""

from .engine import Engine, ServeConfig
from .slots import RejectedError

__all__ = ["Engine", "ServeConfig", "RejectedError"]
