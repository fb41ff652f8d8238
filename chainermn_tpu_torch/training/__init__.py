"""Optimizers for the port's train steps."""

from .optimizers import adamw, sgd

__all__ = ["adamw", "sgd"]
