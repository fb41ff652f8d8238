"""Optimizers, the multi-node optimizer, and ChainerMN's training loop:
updater, trainer, triggers and evaluators."""

from .evaluators import (
    Evaluator,
    GenericMultiNodeEvaluator,
    create_multi_node_evaluator,
)
from .optimizers import (
    adamw,
    create_multi_node_optimizer,
    cross_replica_mean,
    load_optimizer_state_tree,
    optimizer_state_tree,
    sgd,
)
from .trainer import LogReport, PrintReport, Trainer, make_extension
from .triggers import IntervalTrigger, get_trigger
from .updater import StandardUpdater

__all__ = [
    "Evaluator",
    "GenericMultiNodeEvaluator",
    "IntervalTrigger",
    "LogReport",
    "PrintReport",
    "StandardUpdater",
    "Trainer",
    "adamw",
    "create_multi_node_evaluator",
    "create_multi_node_optimizer",
    "cross_replica_mean",
    "get_trigger",
    "load_optimizer_state_tree",
    "make_extension",
    "optimizer_state_tree",
    "sgd",
]
