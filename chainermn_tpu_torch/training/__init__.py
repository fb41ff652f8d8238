"""Optimizers, the multi-node optimizer, and ChainerMN's training loop:
updater, trainer, triggers and evaluators."""

from .elastic import (
    ElasticMembership,
    MembershipRecord,
    RelayoutError,
    ResizeController,
    StaleGenerationError,
    post_resize_intent,
    relayout_state,
    same_topology,
    topology_signature,
)
from .evaluators import (
    Evaluator,
    GenericMultiNodeEvaluator,
    create_multi_node_evaluator,
)
from .optimizers import (
    MultiNodeState,
    Zero1Transformation,
    Zero2Transformation,
    adam,
    adamw,
    create_multi_node_optimizer,
    cross_replica_mean,
    lamb,
    lars,
    load_optimizer_state_tree,
    map_state_moments,
    optimizer_state_tree,
    sgd,
    shard_opt_state,
    zero1_init,
)
from .schedules import (
    cosine_decay_schedule,
    join_schedules,
    linear_schedule,
)
from .trainer import LogReport, PrintReport, Trainer, make_extension
from .triggers import IntervalTrigger, get_trigger
from .updater import StandardUpdater, fuse_steps

__all__ = [
    "ElasticMembership",
    "Evaluator",
    "GenericMultiNodeEvaluator",
    "IntervalTrigger",
    "LogReport",
    "MembershipRecord",
    "MultiNodeState",
    "PrintReport",
    "RelayoutError",
    "ResizeController",
    "StaleGenerationError",
    "StandardUpdater",
    "Trainer",
    "Zero1Transformation",
    "Zero2Transformation",
    "adam",
    "adamw",
    "cosine_decay_schedule",
    "create_multi_node_evaluator",
    "create_multi_node_optimizer",
    "cross_replica_mean",
    "fuse_steps",
    "get_trigger",
    "join_schedules",
    "lamb",
    "lars",
    "linear_schedule",
    "load_optimizer_state_tree",
    "make_extension",
    "map_state_moments",
    "optimizer_state_tree",
    "post_resize_intent",
    "relayout_state",
    "same_topology",
    "sgd",
    "shard_opt_state",
    "topology_signature",
    "zero1_init",
]
