"""Full-trainer resume state, shared by the checkpointer and
``multi_node_snapshot`` (the JAX package's ``training/_resume.py``).

ChainerMN serialised the whole trainer through ``chainer.serializers``,
so a resumed run continued its epoch, shuffle order and log exactly.
:func:`collect_train_state` gathers what lies beyond the parameters and
the optimizer: the updater's epoch bookkeeping, the iterator's position,
order and RNG, each extension's ``state_dict`` (the ``LogReport``
history) and the wall-clock offset; :func:`restore_train_state` puts it
back.

The port's parameters are updated in place and its optimizer holds
references to them, so :func:`restore_updater` copies a snapshot's
leaves into the live tensors (``param.copy_``) and loads the optimizer
state into the live optimizer, where the JAX package rebinds
``updater.params``.

Not ported: the tuned exchange plan riding the snapshot (the JAX
package's ``exchange_plan``; ``plan=`` is ROADMAP Queue A item 10).
"""

from __future__ import annotations

from typing import Optional

import torch

from chainermn_tpu_torch.training.optimizers import (
    load_optimizer_state_tree,
    optimizer_state_tree,
)
from chainermn_tpu_torch.utils.serialization import tree_flatten

__all__ = ["collect_train_state", "copy_tree_into", "restore_train_state",
           "restore_updater", "updater_state"]


def collect_train_state(updater, trainer=None) -> dict:
    """Everything beyond (params, opt_state, model_state) a resume
    needs."""
    extra: dict = {
        "updater": {
            "epoch_detail": float(getattr(updater, "epoch_detail", 0.0)),
            "previous_epoch_detail": float(
                getattr(updater, "previous_epoch_detail", 0.0)),
        },
    }
    it = getattr(updater, "iterator", None)
    if it is not None and hasattr(it, "state_dict"):
        extra["iterator"] = it.state_dict()
    if trainer is not None:
        exts = {}
        for entry in getattr(trainer, "_extensions", []):
            sd = getattr(entry.ext, "state_dict", None)
            if sd is not None:
                exts[entry.name] = sd()
        extra["trainer"] = {
            "elapsed_time": float(getattr(trainer, "elapsed_time", 0.0)),
            "extensions": exts,
        }
    return extra


def restore_train_state(extra: Optional[dict], updater,
                        trainer=None) -> None:
    """Inverse of :func:`collect_train_state`; a snapshot written before
    a piece of state existed restores the rest."""
    if not extra:
        return
    up = extra.get("updater", {})
    if "epoch_detail" in up:
        updater.epoch_detail = float(up["epoch_detail"])
    if "previous_epoch_detail" in up:
        updater.previous_epoch_detail = float(up["previous_epoch_detail"])
    it = getattr(updater, "iterator", None)
    if it is not None and hasattr(it, "load_state_dict") \
            and "iterator" in extra:
        saved = extra["iterator"]
        order = saved.get("order")
        # the example count, not len(dataset): for a tuple of field
        # arrays len() counts the fields
        n_examples = getattr(it, "dataset_length", None)
        ds = getattr(it, "dataset", None)
        if n_examples is None and ds is not None:
            n_examples = len(ds)
        # resize-safe: a saved order that indexes a shard of another
        # size (a snapshot taken at another world size) would read the
        # wrong examples, so the fresh iterator is kept (its epoch
        # restarts; the parameters and optimizer still resume)
        if order is None or n_examples is None \
                or len(order) == n_examples:
            it.load_state_dict(saved)
    if trainer is not None and "trainer" in extra:
        tr = extra["trainer"]
        trainer.elapsed_time = float(tr.get("elapsed_time", 0.0))
        saved = tr.get("extensions", {})
        for entry in getattr(trainer, "_extensions", []):
            if entry.name in saved and hasattr(entry.ext, "load_state_dict"):
                entry.ext.load_state_dict(saved[entry.name])


def updater_state(updater, trainer=None) -> dict:
    """The tree a checkpoint holds: the iteration, the world size, the
    parameters, the optimizer state (:func:`optimizer_state_tree`), the
    model state (BN statistics) when the updater has one, and
    :func:`collect_train_state`.  The tensors are the live ones; the
    writer copies them."""
    state = {
        "iteration": int(updater.iteration),
        "world_size": int(updater.comm.size),
        "params": updater.params,
        "opt_state": optimizer_state_tree(updater.opt_state),
        "train_state": collect_train_state(updater, trainer),
    }
    if getattr(updater, "state", None) is not None:
        state["model_state"] = updater.state
    return state


def copy_tree_into(live, saved, what: str) -> None:
    """Copy every leaf of ``saved`` (numpy arrays or tensors) into the
    tensor at the same place in ``live``.  The two trees must have the
    same structure, and each pair the same shape and dtype."""
    dst, dst_def = tree_flatten(live)
    src, src_def = tree_flatten(saved)
    if dst_def != src_def:
        raise ValueError(f"the snapshot's {what} tree has another "
                         "structure than the live one")
    with torch.no_grad():
        for i, (d, s) in enumerate(zip(dst, src)):
            s = torch.as_tensor(s)
            if not torch.is_tensor(d) or d.shape != s.shape \
                    or d.dtype != s.dtype:
                raise ValueError(
                    f"{what} leaf {i}: snapshot {tuple(s.shape)} {s.dtype} "
                    f"does not fit the live "
                    f"{tuple(getattr(d, 'shape', ()))} "
                    f"{getattr(d, 'dtype', type(d).__name__)}")
            d.copy_(s)


def restore_updater(state: dict, updater, trainer=None) -> None:
    """Load a snapshot's tree into ``updater`` (and ``trainer``): the
    parameters and the model state are copied into the live tensors,
    the optimizer state is loaded into the live optimizer."""
    copy_tree_into(updater.params, state["params"], "params")
    load_optimizer_state_tree(updater.opt_state, state["opt_state"])
    if "model_state" in state:
        copy_tree_into(updater.state, state["model_state"], "model_state")
    updater.iteration = int(state["iteration"])
    restore_train_state(state.get("train_state"), updater, trainer)
