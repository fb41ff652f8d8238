"""The sharded-state layer: one layout signature per leaf driving ZeRO-1/2
optimizer state, FSDP/ZeRO-3 parameters and moments, and the per-layer
just-in-time gathers (the JAX package's ``parallel/sharded_state.py``).

- :class:`LeafLayout` — one leaf's layout: tree path, kind, full shape
  and dtype, world, shard dim.  ``to_record()`` is the JSON record a
  topology signature stamps, the JAX package's for the same tree
  (``shard``/``stack``/``rep`` for ZeRO-1/2, ``fsdp`` for a dim-sharded
  ZeRO-3 leaf).
- :func:`state_layout_table` — the table of a mode: ``zero1``/``zero2``
  state is the world-stacked flat shards of ``_leaf_shard`` (this
  rank's state is the stack's row ``r``), ``zero3`` parameters and the
  moments that mirror them are dim-sharded per
  :func:`~chainermn_tpu_torch.parallel.fsdp.fsdp_dims`.
- :func:`gather_state_leaves` / :func:`shard_state_leaves` — the host
  gather and scatter over any table (numpy).
- :class:`ShardedState` — ZeRO-3 over one data communicator: parameters
  and their moments live 1/world a rank, gathered a layer at a time by
  :class:`LayerGatherStream`.

Trees flatten in ``torch.utils._pytree``'s order: a dict's insertion
order, where JAX sorts a dict's keys, so a tree whose keys are inserted
sorted gives the JAX package's records in the JAX order.

Not ported, each raising: the plan-IR consumers — ``tune_gather_plan``,
``auto_window``, ``payload_descs`` — and the memory accountant's
``register_memory`` (ROADMAP Queue A item 10).  The gathers run on the
compute stream; overlapping them on a side stream is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = [
    "LAYOUT_KINDS",
    "LeafLayout",
    "LayerGatherStream",
    "ShardedState",
    "gather_state_leaves",
    "layout_records",
    "shard_state_leaves",
    "state_layout_table",
    "zero_opt_layouts",
]

#: ``shard``/``stack``/``rep`` are the ZeRO-1/2 records, ``fsdp`` the
#: dim-sharded ZeRO-3 one
LAYOUT_KINDS = ("rep", "stack", "shard", "fsdp")

SHARDING_MODES = ("zero1", "zero2", "zero3")


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to chainermn_tpu_torch yet: the "
        "collective-plan IR, the communication model and the memory "
        "accountant come with ROADMAP Queue A item 10")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _itemsize(dtype: str) -> int:
    # torch's names cover numpy's and bfloat16, which numpy lacks
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


# --------------------------------------------------------------------- #
# the layout signature
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One leaf's layout across ``world`` members.

    ``shape``/``dtype`` describe the FULL (gathered) leaf; a member's
    view follows from ``kind``: ``rep`` every member holds the leaf;
    ``stack`` a leading member axis over per-member replicas (adam's
    ``count`` in the world-stacked carry); ``shard`` a ``(world,
    ceil(size/world))`` stack of flat ZeRO-1/2 shards (``size`` the
    mirrored parameter's element count, padding lanes zero); ``fsdp``
    dim ``dim`` split evenly over the world.  ``axis`` names the mesh
    axis of the sharding (None for ``rep``)."""

    path: Tuple[str, ...]
    kind: str
    shape: Tuple[int, ...]
    dtype: str
    world: int
    dim: Optional[int] = None
    size: Optional[int] = None
    axis: Optional[str] = None

    def __post_init__(self):
        if self.kind not in LAYOUT_KINDS:
            raise ValueError(
                f"unknown layout kind {self.kind!r}; expected one of "
                f"{LAYOUT_KINDS}")
        if self.kind == "shard" and self.size is None:
            raise ValueError(f"{'/'.join(self.path)}: shard layout "
                             "needs the true element count (size=)")
        if self.kind == "fsdp" and self.dim is None:
            raise ValueError(f"{'/'.join(self.path)}: fsdp layout "
                             "needs the shard dim (dim=)")

    @property
    def global_size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def local_shape(self, world: Optional[int] = None) -> Tuple[int, ...]:
        """One member's at-rest shape."""
        w = int(world if world is not None else self.world)
        if self.kind == "shard":
            return (_ceil_div(int(self.size), w),)
        if self.kind == "fsdp":
            shape = list(self.shape)
            d = int(self.dim)
            if shape[d] % w:
                raise ValueError(
                    f"{'/'.join(self.path)}: fsdp dim {d} (length "
                    f"{shape[d]}) not divisible by world {w}")
            shape[d] //= w
            return tuple(shape)
        # a stack's member rows are replicas: one member holds one
        return tuple(self.shape)

    def local_bytes(self, world: Optional[int] = None) -> int:
        return int(np.prod(self.local_shape(world), dtype=np.int64)) \
            * _itemsize(self.dtype)

    def global_bytes(self) -> int:
        return self.global_size * _itemsize(self.dtype)

    def to_record(self) -> dict:
        """The record a snapshot is stamped with."""
        if self.kind == "shard":
            return {"kind": "shard", "size": int(self.size)}
        if self.kind == "fsdp":
            return {"kind": "fsdp", "dim": int(self.dim),
                    "len": int(self.shape[self.dim])}
        return {"kind": self.kind}

    @classmethod
    def from_record(cls, record: dict, *, path: Tuple[str, ...] = (),
                    shape: Tuple[int, ...] = (), dtype: str = "float32",
                    world: int = 1, axis: Optional[str] = None
                    ) -> "LeafLayout":
        return cls(path=tuple(path), kind=record.get("kind"),
                   shape=tuple(int(s) for s in shape), dtype=str(dtype),
                   world=int(world), dim=record.get("dim"),
                   size=record.get("size"), axis=axis)


def layout_records(layouts: Sequence) -> List[dict]:
    """``to_record()`` over layouts (record dicts pass through)."""
    return [spec.to_record() if isinstance(spec, LeafLayout)
            else dict(spec) for spec in layouts]


def _record(spec) -> dict:
    return spec.to_record() if isinstance(spec, LeafLayout) else spec


# --------------------------------------------------------------------- #
# layout tables
# --------------------------------------------------------------------- #


def _leaf_paths(tree):
    return pytree.tree_flatten_with_path(tree)[0]


def _path_keys(path) -> Tuple[str, ...]:
    return tuple(str(k) for k in path)


def _leaf_meta(leaf) -> Tuple[Tuple[int, ...], str]:
    """Shape and dtype name of a tensor, an array, a number or a meta
    tensor (shapes only: nothing is read)."""
    if torch.is_tensor(leaf):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    arr = np.asarray(leaf) if not hasattr(leaf, "dtype") else leaf
    return tuple(int(s) for s in np.shape(arr)), str(np.dtype(arr.dtype))


def _suffix_match(keys: Tuple[str, ...], table: Dict[Tuple[str, ...], Any]):
    """Longest matching path suffix first, the empty suffix included (a
    bare array as the whole params tree)."""
    for start in range(len(keys) + 1):
        hit = table.get(keys[start:])
        if hit is not None:
            yield hit


def zero_opt_layouts(opt_state, params, world: int,
                     axis: Optional[str] = None) -> List[LeafLayout]:
    """The table of a WORLD-STACKED ZeRO-1/2 state tree in flattened
    order: a ``(world, ceil(N/world))`` leaf whose padded width matches
    a suffix-identified parameter is a ``shard``; any other leading
    member axis a ``stack``; the rest ``rep``.  Shapes only."""
    by_path: Dict[Tuple[str, ...], int] = {}
    for path, p in _leaf_paths(params):
        shape, _ = _leaf_meta(p)
        by_path[_path_keys(path)] = int(np.prod(shape, dtype=np.int64)) \
            if shape else 1
    layouts: List[LeafLayout] = []
    for path, leaf in _leaf_paths(opt_state):
        shape, dtype = _leaf_meta(leaf)
        keys = _path_keys(path)
        spec: Optional[LeafLayout] = None
        if len(shape) == 2 and shape[0] == world:
            for n in _suffix_match(keys, by_path):
                if _ceil_div(n, world) == shape[1]:
                    spec = LeafLayout(keys, "shard", shape, dtype, world,
                                      size=n, axis=axis)
                    break
        if spec is None:
            kind = "stack" if len(shape) >= 1 and shape[0] == world \
                else "rep"
            spec = LeafLayout(keys, kind, shape, dtype, world,
                              axis=axis if kind != "rep" else None)
        layouts.append(spec)
    return layouts


def _dim_list(params, dims) -> list:
    return pytree.tree_structure(params).flatten_up_to(dims)


def _fsdp_param_layouts(params, dims, world: int,
                        axis: Optional[str]) -> List[LeafLayout]:
    out = []
    for (path, leaf), d in zip(_leaf_paths(params), _dim_list(params, dims)):
        shape, dtype = _leaf_meta(leaf)
        keys = _path_keys(path)
        out.append(LeafLayout(keys, "rep", shape, dtype, world)
                   if d is None else
                   LeafLayout(keys, "fsdp", shape, dtype, world, dim=int(d),
                              axis=axis))
    return out


def _fsdp_opt_layouts(opt_state, params, dims, world: int,
                      axis: Optional[str]) -> List[LeafLayout]:
    """ZeRO-3 state: an elementwise moment mirrors its parameter, so a
    state leaf takes the dim of the suffix-identified parameter of an
    EQUAL shape; scalars and unmatched leaves replicate (never a
    shape-only guess: two same-shape parameters can shard different
    dims)."""
    by_path = {}
    for (path, p), d in zip(_leaf_paths(params), _dim_list(params, dims)):
        by_path[_path_keys(path)] = (_leaf_meta(p)[0],
                                     None if d is None else int(d))
    out = []
    for path, leaf in _leaf_paths(opt_state):
        shape, dtype = _leaf_meta(leaf)
        keys = _path_keys(path)
        spec = None
        for pshape, d in _suffix_match(keys, by_path):
            if pshape == shape:
                spec = LeafLayout(keys, "rep", shape, dtype, world) \
                    if d is None else LeafLayout(
                        keys, "fsdp", shape, dtype, world, dim=d, axis=axis)
                break
        out.append(spec if spec is not None
                   else LeafLayout(keys, "rep", shape, dtype, world))
    return out


def state_layout_table(mode: str, params, opt_state=None, *, world: int,
                       dims=None, axis: Optional[str] = None
                       ) -> Dict[str, List[LeafLayout]]:
    """``{"params": [...], "opt_state": [...]}`` in flattened order.
    ``zero1``/``zero2``: parameters replicated, the state the
    world-stacked flat shards (:func:`zero_opt_layouts`); ``zero3``:
    parameters and mirrored moments dim-sharded per ``dims`` (an
    :func:`~chainermn_tpu_torch.parallel.fsdp.fsdp_dims` tree,
    required).  Shapes are the full (gathered) ones."""
    if mode not in SHARDING_MODES:
        raise ValueError(
            f"unknown sharding mode {mode!r}; expected one of "
            f"{SHARDING_MODES}")
    world = int(world)
    if mode in ("zero1", "zero2"):
        table = {"params": [
            LeafLayout(_path_keys(path), "rep", *_leaf_meta(leaf), world)
            for path, leaf in _leaf_paths(params)]}
        if opt_state is not None:
            table["opt_state"] = zero_opt_layouts(opt_state, params, world,
                                                  axis=axis)
        return table
    if dims is None:
        raise ValueError(
            "state_layout_table(mode='zero3') needs dims= (an "
            "fsdp_dims tree) — the shard dims ARE the layout")
    table = {"params": _fsdp_param_layouts(params, dims, world, axis)}
    if opt_state is not None:
        table["opt_state"] = _fsdp_opt_layouts(opt_state, params, dims,
                                               world, axis)
    return table


# --------------------------------------------------------------------- #
# host gather / scatter over any table
# --------------------------------------------------------------------- #


def _check_count(path_leaves, layouts):
    from chainermn_tpu_torch.training.elastic import RelayoutError

    if len(path_leaves) != len(layouts):
        raise RelayoutError(f"{len(layouts)} layout records for "
                            f"{len(path_leaves)} leaves")


def _unknown(path, kind):
    from chainermn_tpu_torch.training.elastic import RelayoutError

    return RelayoutError(f"leaf {''.join(_path_keys(path))}: unknown "
                         f"layout kind {kind!r}")


def gather_state_leaves(tree, layouts: Sequence):
    """A sharded state tree's full host values per its records:
    ``shard`` leaves → 1-D true-extent arrays, ``stack`` leaves → one
    row, ``fsdp``/``rep`` leaves unchanged (their host form is
    full-width)."""
    path_leaves, spec = pytree.tree_flatten_with_path(tree)
    _check_count(path_leaves, layouts)
    out = []
    for (path, leaf), layout in zip(path_leaves, layouts):
        rec = _record(layout)
        kind = rec.get("kind")
        arr = np.asarray(leaf)
        if kind == "shard":
            out.append(arr.reshape(-1)[: int(rec["size"])])
        elif kind == "stack":
            out.append(arr[0])
        elif kind in ("rep", "fsdp"):
            out.append(arr)
        else:
            raise _unknown(path, kind)
    return pytree.tree_unflatten(out, spec)


def shard_state_leaves(tree, layouts: Sequence, world: int):
    """The inverse of :func:`gather_state_leaves`: ``shard`` leaves
    padded to ``ceil(N/world)·world`` and split contiguously into a
    ``(world, s)`` stack, ``stack`` leaves re-stacked, ``fsdp``/``rep``
    leaves passed through."""
    path_leaves, spec = pytree.tree_flatten_with_path(tree)
    _check_count(path_leaves, layouts)
    world = int(world)
    out = []
    for (path, leaf), layout in zip(path_leaves, layouts):
        rec = _record(layout)
        kind = rec.get("kind")
        arr = np.asarray(leaf)
        if kind == "shard":
            size = int(rec["size"])
            s = _ceil_div(size, world)
            flat = np.zeros((world * s,), dtype=arr.dtype)
            flat[:size] = arr.reshape(-1)[:size]
            out.append(flat.reshape(world, s))
        elif kind == "stack":
            out.append(np.concatenate([arr[None]] * world, axis=0))
        elif kind in ("rep", "fsdp"):
            out.append(arr)
        else:
            raise _unknown(path, kind)
    return pytree.tree_unflatten(out, spec)


# --------------------------------------------------------------------- #
# the per-layer gather stream (ZeRO-3's forward)
# --------------------------------------------------------------------- #


def _layer_groups(params, dims):
    """A mapping's top-level keys (sorted, the same on every rank) are
    the layers; any other tree is one group ``"all"``."""
    if isinstance(params, dict):
        return [(str(k), params[k], dims[k]) for k in sorted(params)]
    return [("all", params, dims)]


class LayerGatherStream:
    """Just-in-time gathers a layer at a time with a window — ZeRO-3's
    forward::

        stream = sharded.gather_stream(local_params, window=2)
        for i in range(len(stream)):
            full = stream.layer(i)        # this layer, full width
            x = apply(full, x)
            x = stream.retire(i, x)       # drop it; release i + window

    ``layer(i)`` gathers layer ``i`` and prefetches the layers up to
    ``i + window - 1`` whose release has come: layer ``j`` is released
    once layer ``j - window`` is retired, so at most ``window`` layers
    of full-width parameters are alive.  ``retire(i, x)`` drops layer
    ``i``'s gathered leaves and returns ``x``.  The gathers are
    :func:`~chainermn_tpu_torch.parallel.fsdp.fsdp_gather` (so the
    backward's reduce-scatter is untouched), issued on the compute
    stream; ``issued`` lists the layers in the order gathered."""

    def __init__(self, params, dims, *, comm, window: int = 2,
                 wire_dtype=None, plan=None):
        from chainermn_tpu_torch.parallel.fsdp import fsdp_gather

        if plan is not None:
            raise _not_ported("LayerGatherStream(plan=...)")
        self._gather = fsdp_gather
        self._groups = _layer_groups(params, dims)
        self._comm = comm
        self._window = max(1, int(window))
        self._wire_dtype = wire_dtype
        self._full: Dict[int, Any] = {}
        self._retired: set = set()
        self.issued: List[int] = []

    def __len__(self) -> int:
        return len(self._groups)

    @property
    def names(self) -> List[str]:
        return [name for name, _, _ in self._groups]

    @property
    def window(self) -> int:
        return self._window

    @property
    def live(self) -> List[int]:
        """The layers whose gathered parameters are alive."""
        return sorted(self._full)

    def _issue(self, i: int) -> None:
        if i in self._full or i in self._retired:
            return
        _, subtree, subdims = self._groups[i]
        self._full[i] = self._gather(subtree, subdims, self._comm,
                                     self._wire_dtype)
        self.issued.append(i)

    def layer(self, i: int):
        """Layer ``i`` at full width; prefetches the released layers of
        ``[i + 1, i + window)``."""
        n = len(self._groups)
        if not 0 <= i < n:
            raise IndexError(f"layer {i} of {n}")
        self._issue(i)
        for j in range(i + 1, min(i + self._window, n)):
            if j - self._window < 0 or j - self._window in self._retired:
                self._issue(j)
        return self._full[i]

    def retire(self, i: int, x):
        """Drop layer ``i``'s gathered parameters and release layer
        ``i + window``; returns ``x``."""
        self._full.pop(i, None)
        self._retired.add(i)
        return x


# --------------------------------------------------------------------- #
# ZeRO-3 over one data communicator
# --------------------------------------------------------------------- #


def _moment_tree(optimizer, params):
    """An optimizer over ``params``' leaves as the JAX-shaped state tree
    its layouts are read from: ``{"count": ..., key: params-structured
    tree, ...}`` for each per-parameter tensor state (``mu``, ``nu``,
    ``trace``); meta tensors, nothing copied."""
    leaves, spec = pytree.tree_flatten(params)
    held = [p for g in optimizer.param_groups for p in g["params"]]
    states = [optimizer.state[p] for p in held]
    tree = {"count": torch.empty((), dtype=torch.int32, device="meta")}
    for key in [k for k in states[0] if k != "count"] if states else ():
        tree[key] = pytree.tree_unflatten([
            torch.empty(leaf.shape, dtype=st[key].dtype, device="meta")
            for leaf, st in zip(leaves, states)], spec)
    return tree


class ShardedState:
    """ZeRO-3 / FSDP over one data communicator ``comm``: each leaf that
    :func:`~chainermn_tpu_torch.parallel.fsdp.fsdp_dims` gives a dim
    lives at rest as this rank's slice of it (:meth:`place`), the
    optimizer made over the slices keeps its elementwise moments at the
    same width (:meth:`init_opt_state`), and the step gathers a layer
    at a time (:meth:`gather_stream`) or the whole tree
    (:meth:`gather`).  ``taken`` marks dims another axis already claims
    (the JAX ``base_specs``)::

        sharded = ShardedState(params, mesh.comm("data"))
        local = sharded.place(params)            # 1/world a rank
        opt_state = sharded.init_opt_state(opt)  # moments alike
        stream = sharded.gather_stream(local)

    :meth:`layouts` is the table a ``topology_signature(sharding=
    "zero3")`` stamps; :meth:`local_bytes` the at-rest bytes a rank it
    predicts."""

    def __init__(self, params, comm, *, taken=None, min_size: int = 2,
                 wire_dtype=None, window: Optional[int] = None,
                 axis_name: str = "data"):
        from chainermn_tpu_torch.parallel.fsdp import fsdp_dims

        self.comm = comm
        self.axis_name = axis_name
        self.world = int(comm.size)
        self.wire_dtype = wire_dtype
        self.taken = taken
        self.dims = fsdp_dims(params, self.world, taken, min_size=min_size)
        self.window = 2 if window is None else max(1, int(window))
        self.params = None          # set by place()
        self.opt_state = None       # set by init_opt_state()
        self._template = pytree.tree_map(
            lambda p: torch.empty(tuple(p.shape), dtype=p.dtype,
                                  device="meta"), params)

    def place(self, params):
        """This rank's at-rest slice of every leaf (tensors of their
        own); kept as :attr:`params`."""
        from chainermn_tpu_torch.parallel.fsdp import fsdp_shard

        self.params = fsdp_shard(params, self.dims, self.comm.rank,
                                 self.world, self.taken)
        return self.params

    def init_opt_state(self, optimizer):
        """``optimizer.init`` over the placed slices: elementwise moments
        at their width.  Needs :meth:`place` first."""
        if self.params is None:
            raise RuntimeError("init_opt_state before place(params)")
        self.opt_state = optimizer.init(self.params)
        return self.opt_state

    def layouts(self, opt_state=None) -> Dict[str, List[LeafLayout]]:
        opt_state = opt_state if opt_state is not None else self.opt_state
        tree = None
        if opt_state is not None:
            tree = _moment_tree(opt_state, self._template) \
                if isinstance(opt_state, torch.optim.Optimizer) \
                else opt_state
        return state_layout_table("zero3", self._template, tree,
                                  world=self.world, dims=self.dims,
                                  axis=self.axis_name)

    def local_template(self):
        """Meta tensors shaped like one rank's at-rest slices."""
        return pytree.tree_unflatten([
            torch.empty(spec.local_shape(), dtype=getattr(torch, spec.dtype),
                        device="meta")
            for spec in self.layouts()["params"]],
            pytree.tree_structure(self._template))

    def local_bytes(self, world: Optional[int] = None) -> int:
        """At-rest parameter and optimizer-state bytes a rank, from the
        table."""
        table = self.layouts()
        return sum(spec.local_bytes(world) for spec in
                   table["params"] + table.get("opt_state", []))

    def gather(self, local_params, *, plan=None):
        """The whole tree at full width, one gather a sharded leaf."""
        from chainermn_tpu_torch.parallel.fsdp import fsdp_gather

        return fsdp_gather(local_params, self.dims, self.comm,
                           self.wire_dtype, plan=plan)

    def gather_stream(self, local_params, *, window: Optional[int] = None,
                      plan=None) -> LayerGatherStream:
        """A :class:`LayerGatherStream` over this layout."""
        return LayerGatherStream(
            local_params, self.dims, comm=self.comm,
            window=self.window if window is None else window,
            wire_dtype=self.wire_dtype, plan=plan)

    def payload_descs(self):
        raise _not_ported("ShardedState.payload_descs")

    def tune_gather_plan(self, comm, **kwargs):
        raise _not_ported("ShardedState.tune_gather_plan")

    def auto_window(self, layer_compute_s: float, max_window: int = 4):
        raise _not_ported("ShardedState.auto_window")

    def register_memory(self, accountant=None, prefix: str = "sharded"):
        raise _not_ported("ShardedState.register_memory")
