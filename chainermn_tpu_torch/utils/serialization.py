"""Tree snapshots — the JAX package's ``utils/serialization.py``
container, for per-rank tensors.

Format (the JAX package's, so the two packages write the same files
for the same numpy tree): one ``.npz`` holding every leaf as a named
array (``leaf_00000``, ...), a pickled ``__meta__`` record and its
CRC32 in ``__meta_crc__``.  ``__meta__`` holds the tree's structure,
each leaf's true dtype (``dtypes``), each leaf's CRC32 (``crcs``),
``meta_crc_excluded`` and, optionally, the ``topology`` stamp.  A file
is written to ``.tmp`` and renamed into place (``os.replace``), so a
crash never leaves a torn snapshot under the real name.

Leaves are flattened by JAX's rule, not ``torch.utils._pytree``'s: dict
keys in sorted order, lists and tuples (and named tuples, by field) in
order, ``None`` a node with no leaf.  So ``leaf_i`` names the same
array in both packages.  The structure is stored as a builtins-only
record (:func:`tree_flatten`), never as a jax object; ``__meta__`` is
read through an unpickler that admits no class at all, so a file the
JAX package wrote (its ``__meta__`` pickles a jax treedef) is refused
with :class:`ForeignSnapshotError` instead of importing jax.

numpy has no bfloat16 without ``ml_dtypes``: a bf16 tensor is stored as
its ``uint16`` view with ``"bfloat16"`` in ``dtypes`` (the JAX package
records the same name), so the CRC covers the same bytes, and it loads
back as a CPU ``torch.bfloat16`` tensor over those bytes.  Every other
leaf loads as a numpy array, as in the JAX package.

Shard-only covering sets (the JAX package's): one logical snapshot
split into per-member PART files.  Part ``m`` holds member ``m``'s rows
of every ``shard``-kind optimizer leaf (the topology's ``opt_leaves``)
and member ``m``'s slice of every ``fsdp``-kind leaf; the ROOT part
(member 0's) also holds every other entry once, so a set costs about
one state whatever the world size.  :func:`build_shard_part` cuts one
part and :func:`assemble_shard_state` rebuilds the world-stacked state
from a covering set, checking that the parts tile ``[0, world)``; the
part record rides ``__meta__`` beside the topology stamp
(``save_state(shard_part=)``, :func:`load_state_with_stamps`).  A
ZeRO-1/2 set keeps the record's v1 format, one with ``fsdp`` leaves is
v2.  A port rank holds only its own rows: :func:`build_shard_part`
takes a world-stacked leaf and cuts ``[lo, hi)`` from it, or a leaf
that already holds just those rows (leading dim ``hi - lo``, or an
``fsdp`` dim of ``(hi - lo)/world`` of its recorded length).

The flight recorder (:mod:`~chainermn_tpu_torch.utils.telemetry`)
times a save (``checkpoint/save``, with the leaf count and the bytes),
a checked load (``checkpoint/load``) and an integrity walk
(``checkpoint/crc_walk``), the JAX package's spans.
"""

from __future__ import annotations

import collections
import io
import os
import pickle
import zipfile
import zlib

import numpy as np
import torch

__all__ = ["ForeignSnapshotError", "SHARD_PART_FORMAT", "ShardSetError",
           "SnapshotCorruptError", "assemble_shard_state",
           "build_shard_part", "fsdp_leaf_entries", "load_state",
           "load_state_with_stamps", "load_state_with_topology",
           "read_shard_part", "read_topology", "save_state",
           "shard_leaf_indices", "sorted_keys", "tree_flatten",
           "tree_unflatten", "verify_state"]


class SnapshotCorruptError(RuntimeError):
    """A snapshot file failed its integrity check (bad CRC, missing
    leaf, undecodable meta, truncated archive).  Typed so recovery code
    (``MultiNodeCheckpointer.maybe_load``'s fallback) can tell "this
    file is damaged" from a programming error."""


class ShardSetError(RuntimeError):
    """Shard-only part files that do not form a covering set (a member
    missing or twice, worlds or leaf lists that disagree, no root part).
    The checkpointer's fallback treats it like corruption: it skips the
    set and tries the next."""


#: the ``shard_part`` record's version; v2 adds the ``fsdp`` entries,
#: and a v1 (ZeRO-1/2) set is still read
SHARD_PART_FORMAT = 2
_SHARD_PART_ACCEPTED = (1, 2)


class ForeignSnapshotError(SnapshotCorruptError):
    """The file's ``__meta__`` names a class: it was not written by this
    package (a JAX-package snapshot pickles a jax treedef).  A subclass
    of :class:`SnapshotCorruptError`, so a checkpoint directory holding
    one treats it as unusable and falls back."""


# what numpy, zip and pickle raise on a damaged or truncated archive;
# each is re-raised as SnapshotCorruptError
_UNREADABLE = (OSError, ValueError, EOFError, KeyError, IndexError,
               zipfile.BadZipFile, pickle.UnpicklingError)


# --------------------------------------------------------------------- #
# JAX's flatten rule over builtins
# --------------------------------------------------------------------- #

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree):
    """``(leaves, treedef)`` by JAX's rule.  ``treedef`` is a nested
    list of builtins: ``["leaf"]``, ``["none"]``, ``["dict", keys,
    children]``, ``["list", children]``, ``["tuple", children]`` or
    ``["namedtuple", name, fields, children]``."""
    leaves = []

    def walk(x):
        if x is None:
            return ["none"]
        if isinstance(x, dict):
            keys = sorted(x)
            return ["dict", keys, [walk(x[k]) for k in keys]]
        if _is_namedtuple(x):
            return ["namedtuple", type(x).__name__, list(x._fields),
                    [walk(v) for v in x]]
        if isinstance(x, (list, tuple)):
            return ["list" if isinstance(x, list) else "tuple",
                    [walk(v) for v in x]]
        leaves.append(x)
        return ["leaf"]

    treedef = walk(tree)
    return leaves, treedef


def sorted_keys(tree):
    """``tree`` (dicts and lists) with every dict's keys inserted in
    sorted order, so ``torch.utils._pytree`` walks it in this
    container's (JAX's) leaf order."""
    if isinstance(tree, dict):
        return {k: sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [sorted_keys(v) for v in tree]
    return tree


_NAMEDTUPLES: dict = {}


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`.  A named tuple comes back as a
    named tuple of the same name and fields (a class made here: the
    file names no class)."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        if kind == "list":
            return [build(c) for c in node[1]]
        if kind == "tuple":
            return tuple(build(c) for c in node[1])
        if kind == "namedtuple":
            key = (node[1], tuple(node[2]))
            cls = _NAMEDTUPLES.get(key)
            if cls is None:
                cls = _NAMEDTUPLES[key] = collections.namedtuple(*key)
            return cls(*(build(c) for c in node[3]))
        raise ValueError(f"unknown tree node {kind!r}")

    out = build(treedef)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


# --------------------------------------------------------------------- #
# leaves
# --------------------------------------------------------------------- #

def _host_array(leaf):
    """``(array, dtype name)`` of one leaf on the host.  A tensor on the
    card is copied; a CPU tensor or a numpy array is viewed, which is
    safe because the caller writes it before anything mutates it (the
    checkpointer's async path hands this function its own copies)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(
                np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _leaf_crc(arr: np.ndarray) -> int:
    # the bytes of the C-contiguous values, as the JAX package's
    # ``tobytes()`` sees them, without a second copy of the leaf
    flat = np.ascontiguousarray(arr).reshape(-1)
    return zlib.crc32(flat.view(np.uint8)) & 0xFFFFFFFF


def save_state(path: str, pytree, topology=None, shard_part=None) -> None:
    """Atomically write ``pytree`` (tensors, numpy arrays, numbers) to
    ``path``.  ``topology`` (a dict of builtins,
    :func:`~chainermn_tpu_torch.training.elastic.topology_signature`)
    and ``shard_part`` (:func:`build_shard_part`'s record) ride
    ``__meta__``, so a resume can read them without the leaves."""
    from chainermn_tpu_torch.utils.telemetry import get_recorder

    with get_recorder().span("checkpoint/save", cat="checkpoint",
                             path=os.path.basename(path)) as sp:
        leaves, treedef = tree_flatten(pytree)
        payload, dtypes, crcs = {}, [], []
        for i, leaf in enumerate(leaves):
            arr, dtype = _host_array(leaf)
            payload[f"leaf_{i:05d}"] = arr
            dtypes.append(dtype)
            crcs.append(_leaf_crc(arr))
        meta = {"treedef": treedef, "dtypes": dtypes, "crcs": crcs,
                "meta_crc_excluded": True}
        if topology is not None:
            meta["topology"] = topology
        if shard_part is not None:
            meta["shard_part"] = shard_part
        meta_bytes = pickle.dumps(meta)
        # the meta record guards itself: its CRC rides a separate array,
        # so a flipped bit inside the pickle is a typed error
        payload["__meta__"] = np.frombuffer(meta_bytes, dtype=np.uint8)
        payload["__meta_crc__"] = np.asarray(
            [zlib.crc32(meta_bytes) & 0xFFFFFFFF], dtype=np.uint64)
        sp.set(n_leaves=len(leaves),
               nbytes=int(sum(a.nbytes for a in payload.values())))
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)    # atomic on POSIX: no torn snapshots


# --------------------------------------------------------------------- #
# reading
# --------------------------------------------------------------------- #

class _MetaUnpickler(pickle.Unpickler):
    """Admits builtins only: the port's ``__meta__`` names no class."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib"):
            raise ForeignSnapshotError(
                f"__meta__ pickles {module}.{name}: this snapshot was "
                "written by the JAX package (chainermn_tpu), whose meta "
                "holds a jax treedef; chainermn_tpu_torch reads only its "
                "own files")
        raise ForeignSnapshotError(
            f"__meta__ pickles {module}.{name}: not a chainermn_tpu_torch "
            "snapshot (its meta holds builtins only)")


def _open(path: str):
    """The open npz; ``FileNotFoundError`` propagates ("gone" is not
    "damaged": a peer's GC may have removed the file)."""
    try:
        return np.load(path, allow_pickle=False)
    except FileNotFoundError:
        raise
    except _UNREADABLE as e:
        raise SnapshotCorruptError(
            f"{path}: not a readable npz archive "
            f"({type(e).__name__}: {e})") from e


def _read_meta(z, path: str) -> dict:
    """Decode and integrity-check the ``__meta__`` record."""
    try:
        meta_bytes = z["__meta__"].tobytes()
        want = int(z["__meta_crc__"][0]) \
            if "__meta_crc__" in z.files else None
    except _UNREADABLE as e:
        raise SnapshotCorruptError(
            f"{path}: snapshot has no readable __meta__ record "
            f"({type(e).__name__}: {e})") from e
    if want is not None:
        got = zlib.crc32(meta_bytes) & 0xFFFFFFFF
        if got != want:
            raise SnapshotCorruptError(
                f"{path}: __meta__ CRC mismatch "
                f"(recorded {want:#010x}, computed {got:#010x})")
    try:
        meta = _MetaUnpickler(io.BytesIO(meta_bytes)).load()
    except ForeignSnapshotError as e:
        raise ForeignSnapshotError(f"{path}: {e}") from e
    except _UNREADABLE as e:
        raise SnapshotCorruptError(
            f"{path}: __meta__ record does not unpickle "
            f"({type(e).__name__}: {e})") from e
    if not isinstance(meta, dict) or "dtypes" not in meta \
            or "treedef" not in meta:
        raise SnapshotCorruptError(f"{path}: __meta__ is not a snapshot "
                                   "record")
    return meta


def _checked_leaves(z, meta: dict, path: str):
    """``(index, array)`` of every leaf, CRC-checked when the file
    recorded checksums."""
    crcs = meta.get("crcs")
    for i in range(len(meta["dtypes"])):
        key = f"leaf_{i:05d}"
        try:
            arr = z[key]
        except _UNREADABLE as e:
            raise SnapshotCorruptError(
                f"{path}: leaf {i} ({key}) unreadable "
                f"({type(e).__name__}: {e})") from e
        if crcs is not None:
            got = _leaf_crc(arr)
            if got != crcs[i]:
                raise SnapshotCorruptError(
                    f"{path}: leaf {i} CRC mismatch (recorded "
                    f"{crcs[i]:#010x}, computed {got:#010x}): the bytes "
                    "were corrupted on disk")
        yield i, arr


def _typed(arr: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype)
    return arr if arr.dtype == want else arr.view(want)


def verify_state(path: str) -> None:
    """Raise :class:`SnapshotCorruptError` unless ``path`` is a
    complete, checksum-clean snapshot; a missing file raises
    ``FileNotFoundError``.  Reads every leaf, builds no tree."""
    from chainermn_tpu_torch.utils.telemetry import get_recorder

    z = _open(path)
    with get_recorder().span("checkpoint/crc_walk", cat="checkpoint",
                             path=os.path.basename(path)), z:
        meta = _read_meta(z, path)
        for _ in _checked_leaves(z, meta, path):
            pass


def read_shard_part(path: str):
    """The ``shard_part`` record stamped into ``path`` (``None`` for a
    full snapshot); reads the meta record only."""
    with _open(path) as z:
        return _read_meta(z, path).get("shard_part")


def read_topology(path: str):
    """The topology stamped into ``path``'s ``__meta__`` (``None`` when
    none was); reads the meta record only."""
    with _open(path) as z:
        return _read_meta(z, path).get("topology")


def load_state(path: str):
    """Inverse of :func:`save_state`: the tree, every leaf a numpy array
    (a bf16 leaf a CPU ``torch.bfloat16`` tensor).  Raises
    :class:`SnapshotCorruptError` on any integrity failure."""
    return load_state_with_stamps(path)[0]


def load_state_with_topology(path: str):
    """``(tree, topology)`` from one checked read."""
    tree, topology, _ = load_state_with_stamps(path)
    return tree, topology


def load_state_with_stamps(path: str):
    """``(tree, topology, shard_part)`` from one checked read
    (``shard_part`` ``None`` for a full snapshot)."""
    from chainermn_tpu_torch.utils.telemetry import get_recorder

    z = _open(path)
    with get_recorder().span("checkpoint/load", cat="checkpoint",
                             path=os.path.basename(path)) as sp, z:
        meta = _read_meta(z, path)
        leaves = [_typed(arr, meta["dtypes"][i])
                  for i, arr in _checked_leaves(z, meta, path)]
        sp.set(n_leaves=len(leaves))
    return (tree_unflatten(meta["treedef"], leaves), meta.get("topology"),
            meta.get("shard_part"))


# --------------------------------------------------------------------- #
# shard-only covering sets
# --------------------------------------------------------------------- #

def shard_leaf_indices(topology) -> list:
    """Flat ``opt_state`` leaf indices the topology's per-leaf layout
    marks ``shard``: the only leaves a ZeRO-1/2 set splits."""
    layouts = (topology or {}).get("opt_leaves") or []
    return [i for i, spec in enumerate(layouts)
            if spec.get("kind") == "shard"]


def fsdp_leaf_entries(topology, key: str = "opt_leaves") -> list:
    """Flat ``(leaf index, shard dim)`` pairs of the ``fsdp`` records
    under ``key`` (``"opt_leaves"`` or ``"param_leaves"``)."""
    layouts = (topology or {}).get(key) or []
    return [(i, int(spec["dim"])) for i, spec in enumerate(layouts)
            if spec.get("kind") == "fsdp"]


def _fsdp_lengths(topology, key: str) -> dict:
    layouts = (topology or {}).get(key) or []
    return {i: spec.get("len") for i, spec in enumerate(layouts)
            if spec.get("kind") == "fsdp"}


def _member_rows(leaf, lo: int, hi: int, world: int):
    """Member rows ``[lo, hi)`` of a world-stacked leaf, or the leaf
    itself when it holds just those rows."""
    shape = tuple(leaf.shape)
    if shape and shape[0] == world:
        return leaf[lo:hi]
    if shape and shape[0] == hi - lo:
        return leaf
    raise ValueError(
        f"shard leaf has shape {shape}; expected a leading axis of the "
        f"world {world} or of the members [{lo}, {hi})")


def _dim_rows(leaf, lo: int, hi: int, world: int, dim: int, length):
    """Members ``[lo, hi)``'s slice of a dim-sharded leaf along ``dim``:
    cut from the full leaf, or the leaf itself when it is that slice."""
    shape = tuple(leaf.shape)
    full = shape[dim] if length is None else int(length)
    if dim >= len(shape) or full % world:
        raise ValueError(
            f"fsdp leaf has shape {shape}; expected dim {dim} of length "
            f"{full} divisible by world {world}")
    w = full // world
    if shape[dim] == full:
        idx = [slice(None)] * len(shape)
        idx[dim] = slice(lo * w, hi * w)
        return leaf[tuple(idx)]
    if shape[dim] == (hi - lo) * w:
        return leaf
    raise ValueError(
        f"fsdp leaf has {shape[dim]} elements along dim {dim}: neither "
        f"the full {full} nor members [{lo}, {hi})'s {(hi - lo) * w}")


def build_shard_part(state: dict, topology: dict, lo: int, hi: int,
                     *, root: bool):
    """One part of a shard-only covering set: ``(part_state,
    shard_part_record)`` for members ``[lo, hi)``.

    The root part is the checkpointer's state dict with every ``shard``
    leaf of ``opt_state`` cut to its rows (and every ``fsdp`` leaf of
    ``opt_state`` and ``params`` to its slice); a non-root part holds
    only ``{"shards": {leaf_XXXXX: rows}}`` (and ``"param_shards"``
    under FSDP).  The record names the range, the world and the leaf
    indices, so assembly never re-derives the layout."""
    world = int(topology["world_size"])
    if not 0 <= lo < hi <= world:
        raise ValueError(f"member range [{lo}, {hi}) not in [0, {world})")
    idxs = shard_leaf_indices(topology)
    fsdp_opt = fsdp_leaf_entries(topology, "opt_leaves")
    fsdp_par = fsdp_leaf_entries(topology, "param_leaves")
    len_opt = _fsdp_lengths(topology, "opt_leaves")
    len_par = _fsdp_lengths(topology, "param_leaves")
    leaves, treedef = tree_flatten(state["opt_state"])
    p_leaves, p_treedef = tree_flatten(state["params"]) if fsdp_par \
        else (None, None)
    rows = {i: _member_rows(leaves[i], lo, hi, world) for i in idxs}
    rows.update({i: _dim_rows(leaves[i], lo, hi, world, d, len_opt[i])
                 for i, d in fsdp_opt})
    p_rows = {i: _dim_rows(p_leaves[i], lo, hi, world, d, len_par[i])
              for i, d in fsdp_par}
    if root:
        part = dict(state)
        part["opt_state"] = tree_unflatten(
            treedef, [rows.get(i, leaf) for i, leaf in enumerate(leaves)])
        if fsdp_par:
            part["params"] = tree_unflatten(p_treedef, [
                p_rows.get(i, leaf) for i, leaf in enumerate(p_leaves)])
    else:
        part = {"shards": {f"leaf_{i:05d}": v for i, v in rows.items()}}
        if fsdp_par:
            part["param_shards"] = {f"leaf_{i:05d}": v
                                    for i, v in p_rows.items()}
    record = {"format": SHARD_PART_FORMAT, "members": [int(lo), int(hi)],
              "world": world, "root": bool(root),
              "shard_leaves": [int(i) for i in idxs]}
    if fsdp_opt or fsdp_par:
        record["fsdp_opt_leaves"] = [[int(i), int(d)] for i, d in fsdp_opt]
        record["fsdp_param_leaves"] = [[int(i), int(d)]
                                       for i, d in fsdp_par]
    else:
        # a ZeRO-1/2 set keeps the v1 record, which older readers take
        record["format"] = 1
    return part, record


def _cat(rows, axis: int):
    """Concatenate numpy rows, or tensors (a loaded bf16 leaf)."""
    if any(torch.is_tensor(r) for r in rows):
        return torch.cat([torch.as_tensor(r) for r in rows], dim=axis)
    return np.concatenate([np.asarray(r) for r in rows], axis=axis)


def assemble_shard_state(parts) -> dict:
    """The full (world-stacked) state dict from a COVERING set of parts
    (``(shard_part_record, part_state)`` pairs, any order): exactly one
    root, member ranges tiling ``[0, world)``, every part agreeing on
    the world, format and leaf lists (else :class:`ShardSetError`).
    Each ``shard`` leaf is the member-order concatenation of the parts'
    rows, each ``fsdp`` leaf of their slices: bitwise the state a full
    save of the world-stacked state writes."""
    parts = list(parts)
    if not parts:
        raise ShardSetError("no shard parts to assemble")
    roots = [(rec, st) for rec, st in parts if rec.get("root")]
    if len(roots) != 1:
        raise ShardSetError(
            f"covering set needs exactly one root part, got {len(roots)}")
    root_rec, root_state = roots[0]
    fmt = int(root_rec.get("format", -1))
    if fmt not in _SHARD_PART_ACCEPTED:
        raise ShardSetError(
            f"unknown shard_part format {root_rec.get('format')!r} "
            f"(this reader speaks {sorted(_SHARD_PART_ACCEPTED)})")
    world = int(root_rec["world"])

    def lists(rec):
        return ([int(i) for i in rec.get("shard_leaves", [])],
                [(int(i), int(d)) for i, d in rec.get("fsdp_opt_leaves",
                                                      [])],
                [(int(i), int(d)) for i, d in rec.get("fsdp_param_leaves",
                                                      [])])

    idxs, fsdp_opt, fsdp_par = lists(root_rec)
    ranges = []
    for rec, _ in parts:
        if int(rec.get("world", -1)) != world \
                or lists(rec) != (idxs, fsdp_opt, fsdp_par) \
                or int(rec.get("format", -1)) != fmt:
            raise ShardSetError(
                "shard parts disagree on world/leaf layout — files "
                "from different sets were mixed")
        ranges.append((int(rec["members"][0]), int(rec["members"][1])))
    order = sorted(range(len(parts)), key=lambda k: ranges[k])
    cursor = 0
    for k in order:
        lo, hi = ranges[k]
        if lo != cursor:
            raise ShardSetError(
                f"member ranges do not tile [0, {world}): gap or "
                f"overlap at member {cursor} (next part covers "
                f"[{lo}, {hi}))")
        cursor = hi
    if cursor != world:
        raise ShardSetError(
            f"member ranges stop at {cursor}, but the set's world is "
            f"{world} — the covering set is incomplete")

    def collect(i, container_key, state_key):
        key = f"leaf_{i:05d}"
        rows = []
        for k in order:
            rec, st = parts[k]
            if rec.get("root"):
                rows.append(tree_flatten(st[state_key])[0][i])
            elif key not in st.get(container_key, {}):
                raise ShardSetError(
                    f"part covering {rec['members']} is missing shard "
                    f"leaf {key}")
            else:
                rows.append(st[container_key][key])
        return rows

    leaves, treedef = tree_flatten(root_state["opt_state"])
    new = list(leaves)
    for i in idxs:
        new[i] = _cat(collect(i, "shards", "opt_state"), 0)
    for i, dim in fsdp_opt:
        new[i] = _cat(collect(i, "shards", "opt_state"), dim)
    out = dict(root_state)
    out["opt_state"] = tree_unflatten(treedef, new)
    if fsdp_par:
        p_leaves, p_treedef = tree_flatten(root_state["params"])
        p_new = list(p_leaves)
        for i, dim in fsdp_par:
            p_new[i] = _cat(collect(i, "param_shards", "params"), dim)
        out["params"] = tree_unflatten(p_treedef, p_new)
    return out
