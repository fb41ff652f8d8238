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

Not ported: the shard-only covering-set parts (``build_shard_part``,
``assemble_shard_state``, ``ShardSetError``; ``save_state(shard_part=...)``
raises, ROADMAP Queue A item 11) and the telemetry spans around a save
and a load (item 10).
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

__all__ = ["ForeignSnapshotError", "SnapshotCorruptError", "load_state",
           "load_state_with_stamps", "load_state_with_topology",
           "read_topology", "save_state", "tree_flatten", "tree_unflatten",
           "verify_state"]


class SnapshotCorruptError(RuntimeError):
    """A snapshot file failed its integrity check (bad CRC, missing
    leaf, undecodable meta, truncated archive).  Typed so recovery code
    (``MultiNodeCheckpointer.maybe_load``'s fallback) can tell "this
    file is damaged" from a programming error."""


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
    rides ``__meta__``, so a resume can read it without the leaves."""
    if shard_part is not None:
        raise NotImplementedError(
            "save_state(shard_part=...) is not ported to chainermn_tpu_torch "
            "yet (shard-only snapshot sets, ROADMAP Queue A item 11)")
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
    meta_bytes = pickle.dumps(meta)
    # the meta record guards itself: its CRC rides a separate array, so
    # a flipped bit inside the pickle is a typed error
    payload["__meta__"] = np.frombuffer(meta_bytes, dtype=np.uint8)
    payload["__meta_crc__"] = np.asarray(
        [zlib.crc32(meta_bytes) & 0xFFFFFFFF], dtype=np.uint64)
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
    with _open(path) as z:
        meta = _read_meta(z, path)
        for _ in _checked_leaves(z, meta, path):
            pass


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
    """``(tree, topology, shard_part)`` from one checked read; the
    port writes no shard parts, so ``shard_part`` is the stamp a file
    carries or ``None``."""
    with _open(path) as z:
        meta = _read_meta(z, path)
        leaves = [_typed(arr, meta["dtypes"][i])
                  for i, arr in _checked_leaves(z, meta, path)]
    return (tree_unflatten(meta["treedef"], leaves), meta.get("topology"),
            meta.get("shard_part"))
