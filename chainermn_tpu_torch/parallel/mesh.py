"""MeshConfig — the named-axis mesh every strategy composes over, built
on a world communicator (the JAX package's ``parallel/mesh.py``).

The JAX package lays its devices out as a 5-axis ``jax.sharding.Mesh``
and runs each collective over an axis name.  The port works per rank,
one process a device, so the mesh is the world communicator with its
ranks laid out row-major over the axes in the JAX ``_AXIS_ORDER``
(``pipe``, ``data``, ``expert``, ``seq``, ``model``): rank ``r`` is the
JAX mesh's device ``r``, and rank ``r``'s tensor is still the JAX
world-stacked array's ``[r]``.  An axis name becomes a sub-communicator
(:meth:`MeshConfig.comm`): the ranks that share every other coordinate,
ranked by their coordinates on the named axes, built with
``comm.split``.
"""

from __future__ import annotations

from math import prod
from typing import Dict, Tuple

from chainermn_tpu_torch.communicators.loopback import LoopbackCommunicator

__all__ = ["MeshConfig"]

# canonical major→minor order, the JAX package's
_AXIS_ORDER = ("pipe", "data", "expert", "seq", "model")
# the axes the JAX step pmeans its loss over: every parameter is
# replicated over them, so their gradients are meaned over them (a
# model-sharded leaf is not averaged over model: each member's shard is
# its own)
BATCH_AXES = ("data", "expert", "seq")


class MeshConfig:
    """The 5-axis mesh over the ranks of ``comm`` (the world).

    One axis may be ``-1``: it absorbs what the others leave of the
    world (``data`` does by default).  Every axis of size 1 still exists.
    The sub-communicators of ``seq``, ``data``, the batch-like group
    ``("data", "expert", "seq")``, ``model``, ``pipe``, ``expert``, the
    batch rows' ``("data", "expert")``, the experts' gradient group
    ``("data", "seq")`` and FSDP's ``("expert", "seq")`` are built here,
    by every rank together and in that order (``split`` is collective:
    an NCCL group first split inside a block, by some ranks only,
    hangs);
    others on first use of :meth:`comm`, which every rank must then call
    in the same order.

    Example::

        mesh = MeshConfig(comm, data=2, seq=2)      # 4 ranks
        mesh.axis_index("seq"), mesh.comm("seq").size
    """

    def __init__(self, comm, *, data: int = -1, model: int = 1,
                 pipe: int = 1, seq: int = 1, expert: int = 1):
        sizes = {"pipe": pipe, "data": data, "expert": expert,
                 "seq": seq, "model": model}
        n = comm.size
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError("at most one axis may be -1")
        known = prod(v for v in sizes.values() if v != -1)
        if unknown:
            if n % known:
                raise ValueError(f"{n} devices not divisible by {known}")
            sizes[unknown[0]] = n // known
        total = prod(sizes.values())
        if total != n:
            raise ValueError(
                f"mesh {sizes} needs {total} devices, have {n}")
        self.world = comm
        self.shape: Dict[str, int] = {a: sizes[a] for a in _AXIS_ORDER}
        # row-major coordinates of this rank, minor axis last
        coords, r = {}, comm.rank
        for a in reversed(_AXIS_ORDER):
            coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self.coords: Dict[str, int] = {a: coords[a] for a in _AXIS_ORDER}
        self._comms: Dict[Tuple[str, ...], object] = {}
        for axes in (("seq",), ("data",), BATCH_AXES, ("model",),
                     ("pipe",), ("expert",), ("data", "expert"),
                     ("data", "seq"), ("expert", "seq")):
            self.comm(*axes)

    device = property(lambda self: self.world.device)

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    def axis_index(self, name: str) -> int:
        return self.coords[name]

    def _linear(self, axes) -> int:
        """This rank's row-major index over ``axes`` (in mesh order)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def comm(self, *axes: str):
        """The communicator over ``axes``: the ranks whose coordinates
        agree on every other axis, ranked row-major by their coordinates
        on ``axes`` (the JAX collective over those axis names).  The
        world itself when ``axes`` span it; a loopback communicator (no
        process group) when they hold one rank."""
        bad = set(axes) - set(_AXIS_ORDER)
        if bad or not axes:
            raise ValueError(f"axes {axes} not a non-empty subset of "
                             f"{_AXIS_ORDER}")
        key = tuple(a for a in _AXIS_ORDER if a in axes)
        if key not in self._comms:
            size = prod(self.shape[a] for a in key)
            if size == self.world.size:
                sub = self.world
            elif size == 1:
                sub = LoopbackCommunicator(device=self.world.device)
            else:
                rest = tuple(a for a in _AXIS_ORDER if a not in key)
                sub = self.world.split(self._linear(rest),
                                       self._linear(key))
            self._comms[key] = sub
        return self._comms[key]

    def __repr__(self) -> str:  # pragma: no cover
        return ("MeshConfig(" + ", ".join(
            f"{a}={self.shape[a]}" for a in _AXIS_ORDER) + ")")
