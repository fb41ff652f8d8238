"""Pipeline parallelism over the mesh's pipe axis: the GPipe, 1F1B and
interleaved 1F1B schedules (the JAX package's ``parallel/pipeline.py``),
one process a stage.

The JAX package states each schedule as one SPMD ``lax.scan`` of
``ticks``: every device runs its slot of every tick, the slots outside
the schedule's window compute garbage that masks discard, and the
backward of GPipe is the transpose of (scan ∘ ppermute).  The port runs
each schedule as an explicit tick loop on every rank, driven by tables
computed on the host (the same ones on every rank):

- a rank computes only its *active* slots, so the fill and drain
  garbage never exists;
- after each tick a rank posts one hand-off a direction over the pipe
  communicator (``_edge_send``: ``ops.point_to_point.ppermute``, a
  ``batch_isend_irecv``), holding exactly the edges whose sender's slot
  was active this tick and whose receiver's slot consumes the result in
  the next; every rank walks the same ticks and posts its part of the
  same hand-offs in the same order, so the transfers cannot cross;
- the backward is written out, not left to autograd: GPipe
  (:func:`pipeline_apply`) is one ``torch.autograd.Function`` whose
  forward runs the ticks under ``no_grad`` and keeps each stage input
  (``remat``; otherwise each stage application's graph) and whose
  backward walks the ticks in reverse, recomputes each stage under
  ``enable_grad`` and sends the input's gradient down; 1F1B and the
  interleaved schedule run forward and backward slots in one loop, the
  loss inside it (``(loss, stage_grads, loss_grads, dx)``, as JAX).

A value JAX keeps replicated over the pipe axis comes out of the port
the same bits on every pipe rank: the output of GPipe by a broadcast
from the last stage (:func:`_replicate_from`, whose backward is the mean
of the ranks' cotangents, kept on the last stage, as the JAX custom
VJP), the input's gradient and the loss parameters' by a broadcast from
the one stage that holds them (JAX's ``psum`` where only that stage is
nonzero, which is exact).

Parameters are per rank: ``stage_params`` is this rank's stage (the JAX
argument's ``[0]``), any tree of tensors, and its gradients come back in
the same tree; under the interleaved schedule it is a sequence of ``V``
chunk trees (:func:`unstack_stage_params` of the JAX ``(V, ...)``
stack).  ``edge_plan=`` (the collective-plan IR) raises.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from chainermn_tpu_torch.ops.point_to_point import ppermute
from chainermn_tpu_torch.parallel.tensor import reduce_from_model

__all__ = ["stack_stage_params", "pipeline_apply", "pipeline_train_1f1b",
           "pipeline_train_interleaved", "unstack_stage_params"]


def stack_stage_params(params_list):
    """Stack per-stage trees along a new leading stage axis (all stages
    share one structure)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *params_list)


def unstack_stage_params(stacked):
    """Inverse of :func:`stack_stage_params`."""
    n = pytree.tree_leaves(stacked)[0].shape[0]
    return [pytree.tree_map(lambda a: a[i], stacked) for i in range(n)]


class _ReplicateFrom(torch.autograd.Function):
    """The JAX ``_replicate_from``: forward, rank ``src``'s tensor on
    every rank of ``comm``; backward, the mean of the ranks' cotangents
    on ``src`` and zeros elsewhere.  Every rank differentiates its own
    copy of the same loss and seeds the same cotangent, so a plain
    transpose (the sum) would make the stage's gradients ``S`` times too
    large."""

    @staticmethod
    def forward(ctx, x, comm, src):
        ctx.comm, ctx.src = comm, src
        return comm.bcast(x.contiguous(), root=src)

    @staticmethod
    def backward(ctx, g):
        g = ctx.comm.allreduce(g.contiguous(), "mean")
        return (g if ctx.comm.rank == ctx.src else torch.zeros_like(g),
                None, None)


def _replicate_from(x, comm, src):
    return _ReplicateFrom.apply(x, comm, src)


def _no_plan(plan):
    if plan is not None:
        raise NotImplementedError(
            "edge_plan=... is not ported: the collective-plan IR is "
            "ROADMAP Queue A item 10")


def _edge_send(x, comm, perm, like):
    """One hand-off over the stage edges ``perm`` (``[(source, dest)]``,
    the same list on every rank), posted only by the ranks it names:
    this rank sends ``x`` where it is a source and returns what it
    receives where it is a dest (a tensor of ``like``, ``(shape,
    dtype)``), else None."""
    me = comm.rank
    if not any(me in pair for pair in perm):
        return None
    got = ppermute(x, comm, perm, like=like)
    return got if any(d == me for _, d in perm) else None


def _from_stage(x, comm, src):
    """``x`` of stage ``src`` on every rank of ``comm``: the JAX ``psum``
    over pipe of a value only that stage holds (zeros elsewhere), which
    is exact; a copy-free identity on one rank."""
    return x if comm.size == 1 else comm.bcast(x.contiguous(), root=src)


def _split(x, M):
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    return list(x.reshape(M, B // M, *x.shape[1:]).unbind(0))


def _with_aux(stage_fn, with_aux):
    """``stage_fn`` as ``(mb, aux)``: aux None when it has none."""
    return stage_fn if with_aux else (lambda p, mb: (stage_fn(p, mb), None))


def _grad_leaves(leaves):
    """Leaves the backward differentiates against: the same storage,
    detached, requiring grad."""
    return [t.detach().requires_grad_(t.is_floating_point())
            for t in leaves]


def _accumulate(acc, grads):
    for a, g in zip(acc, grads):
        if g is not None:
            a += g


# --------------------------------------------------------------------- #
# GPipe
# --------------------------------------------------------------------- #


def _gpipe_up(S, M, t):
    """The activation edges after GPipe's tick ``t``: stage ``i``
    forwards micro-batch ``t - i`` at tick ``t``, and stage ``i + 1``
    takes it at ``t + 1``."""
    return [(i, i + 1) for i in range(S - 1) if 0 <= t - i < M]


def _gpipe_forward(x, M, comm, step):
    """GPipe's forward ticks on this rank: ``step(m, inp)`` applies the
    stage to micro-batch ``m``'s input and returns ``(y, aux)``.
    Returns the last stage's ``(B, ...)`` output (zeros on the other
    stages) and the fp32 sum of this stage's real ticks' aux (zero
    without aux)."""
    S, s = comm.size, comm.rank
    mbs = _split(x, M)
    outs, act = [None] * M, None
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    like = (mbs[0].shape, mbs[0].dtype)
    for t in range(M + S - 1):
        m = t - s
        y = None
        if 0 <= m < M:
            y, aux = step(m, mbs[m] if s == 0 else act)
            if aux is not None:
                aux_acc = aux_acc + aux.float()
            if s == S - 1:
                outs[m] = y
        act = _edge_send(y if s < S - 1 else None, comm, _gpipe_up(S, M, t),
                         like)
    out = torch.cat(outs).reshape(x.shape) if s == S - 1 \
        else torch.zeros_like(x)
    return out, aux_acc


class _GPipe(torch.autograd.Function):
    """GPipe's schedule with its reverse as the backward.  Outputs: the
    last stage's ``(B, ...)`` output (zeros on the other stages) and
    this stage's aux sum over its real ticks (fp32, zero without aux)."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        fn, spec, comm, M, keep_graph = run
        ctx.run, ctx.x_meta = run, (x.shape, x.dtype)
        g_leaves = _grad_leaves(leaves)
        params = pytree.tree_unflatten(g_leaves, spec)
        kept = [None] * M

        def step(m, inp):
            if not keep_graph:
                kept[m] = inp
                return fn(params, inp)
            with torch.enable_grad():
                inp = inp.detach().requires_grad_()
                y, aux = fn(params, inp)
            kept[m] = (inp, y, aux)
            return y.detach(), None if aux is None else aux.detach()

        out, aux_acc = _gpipe_forward(x.detach(), M, comm, step)
        ctx.kept, ctx.g_leaves = kept, g_leaves
        return out, aux_acc

    @staticmethod
    def backward(ctx, g_out, g_aux):
        fn, spec, comm, M, keep_graph = ctx.run
        S, s = comm.size, comm.rank
        shape, dtype = ctx.x_meta
        g_leaves = ctx.g_leaves
        params = pytree.tree_unflatten(g_leaves, spec)
        g_outs = _split(g_out, M) if s == S - 1 else None
        like = (torch.Size((shape[0] // M, *shape[1:])), dtype)
        gp = [torch.zeros_like(t) if t.requires_grad else None
              for t in g_leaves]
        dx, ct = [None] * M, None
        for t in reversed(range(M + S - 1)):
            m = t - s
            dinp = None
            if 0 <= m < M:
                if keep_graph:
                    inp, y, aux = ctx.kept[m]
                else:
                    with torch.enable_grad():
                        inp = ctx.kept[m].detach().requires_grad_()
                        y, aux = fn(params, inp)
                ctx.kept[m] = None
                outs = [y]
                cts = [g_outs[m] if s == S - 1 else ct]
                if aux is not None:
                    # each real tick's aux enters the stage's sum once
                    outs.append(aux)
                    cts.append(g_aux.to(aux.dtype))
                want = [inp] + [t for t in g_leaves if t.requires_grad]
                grads = torch.autograd.grad(outs, want, cts,
                                            allow_unused=True)
                dinp = grads[0]
                if dinp is None:
                    dinp = torch.zeros_like(inp)
                _accumulate([a for a in gp if a is not None], grads[1:])
                if s == 0:
                    dx[m] = dinp
            # the cotangent edges before tick t: stage i + 1 took
            # micro-batch t - i - 1 at tick t, stage i takes it at t - 1
            down = [(i + 1, i) for i in range(S - 1) if 0 <= t - i - 1 < M]
            ct = _edge_send(dinp if s > 0 else None, comm, down, like)
        gx = None
        if ctx.needs_input_grad[1]:
            # x is the same on every stage and only stage 0 reads it:
            # its gradient is stage 0's, on every rank (JAX's psum over
            # pipe of x's cotangent, zeros off stage 0)
            gx = torch.cat(dx) if s == 0 else torch.empty(shape, dtype=dtype,
                                                          device=g_out.device)
            gx = _from_stage(gx.reshape(shape), comm, 0)
        ctx.kept = ctx.g_leaves = None
        return (None, gx, *gp)


def pipeline_apply(stage_fn: Callable, stage_params, x, *, comm,
                   num_microbatches: int, remat: bool = True,
                   with_aux: bool = False, checkpoint_fn: Callable = None,
                   edge_plan=None):
    """Run the GPipe schedule on every rank of ``comm`` (the pipe
    communicator): ``M`` micro-batches through ``S`` stages in ``M + S
    - 1`` ticks, bubble ``(S-1)/(M+S-1)``.

    Args:
      stage_fn: ``stage_fn(params, mb) -> mb``, one stage's computation;
        it keeps the micro-batch's shape and dtype.
      stage_params: this rank's stage weights (a tree of tensors).
      x: the local batch ``(B, ...)`` with ``B % num_microbatches ==
        0``, the same on every stage (only stage 0 reads it).
      remat: keep only each stage input and recompute the stage in the
        backward (GPipe's memory trick); else keep each stage
        application's graph.
      checkpoint_fn: wraps ``stage_fn`` (a policied checkpoint); the
        graph of the wrapped function is kept, and ``remat`` is
        ignored.
      with_aux: ``stage_fn`` returns ``(mb, aux_scalar)``; the aux of
        the real ticks is summed over stages and averaged over
        micro-batches, and the call returns ``(out, aux)``.

    Returns the ``(B, ...)`` output, the same on every stage (broadcast
    from the last); with ``with_aux`` ``(out, aux)``.  Differentiable in
    ``x`` and ``stage_params``; without gradients it runs the forward
    ticks alone.
    """
    _no_plan(edge_plan)
    M = num_microbatches
    leaves, spec = pytree.tree_flatten(stage_params)
    fn = _with_aux(stage_fn, with_aux)
    if checkpoint_fn is not None:
        fn, keep_graph = checkpoint_fn(fn), True
    else:
        keep_graph = not remat
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in leaves)):
        out, aux_acc = _GPipe.apply((fn, spec, comm, M, keep_graph), x,
                                    *leaves)
    else:
        params = pytree.tree_unflatten(leaves, spec)
        out, aux_acc = _gpipe_forward(x, M, comm,
                                      lambda m, inp: fn(params, inp))
    if comm.size > 1:
        out = _replicate_from(out, comm, comm.size - 1)
    if not with_aux:
        return out
    # the stages' sums added (identity backward: each stage's aux enters
    # the total once), averaged over the micro-batches
    return out, reduce_from_model(aux_acc, comm) / M


# --------------------------------------------------------------------- #
# 1F1B and the interleaved schedule
# --------------------------------------------------------------------- #


class _Ticks:
    """One rank's state in a schedule with the loss inside it: the stash
    of stage inputs, the gradient accumulators of each chunk and of the
    loss parameters, and the banks of the loss, ``dx`` and the aux."""

    def __init__(self, stage_chunks, loss_params, x, M, slots, is_last):
        flat = [pytree.tree_flatten(c) for c in stage_chunks]
        self.specs = [spec for _, spec in flat]
        self.chunks = [_grad_leaves(leaves) for leaves, _ in flat]
        self.gp = [[torch.zeros_like(t) for t in ls] for ls in self.chunks]
        lp_leaves, self.lp_spec = pytree.tree_flatten(loss_params)
        self.lp = _grad_leaves(lp_leaves) if is_last else lp_leaves
        self.glp = [torch.zeros_like(t) for t in lp_leaves]
        self.stash = [None] * slots
        self.x_shape, self.x_dtype = x.shape, x.dtype
        self.dx = [None] * M
        self.loss = torch.zeros((), dtype=torch.float32, device=x.device)
        self.aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def params(self, c):
        return pytree.tree_unflatten(self.chunks[c], self.specs[c])

    def forward_slot(self, raw, c, inp, slot):
        """Chunk ``c`` on ``inp`` without a graph; the input is stashed
        for the backward slot's recompute."""
        with torch.no_grad():
            y, aux = raw(self.params(c), inp)
        self.stash[slot] = inp
        if aux is not None:
            self.aux += aux.float()
        return y

    def backward_slot(self, raw, c, slot, ct, seed, loss_fn, tgt,
                      aux_weight):
        """Recompute chunk ``c`` on its stashed input and backpropagate
        ``ct`` (on the last virtual stage, ``seed``: the loss, seeded
        with one) and the aux, seeded with ``aux_weight``; returns the
        input's gradient."""
        leaves = self.chunks[c]
        with torch.enable_grad():
            inp = self.stash[slot].detach().requires_grad_()
            y, aux = raw(self.params(c), inp)
            if seed:
                loss = loss_fn(pytree.tree_unflatten(self.lp, self.lp_spec),
                               y, tgt)
                outs, cts = [loss], [torch.ones_like(loss)]
            else:
                outs, cts = [y], [ct]
            if aux is not None:
                outs.append(aux)
                cts.append(torch.full_like(aux, aux_weight))
            grads = torch.autograd.grad(
                outs, [inp] + leaves + (self.lp if seed else []), cts,
                allow_unused=True)
        self.stash[slot] = None
        _accumulate(self.gp[c], grads[1:1 + len(leaves)])
        if seed:
            _accumulate(self.glp, grads[1 + len(leaves):])
            self.loss += loss.detach().float()
        dinp = grads[0]
        return torch.zeros_like(inp) if dinp is None else dinp

    def results(self, comm, M, with_aux):
        """``(loss, [aux,] chunk_grads, loss_grads, dx)``, each meaned
        over the micro-batches: the loss and the loss parameters'
        gradients from the last stage and ``dx`` from the first, on
        every rank; a list of each chunk's gradients."""
        S = comm.size
        loss = _from_stage(self.loss, comm, S - 1) / M
        glp = pytree.tree_unflatten(
            [_from_stage(g, comm, S - 1) / M for g in self.glp],
            self.lp_spec)
        dx = torch.cat(self.dx).reshape(self.x_shape) if comm.rank == 0 \
            else torch.empty(self.x_shape, dtype=self.x_dtype,
                             device=self.loss.device)
        dx = _from_stage(dx, comm, 0) / M
        gp = [pytree.tree_unflatten([g / M for g in gs], spec)
              for gs, spec in zip(self.gp, self.specs)]
        # the stages' aux sums added: each stage banks its own
        aux = (comm.allreduce(self.aux, "sum") / M,) if with_aux else ()
        return (loss, *aux, gp, glp, dx)


def pipeline_train_1f1b(stage_fn: Callable, loss_fn: Callable,
                        stage_params, loss_params, x, targets, *, comm,
                        num_microbatches: int, with_aux: bool = False,
                        aux_weight: float = 1.0, edge_plan=None):
    """One-forward-one-backward (1F1B) training step with the loss
    inside the schedule, on every rank of ``comm`` (the pipe
    communicator).

    ``M + 2(S-1)`` ticks, each with a forward and a backward slot: stage
    ``s`` forwards micro-batch ``t - s`` and backwards micro-batch ``t -
    (2S-2-s)``.  The stage inputs wait in a ring of ``2S-1`` slots (the
    ``O(S)`` activation memory), and each backward slot recomputes its
    stage from the stashed input.

    Args:
      stage_fn: ``stage_fn(params, mb) -> mb`` (shape-preserving).
      loss_fn: ``loss_fn(loss_params, y, tgt) -> scalar`` on the last
        stage's output of each micro-batch.
      stage_params: this rank's stage weights.
      loss_params: the tree ``loss_fn`` uses, the same on every rank.
      x, targets: the local batch ``(B, ...)``.
      with_aux, aux_weight: ``stage_fn`` returns ``(mb, aux)``; each
        stage's aux is summed over stages and averaged over
        micro-batches, and its gradient flows with weight
        ``aux_weight``.

    Returns ``(loss, stage_grads, loss_grads, dx)``, each the mean over
    micro-batches (``(loss, aux, ...)`` with ``with_aux``): the loss,
    ``loss_grads`` and ``dx`` (the gradient of ``x``) the same on every
    rank, ``stage_grads`` this rank's, in ``stage_params``' tree.
    """
    _no_plan(edge_plan)
    S, s, M = comm.size, comm.rank, num_microbatches
    raw = _with_aux(stage_fn, with_aux)
    K = 2 * S - 1
    mbs, tgts = _split(x.detach(), M), _split(targets, M)
    state = _Ticks([stage_params], loss_params, x, M, K, s == S - 1)
    like = (mbs[0].shape, mbs[0].dtype)
    act = ct = None
    for t in range(M + 2 * (S - 1)):
        y = dinp = None
        m_f = t - s
        if 0 <= m_f < M:
            y = state.forward_slot(raw, 0, mbs[m_f] if s == 0 else act,
                                   m_f % K)
        m_b = t - (2 * S - 2 - s)
        if 0 <= m_b < M:
            dinp = state.backward_slot(raw, 0, m_b % K, ct, s == S - 1,
                                       loss_fn, tgts[m_b], aux_weight)
            if s == 0:
                state.dx[m_b] = dinp
        # the hand-offs to tick t + 1: activations up from the stages
        # that forwarded, cotangents down from those that backwarded
        up = [(i, i + 1) for i in range(S - 1) if 0 <= t - i < M]
        down = [(i + 1, i) for i in range(S - 1)
                if 0 <= t - (2 * S - 3 - i) < M]
        act = _edge_send(y if s < S - 1 else None, comm, up, like)
        ct = _edge_send(dinp if s > 0 else None, comm, down, like)
    *head, gp, glp, dx = state.results(comm, M, with_aux)
    return (*head, gp[0], glp, dx)


def _interleaved_tables(S: int, V: int, M: int):
    """Static tick tables for the interleaved 1F1B schedule (the JAX
    package's, host numpy).

    Device ``s`` holds ``V`` model chunks; virtual stage ``g = c·S + s``
    is chunk ``c`` on device ``s``.  Per Megatron's schedule, device
    ``s``'s forward slot ``k`` handles micro-batch ``(k // (S·V))·S + k
    % S`` of chunk ``(k % (S·V)) // S``; backward slots mirror it with
    chunks reversed, delayed by the warmup ``(S−s−1)·2 + (V−1)·S``.
    Staggering device ``s``'s slot sequence by ``s`` ticks makes every
    data dependency (chain, ring wrap, and the last virtual stage's
    same-tick loss seed) exactly one ring hop one tick earlier, which
    the function checks and raises on otherwise.

    Returns ``(T, f_act, f_m, f_c, b_act, b_m, b_c, K)``: tick count,
    ``(S, T)`` activity/micro-batch/chunk tables, and the stash ring
    depth.
    """
    if M % S:
        raise ValueError(
            f"interleaved schedule needs micro-batches ({M}) divisible "
            f"by the pipe axis ({S})")
    SV, MV = S * V, M * V
    T = 2 * (S - 1) + (V - 1) * S + MV
    f_act = np.zeros((S, T), bool)
    b_act = np.zeros((S, T), bool)
    f_m = np.zeros((S, T), np.int32)
    f_c = np.zeros((S, T), np.int32)
    b_m = np.zeros((S, T), np.int32)
    b_c = np.zeros((S, T), np.int32)
    for s in range(S):
        w = (S - s - 1) * 2 + (V - 1) * S
        for t in range(T):
            k = t - s
            if 0 <= k < MV:
                p = k % SV
                f_act[s, t] = True
                f_m[s, t] = (k // SV) * S + p % S
                f_c[s, t] = p // S
            j = t - s - w
            if 0 <= j < MV:
                p = j % SV
                b_act[s, t] = True
                b_m[s, t] = (j // SV) * S + p % S
                b_c[s, t] = V - 1 - p // S

    def _dep(cond, what, s, t):
        if not cond:
            raise RuntimeError(
                f"interleaved schedule: {what} dependency broken at "
                f"device {s} tick {t} (S={S} V={V} M={M})")

    for s in range(S):
        for t in range(T):
            if f_act[s, t] and not (s == 0 and f_c[s, t] == 0):
                ps, pc = (s - 1) % S, f_c[s, t] - (1 if s == 0 else 0)
                _dep(f_act[ps, t - 1] and f_m[ps, t - 1] == f_m[s, t]
                     and f_c[ps, t - 1] == pc, "forward", s, t)
            if b_act[s, t] and not (s == S - 1 and b_c[s, t] == V - 1):
                ns = (s + 1) % S
                nc = b_c[s, t] + (1 if s == S - 1 else 0)
                _dep(b_act[ns, t - 1] and b_m[ns, t - 1] == b_m[s, t]
                     and b_c[ns, t - 1] == nc, "backward", s, t)
            if b_act[s, t] and s == S - 1 and b_c[s, t] == V - 1:
                m = b_m[s, t]
                _dep(any(f_act[s, tt] and f_m[s, tt] == m
                         and f_c[s, tt] == V - 1
                         for tt in range(t + 1)), "loss-seed", s, t)

    K = 1
    for s in range(S):
        for c in range(V):
            events = []
            for t in range(T):
                if f_act[s, t] and f_c[s, t] == c:
                    events.append((t, 1))
                if b_act[s, t] and b_c[s, t] == c:
                    events.append((t + 1, -1))
            live = peak = 0
            for t, d in sorted(events):
                live += d
                peak = max(peak, live)
            K = max(K, peak)
    return T, f_act, f_m, f_c, b_act, b_m, b_c, K


def pipeline_train_interleaved(stage_fn: Callable, loss_fn: Callable,
                               stage_params, loss_params, x, targets, *,
                               comm, num_microbatches: int, num_chunks: int,
                               with_aux: bool = False,
                               aux_weight: float = 1.0, edge_plan=None):
    """Interleaved 1F1B (Megatron's virtual pipeline stages) on every
    rank of ``comm`` (the pipe communicator).

    Each rank holds ``num_chunks`` (V) model chunks; virtual stage ``g =
    c·S + s`` is chunk ``c`` of rank ``s``, and a micro-batch loops the
    ring ``V`` times.  The bubble shrinks from ``2(S-1)`` model-ticks to
    ``(2(S-1) + (V-1)S)/V`` for ``V`` times the stash and the ring's
    traffic.  The ticks are :func:`_interleaved_tables`'.

    Args:
      stage_fn: ``stage_fn(chunk_params, mb) -> mb``, one chunk.
      loss_fn: as :func:`pipeline_train_1f1b`, on the last virtual
        stage's output.
      stage_params: this rank's ``V`` chunks, a sequence of trees (chunk
        ``c`` is virtual stage ``c·S + s``).
      x, targets, with_aux, aux_weight: as :func:`pipeline_train_1f1b`;
        the aux sums over all ``S·V`` virtual stages.

    Returns ``(loss, stage_grads, loss_grads, dx)`` as
    :func:`pipeline_train_1f1b`, ``stage_grads`` a list of the ``V``
    chunks' gradients.
    """
    _no_plan(edge_plan)
    S, s, M, V = comm.size, comm.rank, num_microbatches, num_chunks
    if len(stage_params) != V:
        raise ValueError(f"stage_params chunk axis is {len(stage_params)}, "
                         f"expected num_chunks={V}")
    raw = _with_aux(stage_fn, with_aux)
    T, f_act, f_m, f_c, b_act, b_m, b_c, K = _interleaved_tables(S, V, M)
    mbs, tgts = _split(x.detach(), M), _split(targets, M)
    state = _Ticks(list(stage_params), loss_params, x, M, V * K,
                   s == S - 1)
    like = (mbs[0].shape, mbs[0].dtype)

    def injects(i, t):
        # rank i's forward slot at tick t takes a micro-batch from x
        return i == 0 and f_c[i, t] == 0

    def seeds(i, t):
        # rank i's backward slot at tick t is the last virtual stage's
        return i == S - 1 and b_c[i, t] == V - 1

    act = ct = None
    for t in range(T):
        y = dinp = None
        if f_act[s, t]:
            c, m = int(f_c[s, t]), int(f_m[s, t])
            y = state.forward_slot(raw, c, mbs[m] if injects(s, t) else act,
                                   c * K + m % K)
        if b_act[s, t]:
            c, m = int(b_c[s, t]), int(b_m[s, t])
            dinp = state.backward_slot(raw, c, c * K + m % K, ct,
                                       seeds(s, t), loss_fn, tgts[m],
                                       aux_weight)
            if s == 0 and c == 0:
                state.dx[m] = dinp
        # the hand-offs to tick t + 1 around the ring: an edge where the
        # receiver's next slot consumes the sender's result (the tables'
        # dependency check: it was produced one hop away, this tick)
        up, down = [], []
        if t + 1 < T:
            up = [(i, (i + 1) % S) for i in range(S)
                  if f_act[(i + 1) % S, t + 1] and not injects((i + 1) % S,
                                                                t + 1)]
            down = [(i, (i - 1) % S) for i in range(S)
                    if b_act[(i - 1) % S, t + 1] and not seeds((i - 1) % S,
                                                                t + 1)]
        act = _edge_send(y, comm, up, like)
        ct = _edge_send(dinp, comm, down, like)
    return state.results(comm, M, with_aux)
