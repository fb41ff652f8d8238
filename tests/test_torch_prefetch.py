"""The port's prefetching feed (``chainermn_tpu_torch.iterators.prefetch``)
and the updater's ``prefetch=`` on the CPU, against the serial feed and
the JAX package's ``PrefetchIterator``.

The batch stream is a move of the same numpy data, so it must be bitwise
the serial path's and the JAX package's; training with prefetch on is
bitwise the serial run; a checkpoint taken with prefetch on resumes
bitwise, and neither the save nor the restore pulls a batch again.  The card's side (pinned
staging, the copy stream, the event fence) is in ``test_torch_cuda.py``.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import chainermn_tpu as jcmn
from chainermn_tpu.iterators import prefetch as jprefetch
from chainermn_tpu_torch import training
from chainermn_tpu_torch.communicators import LoopbackCommunicator
from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
from chainermn_tpu_torch.iterators import (
    DeviceWindow,
    PrefetchIterator,
    SerialIterator,
    StagingConverter,
    default_converter,
)
from chainermn_tpu_torch.models import (
    init_mlp_numpy,
    mlp_apply,
    mlp_params_from_jax,
    softmax_cross_entropy,
)
from chainermn_tpu_torch.native import NativeBatchIterator, _native_perm


@pytest.fixture()
def comm():
    return LoopbackCommunicator(device="cpu")


def _examples(n=30):
    rng = np.random.RandomState(0)
    return [(rng.randn(4).astype(np.float32), np.int32(i % 3))
            for i in range(n)]


def _serial_stream(it, converter, n):
    return [tuple(torch.as_tensor(a).clone() for a in converter(next(it)))
            for _ in range(n)]


def test_staging_converter_matches_the_jax_packages():
    batches = [_examples()[i:i + 8] for i in (0, 8, 16, 22)]
    port, ref = StagingConverter(n_buffers=2), jprefetch.StagingConverter(2)
    for b in batches:
        got, want = port(b), ref(b)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        assert port.owns_buffers(got) and not port.owns_buffers(
            tuple(np.array(g) for g in got))
    stacked = (np.ones((3, 2), np.float32), np.zeros(3, np.int32))
    assert port(stacked) is stacked             # passed through, unpinned
    assert port.pinned_tensor(stacked[0]) is None
    with pytest.raises(ValueError, match="at least 2"):
        StagingConverter(n_buffers=1)
    with pytest.raises(ValueError, match="empty batch"):
        port([])


@pytest.mark.parametrize("depth", [1, 3])
def test_window_stream_equals_the_serial_and_jax_feeds(comm, depth):
    """Two epochs of a shuffled list dataset with a ragged last batch."""
    data = _examples(30)
    serial = _serial_stream(SerialIterator(data, 8, shuffle=True, seed=4),
                            default_converter, 8)
    pf = PrefetchIterator(SerialIterator(data, 8, shuffle=True, seed=4),
                          comm, depth=depth)
    jax_pf = jprefetch.PrefetchIterator(
        jcmn.SerialIterator(data, 8, shuffle=True, seed=4),
        jcmn.create_communicator("tpu_xla", devices=jax.devices()[:1]),
        depth=depth)
    epochs = []
    for want in serial:
        rec = next(pf)
        jrec = next(jax_pf)
        assert isinstance(rec, DeviceWindow) and rec.k == 1 \
            and rec.tail is None and rec.event is None
        for g, w, j in zip(rec.arrays, want, jrec.arrays):
            assert g.device.type == "cpu"
            assert torch.equal(g, w)
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        epochs.append((pf.epoch, pf.is_new_epoch, pf.epoch_detail))
        assert (jrec.epoch, jrec.is_new_epoch) == epochs[-1][:2]
    assert [e[0] for e in epochs] == [0, 0, 0, 1, 1, 1, 1, 2]
    pf.close()
    jax_pf.close()


class _Boom:
    def __init__(self, fail_at):
        self.n, self.fail_at = 0, fail_at

    def __next__(self):
        self.n += 1
        if self.n == self.fail_at:
            raise KeyError("bad example")
        return np.full((2, 3), self.n, np.float32)


def test_worker_exception_reraises_from_next(comm):
    pf = PrefetchIterator(_Boom(3), comm, depth=2)
    assert float(next(pf).arrays[0][0, 0]) == 1.0
    assert float(next(pf).arrays[0][0, 0]) == 2.0
    with pytest.raises(KeyError, match="bad example"):
        next(pf)
    with pytest.raises(KeyError):               # sticky
        next(pf)
    assert pf._thread is None


def test_close_joins_the_worker(comm):
    before = threading.active_count()
    pf = PrefetchIterator(SerialIterator(_examples(), 4), comm, depth=2)
    next(pf)
    thread = pf._thread
    assert thread.is_alive()
    pf.close()
    assert not thread.is_alive() and pf._thread is None
    pf.close()                                   # idempotent
    assert threading.active_count() == before
    with PrefetchIterator(SerialIterator(_examples(), 4), comm) as pf2:
        next(pf2)
    assert pf2._thread is None


def test_state_dict_mid_epoch_rewinds_exactly(comm):
    data = _examples(30)
    pf = PrefetchIterator(SerialIterator(data, 8, shuffle=True, seed=2),
                          comm, depth=3)
    ref = SerialIterator(data, 8, shuffle=True, seed=2)
    for _ in range(2):
        next(pf)
        next(ref)
    st = pf.state_dict()                         # the worker ran ahead
    want = ref.state_dict()
    assert st.keys() == want.keys()
    for k in st:
        np.testing.assert_array_equal(st[k], want[k])
    tail = _serial_stream(ref, default_converter, 5)
    for w in tail:                               # the buffered lookahead
        assert all(torch.equal(g, x) for g, x in zip(next(pf).arrays, w))
    fresh = PrefetchIterator(SerialIterator(data, 8, shuffle=True, seed=9),
                             comm)
    fresh.load_state_dict(st)
    assert fresh.epoch_detail == pytest.approx(16 / 30)
    for w in tail:
        assert all(torch.equal(g, x) for g, x in zip(next(fresh).arrays, w))
    pf.close()
    fresh.close()


def test_native_loader_through_the_prefetcher(comm):
    """The C++ loader's recycled slots are copied before they are handed
    on; the order is ``_native_perm``'s, and the rewind is exact."""
    rng = np.random.RandomState(1)
    xs, ys = rng.randn(40, 3).astype(np.float32), np.arange(40)
    pf = PrefetchIterator(
        NativeBatchIterator([xs, ys], 8, shuffle=True, seed=3), comm,
        depth=2)
    got = [next(pf).arrays for _ in range(7)]
    for step, (x, y) in enumerate(got):
        ep, k = divmod(step, 5)
        idx = _native_perm(40, 3, ep)[k * 8:(k + 1) * 8]
        np.testing.assert_array_equal(y.numpy(), ys[idx])
        np.testing.assert_array_equal(x.numpy(), xs[idx])
    st = pf.state_dict()
    assert st == {"popped": 7}
    again = PrefetchIterator(
        NativeBatchIterator([xs, ys], 8, shuffle=True, seed=3), comm)
    again.load_state_dict(st)
    np.testing.assert_array_equal(next(again).arrays[1].numpy(),
                                  next(pf).arrays[1].numpy())
    pf.close()
    again.close()


def _counted(it):
    """Record the position of every batch ``it`` (a C++ loader) pulls."""
    pulls = []
    real = it._next_native

    def pull():
        pulls.append(it.state_dict()["popped"])
        return real()

    it._next_native = pull
    return pulls


def test_save_and_restore_far_into_a_run_pull_nothing_again(comm):
    """``state_dict`` 60 batches (12 epochs) in keeps the lookahead
    instead of rewinding the base, so no batch is pulled twice, through
    ``close()`` too; a restore over a fresh C++ loader starts at the
    saved batch and pulls nothing before the consumer asks."""
    rng = np.random.RandomState(2)
    xs, ys = rng.randn(40, 3).astype(np.float32), np.arange(40)
    pf = PrefetchIterator(
        NativeBatchIterator([xs, ys], 8, shuffle=True, seed=3), comm,
        depth=2)
    pulls = _counted(pf._base)
    for _ in range(60):
        next(pf)
    before = len(pulls)
    st = pf.state_dict()
    assert st == {"popped": 60} and len(pulls) == before
    pf.close()
    tail = [next(pf).arrays for _ in range(6)]
    pf.close()
    assert pulls == list(range(len(pulls))) and len(pulls) <= 66 + 3
    for step, (x, y) in enumerate(tail, start=60):
        ep, k = divmod(step, 5)
        idx = _native_perm(40, 3, ep)[k * 8:(k + 1) * 8]
        np.testing.assert_array_equal(y.numpy(), ys[idx])
        np.testing.assert_array_equal(x.numpy(), xs[idx])
    again = PrefetchIterator(
        NativeBatchIterator([xs, ys], 8, shuffle=True, seed=3), comm)
    pulls_again = _counted(again._base)
    again.load_state_dict(st)
    assert not pulls_again and again.epoch == 12
    for x, y in tail:
        rec = next(again)
        assert torch.equal(rec.arrays[0], x) and torch.equal(rec.arrays[1], y)
    again.close()
    assert pulls_again[0] == 60


def test_steps_per_execution_and_depth_errors(comm):
    # windows of 3 batches stack into (3, batch, ...); 30 examples in
    # batches of 4 end an epoch with 4, 4 and a ragged 2, which rides as
    # the tail; the batches are the serial feed's
    it = SerialIterator(_examples(), 4, repeat=False)
    pf = PrefetchIterator(it, comm, steps_per_execution=3)
    want = list(_serial_stream(SerialIterator(_examples(), 4, repeat=False),
                               default_converter, 8))
    got = []
    for rec in pf:
        assert rec.n_iterations == rec.k + (rec.tail is not None)
        got += [rec.arrays] if rec.k == 1 else [
            tuple(a[j] for a in rec.arrays) for j in range(rec.k)]
        if rec.tail is not None:
            assert rec.k == 1 and rec.tail[0].shape == (2, 4)
            got.append(rec.tail)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="depth"):
        PrefetchIterator(it, comm, depth=0)
    with pytest.raises(ValueError, match="too small"):
        PrefetchIterator(it, comm, steps_per_execution=4,
                         converter=StagingConverter(n_buffers=3))


# --------------------------------------------------------------------- #
# the updater
# --------------------------------------------------------------------- #

def _mnist_like(n=96):
    rng = np.random.RandomState(5)
    protos = rng.randn(10, 20).astype(np.float32)
    return [(protos[i % 10] + 0.3 * rng.randn(20).astype(np.float32),
             np.int32(i % 10)) for i in range(n)]


def _mlp_updater(comm, prefetch=0, seed=1):
    params = mlp_params_from_jax(init_mlp_numpy([20, 16, 10], 0),
                                 device="cpu")
    it = SerialIterator(_mnist_like(), 16, shuffle=True, seed=seed)
    opt = training.create_multi_node_optimizer(training.sgd(0.1), comm)
    return training.StandardUpdater(
        it, opt, lambda p, x, y: softmax_cross_entropy(mlp_apply(p, x), y),
        params, comm, prefetch=prefetch)


def _params(up):
    return [t.detach().clone() for layer in up.params for t in layer.values()]


def test_prefetched_mlp_is_bitwise_the_serial_run(comm):
    serial, pre = _mlp_updater(comm), _mlp_updater(comm, prefetch=True)
    assert pre.prefetch == 2 and isinstance(pre.iterator, PrefetchIterator)
    assert isinstance(pre.iterator._converter, StagingConverter)
    for _ in range(10):                          # crosses an epoch end
        serial.update()
        pre.update()
        assert float(serial.observation["main/loss"]) \
            == float(pre.observation["main/loss"])
        assert serial.epoch_detail == pre.epoch_detail
    assert all(torch.equal(a, b)
               for a, b in zip(_params(serial), _params(pre)))
    thread = pre.iterator._thread
    pre.finalize()
    assert not thread.is_alive()


def test_updater_adopts_and_checks_a_prefetcher(comm):
    it = PrefetchIterator(SerialIterator(_mnist_like(), 16), comm, depth=3)
    up = training.StandardUpdater(
        it, training.create_multi_node_optimizer(training.sgd(0.1), comm),
        lambda p, x, y: softmax_cross_entropy(mlp_apply(p, x), y),
        mlp_params_from_jax(init_mlp_numpy([20, 10], 0), device="cpu"),
        comm)
    assert up.prefetch == 3 and up.iterator is it
    up.update()
    up.finalize()
    with pytest.raises(ValueError, match="drop_remainder"):
        training.StandardUpdater(
            PrefetchIterator(SerialIterator(_mnist_like(), 16), comm,
                             drop_remainder=False),
            training.sgd(0.1), None, [], comm)
    with pytest.raises(ValueError, match="prefetch depth"):
        training.StandardUpdater(SerialIterator(_mnist_like(), 16),
                                 training.sgd(0.1), None, [], comm,
                                 prefetch=-1)
    # windows in flight: none on the CPU, where a window is done when its
    # update returns, so the observed loss is the window's own
    up = training.StandardUpdater(
        SerialIterator(_mnist_like(), 16),
        training.create_multi_node_optimizer(training.sgd(0.1), comm),
        lambda p, x, y: softmax_cross_entropy(mlp_apply(p, x), y),
        mlp_params_from_jax(init_mlp_numpy([20, 10], 0), device="cpu"),
        comm, prefetch=2, max_inflight=3)
    assert up.max_inflight == 3
    for _ in range(4):
        up.update()
        assert not up._inflight
        assert up.observation["main/loss"] is up._last_retired
    up.finalize()


def test_checkpoint_with_prefetch_resumes_bitwise(comm, tmp_path):
    """Save at iteration 4 (mid-epoch, the worker ahead of the
    consumer), go on to 9; a fresh job resumed from the file reaches the
    same parameters and losses bitwise."""
    straight = _mlp_updater(comm, prefetch=2)
    cp = create_multi_node_checkpointer(comm, str(tmp_path))
    losses = []
    for i in range(9):
        straight.update()
        losses.append(float(straight.observation["main/loss"]))
        if straight.iteration == 4:
            cp.save(straight)
    straight.finalize()
    resumed = _mlp_updater(comm, prefetch=2, seed=99)
    assert create_multi_node_checkpointer(
        comm, str(tmp_path)).maybe_load(resumed) == 4
    got = []
    for _ in range(5):
        resumed.update()
        got.append(float(resumed.observation["main/loss"]))
    resumed.finalize()
    assert got == losses[4:]
    assert all(torch.equal(a, b)
               for a, b in zip(_params(straight), _params(resumed)))
