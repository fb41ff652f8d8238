"""The port's object channel (``chainermn_tpu_torch/communicators/
_obj_channel.py``) — the cases of the JAX package's
``tests/communicator_tests/test_obj_channel_retry.py`` on a c10d store.

They run over a flaky double of a real ``torch.distributed.HashStore``:
every verb can fail transiently (``DistNetworkError``, c10d's connection
reset) a set number of times, and a set can land before its error is
reported.  Retry helpers and their bounds, flakes absorbed by send,
recv and multi-frame messages, a timeout that does not advance the
lane, the first attempt that landed, the metrics the retries feed, and
generation fencing: a message of another generation is refused and the
lane recovers.
"""

from datetime import timedelta

import pytest
import torch.distributed as dist

from chainermn_tpu_torch.communicators import _obj_channel
from chainermn_tpu_torch.communicators._obj_channel import (
    KVObjectChannel,
    StaleGenerationError,
    _is_transient,
    _kv_delete,
    _kv_retry,
)
from chainermn_tpu_torch.utils.metrics import (
    MetricsRegistry,
    get_registry,
    set_registry,
)


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    monkeypatch.setattr(_obj_channel, "KV_BACKOFF_BASE_S", 0.001)
    monkeypatch.setattr(_obj_channel, "KV_BACKOFF_MAX_S", 0.002)


class _FlakyStore:
    """A ``HashStore`` whose verbs fail transiently: the first
    ``fail_first`` calls raise c10d's network error, and the next
    ``lost_acks`` sets are applied and then raise all the same (the set
    landed before its error reached the client)."""

    def __init__(self, fail_first=0, lost_acks=0):
        self.store = dist.HashStore()
        self.fail_first = fail_first
        self.lost_acks = lost_acks
        self.calls = 0

    def _maybe_fail(self):
        self.calls += 1
        if self.calls <= self.fail_first:
            raise dist.DistNetworkError("Connection reset by peer")

    def set(self, key, value):
        self._maybe_fail()
        self.store.set(key, value)
        if self.lost_acks > 0:
            self.lost_acks -= 1
            raise dist.DistNetworkError("Connection reset by peer")

    def get(self, key):
        self._maybe_fail()
        return self.store.get(key)

    def wait(self, keys, timeout):
        self._maybe_fail()
        self.store.wait(keys, timeout)

    def check(self, keys):
        self._maybe_fail()
        return self.store.check(keys)

    def delete_key(self, key):
        self._maybe_fail()
        return self.store.delete_key(key)


def _channel(store, timeout_ms=200):
    return KVObjectChannel(tag="t", timeout_ms=timeout_ms, store=store)


def _left(store, prefix):
    """Whether any key of one message is still on the store."""
    return any(store.store.check([f"{prefix}{part}"])
               for part in ("meta", "c0", "c1"))


class TestRetryHelpers:
    def test_transient_markers(self):
        assert _is_transient(dist.DistNetworkError("try again"))
        assert _is_transient(dist.DistError("connection reset by peer"))
        assert _is_transient(dist.DistError("Broken pipe"))
        assert not _is_transient(dist.DistStoreError("Wait timeout"))
        assert not _is_transient(dist.DistNetworkError("timed out"))
        assert not _is_transient(ValueError("bad payload"))

    def test_retry_succeeds_after_transient_failures(self):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) < 3:
                raise dist.DistNetworkError("Connection reset by peer")
            return "ok"

        assert _kv_retry(fn, "test") == "ok"
        assert len(calls) == 3

    def test_retry_bounded(self):
        calls = []

        def fn():
            calls.append(1)
            raise dist.DistNetworkError("Connection reset forever")

        with pytest.raises(dist.DistNetworkError, match="forever"):
            _kv_retry(fn, "test")
        assert len(calls) == _obj_channel.KV_RETRIES + 1

    def test_non_transient_raises_immediately(self):
        calls = []

        def fn():
            calls.append(1)
            raise dist.DistStoreError("Wait timeout")

        with pytest.raises(dist.DistStoreError, match="timeout"):
            _kv_retry(fn, "test")
        assert len(calls) == 1  # a timeout is NOT multiplied by retries

    def test_delete_tolerates_already_gone(self):
        _kv_delete(_FlakyStore(), "missing-key")  # must not raise


class TestChannelUnderFlakes:
    def test_send_recv_survives_transient_flakes(self):
        store = _FlakyStore(fail_first=2)
        chan = _channel(store)
        chan.send({"x": 41}, src=0, dst=1)
        # receiving side: same store, fresh flake budget
        store.fail_first = store.calls + 2
        assert chan.recv(src=0, dst=1) == {"x": 41}
        # lane counters advanced exactly once each
        assert chan._send_seq[(0, 1)] == 1
        assert chan._recv_seq[(0, 1)] == 1
        # consumed keys deleted
        assert not _left(store, "t/0.1.0/")

    def test_recv_timeout_does_not_advance_lane(self):
        chan = _channel(_FlakyStore(), timeout_ms=50)
        with pytest.raises(dist.DistStoreError, match="timeout"):
            chan.recv(src=0, dst=1)  # nothing published
        assert chan._recv_seq.get((0, 1), 0) == 0
        # the retried send still pairs with the retried recv in order
        chan.send("late", src=0, dst=1)
        assert chan.recv(src=0, dst=1) == "late"

    def test_publish_whose_first_attempt_landed_still_succeeds(self):
        """A set applied before its transient error reached the client:
        the retried set writes the same value again."""
        chan = _channel(_FlakyStore(lost_acks=1))
        chan.send({"x": 1}, src=0, dst=1)
        assert chan.recv(src=0, dst=1) == {"x": 1}

    def test_multi_frame_publish_retries(self, monkeypatch):
        monkeypatch.setattr(_obj_channel, "FRAME_BYTES", 64)
        store = _FlakyStore(fail_first=3)
        chan = _channel(store)
        payload = list(range(200))  # several 64-byte frames
        chan.send(payload, src=2, dst=0)
        store.fail_first = store.calls + 3
        assert chan.recv(src=2, dst=0) == payload


class TestRetryMetrics:
    """The retry choke point feeds ``comm/kv_retries`` (the retry
    attempts) and ``comm/kv_wait`` (each verb's wall time, backoff
    included)."""

    @pytest.fixture()
    def registry(self):
        reg = MetricsRegistry(enabled=True)
        prev = set_registry(reg)
        yield reg
        set_registry(prev)

    def test_clean_call_counts_no_retries(self, registry):
        assert _kv_retry(lambda: "ok", "test") == "ok"
        snap = registry.snapshot()
        assert "comm/kv_retries" not in snap
        assert snap["comm/kv_wait"]["count"] == 1

    def test_transient_flakes_count_retries_and_wait(self, registry):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) < 3:
                raise dist.DistNetworkError("Connection reset by peer")
            return "ok"

        assert _kv_retry(fn, "test") == "ok"
        snap = registry.snapshot()
        assert snap["comm/kv_retries"]["value"] == 2
        assert snap["comm/kv_wait"]["count"] == 1
        # the recorded wait includes the two backoff sleeps
        assert snap["comm/kv_wait"]["max"] >= 2 * 0.001

    def test_exhausted_retries_still_recorded(self, registry):
        def fn():
            raise dist.DistNetworkError("Connection reset forever")

        with pytest.raises(dist.DistNetworkError):
            _kv_retry(fn, "test")
        snap = registry.snapshot()
        assert snap["comm/kv_retries"]["value"] \
            == _obj_channel.KV_RETRIES
        assert snap["comm/kv_wait"]["count"] == 1

    def test_disabled_registry_records_nothing(self):
        prev = set_registry(MetricsRegistry())
        try:
            assert not get_registry().enabled  # the default
            assert _kv_retry(lambda: 1, "test") == 1
            assert len(get_registry()) == 0
        finally:
            set_registry(prev)

    def test_channel_verbs_are_counted(self, registry):
        store = _FlakyStore(fail_first=1)
        chan = _channel(store)
        chan.send("x", src=0, dst=1)
        assert chan.recv(src=0, dst=1) == "x"
        snap = registry.snapshot()
        assert snap["comm/kv_retries"]["value"] == 1
        # send: one frame and the meta; recv: meta, frame, two deletes
        assert snap["comm/kv_wait"]["count"] == 6


class TestGenerationFencing:
    """A message published under another generation is refused at
    receipt (``StaleGenerationError``), never consumed as live traffic
    by the resized world, and the lane stays usable after."""

    def test_stale_generation_rejected_then_lane_recovers(self):
        store = _FlakyStore()
        chan = _channel(store)
        assert chan.generation == 0
        chan.send("pre-resize", src=0, dst=1)   # published under gen 0
        # the survivors agree a new membership epoch and fence
        chan.set_generation(1)
        with pytest.raises(StaleGenerationError, match="generation 0"):
            chan.recv(src=0, dst=1)
        # the rejected message is CONSUMED: lane advanced AND its keys
        # deleted, so the dead slot cannot shadow a later publish onto
        # the same (src, dst, seq) coordinates
        assert not _left(store, "t/0.1.0/")
        chan.send("post-resize", src=0, dst=1)
        assert chan.recv(src=0, dst=1) == "post-resize"

    def test_future_generation_also_rejected(self):
        chan = _channel(_FlakyStore())
        chan.set_generation(3)
        chan.send("from-the-future", src=1, dst=0)
        chan.set_generation(2)   # this end never saw epoch 3
        with pytest.raises(StaleGenerationError, match="generation 3"):
            chan.recv(src=1, dst=0)

    def test_allgather_carries_generation(self):
        chan = _channel(_FlakyStore())
        chan.set_generation(5)
        # single-member group: the payload still round-trips through
        # the envelope machinery via publish
        assert chan.allgather({"x": 1}, [0], 0) == [{"x": 1}]

    def test_allgather_rejects_without_deleting(self):
        """A group message has other readers: a stale one raises and
        its keys stay for them."""
        store = _FlakyStore()
        a, b = _channel(store), _channel(store)
        b.set_generation(1)
        a._ag_seq = b._ag_seq = 0
        # member 1 publishes under generation 1, member 0 reads it
        # under generation 0
        b._ag_frames[0] = b._publish(
            "gen-1", lambda part: b._key(1, -1, 0, "gmeta" if part ==
                                         "meta" else "g" + part),
            "allgather_obj")
        with pytest.raises(StaleGenerationError, match="generation 1"):
            a.allgather("gen-0", [0, 1], 0)
        assert store.store.check(["t/1.-1.0/gmeta"])

    def test_stale_rejection_counted(self):
        reg = MetricsRegistry(enabled=True)
        prev = set_registry(reg)
        try:
            chan = _channel(_FlakyStore())
            chan.send("old", src=0, dst=1)
            chan.set_generation(9)
            with pytest.raises(StaleGenerationError):
                chan.recv(src=0, dst=1)
            snap = reg.snapshot()
            assert snap["comm/stale_generation_rejected"]["value"] == 1
        finally:
            set_registry(prev)

    def test_channel_needs_a_store(self, monkeypatch):
        from chainermn_tpu_torch import communicators

        monkeypatch.setattr(communicators, "_STORE", None)
        with pytest.raises(RuntimeError, match="init_distributed"):
            KVObjectChannel(tag="x").send(1, 0, 1)


def test_wait_bounds_a_read_by_the_channels_timeout():
    """``Store.get`` blocks until the store's own timeout; a channel
    read waits ``timeout_ms`` first."""
    store = dist.HashStore()
    store.set_timeout(timedelta(seconds=60))
    chan = KVObjectChannel(tag="t", timeout_ms=30, store=store)
    with pytest.raises(dist.DistStoreError, match="timeout"):
        chan.recv(0, 1)
