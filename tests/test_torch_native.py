"""The port's native loader (``chainermn_tpu_torch.native``: its own copy
of ``loader.cpp``, built with ``g++`` into ``build/native/``) against the
JAX package's ``NativeBatchIterator`` and ``_native_perm``.

Batch order and contents are integer and byte moves, so they must match
bitwise, over two shuffled epochs and over an unshuffled ragged one.
``pack_arrays``/``unpack_arrays`` round-trip and produce the JAX
package's bytes.  A restore starts the loader at the saved batch and
replays nothing.  A compiler that fails makes the build raise with its
message; nothing falls back to numpy unless ``backend="numpy"`` is
asked for.
"""

import difflib
import os
import stat

import numpy as np
import pytest

from chainermn_tpu import native as jnative
from chainermn_tpu_torch import native


def _fields(n=37):
    rng = np.random.RandomState(3)
    return [rng.randn(n, 3, 2).astype(np.float32),
            np.arange(n, dtype=np.int32),
            rng.randint(0, 255, (n, 5)).astype(np.uint8)]


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)],
                         ids=["shuffled", "ragged"])
def test_order_is_the_jax_packages(shuffle, drop_last):
    arrays = _fields()
    kw = dict(shuffle=shuffle, seed=11, drop_last=drop_last)
    port = native.NativeBatchIterator(arrays, 8, **kw)
    plain = native.NativeBatchIterator(arrays, 8, backend="numpy", **kw)
    ref = jnative.NativeBatchIterator(arrays, 8, **kw)
    assert port.owns_buffers(()) and not plain.owns_buffers(())
    bpe = 37 // 8 if drop_last else 5
    for step in range(2 * bpe):
        ep, k = divmod(step, bpe)
        perm = native._native_perm(37, 11, ep)
        np.testing.assert_array_equal(perm, jnative._native_perm(37, 11, ep))
        if not shuffle:
            perm = np.arange(37)
        want = [a[perm[k * 8:(k + 1) * 8]] for a in arrays]
        got, got_plain, got_ref = next(port), next(plain), next(ref)
        for g, gp, gr, w in zip(got, got_plain, got_ref, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(gp, w)
            np.testing.assert_array_equal(gr, w)
            assert g.dtype == w.dtype
        assert port.epoch == ref.epoch == (step + 1) // bpe
        assert port.epoch_detail == ref.epoch_detail


def test_no_repeat_stops_and_reset_restarts():
    arrays = _fields()
    it = native.NativeBatchIterator(arrays, 8, repeat=False, shuffle=True,
                                    seed=2)
    first = [b[1].copy() for b in it]
    assert len(first) == 4
    with pytest.raises(StopIteration):
        next(it)
    it.reset()
    assert it.epoch == 0
    np.testing.assert_array_equal(next(it)[1], first[0])


def test_state_dict_resumes_where_it_stood():
    arrays = _fields()
    it = native.NativeBatchIterator(arrays, 8, shuffle=True, seed=5)
    for _ in range(6):                  # into the second epoch
        next(it)
    st = it.state_dict()
    tail = [next(it)[1].copy() for _ in range(5)]
    for backend in ("native", "numpy"):
        again = native.NativeBatchIterator(arrays, 8, shuffle=True, seed=5,
                                           backend=backend)
        again.load_state_dict(st)
        assert again.epoch == 1 and again.epoch_detail == 6 / 4
        for want in tail:
            np.testing.assert_array_equal(next(again)[1], want)


def test_pack_unpack_round_trip():
    arrays = _fields() + [np.zeros((0, 4), np.float64)]
    packed = native.pack_arrays(arrays)
    assert packed.dtype == np.uint8
    np.testing.assert_array_equal(packed, jnative.pack_arrays(arrays))
    back = native.unpack_arrays(packed, arrays)
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and a.shape == b.shape
    assert native.pack_arrays([]).size == 0
    with pytest.raises(ValueError, match="does not match"):
        native.unpack_arrays(packed[:-1], arrays)


def test_validation_errors():
    arrays = _fields()
    with pytest.raises(ValueError, match="at least one field"):
        native.NativeBatchIterator([], 4)
    with pytest.raises(ValueError, match="share their leading dim"):
        native.NativeBatchIterator([arrays[0], arrays[1][:-1]], 4)
    with pytest.raises(ValueError, match="smaller than one batch"):
        native.NativeBatchIterator(arrays, 64)
    with pytest.raises(ValueError, match="backend"):
        native.NativeBatchIterator(arrays, 4, backend="python")


def test_build_raises_on_a_broken_compiler(monkeypatch, tmp_path):
    stub = tmp_path / "bin" / "g++"
    stub.parent.mkdir()
    stub.write_text("#!/bin/sh\necho 'stub compiler: no such target' >&2\n"
                    "exit 1\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(stub.parent))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="stub compiler: no such target"):
        native.load()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.NativeBatchIterator(_fields(), 8)
    assert not native.native_available()
    assert not list((tmp_path / "native").glob("*"))   # no stray library
    # the plain version needs no library
    it = native.NativeBatchIterator(_fields(), 8, backend="numpy")
    assert next(it)[0].shape == (8, 3, 2)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load()


def test_library_is_keyed_by_the_source():
    native.load()
    lib = native._library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    # the port's copy differs from the JAX package's only where it adds
    # the start position
    ours = native.SRC.read_text().splitlines()
    theirs = (native.SRC.parent.parent.parent / "chainermn_tpu" / "native"
              / "loader.cpp").read_text().splitlines()
    changed = [ours[j1:j2] for tag, _, _, j1, j2 in difflib.SequenceMatcher(
        None, theirs, ours, autojunk=False).get_opcodes() if tag != "equal"]
    assert changed and all("start_batch" in "\n".join(c) for c in changed)
    assert os.path.basename(lib).startswith("libcmn_native-")


def test_restore_far_into_a_run_replays_nothing():
    """A restore rebuilds the C++ loader at the saved batch: nothing is
    pulled and dropped, however far the run went (a million batches
    here), and it continues as the JAX package's loader does after the
    same number of pulls, and in ``_native_perm``'s order."""
    arrays = _fields()
    ref = jnative.NativeBatchIterator(arrays, 8, shuffle=True, seed=5)
    for far in (13, 10**6 + 3):             # bpe 4: mid-epoch both times
        it = native.NativeBatchIterator(arrays, 8, shuffle=True, seed=5)
        pulls = []
        real = it._next_native
        it._next_native = lambda real=real, pulls=pulls: (
            pulls.append(1), real())[1]
        it.load_state_dict({"popped": far})
        assert not pulls and it.state_dict() == {"popped": far}
        assert it.epoch == far // 4 and it.epoch_detail == far / 4
        if far == 13:
            for _ in range(far):
                next(ref)
        for step in range(far, far + 6):    # across an epoch turn
            ep, k = divmod(step, 4)
            idx = native._native_perm(37, 5, ep)[k * 8:(k + 1) * 8]
            got = next(it)
            want = next(ref) if far == 13 else [a[idx] for a in arrays]
            for g, w, a in zip(got, want, arrays):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, a[idx])
        assert len(pulls) == 6
    with pytest.raises(ValueError, match="popped"):
        it.load_state_dict({"popped": -1})
