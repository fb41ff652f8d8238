"""Native host runtime — the C++ batch loader and pack/unpack (the JAX
package's ``native/``; ``loader.cpp`` is its copy and holds the design).

The library is built with ``g++ -O3 -shared -fPIC -pthread -std=c++17``
on first use into ``build/native/libcmn_native-<hash>.so`` at the root
of the checkout (``build/`` is git-ignored), keyed by the source's hash,
written to a temporary name and moved into place, so concurrent
processes may build it at once.  Nothing is built when the module is
imported.  A failed build raises with the compiler's message: nothing
falls back to numpy on its own.  The numpy assembly the JAX package
falls back to stays as the plain version of the loader, reached only by
``NativeBatchIterator(..., backend="numpy")``.

A batch of the C++ loader is a set of views into a recycled slot: the
next ``next()`` hands the slot back to the loader's threads, which then
overwrite it.  Copy a batch out (``PrefetchIterator``'s staging ring
does, and the serial updater's move to the device does) before pulling
the next.

Beyond the JAX package: ``state_dict``/``load_state_dict`` (the number
of batches pulled), so that a prefetched run over this loader resumes
from a checkpoint where it stood.  The port's ``loader.cpp`` takes the
batch to start at, so a restore rebuilds the loader there and replays
nothing, however long the run has been.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "NativeBatchIterator",
    "native_available",
    "pack_arrays",
    "unpack_arrays",
]

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libcmn_native-{digest}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found; the native loader is built "
                           f"from {SRC.name} on first use: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none


def load():
    """The loaded library, built on first use; raises if it cannot be
    built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.cmn_loader_create.restype = ctypes.c_void_p
        lib.cmn_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64,
        ]
        lib.cmn_loader_next.restype = ctypes.c_int
        lib.cmn_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.cmn_loader_release.restype = None
        lib.cmn_loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.cmn_loader_destroy.restype = None
        lib.cmn_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.cmn_pack.restype = None
        lib.cmn_pack.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.cmn_unpack.restype = None
        lib.cmn_unpack.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the C++ runtime is (or can be) built and loaded."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _native_perm(n: int, seed: int, epoch: int) -> np.ndarray:
    """EXACTLY the permutation loader.cpp builds (std::mt19937_64 and a
    top-down Fisher-Yates with ``rng() % (i+1)``): the plain version of
    the loader's order."""
    state = np.empty(312, np.uint64)
    mask = 0xFFFFFFFFFFFFFFFF
    s = (seed + 0x9E3779B97F4A7C15 * (epoch + 1)) & mask
    state[0] = s
    for i in range(1, 312):
        # python-int arithmetic: mod-2^64 wraparound without numpy's
        # overflow warnings
        s = (6364136223846793005 * (s ^ (s >> 62)) + i) & mask
        state[i] = s
    idx = 312

    def gen():
        nonlocal idx
        if idx >= 312:
            # mt19937_64 twist, sequential: entries past the wrap point
            # read values already twisted this round
            upper = np.uint64(0xFFFFFFFF80000000)
            lower = np.uint64(0x7FFFFFFF)
            for i in range(312):
                x = ((state[i] & upper)
                     | (state[(i + 1) % 312] & lower))
                xa = x >> np.uint64(1)
                if x & np.uint64(1):
                    xa ^= np.uint64(0xB5026F5AA96619E9)
                state[i] = state[(i + 156) % 312] ^ xa
            idx = 0
        y = state[idx]
        idx += 1
        y ^= (y >> np.uint64(29)) & np.uint64(0x5555555555555555)
        y ^= (y << np.uint64(17)) & np.uint64(0x71D67FFFEDA60000)
        y ^= (y << np.uint64(37)) & np.uint64(0xFFF7EEE000000000)
        y ^= y >> np.uint64(43)
        return int(y)

    perm = np.arange(n, dtype=np.int64)
    for i in range(n - 1, 0, -1):
        j = gen() % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    return perm


class NativeBatchIterator:
    """Prefetching batch iterator over memory-resident field arrays.

    The :class:`~chainermn_tpu_torch.iterators.SerialIterator` surface
    the trainer touches (``epoch``, ``epoch_detail``,
    ``reset``, ``__next__`` → a tuple of per-field batch arrays), with
    batch assembly in C++ worker threads ahead of the training step.

    The arrays it returns are views into a recycled slot: consume them
    before the next ``__next__`` (see the module's note).

    Args:
      arrays: one array a field, sharing the leading (example) dim.
      backend: ``"native"`` (the C++ loader; raises when it cannot be
        built) or ``"numpy"`` (the plain version: the same batches in
        the same order, assembled by numpy fancy indexing).
    """

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 repeat: bool = True, shuffle: bool = False,
                 seed: int = 0, n_slots: int = 3, n_threads: int = 2,
                 drop_last: bool = True, backend: str = "native"):
        if backend not in ("native", "numpy"):
            raise ValueError(f"backend must be 'native' or 'numpy', got "
                             f"{backend!r}")
        if not arrays:
            raise ValueError("need at least one field array")
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("field arrays must share their leading dim")
        if drop_last and n < batch_size:
            raise ValueError(
                f"dataset of {n} examples smaller than one batch "
                f"({batch_size}) with drop_last")
        self._arrays = [np.ascontiguousarray(a) for a in arrays]
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._seed = seed
        self._drop_last = drop_last
        self._n = n
        self._bpe = (n // batch_size if drop_last
                     else (n + batch_size - 1) // batch_size)
        self._n_slots = n_slots
        self._n_threads = n_threads
        self.epoch = 0
        self._popped = 0
        self._pending_release = -1
        self._handle = None
        self._lib = load() if backend == "native" else None
        if self._lib is not None:
            self._create(0)

    def _create(self, start: int):
        fields = (ctypes.c_void_p * len(self._arrays))(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in self._arrays])
        itemsizes = (ctypes.c_int64 * len(self._arrays))(
            *[a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
              for a in self._arrays])
        handle = self._lib.cmn_loader_create(
            fields, itemsizes, len(self._arrays), self._n,
            self.batch_size, self._n_slots, self._n_threads,
            self._seed, int(self._shuffle), int(self._drop_last), start)
        if not handle:
            raise RuntimeError("cmn_loader_create failed")
        self._handle = handle

    def _destroy(self):
        if self._handle is not None:
            self._lib.cmn_loader_destroy(self._handle)
            self._handle = None

    @property
    def repeat(self) -> bool:
        return self._repeat

    def owns_buffers(self, arrays) -> bool:
        """True with the C++ loader: its batches are views into
        recycled slots, so a consumer that defers its copy must copy
        them first.  The numpy version returns fresh copies."""
        return self._handle is not None

    @property
    def epoch_detail(self) -> float:
        return self._popped / self._bpe

    def reset(self):
        """Restart at epoch 0 (the C++ loader is rebuilt)."""
        self.load_state_dict({"popped": 0})

    def state_dict(self) -> dict:
        return {"popped": self._popped}

    def load_state_dict(self, st: dict) -> None:
        """Continue after ``st["popped"]`` batches: the C++ loader is
        rebuilt to start at that batch (nothing is pulled and dropped)."""
        popped = int(st["popped"])
        if popped < 0:
            raise ValueError(f"popped must be >= 0, got {popped}")
        self._pending_release = -1
        if self._lib is not None:
            self._destroy()
            self._create(popped)
        self._popped = popped
        self.epoch = popped // self._bpe

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, ...]:
        if not self._repeat and self._popped >= self._bpe:
            raise StopIteration
        if self._lib is not None:
            return self._next_native()
        return self._next_fallback()

    next = __next__

    def _next_native(self):
        lib = self._lib
        if self._pending_release >= 0:
            lib.cmn_loader_release(self._handle, self._pending_release)
        ptrs = (ctypes.c_void_p * len(self._arrays))()
        rows = ctypes.c_int64()
        epoch = ctypes.c_int64()
        slot = lib.cmn_loader_next(
            self._handle, ptrs, ctypes.byref(rows), ctypes.byref(epoch))
        self._pending_release = slot
        out = []
        for a, p in zip(self._arrays, ptrs):
            shape = (int(rows.value),) + a.shape[1:]
            buf = (ctypes.c_char * (
                int(rows.value) * a.dtype.itemsize
                * int(np.prod(a.shape[1:], dtype=np.int64)))
            ).from_address(p)
            out.append(np.frombuffer(buf, dtype=a.dtype).reshape(shape))
        self._popped += 1
        self.epoch = self._popped // self._bpe
        return tuple(out)

    def _next_fallback(self):
        ep, in_ep = divmod(self._popped, self._bpe)
        if self._shuffle:
            perm = _native_perm(self._n, self._seed, ep)
        else:
            perm = np.arange(self._n)
        idx = perm[in_ep * self.batch_size:
                   in_ep * self.batch_size + self.batch_size]
        self._popped += 1
        self.epoch = self._popped // self._bpe
        return tuple(a[idx] for a in self._arrays)

    def __del__(self):  # pragma: no cover
        if getattr(self, "_handle", None) is not None:
            self._destroy()


def pack_arrays(arrays: Sequence[np.ndarray],
                n_threads: int = 4) -> np.ndarray:
    """Concatenate the arrays' bytes into one contiguous uint8 buffer
    with the C++ thread pool."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    sizes = [a.nbytes for a in arrays]
    out = np.empty(sum(sizes), np.uint8)
    if not arrays:
        return out
    srcs = (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
    csizes = (ctypes.c_int64 * len(arrays))(*sizes)
    load().cmn_pack(srcs, csizes, len(arrays),
                    out.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out


def unpack_arrays(packed: np.ndarray, templates: Sequence[np.ndarray],
                  n_threads: int = 4):
    """Inverse of :func:`pack_arrays`: split ``packed`` into arrays with
    the shapes and dtypes of ``templates``."""
    packed = np.ascontiguousarray(packed.view(np.uint8).reshape(-1))
    outs = [np.empty(t.shape, t.dtype) for t in templates]
    sizes = [o.nbytes for o in outs]
    if sum(sizes) != packed.nbytes:
        raise ValueError(
            f"packed buffer of {packed.nbytes} bytes does not match "
            f"templates totalling {sum(sizes)}")
    if not outs:
        return outs
    dsts = (ctypes.c_void_p * len(outs))(
        *[o.ctypes.data_as(ctypes.c_void_p) for o in outs])
    csizes = (ctypes.c_int64 * len(outs))(*sizes)
    load().cmn_unpack(packed.ctypes.data_as(ctypes.c_void_p), csizes,
                      len(outs), dsts, n_threads)
    return outs
