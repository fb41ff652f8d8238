// Native batch loader — the host-side data runtime.
//
// TPU-native counterpart of the reference's native host machinery
// (chainermn/communicators/_memory_utility.py pinned-memory arenas +
// CuPy batched pack/unpack kernels, and the iterator worker threads of
// the wider Chainer stack; reference unverified — mount empty, see
// SURVEY.md).  On TPU the device-side packing is XLA's job, but feeding
// the chip stays a host problem: batch assembly (gather + stack) in
// Python serialises on the GIL exactly when the step gap is tightest.
//
// Design:
//   - the dataset lives in page-aligned host arrays (one per field);
//   - an arena is carved into S slots (double/triple buffering), each
//     holding one assembled batch per field — the HostPinnedMemory
//     analogue (TPU infeed pins on transfer; alignment keeps DMA fast);
//   - a worker pool fills slots ahead of the consumer: per-epoch
//     deterministic Fisher-Yates shuffle (seed + epoch), row gather via
//     parallel memcpy, no Python in the loop;
//   - the consumer (Python, via ctypes) pops filled slots in order and
//     recycles them after device_put — a bounded SPSC-with-workers ring.
//
// C ABI only (no pybind11 in the image): create / next / release /
// destroy.  Thread-safety contract: one consumer thread.
//
// Beyond the JAX package's copy: cmn_loader_create takes start_batch,
// the global batch index to start at.  A batch's rows depend only on the
// seed and its index (epoch = index / batches_per_epoch), so a loader
// resumed at batch k yields exactly what a fresh one yields after k
// pulls, with nothing replayed.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Field {
  const uint8_t* data;     // n_examples * itemsize bytes
  int64_t itemsize;        // bytes per example
};

struct Slot {
  std::vector<uint8_t*> buffers;   // one per field, batch_size*itemsize
  int64_t batch_index = -1;        // global batch counter this slot holds
  int64_t batch_size = 0;          // rows actually filled
  int64_t epoch = 0;
};

struct Loader {
  std::vector<Field> fields;
  int64_t n_examples;
  int64_t batch_size;
  bool shuffle;
  bool drop_last;
  uint64_t seed;

  std::vector<Slot> slots;
  std::vector<uint8_t> arena;

  // producer state
  std::mutex mu;
  std::condition_variable cv_free, cv_filled;
  std::queue<int> free_slots;               // recycled, ready to fill
  std::vector<int> filled_slots;            // assembled, ready to pop
  int64_t next_batch = 0;                   // next global batch to assemble
  int64_t next_pop = 0;                     // next batch the consumer gets
  bool stop = false;

  // per-epoch permutation cache (workers share; rebuilt on epoch turn)
  std::vector<int64_t> perm;
  int64_t perm_epoch = -1;

  std::vector<std::thread> workers;

  int64_t batches_per_epoch() const {
    if (drop_last) return n_examples / batch_size;
    return (n_examples + batch_size - 1) / batch_size;
  }

  void build_perm(int64_t epoch) {
    perm.resize(n_examples);
    std::iota(perm.begin(), perm.end(), 0);
    if (shuffle) {
      std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (epoch + 1));
      for (int64_t i = n_examples - 1; i > 0; --i) {
        int64_t j = rng() % (i + 1);
        std::swap(perm[i], perm[j]);
      }
    }
    perm_epoch = epoch;
  }

  // Gather the example indices for `batch` — CALL UNDER THE LOCK: the
  // shared permutation may be rebuilt at epoch turns, and a worker still
  // filling the previous epoch must have snapshotted its rows already.
  std::vector<int64_t> rows_for(int64_t batch, int64_t* epoch_out) {
    int64_t bpe = batches_per_epoch();
    int64_t epoch = batch / bpe;
    int64_t start = (batch % bpe) * batch_size;
    int64_t rows = std::min(batch_size, n_examples - start);
    if (perm_epoch != epoch) build_perm(epoch);
    *epoch_out = epoch;
    return std::vector<int64_t>(perm.begin() + start,
                                perm.begin() + start + rows);
  }

  void fill(Slot& slot, const std::vector<int64_t>& rows) {
    for (size_t f = 0; f < fields.size(); ++f) {
      const Field& fd = fields[f];
      uint8_t* dst = slot.buffers[f];
      for (size_t r = 0; r < rows.size(); ++r) {
        std::memcpy(dst + r * fd.itemsize,
                    fd.data + rows[r] * fd.itemsize,
                    static_cast<size_t>(fd.itemsize));
      }
    }
    slot.batch_size = static_cast<int64_t>(rows.size());
  }

  void worker() {
    for (;;) {
      int idx;
      int64_t batch, epoch;
      std::vector<int64_t> rows;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop || !free_slots.empty(); });
        if (stop) return;
        idx = free_slots.front();
        free_slots.pop();
        batch = next_batch++;
        rows = rows_for(batch, &epoch);   // snapshot under the lock
      }
      fill(slots[idx], rows);             // memcpy outside the lock
      {
        std::lock_guard<std::mutex> g(mu);
        slots[idx].batch_index = batch;
        slots[idx].epoch = epoch;
        filled_slots.push_back(idx);
      }
      cv_filled.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// arrays[i]: base pointer of field i; itemsizes[i]: bytes per example;
// start_batch: the global batch index of the first batch popped.
void* cmn_loader_create(const void** arrays, const int64_t* itemsizes,
                        int n_fields, int64_t n_examples,
                        int64_t batch_size, int n_slots, int n_threads,
                        uint64_t seed, int shuffle, int drop_last,
                        int64_t start_batch) {
  if (n_fields <= 0 || n_examples <= 0 || batch_size <= 0 ||
      n_slots < 2 || n_threads <= 0 || start_batch < 0) {
    return nullptr;
  }
  auto* L = new Loader();
  L->next_batch = start_batch;
  L->next_pop = start_batch;
  L->n_examples = n_examples;
  L->batch_size = batch_size;
  L->shuffle = shuffle != 0;
  L->drop_last = drop_last != 0;
  L->seed = seed;
  int64_t slot_bytes = 0;
  for (int f = 0; f < n_fields; ++f) {
    L->fields.push_back(Field{
        static_cast<const uint8_t*>(arrays[f]), itemsizes[f]});
    slot_bytes += batch_size * itemsizes[f];
  }
  // one contiguous arena, 64-byte aligned per buffer
  int64_t aligned = (slot_bytes + 63) & ~int64_t(63);
  L->arena.resize(static_cast<size_t>(aligned) * n_slots + 64);
  uint8_t* base = L->arena.data();
  base += (64 - (reinterpret_cast<uintptr_t>(base) & 63)) & 63;
  L->slots.resize(n_slots);
  for (int s = 0; s < n_slots; ++s) {
    uint8_t* p = base + static_cast<size_t>(aligned) * s;
    for (int f = 0; f < n_fields; ++f) {
      L->slots[s].buffers.push_back(p);
      p += batch_size * itemsizes[f];
    }
    L->free_slots.push(s);
  }
  for (int t = 0; t < n_threads; ++t) {
    L->workers.emplace_back([L] { L->worker(); });
  }
  return L;
}

// Pops the NEXT-IN-ORDER filled slot (blocking): with several workers,
// batch i+1 can finish before batch i, so the consumer waits for the
// exact batch index it expects — deterministic batch order regardless of
// worker scheduling (the reference's iterators were deterministic too).
int cmn_loader_next(void* handle, void** out_ptrs, int64_t* out_rows,
                    int64_t* out_epoch) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  int chosen = -1;
  L->cv_filled.wait(lk, [&] {
    for (size_t i = 0; i < L->filled_slots.size(); ++i) {
      if (L->slots[L->filled_slots[i]].batch_index == L->next_pop) {
        chosen = L->filled_slots[i];
        L->filled_slots.erase(L->filled_slots.begin() + i);
        return true;
      }
    }
    return false;
  });
  L->next_pop++;
  const Slot& slot = L->slots[chosen];
  for (size_t f = 0; f < L->fields.size(); ++f) {
    out_ptrs[f] = slot.buffers[f];
  }
  *out_rows = slot.batch_size;
  *out_epoch = slot.epoch;
  return chosen;
}

// Recycle a slot once its buffers are consumed (device_put done).
void cmn_loader_release(void* handle, int slot) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> g(L->mu);
    L->free_slots.push(slot);
  }
  L->cv_free.notify_one();
}

void cmn_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> g(L->mu);
    L->stop = true;
  }
  L->cv_free.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// ------------------------------------------------------------------ //
// Parallel pack/unpack — the _memory_utility.pack_params analogue for
// host-side snapshot assembly: scatter/gather N buffers into one
// contiguous arena with a thread pool (memcpy saturates one core long
// before it saturates DRAM).
// ------------------------------------------------------------------ //

void cmn_pack(const void** srcs, const int64_t* sizes, int n, void* dst,
              int n_threads) {
  std::vector<int64_t> offs(n + 1, 0);
  for (int i = 0; i < n; ++i) offs[i + 1] = offs[i] + sizes[i];
  std::atomic<int> next{0};
  auto work = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      std::memcpy(static_cast<uint8_t*>(dst) + offs[i], srcs[i],
                  static_cast<size_t>(sizes[i]));
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads - 1; ++t) ts.emplace_back(work);
  work();
  for (auto& t : ts) t.join();
}

void cmn_unpack(const void* src, const int64_t* sizes, int n, void** dsts,
                int n_threads) {
  std::vector<int64_t> offs(n + 1, 0);
  for (int i = 0; i < n; ++i) offs[i + 1] = offs[i] + sizes[i];
  std::atomic<int> next{0};
  auto work = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      std::memcpy(dsts[i], static_cast<const uint8_t*>(src) + offs[i],
                  static_cast<size_t>(sizes[i]));
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads - 1; ++t) ts.emplace_back(work);
  work();
  for (auto& t : ts) t.join();
}

}  // extern "C"
