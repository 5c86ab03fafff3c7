// fstore: memory-mapped feature-store reader with asynchronous prefetch.
//
// The port's copy of native/fstore.cc (the RVFS format:
// revisionllm_tpu_torch/data/feature_store.py), bound by
// revisionllm_tpu_torch/data/native_store.py through ctypes:
//
//  - a worker-thread prefetch queue: while the device works on batch N,
//    the host faults in the pages of batch N+1 (madvise(WILLNEED) + an
//    explicit touch pass, which also works on filesystems where madvise is a
//    no-op);
//  - GIL-free bulk copies into caller-owned buffers (ctypes releases the GIL
//    during the call), so Python-side data workers overlap with decode.
//
// It differs from native/fstore.cc in fstore_close, which sets `shutdown`
// under the queue's mutex: set outside it, the store and its notify can fall
// between a worker's predicate check and its wait, and that worker then
// sleeps through the shutdown while close joins it forever.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct PrefetchTask {
  uint64_t offset;
  uint64_t length;
};

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  uint64_t size = 0;

  std::vector<std::thread> workers;
  std::deque<PrefetchTask> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<int> pending{0};
  std::atomic<bool> shutdown{false};

  void worker_loop() {
    const uint64_t page = static_cast<uint64_t>(sysconf(_SC_PAGESIZE));
    for (;;) {
      PrefetchTask task;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] { return shutdown.load() || !queue.empty(); });
        if (shutdown.load() && queue.empty()) return;
        task = queue.front();
        queue.pop_front();
      }
      uint64_t begin = task.offset & ~(page - 1);
      uint64_t end = task.offset + task.length;
      if (end > size) end = size;
      if (begin < end) {
        madvise(const_cast<uint8_t*>(base) + begin, end - begin, MADV_WILLNEED);
        // touch one byte per page: forces the fault even where WILLNEED is
        // advisory-only; volatile sink prevents the loop being optimized out
        volatile uint8_t sink = 0;
        for (uint64_t p = begin; p < end; p += page) sink ^= base[p];
        (void)sink;
      }
      pending.fetch_sub(1);
    }
  }
};

}  // namespace

extern "C" {

void* fstore_open(const char* path, int num_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  madvise(base, st.st_size, MADV_RANDOM);  // keyed access pattern

  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->size = static_cast<uint64_t>(st.st_size);
  if (num_threads < 1) num_threads = 2;
  for (int i = 0; i < num_threads; ++i) {
    s->workers.emplace_back([s] { s->worker_loop(); });
  }
  return s;
}

void fstore_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  {
    std::lock_guard<std::mutex> lock(s->mu);
    s->shutdown.store(true);
  }
  s->cv.notify_all();
  for (auto& t : s->workers) t.join();
  munmap(const_cast<uint8_t*>(s->base), s->size);
  close(s->fd);
  delete s;
}

// Copy [offset, offset+length) into dst. Returns bytes copied (clamped).
uint64_t fstore_read(void* handle, uint64_t offset, uint64_t length, void* dst) {
  auto* s = static_cast<Store*>(handle);
  if (!s || offset >= s->size) return 0;
  uint64_t n = length;
  if (offset + n > s->size) n = s->size - offset;
  std::memcpy(dst, s->base + offset, n);
  return n;
}

// Zero-copy pointer into the mapping (caller must not outlive the store).
const void* fstore_view(void* handle, uint64_t offset) {
  auto* s = static_cast<Store*>(handle);
  if (!s || offset >= s->size) return nullptr;
  return s->base + offset;
}

void fstore_prefetch(void* handle, uint64_t offset, uint64_t length) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  s->pending.fetch_add(1);
  {
    std::lock_guard<std::mutex> lock(s->mu);
    s->queue.push_back({offset, length});
  }
  s->cv.notify_one();
}

int fstore_pending(void* handle) {
  auto* s = static_cast<Store*>(handle);
  return s ? s->pending.load() : 0;
}

uint64_t fstore_size(void* handle) {
  auto* s = static_cast<Store*>(handle);
  return s ? s->size : 0;
}

}  // extern "C"
