// Native token-file loader of the port (host C++, not a kernel): the
// counterpart of src/data_loader/loader.cc. An mmap'd token file is sampled
// into a ring of batch buffers by a background thread; the Python side
// (ray_tpu_torch/data/token_loader.py, through ctypes) hands out zero-copy
// int32 views, which the caller copies to the card.
//
// File format: raw little-endian tokens, dtype selected by token_bytes
// (2 = uint16, 4 = int32). Each sampled row is `seq + 1` consecutive tokens
// at a seeded-random offset (targets = inputs shifted by one, sliced in
// Python).
//
// Order: the one filling thread draws the offsets of the batches in fill
// order, and dl_next hands filled slots out in that order (a FIFO), so
// batch k is the k-th draw of the seeded xorshift stream at any ring size
// and any consumer timing, as the numpy route's batch k is.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
};

struct Loader {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t file_bytes = 0;
  int64_t num_tokens = 0;
  int token_bytes = 4;
  int64_t batch = 0, seq = 0;
  int n_buffers = 0;
  std::vector<int32_t*> buffers;  // n_buffers x (batch * (seq+1))
  std::vector<int> free_slots;    // slots neither filled nor held
  std::deque<int> filled;         // filled slots, oldest fill first
  std::mutex mu;
  std::condition_variable cv_filled, cv_free;
  std::thread worker;
  std::atomic<bool> stop{false};
  XorShift rng;
  int64_t batches_produced = 0;

  explicit Loader(uint64_t seed) : rng(seed) {}

  void fill_loop() {
    while (true) {
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_slots.empty(); });
        if (stop.load()) return;
        slot = free_slots.back();
        free_slots.pop_back();
      }
      fill(buffers[slot]);
      {
        std::lock_guard<std::mutex> lk(mu);
        filled.push_back(slot);
        batches_produced++;
      }
      cv_filled.notify_one();
    }
  }

  void fill(int32_t* out) {
    const int64_t row = seq + 1;
    const int64_t max_start = num_tokens - row;
    for (int64_t b = 0; b < batch; b++) {
      int64_t start = max_start > 0 ? (int64_t)(rng.next() % (uint64_t)(max_start + 1)) : 0;
      if (token_bytes == 4) {
        std::memcpy(out + b * row, data + (size_t)start * 4, (size_t)row * 4);
      } else {  // widen uint16 -> int32
        const uint16_t* src = reinterpret_cast<const uint16_t*>(data) + start;
        int32_t* dst = out + b * row;
        for (int64_t i = 0; i < row; i++) dst[i] = (int32_t)src[i];
      }
    }
  }
};

}  // namespace

extern "C" {

void* dl_create(const char* path, int64_t batch, int64_t seq, uint64_t seed,
                int n_buffers, int token_bytes) {
  if (n_buffers < 1 || batch < 1 || seq < 1) return nullptr;
  if (token_bytes != 2 && token_bytes != 4) return nullptr;
  auto* L = new Loader(seed);
  L->fd = open(path, O_RDONLY);
  if (L->fd < 0) { delete L; return nullptr; }
  struct stat st;
  if (fstat(L->fd, &st) != 0 || st.st_size < (seq + 1) * token_bytes) {
    close(L->fd);
    delete L;
    return nullptr;
  }
  L->file_bytes = (size_t)st.st_size;
  L->data = (const uint8_t*)mmap(nullptr, L->file_bytes, PROT_READ, MAP_PRIVATE,
                                 L->fd, 0);
  if (L->data == MAP_FAILED) { close(L->fd); delete L; return nullptr; }
  madvise((void*)L->data, L->file_bytes, MADV_RANDOM);
  L->token_bytes = token_bytes;
  L->num_tokens = (int64_t)(L->file_bytes / (size_t)token_bytes);
  L->batch = batch;
  L->seq = seq;
  L->n_buffers = n_buffers;
  L->buffers.resize(n_buffers);
  for (int i = 0; i < n_buffers; i++) {
    L->buffers[i] = new int32_t[(size_t)batch * (size_t)(seq + 1)];
    L->free_slots.push_back(i);
  }
  L->worker = std::thread([L] { L->fill_loop(); });
  return L;
}

// Blocks until a filled buffer is ready; returns the oldest filled slot
// (>= 0), now held by the caller, or -1 once the loader is stopping.
int dl_next(void* h) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_filled.wait(lk, [&] { return L->stop.load() || !L->filled.empty(); });
  if (L->stop.load()) return -1;
  int slot = L->filled.front();
  L->filled.pop_front();
  return slot;
}

int32_t* dl_buffer(void* h, int slot) {
  auto* L = (Loader*)h;
  if (slot < 0 || slot >= L->n_buffers) return nullptr;
  return L->buffers[slot];
}

// Returns a held slot to the ring. The Python side releases only the slot
// that dl_next handed it, once.
void dl_release(void* h, int slot) {
  auto* L = (Loader*)h;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    if (slot < 0 || slot >= L->n_buffers) return;
    L->free_slots.push_back(slot);
  }
  L->cv_free.notify_one();
}

int64_t dl_num_tokens(void* h) { return ((Loader*)h)->num_tokens; }

int64_t dl_batches_produced(void* h) {
  auto* L = (Loader*)h;
  std::lock_guard<std::mutex> lk(L->mu);
  return L->batches_produced;
}

void dl_destroy(void* h) {
  auto* L = (Loader*)h;
  {
    // store under the mutex: orders against the cv predicates so the
    // worker / a blocked dl_next can't miss the wakeup
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_free.notify_all();
  L->cv_filled.notify_all();
  if (L->worker.joinable()) L->worker.join();
  for (auto* b : L->buffers) delete[] b;
  if (L->data && L->data != MAP_FAILED) munmap((void*)L->data, L->file_bytes);
  if (L->fd >= 0) close(L->fd);
  delete L;
}

}  // extern "C"
