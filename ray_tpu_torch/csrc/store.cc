// Shared-memory arena object store (native core of the node object plane).
//
// Role-equivalent of the reference's plasma store internals
// (src/ray/object_manager/plasma: plasma_allocator.cc + dlmalloc arena +
// obj_lifecycle_mgr.cc): one mmap'd /dev/shm arena per node, a first-fit
// free list with coalescing, and an object table keyed by 16-byte ids. The
// raylet process owns allocation; worker processes map the same arena file
// and read objects zero-copy at the returned offsets (fd passing not
// required — the arena is a named file, which also lets numpy and torch
// map buffers directly).
//
// The port's copy of the JAX package's src/object_store/store.cc, built by
// ray_tpu_torch/_private/cpp_store.py; the C++ is unchanged.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>

namespace {

struct ObjectId {
  uint8_t bytes[16];
  bool operator==(const ObjectId& o) const {
    return std::memcmp(bytes, o.bytes, 16) == 0;
  }
};

struct ObjectIdHash {
  size_t operator()(const ObjectId& id) const {
    uint64_t h;
    std::memcpy(&h, id.bytes, 8);
    uint64_t l;
    std::memcpy(&l, id.bytes + 8, 8);
    return static_cast<size_t>(h ^ (l * 0x9e3779b97f4a7c15ULL));
  }
};

struct Entry {
  uint64_t offset;
  uint64_t size;
  bool sealed;
};

constexpr uint64_t kAlign = 64;

inline uint64_t AlignUp(uint64_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

class ArenaStore {
 public:
  ArenaStore(const std::string& path, uint64_t capacity, bool create)
      : path_(path), capacity_(AlignUp(capacity)) {
    int flags = O_RDWR | (create ? O_CREAT : 0);
    fd_ = ::open(path.c_str(), flags, 0600);
    if (fd_ < 0) {
      ok_ = false;
      return;
    }
    if (create && ::ftruncate(fd_, static_cast<off_t>(capacity_)) != 0) {
      ok_ = false;
      return;
    }
    base_ = ::mmap(nullptr, capacity_, PROT_READ | PROT_WRITE, MAP_SHARED, fd_, 0);
    if (base_ == MAP_FAILED) {
      ok_ = false;
      return;
    }
    if (create) {
      free_list_[0] = capacity_;  // offset -> length
    }
  }

  ~ArenaStore() {
    if (base_ != nullptr && base_ != MAP_FAILED) ::munmap(base_, capacity_);
    if (fd_ >= 0) ::close(fd_);
  }

  bool ok() const { return ok_; }

  // First-fit allocation with free-list coalescing on free.
  int Alloc(const ObjectId& id, uint64_t size, uint64_t* offset_out) {
    std::lock_guard<std::mutex> g(mu_);
    if (objects_.count(id)) return -2;  // exists
    uint64_t need = AlignUp(size);
    for (auto it = free_list_.begin(); it != free_list_.end(); ++it) {
      if (it->second >= need) {
        uint64_t off = it->first;
        uint64_t rest = it->second - need;
        free_list_.erase(it);
        if (rest > 0) free_list_[off + need] = rest;
        objects_[id] = Entry{off, size, false};
        used_ += need;
        *offset_out = off;
        return 0;
      }
    }
    return -1;  // out of memory / fragmentation
  }

  int Seal(const ObjectId& id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return -1;
    it->second.sealed = true;
    return 0;
  }

  int Lookup(const ObjectId& id, uint64_t* offset, uint64_t* size, int* sealed) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return -1;
    *offset = it->second.offset;
    *size = it->second.size;
    *sealed = it->second.sealed ? 1 : 0;
    return 0;
  }

  int Free(const ObjectId& id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return -1;
    uint64_t off = it->second.offset;
    uint64_t len = AlignUp(it->second.size);
    objects_.erase(it);
    used_ -= len;
    // coalesce with neighbors
    auto next = free_list_.lower_bound(off);
    if (next != free_list_.begin()) {
      auto prev = std::prev(next);
      if (prev->first + prev->second == off) {
        off = prev->first;
        len += prev->second;
        free_list_.erase(prev);
      }
    }
    next = free_list_.lower_bound(off + len);
    if (next != free_list_.end() && next->first == off + len) {
      len += next->second;
      free_list_.erase(next);
    }
    free_list_[off] = len;
    return 0;
  }

  uint64_t Used() {
    std::lock_guard<std::mutex> g(mu_);
    return used_;
  }

  uint64_t Capacity() const { return capacity_; }
  void* Base() const { return base_; }

  uint64_t NumObjects() {
    std::lock_guard<std::mutex> g(mu_);
    return objects_.size();
  }

  uint64_t LargestFree() {
    std::lock_guard<std::mutex> g(mu_);
    uint64_t best = 0;
    for (auto& kv : free_list_) best = kv.second > best ? kv.second : best;
    return best;
  }

 private:
  std::string path_;
  uint64_t capacity_;
  int fd_ = -1;
  void* base_ = nullptr;
  bool ok_ = true;
  std::mutex mu_;
  std::unordered_map<ObjectId, Entry, ObjectIdHash> objects_;
  std::map<uint64_t, uint64_t> free_list_;  // offset -> length, sorted
  uint64_t used_ = 0;
};

ObjectId ToId(const uint8_t* oid) {
  ObjectId id;
  std::memcpy(id.bytes, oid, 16);
  return id;
}

}  // namespace

extern "C" {

void* rts_open(const char* path, uint64_t capacity, int create) {
  auto* store = new ArenaStore(path, capacity, create != 0);
  if (!store->ok()) {
    delete store;
    return nullptr;
  }
  return store;
}

void rts_close(void* handle) { delete static_cast<ArenaStore*>(handle); }

int rts_alloc(void* handle, const uint8_t* oid, uint64_t size, uint64_t* offset_out) {
  return static_cast<ArenaStore*>(handle)->Alloc(ToId(oid), size, offset_out);
}

int rts_seal(void* handle, const uint8_t* oid) {
  return static_cast<ArenaStore*>(handle)->Seal(ToId(oid));
}

int rts_lookup(void* handle, const uint8_t* oid, uint64_t* offset, uint64_t* size,
               int* sealed) {
  return static_cast<ArenaStore*>(handle)->Lookup(ToId(oid), offset, size, sealed);
}

int rts_free(void* handle, const uint8_t* oid) {
  return static_cast<ArenaStore*>(handle)->Free(ToId(oid));
}

uint64_t rts_used(void* handle) { return static_cast<ArenaStore*>(handle)->Used(); }

uint64_t rts_capacity(void* handle) {
  return static_cast<ArenaStore*>(handle)->Capacity();
}

uint64_t rts_num_objects(void* handle) {
  return static_cast<ArenaStore*>(handle)->NumObjects();
}

uint64_t rts_largest_free(void* handle) {
  return static_cast<ArenaStore*>(handle)->LargestFree();
}

// direct data access helpers (server-side copies for spill/restore)
int rts_read(void* handle, uint64_t offset, uint64_t length, uint8_t* out) {
  auto* store = static_cast<ArenaStore*>(handle);
  if (offset + length > store->Capacity()) return -1;
  std::memcpy(out, static_cast<uint8_t*>(store->Base()) + offset, length);
  return 0;
}

int rts_write(void* handle, uint64_t offset, const uint8_t* data, uint64_t length) {
  auto* store = static_cast<ArenaStore*>(handle);
  if (offset + length > store->Capacity()) return -1;
  std::memcpy(static_cast<uint8_t*>(store->Base()) + offset, data, length);
  return 0;
}

}  // extern "C"
