// Native event IO for dgcnn_tpu_torch (a copy of the JAX package's
// dgcnn_tpu/io/native/event_reader.cpp): mmap'd binary event store and
// threaded batch assembly.
//
// The DGB ("dynamic-graph binary") format is a flat, mmap-able layout of
// variable-length labeled point clouds; reading an event is a pointer
// offset, and assembling a padded/cropped minibatch (the host-side hot
// path that feeds the card) runs one worker thread per event with no
// Python-object traffic.
//
// File layout (little-endian):
//   0x00  magic   "DGB1"
//   0x04  u32     num_features F
//   0x08  u64     num_events E
//   0x10  u32     flags (bit0: labels present, bit1: weights present)
//   0x14  u32     reserved
//   0x18  u64[E+1] point offsets (prefix sums)
//   ....  f32     points  [total, F]
//   ....  i32     labels  [total]          (if flags&1)
//   ....  f32     weights [total]          (if flags&2)
//
// Exposed C ABI (ctypes; see native/__init__.py):
//   dgb_open / dgb_close / dgb_info / dgb_event_bounds
//   dgb_read_batch — crop (canonical policy: stratified-random | stride)
//                    + pad + stack
//
// Build (native/__init__.py, at first use, into build/native/):
//   g++ -O3 -shared -fPIC -pthread -std=c++17 event_reader.cpp -o libdgbio-<hash>.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct DgbFile {
  int fd = -1;
  size_t size = 0;
  const uint8_t* base = nullptr;
  uint32_t num_features = 0;
  uint64_t num_events = 0;
  uint32_t flags = 0;
  const uint64_t* offsets = nullptr;  // E+1 entries
  const float* points = nullptr;
  const int32_t* labels = nullptr;
  const float* weights = nullptr;
};

constexpr uint32_t kMagic = 0x31424744;  // "DGB1"

// splitmix64 finalizer — MUST stay bit-identical to io/crop.py::_sm64
// (cross-path crop bit-exactness is tested).
inline uint64_t sm64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

constexpr uint64_t kPhi = 0x9E3779B97F4A7C15ULL;

// Canonical crop policy (io/crop.py::crop_select): source row for output
// row j when cropping n -> m. mode 0 = stratified random, 1 = stride.
inline int64_t crop_src(int64_t j, int64_t n, int64_t m, int mode,
                        uint64_t base) {
  const int64_t lo = (j * n) / m;
  if (mode == 1) return lo;
  const int64_t hi = ((j + 1) * n) / m;
  const uint64_t h = sm64(base + (static_cast<uint64_t>(j) + 1) * kPhi);
  return lo + static_cast<int64_t>(h % static_cast<uint64_t>(hi - lo));
}

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or nullptr on failure.
void* dgb_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 0x18) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* f = new DgbFile();
  f->fd = fd;
  f->size = st.st_size;
  f->base = static_cast<const uint8_t*>(mem);
  uint32_t magic;
  std::memcpy(&magic, f->base, 4);
  std::memcpy(&f->num_features, f->base + 0x04, 4);
  std::memcpy(&f->num_events, f->base + 0x08, 8);
  std::memcpy(&f->flags, f->base + 0x10, 4);
  if (magic != kMagic || f->num_features == 0) {
    munmap(mem, f->size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  // bounds-check the offsets table BEFORE dereferencing it: a corrupt
  // header claiming a huge num_events must fail cleanly, not read out of
  // the mapping (also guards the (E+1)*8 arithmetic against overflow)
  const uint64_t max_entries = (f->size - 0x18) / sizeof(uint64_t);
  if (f->num_events >= max_entries) {
    munmap(mem, f->size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  const uint8_t* p = f->base + 0x18;
  f->offsets = reinterpret_cast<const uint64_t*>(p);
  p += (f->num_events + 1) * sizeof(uint64_t);
  // offsets must start at 0 and be non-decreasing: a corrupt table would
  // make offsets[i+1]-offsets[i] wrap to a huge unsigned count and drive
  // out-of-bounds memcpy in dgb_read_batch
  if (f->offsets[0] != 0) {
    munmap(mem, f->size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  for (uint64_t i = 0; i < f->num_events; ++i) {
    if (f->offsets[i + 1] < f->offsets[i]) {
      munmap(mem, f->size);
      ::close(fd);
      delete f;
      return nullptr;
    }
  }
  const uint64_t total = f->offsets[f->num_events];
  // bound total BEFORE the pointer arithmetic below: a monotonic but
  // huge offsets[E] (e.g. 2^62) would overflow total*F*sizeof(float),
  // wrap the truncation check, and leave OOB reads reachable for direct
  // native-API consumers
  const uint64_t row_bytes =
      static_cast<uint64_t>(f->num_features) * sizeof(float);
  if (total > (f->size - 0x18) / row_bytes) {
    munmap(mem, f->size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  f->points = reinterpret_cast<const float*>(p);
  p += total * f->num_features * sizeof(float);
  if (f->flags & 1) {
    f->labels = reinterpret_cast<const int32_t*>(p);
    p += total * sizeof(int32_t);
  }
  if (f->flags & 2) {
    f->weights = reinterpret_cast<const float*>(p);
    p += total * sizeof(float);
  }
  if (static_cast<size_t>(p - f->base) > f->size) {  // truncated file
    munmap(mem, f->size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  return f;
}

void dgb_close(void* handle) {
  auto* f = static_cast<DgbFile*>(handle);
  if (!f) return;
  munmap(const_cast<uint8_t*>(f->base), f->size);
  ::close(f->fd);
  delete f;
}

// info[0]=num_events, info[1]=num_features, info[2]=flags, info[3]=total_points
void dgb_info(void* handle, uint64_t* info) {
  auto* f = static_cast<DgbFile*>(handle);
  info[0] = f->num_events;
  info[1] = f->num_features;
  info[2] = f->flags;
  info[3] = f->offsets[f->num_events];
}

// start/count of one event's rows.
void dgb_event_bounds(void* handle, uint64_t i, uint64_t* start,
                      uint64_t* count) {
  auto* f = static_cast<DgbFile*>(handle);
  *start = f->offsets[i];
  *count = f->offsets[i + 1] - f->offsets[i];
}

// Assemble a padded minibatch straight from the mmap.
//
//   event_ids [batch]   events to load
//   n_pad               padded point count (output row stride)
//   crop                max points kept per event (<= n_pad); longer
//                       events are subsampled with the canonical crop
//                       policy (see crop_src / io/crop.py)
//   crop_mode           0 = stratified random (seeded), 1 = stride
//   seed                crop seed (combined with the event id)
//   out_points  [batch, n_pad, F]  (zero-filled padding)
//   out_labels  [batch, n_pad]     (zeros if absent)
//   out_weights [batch, n_pad]     (zeros if absent; pass nullptr to skip)
//   out_mask    [batch, n_pad]     (uint8 0/1)
//   out_lengths [batch]            true event sizes
//
// Returns 0 on success, -1 on bad event id.
int dgb_read_batch(void* handle, const int64_t* event_ids, int64_t batch,
                   int64_t n_pad, int64_t crop, int32_t crop_mode,
                   uint64_t seed, float* out_points, int32_t* out_labels,
                   float* out_weights, uint8_t* out_mask,
                   int64_t* out_lengths) {
  auto* f = static_cast<DgbFile*>(handle);
  const int64_t F = f->num_features;
  std::atomic<int> rc{0};
  if (crop <= 0 || crop > n_pad) crop = n_pad;

  auto worker = [&](int64_t b) {
    const int64_t eid = event_ids[b];
    if (eid < 0 || static_cast<uint64_t>(eid) >= f->num_events) {
      rc.store(-1);
      return;
    }
    const uint64_t lo = f->offsets[eid];
    const int64_t n = static_cast<int64_t>(f->offsets[eid + 1] - lo);
    out_lengths[b] = n;
    float* dst_p = out_points + b * n_pad * F;
    int32_t* dst_l = out_labels ? out_labels + b * n_pad : nullptr;
    float* dst_w = out_weights ? out_weights + b * n_pad : nullptr;
    uint8_t* dst_m = out_mask + b * n_pad;
    std::memset(dst_p, 0, sizeof(float) * n_pad * F);
    if (dst_l) std::memset(dst_l, 0, sizeof(int32_t) * n_pad);
    if (dst_w) std::memset(dst_w, 0, sizeof(float) * n_pad);
    std::memset(dst_m, 0, n_pad);

    const int64_t m = std::min<int64_t>(n, crop);
    if (n <= crop) {
      std::memcpy(dst_p, f->points + lo * F, sizeof(float) * n * F);
      if (dst_l && f->labels)
        std::memcpy(dst_l, f->labels + lo, sizeof(int32_t) * n);
      if (dst_w && f->weights)
        std::memcpy(dst_w, f->weights + lo, sizeof(float) * n);
    } else {
      // canonical subsample — bit-identical to io/crop.py::crop_select
      const uint64_t base =
          sm64((seed ^ (static_cast<uint64_t>(eid) * kPhi)) + kPhi);
      for (int64_t j = 0; j < m; ++j) {
        const int64_t src = lo + crop_src(j, n, m, crop_mode, base);
        std::memcpy(dst_p + j * F, f->points + src * F, sizeof(float) * F);
        if (dst_l && f->labels) dst_l[j] = f->labels[src];
        if (dst_w && f->weights) dst_w[j] = f->weights[src];
      }
    }
    std::memset(dst_m, 1, m);
  };

  if (batch <= 1) {
    for (int64_t b = 0; b < batch; ++b) worker(b);
  } else {
    // bounded worker count: one thread PER EVENT would put thread
    // create/join on the per-step hot path (and can exceed container
    // thread limits at large batches); a few workers striding over the
    // batch do the same memcpy work with constant overhead
    const unsigned hw = std::thread::hardware_concurrency();
    const int64_t n_workers =
        std::min<int64_t>(batch, std::max(2u, hw ? hw : 8u));
    std::vector<std::thread> threads;
    threads.reserve(n_workers);
    for (int64_t w = 0; w < n_workers; ++w) {
      threads.emplace_back([&, w]() {
        for (int64_t b = w; b < batch; b += n_workers) worker(b);
      });
    }
    for (auto& t : threads) t.join();
  }
  return rc.load();
}

}  // extern "C"
