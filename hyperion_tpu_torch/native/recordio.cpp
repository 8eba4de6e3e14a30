// recordio: memory-mapped fixed-record binary storage for training data.
//
// Role (SURVEY §2.3): the reference's tokenized corpora live in HF/Arrow
// files whose zero-copy reads come from the Arrow C++ core; this is the
// in-tree native equivalent — an mmap-backed record file the Python data
// layer reads without copying, with per-host shard windows for
// multi-host input pipelines.
//
// Format (little-endian):
//   [0:8)    magic "HYPREC01"
//   [8:16)   u64 record_count
//   [16:24)  u64 record_bytes       (fixed-size records)
//   [24:32)  u64 reserved
//   [32:...) payload, record_count * record_bytes
//
// The C ABI below is consumed via ctypes (no pybind11 in the image).
// Thread-safety: handles are immutable after open; concurrent reads are
// safe (mmap + pread semantics).

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'H', 'Y', 'P', 'R', 'E', 'C', '0', '1'};
constexpr uint64_t kHeaderBytes = 32;

struct Header {
  char magic[8];
  uint64_t count;
  uint64_t record_bytes;
  uint64_t reserved;
};

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;  // whole-file mapping
  uint64_t file_bytes = 0;
  uint64_t count = 0;
  uint64_t record_bytes = 0;
};

}  // namespace

extern "C" {

// Writes a complete record file in one call. Returns 0 on success.
int hyprec_write(const char* path, const void* data, uint64_t count,
                 uint64_t record_bytes) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  Header h{};
  std::memcpy(h.magic, kMagic, 8);
  h.count = count;
  h.record_bytes = record_bytes;
  int ok = std::fwrite(&h, sizeof(h), 1, f) == 1 &&
           (count == 0 ||
            std::fwrite(data, record_bytes, count, f) == count);
  return std::fclose(f) == 0 && ok ? 0 : -2;
}

// Opens and mmaps a record file. Returns a handle (heap pointer) or null.
void* hyprec_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || static_cast<uint64_t>(st.st_size) < kHeaderBytes) {
    ::close(fd);
    return nullptr;
  }
  void* mapped = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mapped == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const Header* h = static_cast<const Header*>(mapped);
  if (std::memcmp(h->magic, kMagic, 8) != 0 ||
      kHeaderBytes + h->count * h->record_bytes !=
          static_cast<uint64_t>(st.st_size)) {
    ::munmap(mapped, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Reader* r = new Reader();
  r->fd = fd;
  r->base = static_cast<const uint8_t*>(mapped);
  r->file_bytes = st.st_size;
  r->count = h->count;
  r->record_bytes = h->record_bytes;
  // training access is random (shuffled epochs)
  ::madvise(mapped, st.st_size, MADV_RANDOM);
  return r;
}

uint64_t hyprec_count(const void* handle) {
  return handle ? static_cast<const Reader*>(handle)->count : 0;
}

uint64_t hyprec_record_bytes(const void* handle) {
  return handle ? static_cast<const Reader*>(handle)->record_bytes : 0;
}

// Pointer to record i inside the mapping (zero-copy; valid until close).
const void* hyprec_record(const void* handle, uint64_t i) {
  const Reader* r = static_cast<const Reader*>(handle);
  if (!r || i >= r->count) return nullptr;
  return r->base + kHeaderBytes + i * r->record_bytes;
}

// Gathers `n` records by index into `out` (n * record_bytes). The batch
// assembly loop the Python layer would otherwise do row-by-row. -1 on
// any out-of-range index.
int hyprec_gather(const void* handle, const uint64_t* indices, uint64_t n,
                  void* out) {
  const Reader* r = static_cast<const Reader*>(handle);
  if (!r) return -1;
  uint8_t* dst = static_cast<uint8_t*>(out);
  const uint8_t* payload = r->base + kHeaderBytes;
  for (uint64_t j = 0; j < n; ++j) {
    if (indices[j] >= r->count) return -1;
    std::memcpy(dst + j * r->record_bytes,
                payload + indices[j] * r->record_bytes, r->record_bytes);
  }
  return 0;
}

void hyprec_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r) return;
  ::munmap(const_cast<uint8_t*>(r->base), r->file_bytes);
  ::close(r->fd);
  delete r;
}

}  // extern "C"
