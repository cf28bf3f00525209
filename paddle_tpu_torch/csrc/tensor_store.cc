// Native tensor container: fast checkpoint/persistables I/O.
//
// ≙ paddle_tpu/native/tensor_store.cc, in the same file format, with
// CRC-32 computed here (zlib's polynomial, slicing-by-8 tables) instead
// of linking zlib, so the build needs g++ alone. A file this build
// writes is byte-for-byte the file the zlib build writes.
//
// Capability equivalent of the reference's LoDTensor (de)serialization used
// by save/load ops (reference: paddle/fluid/framework/lod_tensor.cc
// SerializeToStream / DeserializeFromStream, operators/save_combine_op.cc /
// load_combine_op.cc — one file holding many named tensors, streamed through
// C++ so checkpointing large models never round-trips Python objects).
// Design is new: single translation unit, C ABI for ctypes, CRC-checked
// entries, O(1) name lookup via an index footer, buffered sequential writes.
//
// File format (little-endian):
//   file   := MAGIC u32 | version u32 | entry* | index | index_off u64
//             | index_len u32 | crc32(index) u32 | MAGIC u32
//   entry  := name_len u16 | name | crc32(hdr) u32 | hdr | data
//   hdr    := dtype u8 | ndim u8 | dims u64*ndim | data_len u64
//             | crc32(data) u32
//   index  := count u32 | (name_len u16 | name | entry_off u64)*
//
// dtype codes match numpy kinds the framework uses:
//   0=f32 1=f64 2=i32 3=i64 4=u8 5=bool 6=bf16 7=f16 8=i16 9=u32 10=u64

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50545453;  // "PTTS"
constexpr uint32_t kVersion = 2;         // v2: per-entry header CRC
constexpr uint8_t kMaxDims = 16;

// CRC-32 (reflected polynomial 0xEDB88320, init and final xor ~0: zlib's
// crc32), eight bytes a step through eight derived tables.
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const CrcTables& Tables() {
  static const CrcTables tables;
  return tables;
}

uint32_t Crc(const char* data, size_t n) {
  const uint32_t(*t)[256] = Tables().t;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(data);
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Entry {
  uint8_t dtype = 0;
  std::vector<uint64_t> dims;
  uint64_t data_off = 0;  // absolute file offset of raw data
  uint64_t data_len = 0;
  uint32_t crc = 0;
};

// ---------------------------------------------------------------- writer
class StoreWriter {
 public:
  explicit StoreWriter(const char* path) : f_(std::fopen(path, "wb")) {
    if (f_) {
      std::fwrite(&kMagic, 4, 1, f_);
      std::fwrite(&kVersion, 4, 1, f_);
    }
  }

  bool ok() const { return f_ != nullptr; }

  bool Add(const char* name, uint8_t dtype, const uint64_t* dims,
           uint8_t ndim, const char* data, uint64_t len) {
    if (!f_) return false;
    if (ndim > kMaxDims) return false;
    uint16_t name_len = static_cast<uint16_t>(std::strlen(name));
    long long off = ftello(f_);
    if (off < 0) return false;
    index_[std::string(name)] = static_cast<uint64_t>(off);
    // header blob (dtype|ndim|dims|data_len|data_crc) is itself CRC'd so
    // metadata corruption fails loudly instead of decoding garbage
    std::string hdr;
    hdr.append(reinterpret_cast<const char*>(&dtype), 1);
    hdr.append(reinterpret_cast<const char*>(&ndim), 1);
    hdr.append(reinterpret_cast<const char*>(dims), 8ull * ndim);
    hdr.append(reinterpret_cast<const char*>(&len), 8);
    uint32_t dcrc = Crc(data, len);
    hdr.append(reinterpret_cast<const char*>(&dcrc), 4);
    uint32_t hcrc = Crc(hdr.data(), hdr.size());
    std::fwrite(&name_len, 2, 1, f_);
    std::fwrite(name, 1, name_len, f_);
    std::fwrite(&hcrc, 4, 1, f_);
    std::fwrite(hdr.data(), 1, hdr.size(), f_);
    return std::fwrite(data, 1, len, f_) == len || len == 0;
  }

  bool Finish() {
    if (!f_) return false;
    long long ioff = ftello(f_);
    if (ioff < 0) return false;
    std::string idx;
    uint32_t count = static_cast<uint32_t>(index_.size());
    idx.append(reinterpret_cast<const char*>(&count), 4);
    for (const auto& kv : index_) {
      uint16_t nl = static_cast<uint16_t>(kv.first.size());
      idx.append(reinterpret_cast<const char*>(&nl), 2);
      idx.append(kv.first);
      idx.append(reinterpret_cast<const char*>(&kv.second), 8);
    }
    std::fwrite(idx.data(), 1, idx.size(), f_);
    uint64_t off64 = static_cast<uint64_t>(ioff);
    uint32_t ilen = static_cast<uint32_t>(idx.size());
    uint32_t icrc = Crc(idx.data(), idx.size());
    std::fwrite(&off64, 8, 1, f_);
    std::fwrite(&ilen, 4, 1, f_);
    std::fwrite(&icrc, 4, 1, f_);
    std::fwrite(&kMagic, 4, 1, f_);
    bool ok = std::fflush(f_) == 0;
    std::fclose(f_);
    f_ = nullptr;
    return ok;
  }

  ~StoreWriter() {
    if (f_) Finish();
  }

 private:
  std::FILE* f_;
  std::map<std::string, uint64_t> index_;
};

// ---------------------------------------------------------------- reader
class StoreReader {
 public:
  explicit StoreReader(const char* path) : f_(std::fopen(path, "rb")) {
    if (!f_) return;
    uint32_t magic = 0, version = 0;
    if (std::fread(&magic, 4, 1, f_) != 1 || magic != kMagic ||
        std::fread(&version, 4, 1, f_) != 1 || version != kVersion) {
      Close();
      return;
    }
    // footer: index_off u64 | index_len u32 | crc u32 | magic u32
    if (fseeko(f_, -20, SEEK_END) != 0) { Close(); return; }
    uint64_t ioff = 0;
    uint32_t ilen = 0, icrc = 0, tail = 0;
    if (std::fread(&ioff, 8, 1, f_) != 1 ||
        std::fread(&ilen, 4, 1, f_) != 1 ||
        std::fread(&icrc, 4, 1, f_) != 1 ||
        std::fread(&tail, 4, 1, f_) != 1 || tail != kMagic) {
      Close();
      return;
    }
    std::string idx(ilen, '\0');
    if (fseeko(f_, static_cast<long long>(ioff), SEEK_SET) != 0 ||
        (ilen && std::fread(&idx[0], 1, ilen, f_) != ilen) ||
        Crc(idx.data(), idx.size()) != icrc) {
      Close();
      return;
    }
    // parse index then load each entry header
    size_t p = 0;
    auto rd = [&](void* dst, size_t n) {
      if (p + n > idx.size()) return false;
      std::memcpy(dst, idx.data() + p, n);
      p += n;
      return true;
    };
    uint32_t count = 0;
    if (!rd(&count, 4)) { Close(); return; }
    for (uint32_t i = 0; i < count; ++i) {
      uint16_t nl = 0;
      if (!rd(&nl, 2)) { Close(); return; }
      if (p + nl > idx.size()) { Close(); return; }
      std::string name(idx.data() + p, nl);
      p += nl;
      uint64_t off = 0;
      if (!rd(&off, 8)) { Close(); return; }
      if (!LoadHeader(name, off)) { Close(); return; }
    }
    ok_ = true;
  }

  bool ok() const { return ok_; }
  size_t count() const { return entries_.size(); }

  // list names joined by '\n' into caller buffer; returns required size
  uint64_t Names(char* buf, uint64_t cap) const {
    std::string all;
    for (const auto& kv : entries_) {
      if (!all.empty()) all.push_back('\n');
      all.append(kv.first);
    }
    if (buf && cap >= all.size()) std::memcpy(buf, all.data(), all.size());
    return all.size();
  }

  // metadata: returns data_len; fills dtype/ndim/dims (dims cap 16)
  uint64_t Meta(const char* name, uint8_t* dtype, uint8_t* ndim,
                uint64_t* dims) const {
    auto it = entries_.find(name);
    if (it == entries_.end()) return UINT64_MAX;
    const Entry& e = it->second;
    *dtype = e.dtype;
    *ndim = static_cast<uint8_t>(e.dims.size());
    for (size_t i = 0; i < e.dims.size() && i < 16; ++i) dims[i] = e.dims[i];
    return e.data_len;
  }

  // read the tensor payload into caller buffer; verifies CRC
  bool Read(const char* name, char* dst, uint64_t cap) {
    auto it = entries_.find(name);
    if (it == entries_.end()) return false;
    const Entry& e = it->second;
    if (cap < e.data_len) return false;
    if (fseeko(f_, static_cast<long long>(e.data_off), SEEK_SET) != 0)
      return false;
    if (e.data_len &&
        std::fread(dst, 1, e.data_len, f_) != e.data_len) return false;
    return Crc(dst, e.data_len) == e.crc;
  }

  ~StoreReader() { Close(); }

 private:
  bool LoadHeader(const std::string& name, uint64_t off) {
    if (fseeko(f_, static_cast<long long>(off), SEEK_SET) != 0) return false;
    uint16_t nl = 0;
    if (std::fread(&nl, 2, 1, f_) != 1) return false;
    std::string stored(nl, '\0');
    if (nl && std::fread(&stored[0], 1, nl, f_) != nl) return false;
    if (stored != name) return false;  // index/entry mismatch = corruption
    Entry e;
    uint32_t hcrc = 0;
    if (std::fread(&hcrc, 4, 1, f_) != 1) return false;
    std::string hdr(2, '\0');
    if (std::fread(&hdr[0], 1, 2, f_) != 2) return false;
    uint8_t ndim = static_cast<uint8_t>(hdr[1]);
    if (ndim > kMaxDims) return false;
    size_t rest = 8ull * ndim + 8 + 4;
    hdr.resize(2 + rest);
    if (std::fread(&hdr[2], 1, rest, f_) != rest) return false;
    if (Crc(hdr.data(), hdr.size()) != hcrc) return false;
    e.dtype = static_cast<uint8_t>(hdr[0]);
    e.dims.resize(ndim);
    std::memcpy(e.dims.data(), hdr.data() + 2, 8ull * ndim);
    std::memcpy(&e.data_len, hdr.data() + 2 + 8ull * ndim, 8);
    std::memcpy(&e.crc, hdr.data() + 2 + 8ull * ndim + 8, 4);
    long long pos = ftello(f_);
    if (pos < 0) return false;
    e.data_off = static_cast<uint64_t>(pos);
    entries_[name] = e;
    return true;
  }

  void Close() {
    if (f_) std::fclose(f_);
    f_ = nullptr;
    ok_ = false;
  }

  std::FILE* f_ = nullptr;
  bool ok_ = false;
  std::map<std::string, Entry> entries_;
};

}  // namespace

// ------------------------------------------------------------------ C ABI
extern "C" {

void* ptpu_store_writer_open(const char* path) {
  auto* w = new StoreWriter(path);
  if (!w->ok()) {
    delete w;
    return nullptr;
  }
  return w;
}

int ptpu_store_writer_add(void* h, const char* name, uint8_t dtype,
                          const uint64_t* dims, uint8_t ndim,
                          const char* data, uint64_t len) {
  return static_cast<StoreWriter*>(h)->Add(name, dtype, dims, ndim, data,
                                           len) ? 1 : 0;
}

int ptpu_store_writer_finish(void* h) {
  auto* w = static_cast<StoreWriter*>(h);
  int ok = w->Finish() ? 1 : 0;
  delete w;
  return ok;
}

void* ptpu_store_reader_open(const char* path) {
  auto* r = new StoreReader(path);
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

uint64_t ptpu_store_reader_names(void* h, char* buf, uint64_t cap) {
  return static_cast<StoreReader*>(h)->Names(buf, cap);
}

uint64_t ptpu_store_reader_meta(void* h, const char* name, uint8_t* dtype,
                                uint8_t* ndim, uint64_t* dims) {
  return static_cast<StoreReader*>(h)->Meta(name, dtype, ndim, dims);
}

int ptpu_store_reader_read(void* h, const char* name, char* dst,
                           uint64_t cap) {
  return static_cast<StoreReader*>(h)->Read(name, dst, cap) ? 1 : 0;
}

void ptpu_store_reader_close(void* h) {
  delete static_cast<StoreReader*>(h);
}

uint32_t ptpu_store_version() { return kVersion; }

}  // extern "C"
