// Record container + threaded loader for the port's data layer
// (data/recordio.py binds it with ctypes).
//
// The port's own copy of the JAX package's native/recordio.cc: the same
// chunk format, writer, scanner (with resync over corrupt chunks) and
// threaded loader, so either package reads the other's files and both
// write the same bytes for the same records. ≙ the reference's RecordIO
// container (paddle/fluid/recordio/{chunk,scanner,writer}.h) and its
// threaded reader stack (operators/reader/buffered_reader.h:27,
// reader/lod_tensor_blocking_queue.h:31).
//
// File format (little-endian):
//   file   := chunk*
//   chunk  := MAGIC u32 | flags u32 | raw_len u32 | comp_len u32
//             | crc32(payload) u32 | num_records u32 | payload
//   payload:= (rec_len u32 | bytes)*     (zlib-deflated iff flags & 1)
// A corrupt chunk is skipped by scanning forward for the next MAGIC.
//
// zlib: the four functions used are declared here, with zlib's own
// prototypes, and the library is linked by its runtime name
// (-l:libz.so.1), so the build needs no zlib header: a machine with
// libz's runtime alone (which Python's zlib module loads) builds it.

extern "C" {
typedef unsigned char Bytef;
typedef unsigned long uLong;
typedef unsigned long uLongf;
int compress2(Bytef* dest, uLongf* destLen, const Bytef* source,
              uLong sourceLen, int level);
uLong compressBound(uLong sourceLen);
int uncompress(Bytef* dest, uLongf* destLen, const Bytef* source,
               uLong sourceLen);
uLong crc32(uLong crc, const Bytef* buf, unsigned int len);
}

#define Z_OK 0
#define Z_DEFAULT_COMPRESSION (-1)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50545052;  // "PTPR"
constexpr uint32_t kFlagDeflate = 1u;

struct Header {
  uint32_t magic, flags, raw_len, comp_len, crc, num_records;
};

uint32_t Crc(const char* data, size_t n) {
  return static_cast<uint32_t>(
      crc32(0L, reinterpret_cast<const Bytef*>(data), n));
}

// ---------------------------------------------------------------- writer
class Writer {
 public:
  Writer(const char* path, uint32_t max_chunk_bytes, bool compress)
      : f_(std::fopen(path, "wb")),
        max_chunk_bytes_(max_chunk_bytes ? max_chunk_bytes : (1u << 20)),
        compress_(compress) {}

  bool ok() const { return f_ != nullptr; }

  bool Write(const char* data, uint32_t len) {
    uint32_t n = len;
    buf_.append(reinterpret_cast<const char*>(&n), sizeof(n));
    buf_.append(data, len);
    ++num_records_;
    if (buf_.size() >= max_chunk_bytes_) return Flush();
    return true;
  }

  bool Flush() {
    if (num_records_ == 0) return true;
    std::string payload;
    uint32_t flags = 0;
    if (compress_) {
      uLongf bound = compressBound(buf_.size());
      payload.resize(bound);
      if (compress2(reinterpret_cast<Bytef*>(&payload[0]), &bound,
                    reinterpret_cast<const Bytef*>(buf_.data()), buf_.size(),
                    Z_DEFAULT_COMPRESSION) != Z_OK)
        return false;
      payload.resize(bound);
      flags |= kFlagDeflate;
    } else {
      payload = buf_;
    }
    Header h{kMagic, flags, static_cast<uint32_t>(buf_.size()),
             static_cast<uint32_t>(payload.size()),
             Crc(payload.data(), payload.size()), num_records_};
    if (std::fwrite(&h, sizeof(h), 1, f_) != 1) return false;
    if (!payload.empty() &&
        std::fwrite(payload.data(), payload.size(), 1, f_) != 1)
      return false;
    buf_.clear();
    num_records_ = 0;
    return true;
  }

  bool Close() {
    bool ok = true;
    if (f_) {
      ok = Flush();
      ok = std::fclose(f_) == 0 && ok;
      f_ = nullptr;
    }
    return ok;
  }

  ~Writer() { Close(); }

 private:
  std::FILE* f_;
  uint32_t max_chunk_bytes_;
  bool compress_;
  std::string buf_;
  uint32_t num_records_ = 0;
};

// --------------------------------------------------------------- scanner
class Scanner {
 public:
  explicit Scanner(const char* path) : f_(std::fopen(path, "rb")) {
    if (f_) {
      std::fseek(f_, 0, SEEK_END);
      file_size_ = ftello(f_);
      std::fseek(f_, 0, SEEK_SET);
    }
  }
  bool ok() const { return f_ != nullptr; }

  // Returns pointer/len valid until the next call; nullptr at EOF.
  const char* Next(uint32_t* len) {
    while (idx_ >= records_.size()) {
      if (!LoadChunk()) return nullptr;
    }
    const std::string& r = records_[idx_++];
    *len = static_cast<uint32_t>(r.size());
    return r.data();
  }

  uint32_t skipped_chunks() const { return skipped_; }

  ~Scanner() {
    if (f_) std::fclose(f_);
  }

 private:
  // Reads the next valid chunk into records_; resyncs past corruption.
  bool LoadChunk() {
    Header h;
    for (;;) {
      long long pos = ftello(f_);
      if (std::fread(&h, sizeof(h), 1, f_) != 1) return false;
      if (h.magic != kMagic) {
        // resync: advance one byte past `pos` and scan for magic
        ++skipped_;
        fseeko(f_, pos + 1, SEEK_SET);
        if (!Resync()) return false;
        continue;
      }
      // bound the untrusted length by the bytes actually left in the file
      // BEFORE allocating — a corrupt comp_len must become a skipped chunk,
      // not a std::bad_alloc escaping the C ABI
      long long here = ftello(f_);
      if (here < 0 ||
          static_cast<long long>(h.comp_len) > file_size_ - here) {
        ++skipped_;
        fseeko(f_, pos + 1, SEEK_SET);
        if (!Resync()) return false;
        continue;
      }
      std::string payload(h.comp_len, '\0');
      if (h.comp_len &&
          std::fread(&payload[0], h.comp_len, 1, f_) != 1) {
        // short read: corrupt length header or truncated file — count it
        // and resync instead of silently ending the scan
        ++skipped_;
        fseeko(f_, pos + 1, SEEK_SET);
        if (!Resync()) return false;
        continue;
      }
      if (Crc(payload.data(), payload.size()) != h.crc) {
        ++skipped_;
        fseeko(f_, pos + 1, SEEK_SET);
        if (!Resync()) return false;
        continue;
      }
      std::string raw;
      if (h.flags & kFlagDeflate) {
        raw.resize(h.raw_len);
        uLongf dlen = h.raw_len;
        if (uncompress(reinterpret_cast<Bytef*>(&raw[0]), &dlen,
                       reinterpret_cast<const Bytef*>(payload.data()),
                       payload.size()) != Z_OK ||
            dlen != h.raw_len) {
          ++skipped_;
          fseeko(f_, pos + 1, SEEK_SET);
          if (!Resync()) return false;
          continue;
        }
      } else {
        raw.swap(payload);
      }
      records_.clear();
      idx_ = 0;
      size_t off = 0;
      bool bad = false;
      for (uint32_t i = 0; i < h.num_records; ++i) {
        if (off + sizeof(uint32_t) > raw.size()) { bad = true; break; }
        uint32_t n;
        std::memcpy(&n, raw.data() + off, sizeof(n));
        off += sizeof(n);
        if (off + n > raw.size()) { bad = true; break; }
        records_.emplace_back(raw.data() + off, n);
        off += n;
      }
      if (bad) {
        ++skipped_;
        records_.clear();
        continue;
      }
      return !records_.empty();
    }
  }

  // Scan forward byte-by-byte (buffered) until MAGIC; leaves file pos at it.
  bool Resync() {
    uint32_t window = 0;
    int c;
    size_t got = 0;
    while ((c = std::fgetc(f_)) != EOF) {
      window = (window >> 8) | (static_cast<uint32_t>(c) << 24);
      if (++got >= 4 && window == kMagic) {
        std::fseek(f_, -4, SEEK_CUR);
        return true;
      }
    }
    return false;
  }

  std::FILE* f_;
  std::vector<std::string> records_;
  size_t idx_ = 0;
  uint32_t skipped_ = 0;
  long long file_size_ = 0;
};

// ------------------------------------------------- bounded blocking queue
// ≙ reference LoDTensorBlockingQueue (reader/lod_tensor_blocking_queue.h:31)
class BlockingQueue {
 public:
  explicit BlockingQueue(size_t cap) : cap_(cap) {}

  bool Push(std::string&& v) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return false;
    q_.push_back(std::move(v));
    not_empty_.notify_one();
    return true;
  }

  // false => queue closed AND drained
  bool Pop(std::string* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

 private:
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<std::string> q_;
  size_t cap_;
  bool closed_ = false;
};

// ------------------------------------------------------- threaded loader
// N worker threads scan disjoint file subsets into one bounded queue
// (≙ open_files_op multi-file reading + double-buffer prefetch).
class Loader {
 public:
  Loader(const std::vector<std::string>& files, int num_threads,
         size_t queue_cap)
      : queue_(queue_cap) {
    if (files.empty()) {  // no workers will ever close the queue
      queue_.Close();
      return;
    }
    if (num_threads <= 0) num_threads = 1;
    if (num_threads > static_cast<int>(files.size()))
      num_threads = static_cast<int>(files.size());
    pending_workers_ = num_threads;
    for (int t = 0; t < num_threads; ++t) {
      std::vector<std::string> mine;
      for (size_t i = t; i < files.size();
           i += static_cast<size_t>(num_threads))
        mine.push_back(files[i]);
      workers_.emplace_back([this, mine] { Work(mine); });
    }
  }

  bool Next(std::string* out) { return queue_.Pop(out); }

  void Shutdown() {
    queue_.Close();
    for (auto& w : workers_)
      if (w.joinable()) w.join();
    workers_.clear();
  }

  ~Loader() { Shutdown(); }

  uint32_t failed_files() const { return failed_files_.load(); }
  uint32_t skipped_chunks() const { return skipped_chunks_.load(); }

 private:
  void Work(const std::vector<std::string>& files) {
    for (const auto& path : files) {
      Scanner s(path.c_str());
      if (!s.ok()) {
        ++failed_files_;  // surfaced via rio_loader_failed_files
        continue;
      }
      uint32_t len;
      const char* p;
      while ((p = s.Next(&len)) != nullptr) {
        if (!queue_.Push(std::string(p, len))) return;  // closed
      }
      skipped_chunks_ += s.skipped_chunks();
    }
    if (--pending_workers_ == 0) queue_.Close();  // EOF for consumers
  }

  BlockingQueue queue_;
  std::vector<std::thread> workers_;
  std::atomic<int> pending_workers_{0};
  std::atomic<uint32_t> failed_files_{0};
  std::atomic<uint32_t> skipped_chunks_{0};
};

thread_local std::string g_last;  // holds Pop/Next result for the C ABI

}  // namespace

// ---------------------------------------------------------------- C ABI
extern "C" {

void* rio_writer_open(const char* path, uint32_t max_chunk_bytes,
                      int compress) {
  auto* w = new Writer(path, max_chunk_bytes, compress != 0);
  if (!w->ok()) {
    delete w;
    return nullptr;
  }
  return w;
}

int rio_writer_write(void* h, const char* data, uint32_t len) {
  return static_cast<Writer*>(h)->Write(data, len) ? 0 : -1;
}

int rio_writer_flush(void* h) {
  return static_cast<Writer*>(h)->Flush() ? 0 : -1;
}

int rio_writer_close(void* h) {
  auto* w = static_cast<Writer*>(h);
  int rc = w->Close() ? 0 : -1;
  delete w;
  return rc;
}

void* rio_scanner_open(const char* path) {
  auto* s = new Scanner(path);
  if (!s->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

// returns pointer to record bytes (valid until next call on this scanner
// from the same thread) or nullptr at EOF
const char* rio_scanner_next(void* h, uint32_t* len) {
  const char* p = static_cast<Scanner*>(h)->Next(len);
  // Scanner::Next's pointer stays valid until the next call on this
  // scanner — no defensive copy needed.
  return p;
}

uint32_t rio_scanner_skipped(void* h) {
  return static_cast<Scanner*>(h)->skipped_chunks();
}

void rio_scanner_close(void* h) { delete static_cast<Scanner*>(h); }

void* rio_loader_open(const char** paths, int num_paths, int num_threads,
                      uint32_t queue_cap) {
  std::vector<std::string> files(paths, paths + num_paths);
  return new Loader(files, num_threads, queue_cap ? queue_cap : 64);
}

const char* rio_loader_next(void* h, uint32_t* len) {
  if (!static_cast<Loader*>(h)->Next(&g_last)) return nullptr;
  *len = static_cast<uint32_t>(g_last.size());
  return g_last.data();
}

uint32_t rio_loader_failed_files(void* h) {
  return static_cast<Loader*>(h)->failed_files();
}

uint32_t rio_loader_skipped(void* h) {
  return static_cast<Loader*>(h)->skipped_chunks();
}

void rio_loader_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
