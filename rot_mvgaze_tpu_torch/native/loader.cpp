// rmg_loader: the native batch-assembly engine of the port's packed-cache
// loader (the port's own copy of the repository's native/loader.cpp).
//
// Subject archives are packed once into flat caches that can be
// memory-mapped (rot_mvgaze_tpu_torch/data/packed.py), and this engine
// gathers shuffled stereo batches with a parallel memcpy pool: no Python, no
// GIL and no decompression on the hot path. It is host code, built with g++
// by rot_mvgaze_tpu_torch/data/native.py.
//
// C ABI (ctypes):
//   rmg_pool_create / rmg_pool_add / rmg_pool_destroy   mmap management
//   rmg_file_info                                       a file's n, h, w, c
//   rmg_pool_gather                                     synchronous gather
//   rmg_pool_gather_async / rmg_wait                    double buffering
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC -o librmg_loader.so loader.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <unordered_set>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kHeaderSize = 56;
constexpr char kMagic[9] = "RMGPACK1";

struct PackedFile {
  const uint8_t* base = nullptr;
  size_t map_len = 0;
  uint64_t n = 0;
  uint32_t h = 0, w = 0, c = 0;
  const uint8_t* img = nullptr;
  const float* gaze = nullptr;
  const float* pose = nullptr;

  size_t img_bytes() const { return size_t(h) * w * c; }
};

struct Task {
  // One gather job: for sample s, copy row rows[s] of file files[s] into
  // out_img + s*img_bytes (and labels likewise).
  const int32_t* files;
  const int64_t* rows;
  int64_t n_samples;
  uint8_t* out_img;
  float* out_gaze;
  float* out_pose;
};

class Pool {
 public:
  explicit Pool(int n_threads) : stop_(false) {
    if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
    // hardware_concurrency() may legally return 0; an empty pool would
    // deadlock async waits and divide-by-zero in Gather's chunking.
    if (n_threads <= 0) n_threads = 1;
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
    for (auto& f : files_)
      if (f.base) munmap(const_cast<uint8_t*>(f.base), f.map_len);
  }

  int AddFile(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      return -1;
    }
    void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    close(fd);
    if (mem == MAP_FAILED) return -1;
    const uint8_t* base = static_cast<const uint8_t*>(mem);
    const uint64_t map_len = uint64_t(st.st_size);
    // Validate the whole header and the claimed extents against the mapped
    // size: a truncated or corrupt pack must fail loudly here (a negative
    // error the Python side raises), never SIGBUS inside a worker memcpy.
    if (map_len < kHeaderSize || memcmp(base, kMagic, 8) != 0) {
      munmap(mem, st.st_size);
      return -2;
    }
    PackedFile f;
    f.base = base;
    f.map_len = st.st_size;
    memcpy(&f.n, base + 8, 8);
    memcpy(&f.h, base + 16, 4);
    memcpy(&f.w, base + 20, 4);
    memcpy(&f.c, base + 24, 4);
    uint64_t img_off, gaze_off, pose_off;
    memcpy(&img_off, base + 32, 8);
    memcpy(&gaze_off, base + 40, 8);
    memcpy(&pose_off, base + 48, 8);
    // Overflow-proof extent math: a corrupted header with a huge n (or
    // absurd dims) must not wrap n*h*w*c or off+bytes in uint64 and slip
    // past validation — that would re-enable the SIGBUS this check exists
    // to prevent. Bound the dims first so the per-sample product fits, use
    // checked division for n, and compare offsets by subtraction.
    constexpr uint64_t kMaxDim = 1ull << 20;  // 1M px/side, 1M channels
    if (f.h == 0 || f.w == 0 || f.c == 0 ||
        f.h > kMaxDim || f.w > kMaxDim || f.c > kMaxDim) {
      munmap(mem, st.st_size);
      return -3;
    }
    const uint64_t per_sample = uint64_t(f.h) * f.w * f.c;  // <= 2^60
    if (f.n > map_len / per_sample || f.n > map_len / (2 * sizeof(float))) {
      munmap(mem, st.st_size);
      return -3;
    }
    const uint64_t img_bytes = uint64_t(f.n) * per_sample;
    const uint64_t label_bytes = uint64_t(f.n) * 2 * sizeof(float);
    if (img_off < kHeaderSize || img_off > map_len ||
        img_bytes > map_len - img_off ||
        gaze_off < kHeaderSize || gaze_off > map_len ||
        label_bytes > map_len - gaze_off ||
        pose_off < kHeaderSize || pose_off > map_len ||
        label_bytes > map_len - pose_off) {
      munmap(mem, st.st_size);
      return -3;  // truncated or inconsistent pack
    }
    f.img = base + img_off;
    f.gaze = reinterpret_cast<const float*>(base + gaze_off);
    f.pose = reinterpret_cast<const float*>(base + pose_off);
    {
      std::unique_lock<std::mutex> lk(mu_);
      // push_back may reallocate files_, which gather workers index without
      // the lock — drain every in-flight async gather first (cheap: files
      // are added at dataset construction, gathers run at steady state).
      // Callers must likewise not race AddFile with a SYNCHRONOUS
      // rmg_pool_gather from another thread (the Python wrapper adds all
      // files in its constructor, before any gather).
      done_cv_.wait(lk, [&] {
        return queue_.empty() && done_set_.empty() &&
               done_contig_ == last_ticket_;
      });
      // All pool files must share one image geometry: Gather computes the
      // caller's output offset as s * this-file's img_bytes, and the Python
      // side sizes the batch buffer from file 0 — mixed dims would silently
      // interleave/overflow that buffer.
      if (!files_.empty() &&
          (f.h != files_[0].h || f.w != files_[0].w || f.c != files_[0].c)) {
        munmap(mem, st.st_size);
        return -4;
      }
      files_.push_back(f);
      return int(files_.size()) - 1;
    }
  }

  // Gather n_samples rows; parallelized over a static chunking of samples.
  void Gather(const Task& t) {
    int n_workers = int(workers_.size());
    std::atomic<int64_t> next{0};
    const int64_t chunk = std::max<int64_t>(1, t.n_samples / (n_workers * 4));
    auto work = [&]() {
      for (;;) {
        int64_t start = next.fetch_add(chunk);
        if (start >= t.n_samples) break;
        int64_t end = std::min(start + chunk, t.n_samples);
        for (int64_t s = start; s < end; ++s) {
          const PackedFile& f = files_[t.files[s]];
          const size_t ib = f.img_bytes();
          memcpy(t.out_img + size_t(s) * ib, f.img + size_t(t.rows[s]) * ib, ib);
          memcpy(t.out_gaze + s * 2, f.gaze + t.rows[s] * 2, 2 * sizeof(float));
          memcpy(t.out_pose + s * 2, f.pose + t.rows[s] * 2, 2 * sizeof(float));
        }
      }
    };
    // Run on the caller's thread plus one-shot helper threads: a thread is
    // cheap beside a batch's memcpy, and Gather stays usable both
    // synchronously and from inside a persistent worker.
    std::vector<std::thread> helpers;
    int n_help = std::min<int64_t>(n_workers - 1,
                                   std::max<int64_t>(0, t.n_samples / chunk - 1));
    helpers.reserve(n_help);
    for (int i = 0; i < n_help; ++i) helpers.emplace_back(work);
    work();
    for (auto& h : helpers) h.join();
  }

  uint64_t SubmitAsync(const Task& t) {
    uint64_t ticket;
    {
      std::lock_guard<std::mutex> lk(mu_);
      ticket = ++last_ticket_;
      queue_.push({ticket, t});
    }
    cv_.notify_one();
    return ticket;
  }

  void Wait(uint64_t ticket) {
    // Tickets complete out of order with >1 worker thread, so completion is
    // tracked exactly: a contiguous low-watermark plus a set of tickets that
    // finished ahead of it. Waiting on "max completed >= ticket" would return
    // while an earlier ticket is still writing its output buffer.
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] {
      return ticket <= done_contig_ || done_set_.count(ticket) != 0;
    });
  }

  const PackedFile* File(int idx) const {
    if (idx < 0 || idx >= int(files_.size())) return nullptr;
    return &files_[idx];
  }

 private:
  void WorkerLoop() {
    for (;;) {
      std::pair<uint64_t, Task> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        job = queue_.front();
        queue_.pop();
      }
      Gather(job.second);
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_set_.insert(job.first);
        while (done_set_.erase(done_contig_ + 1)) ++done_contig_;
      }
      done_cv_.notify_all();
    }
  }

  std::vector<PackedFile> files_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::queue<std::pair<uint64_t, Task>> queue_;
  uint64_t last_ticket_ = 0;
  uint64_t done_contig_ = 0;            // all tickets <= this are complete
  std::unordered_set<uint64_t> done_set_;  // completed tickets > done_contig_
  bool stop_;
};

}  // namespace

extern "C" {

void* rmg_pool_create(int n_threads) { return new Pool(n_threads); }

void rmg_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Returns file index >= 0, or negative error.
int rmg_pool_add(void* pool, const char* path) {
  return static_cast<Pool*>(pool)->AddFile(path);
}

// Shape query: fills n/h/w/c for file idx; returns 0 on success.
int rmg_file_info(void* pool, int idx, int64_t* n, int* h, int* w, int* c) {
  const PackedFile* f = static_cast<Pool*>(pool)->File(idx);
  if (!f) return -1;
  *n = int64_t(f->n);
  *h = int(f->h);
  *w = int(f->w);
  *c = int(f->c);
  return 0;
}

void rmg_pool_gather(void* pool, const int32_t* files, const int64_t* rows,
                     int64_t n_samples, uint8_t* out_img, float* out_gaze,
                     float* out_pose) {
  Task t{files, rows, n_samples, out_img, out_gaze, out_pose};
  static_cast<Pool*>(pool)->Gather(t);
}

uint64_t rmg_pool_gather_async(void* pool, const int32_t* files,
                               const int64_t* rows, int64_t n_samples,
                               uint8_t* out_img, float* out_gaze,
                               float* out_pose) {
  Task t{files, rows, n_samples, out_img, out_gaze, out_pose};
  return static_cast<Pool*>(pool)->SubmitAsync(t);
}

void rmg_wait(void* pool, uint64_t ticket) {
  static_cast<Pool*>(pool)->Wait(ticket);
}

}  // extern "C"
