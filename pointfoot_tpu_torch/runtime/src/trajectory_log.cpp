// Async trajectory recorder: lock-free SPSC ring buffer + writer thread.
//
// Native runtime component of pointfoot_tpu (the reference framework's
// native surface lived in the Isaac Gym binary; our compute path is
// XLA/Pallas, and the host-side runtime around it is C++ — see SURVEY.md
// §2.9).  The trainer/rollout loop pushes fixed-size float records
// (observations, torques, contact forces...) from the host callback path;
// a background thread drains them to a binary log file, so device-to-disk
// telemetry never stalls the jitted step.  Used for sys-ID data capture
// (the role of the reference's rosbag -> npy pipeline, read_bag1.py) and
// rollout replay.
//
// File format: 16-byte header [magic u32 | version u32 | record_size u32 |
// reserved u32], then raw little-endian float32 records.
//
// C ABI (ctypes-friendly):
//   void*  tlog_open(const char* path, uint32_t record_size, uint32_t capacity);
//   int    tlog_push(void* h, const float* data);       // 1 ok, 0 dropped
//   int    tlog_push_n(void* h, const float* data, uint32_t n);  // #accepted
//   uint64_t tlog_written(void* h);
//   uint64_t tlog_dropped(void* h);
//   void   tlog_flush(void* h);     // block until queue drained + fflush
//   void   tlog_close(void* h);

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x544C4F47;  // "TLOG"
constexpr uint32_t kVersion = 1;

struct TLog {
  FILE* file = nullptr;
  uint32_t record_size = 0;   // floats per record
  uint32_t capacity = 0;      // records in the ring
  std::vector<float> ring;    // capacity * record_size
  std::atomic<uint64_t> head{0};  // producer writes
  std::atomic<uint64_t> tail{0};  // consumer reads
  std::atomic<uint64_t> dropped{0};
  std::atomic<uint64_t> written{0};
  std::atomic<bool> stop{false};
  std::thread writer;
  std::mutex wake_mu;
  std::condition_variable wake_cv;

  void writer_loop() {
    std::vector<float> batch;
    while (true) {
      uint64_t t = tail.load(std::memory_order_relaxed);
      uint64_t h = head.load(std::memory_order_acquire);
      if (t == h) {
        if (stop.load(std::memory_order_relaxed)) break;
        std::unique_lock<std::mutex> lk(wake_mu);
        wake_cv.wait_for(lk, std::chrono::milliseconds(5));
        continue;
      }
      // drain contiguous chunk
      uint64_t n = h - t;
      while (n > 0) {
        uint64_t idx = t % capacity;
        uint64_t run = std::min<uint64_t>(n, capacity - idx);
        fwrite(ring.data() + idx * record_size, sizeof(float),
               run * record_size, file);
        written.fetch_add(run, std::memory_order_relaxed);
        t += run;
        n -= run;
      }
      tail.store(t, std::memory_order_release);
    }
    fflush(file);
  }
};

}  // namespace

extern "C" {

void* tlog_open(const char* path, uint32_t record_size, uint32_t capacity) {
  if (record_size == 0 || capacity == 0) return nullptr;
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  uint32_t header[4] = {kMagic, kVersion, record_size, 0};
  fwrite(header, sizeof(uint32_t), 4, f);
  auto* log = new TLog();
  log->file = f;
  log->record_size = record_size;
  log->capacity = capacity;
  log->ring.resize(static_cast<size_t>(capacity) * record_size);
  log->writer = std::thread([log] { log->writer_loop(); });
  return log;
}

int tlog_push(void* handle, const float* data) {
  auto* log = static_cast<TLog*>(handle);
  uint64_t h = log->head.load(std::memory_order_relaxed);
  uint64_t t = log->tail.load(std::memory_order_acquire);
  if (h - t >= log->capacity) {  // full: drop (never block the train loop)
    log->dropped.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  std::memcpy(log->ring.data() + (h % log->capacity) * log->record_size,
              data, log->record_size * sizeof(float));
  log->head.store(h + 1, std::memory_order_release);
  log->wake_cv.notify_one();
  return 1;
}

int tlog_push_n(void* handle, const float* data, uint32_t n) {
  auto* log = static_cast<TLog*>(handle);
  int accepted = 0;
  for (uint32_t i = 0; i < n; ++i) {
    accepted += tlog_push(handle, data + static_cast<size_t>(i) * log->record_size);
  }
  return accepted;
}

uint64_t tlog_written(void* handle) {
  return static_cast<TLog*>(handle)->written.load(std::memory_order_relaxed);
}

uint64_t tlog_dropped(void* handle) {
  return static_cast<TLog*>(handle)->dropped.load(std::memory_order_relaxed);
}

void tlog_flush(void* handle) {
  auto* log = static_cast<TLog*>(handle);
  while (log->tail.load(std::memory_order_acquire) !=
         log->head.load(std::memory_order_acquire)) {
    log->wake_cv.notify_one();
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  fflush(log->file);
}

void tlog_close(void* handle) {
  auto* log = static_cast<TLog*>(handle);
  log->stop.store(true);
  log->wake_cv.notify_one();
  if (log->writer.joinable()) log->writer.join();
  fclose(log->file);
  delete log;
}

}  // extern "C"
