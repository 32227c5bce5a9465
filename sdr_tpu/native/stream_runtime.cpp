// Native stream runtime: bounded-ring block reader/writer threads.
//
// The equivalent of the reference's concurrency runtime
// (src/project.cpp:17-141): there the producer thread reads u8 blocks from
// stdin and hands them to consumers through a capacity-3 mutex/condvar
// queue.  Here the DSP pipeline lives on the device under one jitted step, so
// the native runtime's job is host I/O overlap: a reader thread pumps u8
// blocks from a file descriptor into a bounded ring (backpressure by
// blocking when full, like the reference's cvar wait at project.cpp:73-76),
// while Python pops blocks and feeds the device; a writer thread drains
// audio bytes so fwrite latency never stalls the compute loop.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C sdr_tpu/native   (g++ -O3 -shared -fPIC)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <unistd.h>

namespace {

struct BlockRing {
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
  std::queue<std::vector<uint8_t>> q;
  size_t capacity;
  bool eof = false;
  bool stopped = false;
};

struct Reader {
  int fd;
  size_t block_bytes;
  BlockRing ring;
  std::thread thread;
  std::atomic<uint64_t> blocks_read{0};
  std::vector<uint8_t> tail;  // partial final block (guarded by ring.mu)

  void pump() {
    std::vector<uint8_t> buf(block_bytes);
    while (true) {
      size_t got = 0;
      while (got < block_bytes) {
        ssize_t r = ::read(fd, buf.data() + got, block_bytes - got);
        if (r <= 0) {  // EOF or error: keep the short block as the tail so
                       // the consumer can flush it at a finer alignment
                       // (the reference drops it, src/project.cpp:51-54)
          std::lock_guard<std::mutex> lk(ring.mu);
          tail.assign(buf.data(), buf.data() + got);
          ring.eof = true;
          ring.not_empty.notify_all();
          return;
        }
        got += static_cast<size_t>(r);
      }
      std::unique_lock<std::mutex> lk(ring.mu);
      ring.not_full.wait(lk, [&] {
        return ring.q.size() < ring.capacity || ring.stopped;
      });
      if (ring.stopped) return;
      ring.q.push(buf);  // copy; ring owns its storage
      blocks_read.fetch_add(1, std::memory_order_relaxed);
      ring.not_empty.notify_one();
    }
  }
};

struct Writer {
  int fd;
  BlockRing ring;
  std::thread thread;

  void drain() {
    while (true) {
      std::vector<uint8_t> buf;
      {
        std::unique_lock<std::mutex> lk(ring.mu);
        ring.not_empty.wait(lk, [&] {
          return !ring.q.empty() || ring.stopped;
        });
        if (ring.q.empty()) return;  // stopped and drained
        buf = std::move(ring.q.front());
        ring.q.pop();
        ring.not_full.notify_one();
      }
      size_t put = 0;
      while (put < buf.size()) {
        ssize_t w = ::write(fd, buf.data() + put, buf.size() - put);
        if (w <= 0) return;
        put += static_cast<size_t>(w);
      }
    }
  }
};

}  // namespace

extern "C" {

void* sdr_reader_create(int fd, uint64_t block_bytes, uint64_t capacity) {
  auto* r = new Reader();
  r->fd = fd;
  r->block_bytes = block_bytes;
  r->ring.capacity = capacity ? capacity : 3;  // reference QUEUE_CAPACITY 3
  r->thread = std::thread([r] { r->pump(); });
  return r;
}

// Returns 0 = block copied to out, 1 = end of stream.
int sdr_reader_next(void* handle, uint8_t* out) {
  auto* r = static_cast<Reader*>(handle);
  std::unique_lock<std::mutex> lk(r->ring.mu);
  r->ring.not_empty.wait(lk, [&] {
    return !r->ring.q.empty() || r->ring.eof || r->ring.stopped;
  });
  if (r->ring.q.empty()) return 1;
  std::memcpy(out, r->ring.q.front().data(), r->block_bytes);
  r->ring.q.pop();
  r->ring.not_full.notify_one();
  return 0;
}

uint64_t sdr_reader_blocks_read(void* handle) {
  return static_cast<Reader*>(handle)->blocks_read.load();
}

// Copies the partial EOF tail (0 <= n < block_bytes) into out (which must
// hold block_bytes); returns n.  Valid once sdr_reader_next returned 1.
uint64_t sdr_reader_tail(void* handle, uint8_t* out) {
  auto* r = static_cast<Reader*>(handle);
  std::lock_guard<std::mutex> lk(r->ring.mu);
  if (!r->tail.empty()) std::memcpy(out, r->tail.data(), r->tail.size());
  return r->tail.size();
}

void sdr_reader_destroy(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  {
    std::lock_guard<std::mutex> lk(r->ring.mu);
    r->ring.stopped = true;
    r->ring.not_full.notify_all();
    r->ring.not_empty.notify_all();
  }
  if (r->thread.joinable()) r->thread.join();
  delete r;
}

void* sdr_writer_create(int fd, uint64_t capacity) {
  auto* w = new Writer();
  w->fd = fd;
  w->ring.capacity = capacity ? capacity : 8;
  w->thread = std::thread([w] { w->drain(); });
  return w;
}

// Enqueue bytes; blocks when the ring is full (backpressure).
void sdr_writer_push(void* handle, const uint8_t* data, uint64_t n) {
  auto* w = static_cast<Writer*>(handle);
  std::unique_lock<std::mutex> lk(w->ring.mu);
  w->ring.not_full.wait(lk, [&] {
    return w->ring.q.size() < w->ring.capacity || w->ring.stopped;
  });
  if (w->ring.stopped) return;
  w->ring.q.emplace(data, data + n);
  w->ring.not_empty.notify_one();
}

void sdr_writer_destroy(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  {
    std::lock_guard<std::mutex> lk(w->ring.mu);
    w->ring.stopped = true;
    w->ring.not_empty.notify_all();
    w->ring.not_full.notify_all();
  }
  if (w->thread.joinable()) w->thread.join();
  delete w;
}

}  // extern "C"
