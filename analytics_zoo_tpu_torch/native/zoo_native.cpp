// Port of analytics_zoo_tpu/native/zoo_native.cpp (a copy; the port builds
// it into its own build directory, never beside this source).
// Native runtime primitives for analytics_zoo_tpu.
//
// Reference parity (SURVEY.md §2.10): the reference's runtime data plane was
// native — Spark BlockManager (netty), Ray plasma, Redis, PMEM native arrays
// behind JNI.  The TPU-native equivalent is the host-side data plane that
// feeds the chip: a bounded MPMC byte-queue (prefetch pipelines, serving
// request batching) implemented in C++ with POSIX threads, exposed through a
// plain C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC zoo_native.cpp -o libzoonative.so
// (driven by analytics_zoo_tpu/native/__init__.py at first import).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Item {
  std::vector<uint8_t> data;
  uint64_t tag;
};

struct Queue {
  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;
  std::deque<Item> items;
  size_t capacity_items;
  size_t capacity_bytes;
  size_t bytes = 0;
  std::atomic<bool> closed{false};
  // stats
  std::atomic<uint64_t> pushed{0};
  std::atomic<uint64_t> popped{0};
};

}  // namespace

extern "C" {

// ---- bounded MPMC byte queue ------------------------------------------------

void* zn_queue_create(size_t capacity_items, size_t capacity_bytes) {
  auto* q = new Queue();
  q->capacity_items = capacity_items ? capacity_items : SIZE_MAX;
  q->capacity_bytes = capacity_bytes ? capacity_bytes : SIZE_MAX;
  return q;
}

void zn_queue_destroy(void* qp) { delete static_cast<Queue*>(qp); }

void zn_queue_close(void* qp) {
  auto* q = static_cast<Queue*>(qp);
  q->closed.store(true);
  std::lock_guard<std::mutex> lk(q->mu);
  q->not_empty.notify_all();
  q->not_full.notify_all();
}

// returns: 0 ok, -1 timeout, -2 closed
int zn_queue_push(void* qp, const uint8_t* data, size_t len, uint64_t tag,
                  int timeout_ms) {
  auto* q = static_cast<Queue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  auto has_room = [&] {
    return (q->items.size() < q->capacity_items &&
            q->bytes + len <= q->capacity_bytes) || q->closed.load();
  };
  if (timeout_ms < 0) {
    q->not_full.wait(lk, has_room);
  } else if (!q->not_full.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   has_room)) {
    return -1;
  }
  if (q->closed.load()) return -2;
  Item it;
  it.data.assign(data, data + len);
  it.tag = tag;
  q->bytes += len;
  q->items.push_back(std::move(it));
  q->pushed.fetch_add(1);
  q->not_empty.notify_one();
  return 0;
}

// Peek size of the next item without popping (0 if empty).
size_t zn_queue_next_size(void* qp) {
  auto* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.empty() ? 0 : q->items.front().data.size();
}

// Pop into caller buffer.  Returns payload size (>= 0), -3 on timeout,
// -2 closed+empty.  A zero-length payload is a valid pop (returns 0), which
// is why timeout has its own code.  If the buffer is too small the item
// stays queued and -(needed) is returned (callers retry with a bigger
// buffer; needed is always > buflen >= 4, so it cannot collide with
// -2/-3).
long long zn_queue_pop(void* qp, uint8_t* buf, size_t buflen, uint64_t* tag,
                       int timeout_ms) {
  auto* q = static_cast<Queue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  auto has_item = [&] { return !q->items.empty() || q->closed.load(); };
  if (timeout_ms < 0) {
    q->not_empty.wait(lk, has_item);
  } else if (!q->not_empty.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                    has_item)) {
    return -3;
  }
  if (q->items.empty()) return -2;  // closed and drained
  Item& it = q->items.front();
  if (it.data.size() > buflen) return -(long long)it.data.size();
  size_t n = it.data.size();
  std::memcpy(buf, it.data.data(), n);
  if (tag) *tag = it.tag;
  q->bytes -= n;
  q->items.pop_front();
  q->popped.fetch_add(1);
  q->not_full.notify_one();
  return (long long)n;
}

size_t zn_queue_len(void* qp) {
  auto* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.size();
}

uint64_t zn_queue_pushed(void* qp) {
  return static_cast<Queue*>(qp)->pushed.load();
}

uint64_t zn_queue_popped(void* qp) {
  return static_cast<Queue*>(qp)->popped.load();
}

// ---- fast batch assembly ----------------------------------------------------
// Stack n_rows row-major float32 rows (each row_len floats, given as an array
// of pointers) into one contiguous [n_rows, row_len] buffer.  This is the hot
// host-side op when assembling a serving micro-batch from many requests.

void zn_stack_rows_f32(const float** rows, size_t n_rows, size_t row_len,
                       float* out) {
  for (size_t i = 0; i < n_rows; ++i) {
    std::memcpy(out + i * row_len, rows[i], row_len * sizeof(float));
  }
}

}  // extern "C"
