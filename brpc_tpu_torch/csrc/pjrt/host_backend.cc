// The plain version of the plugin's backend (plugin.h), for tests on a CPU:
// host memory, one worker thread a device that runs the device's
// operations in issue order (its stream), and the six programs as plain
// loops with the kernels' arithmetic:
//  - add: a + b, one f32 rounding;
//  - reduce_sum: the sum in f64, in index order, rounded to f32 once;
//  - all_reduce: from +0.0f, replica by replica in order, each addition
//    rounded as f32 (every route the same bytes);
//  - all_gather: the inputs in replica order;
//  - gather_rows: table[ids], a row of zeros for an id outside the table;
//  - scatter_sub: a fresh table with, for each id in batch order,
//    row = row - lr * grad, the product and the difference each rounded as
//    f32 (np.subtract.at's order); an id outside the table is skipped.
// Build it with -ffp-contract=off so that no product and sum fuse. It is
// built only for the tests that ask for it by name; nothing on the card's
// path loads it.
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include "plugin.h"

namespace brt_pjrt {
namespace {

// Devices without the num_devices option, as the reference's test plugin
// has (cpp/device/fake_pjrt_plugin.cc).
constexpr int kDefaultDevices = 4;
// The kernels' limit (kMaxReplicas in csrc/device_programs.cu).
constexpr int kMaxReplicas = 8;

struct HostMarker {
  std::mutex mu;
  std::condition_variable cv;
  bool passed = false;

  void Pass() {
    {
      std::lock_guard<std::mutex> g(mu);
      passed = true;
    }
    cv.notify_all();
  }
  void Wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return passed; });
  }
};

// What a Marker points to; queued waits hold the marker itself.
struct MarkerHandle {
  std::shared_ptr<HostMarker> m;
};

std::shared_ptr<HostMarker> MarkerOf(Marker m) {
  return static_cast<MarkerHandle*>(m)->m;
}

// A device's stream: runs what is issued to it, in order, on its thread.
class Worker {
 public:
  Worker() : thread_([this] { Run(); }) {}
  ~Worker() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    thread_.join();  // after everything issued has run
  }

  void Issue(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> g(mu_);
      queue_.push_back(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Run() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) return;
        fn = std::move(queue_.front());
        queue_.pop_front();
      }
      fn();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::function<void()>> queue_;
  bool stop_ = false;
  std::thread thread_;  // last: starts once the members above exist
};

class HostBackend : public Backend {
 public:
  explicit HostBackend(int devices) {
    for (int d = 0; d < devices; ++d) {
      workers_.push_back(std::make_unique<Worker>());
    }
  }

  std::string platform() const override { return "brt_host"; }
  int device_count() const override { return int(workers_.size()); }
  int max_replicas() const override { return kMaxReplicas; }

  std::string Alloc(int, size_t bytes, void** out) override {
    *out = nullptr;
    if (bytes == 0) return "";
    *out = aligned_alloc(64, (bytes + 63) / 64 * 64);
    return *out == nullptr ? "host allocation of " + std::to_string(bytes) +
                                 " bytes failed"
                           : "";
  }
  void Free(int d, void* p) override {
    Issue(d, [p] { free(p); });
  }
  std::string CopyIn(int d, void* dst, const void* src,
                     size_t bytes) override {
    Issue(d, [=] { memcpy(dst, src, bytes); });
    return "";
  }
  std::string CopyOut(int d, void* dst, const void* src,
                      size_t bytes) override {
    Issue(d, [=] { memcpy(dst, src, bytes); });
    return "";
  }

  std::string Record(int d, Marker* out) override {
    auto m = std::make_shared<HostMarker>();
    Issue(d, [m] { m->Pass(); });
    *out = new MarkerHandle{std::move(m)};
    return "";
  }
  std::string StreamWait(int d, Marker m) override {
    std::shared_ptr<HostMarker> ref = MarkerOf(m);
    Issue(d, [ref] { ref->Wait(); });
    return "";
  }
  std::string Sync(Marker m) override {
    MarkerOf(m)->Wait();
    return "";
  }
  void Destroy(Marker m) override { delete static_cast<MarkerHandle*>(m); }

  std::string EnablePeers(int) override { return ""; }  // one memory
  bool TwoShot(int replicas, int64_t n) const override {
    // Either route gives the same bytes; this rule runs both on small
    // inputs, so that the tests reach the slices.
    return replicas > 1 && n >= kSliceFloats * replicas;
  }

  std::string Add(int d, const float* a, const float* b, float* out,
                  int64_t n) override {
    Issue(d, [=] {
      for (int64_t i = 0; i < n; ++i) out[i] = a[i] + b[i];
    });
    return "";
  }
  std::string ReduceSum(int d, const float* x, float* out,
                        int64_t n) override {
    Issue(d, [=] {
      double s = 0.0;
      for (int64_t i = 0; i < n; ++i) s += double(x[i]);
      *out = float(s);
    });
    return "";
  }
  std::string GatherRows(int d, const float* table, const int32_t* ids,
                         float* out, int k, int rows, int dim) override {
    Issue(d, [=] {
      const size_t w = size_t(dim);
      for (int i = 0; i < k; ++i) {
        float* o = out + size_t(i) * w;
        if (ids[i] >= 0 && ids[i] < rows) {
          memcpy(o, table + size_t(ids[i]) * w, w * 4);
        } else {
          memset(o, 0, w * 4);
        }
      }
    });
    return "";
  }
  std::string ScatterSub(int d, const float* table, const int32_t* ids,
                         const float* grads, const float* lr, float* out,
                         int k, int rows, int dim) override {
    Issue(d, [=] {
      const size_t w = size_t(dim);
      memcpy(out, table, size_t(rows) * w * 4);
      const float rate = *lr;
      for (int i = 0; i < k; ++i) {
        if (ids[i] < 0 || ids[i] >= rows) continue;
        float* o = out + size_t(ids[i]) * w;
        const float* g = grads + size_t(i) * w;
        for (size_t j = 0; j < w; ++j) {
          const float step = rate * g[j];
          o[j] = o[j] - step;
        }
      }
    });
    return "";
  }
  std::string AllReduce(int d, const float* const* inputs, int replicas,
                        float* const* outputs, int targets, int64_t begin,
                        int64_t end) override {
    std::vector<const float*> ins(inputs, inputs + replicas);
    std::vector<float*> outs(outputs, outputs + targets);
    Issue(d, [ins, outs, begin, end] {
      for (int64_t i = begin; i < end; ++i) {
        float acc = 0.0f;
        for (const float* x : ins) acc = acc + x[i];
        for (float* o : outs) o[i] = acc;
      }
    });
    return "";
  }
  std::string AllGather(int d, const float* input, float* const* outputs,
                        int targets, int64_t offset, int64_t n) override {
    std::vector<float*> outs(outputs, outputs + targets);
    Issue(d, [input, outs, offset, n] {
      for (float* o : outs) memcpy(o + offset, input, size_t(n) * 4);
    });
    return "";
  }

 private:
  void Issue(int d, std::function<void()> fn) {
    workers_[size_t(d)]->Issue(std::move(fn));
  }

  std::vector<std::unique_ptr<Worker>> workers_;
};

}  // namespace

std::shared_ptr<Backend> MakeBackend(int num_devices, std::string* error) {
  const int n = num_devices < 0 ? kDefaultDevices : num_devices;
  if (n > kMaxReplicas) {
    *error = "num_devices " + std::to_string(n) +
             ": the kernels take at most " + std::to_string(kMaxReplicas) +
             " replicas";
    return nullptr;
  }
  return std::make_shared<HostBackend>(n);
}

}  // namespace brt_pjrt
