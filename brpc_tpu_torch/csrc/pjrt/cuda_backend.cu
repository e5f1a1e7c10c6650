// The H100's backend of the port's PJRT plugin (plugin.h).
//
// Devices: the num_devices create option's count, device d on card
// d % cudaGetDeviceCount() (several devices may share a card: each has its
// own stream, and the collective kernels take replicas on one card), one
// device a card without it; at most brt_device_programs_max_replicas().
// No card, no client: there is no host device and no host path here.
//
// Each device has one non-blocking stream. Buffers come from
// cudaMallocAsync on it (the card's default pool, which keeps what is freed
// rather than trimming it at every synchronisation, and is never opened to
// another card) and go back with cudaFreeAsync on it. Where the devices
// span cards, each card also has a peer pool (cudaMemPoolCreate, opened to
// the other cards by EnablePeers, release threshold 0) for the buffers a
// collective's peers read and write: its outputs and the copies of its
// inputs (plugin.cc RunCollective). On the H100 a pool that keeps its freed
// memory and is open to a peer card fails to grow (cudaErrorMemoryAllocation
// with 80 GB free) after a few large blocks; a released one does not, but
// maps its memory anew for every block, which the K2/K3 path of a shard
// must not pay. Copies are cudaMemcpyAsync on the stream, from
// and into the core's pageable blocks; the plugin's events follow a
// marker recorded after them. Markers are CUDA events (blocking sync,
// no timing), waited for by the plugin's completion threads, never by a
// host function on the stream: the events' callbacks free memory and
// destroy events, which a host function may not do.
//
// The programs are the port's kernels, launched through their C entry
// points: brt_gather_rows_f32 and brt_scatter_sub_f32
// (csrc/embedding_rows.cu), brt_add_f32, brt_reduce_sum_f32,
// brt_all_reduce_sum_f32 and brt_all_gather_f32 (csrc/device_programs.cu).
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <utility>
#include <vector>

#include "plugin.h"

extern "C" {
int brt_gather_rows_f32(const void* table, const void* ids, void* out, int k,
                        int rows, int dim, void* stream);
int brt_scatter_sub_f32(const void* table, const void* ids, const void* grads,
                        const void* lr, void* out, int k, int rows, int dim,
                        void* stream);
int brt_add_f32(const void* a, const void* b, void* out, long long n,
                int device, void* stream);
int brt_reduce_sum_f32(const void* x, void* scratch, void* out, long long n,
                       int device, void* stream);
int brt_reduce_sum_scratch_doubles();
int brt_all_reduce_two_shot(int replicas, long long n);
int brt_all_reduce_sum_f32(const void* const* inputs, int replicas,
                           void* const* outputs, int targets,
                           long long begin, long long end, int device,
                           void* stream);
int brt_all_gather_f32(const void* input, void* const* outputs, int targets,
                       long long offset, long long n, int device,
                       void* stream);
int brt_enable_peer_access(int device, int peer);
int brt_device_programs_max_replicas();
}

namespace brt_pjrt {
namespace {

std::string CudaError(const std::string& what, int err) {
  return what + ": CUDA error " + std::to_string(err) + " (" +
         cudaGetErrorString(static_cast<cudaError_t>(err)) + ")";
}

// Makes `card` current for the scope, restoring the caller's device.
class CardScope {
 public:
  explicit CardScope(int card) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != card) err_ = cudaSetDevice(card);
  }
  ~CardScope() {
    int now = -1;
    if (cudaGetDevice(&now) == cudaSuccess && now != prev_ && prev_ >= 0) {
      cudaSetDevice(prev_);
    }
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_;
};

class CudaBackend : public Backend {
 public:
  struct Dev {
    int card = 0;
    cudaStream_t stream = nullptr;
    void* scratch = nullptr;  // reduce_sum's f64 partials
    cudaMemPool_t peer_pool = nullptr;  // where the devices span cards
  };

  // Filled by MakeBackend; an error leaves the backend unusable.
  std::string Init(int devices, int cards) {
    const size_t scratch =
        size_t(brt_reduce_sum_scratch_doubles()) * sizeof(double);
    spans_cards_ = devices > 1 && cards > 1;
    std::map<int, cudaMemPool_t> peer_pools;  // by card
    for (int d = 0; d < devices; ++d) {
      Dev dev;
      dev.card = d % cards;
      CardScope scope(dev.card);
      if (scope.error() != cudaSuccess) {
        return CudaError("cudaSetDevice", scope.error());
      }
      cudaError_t err =
          cudaStreamCreateWithFlags(&dev.stream, cudaStreamNonBlocking);
      if (err == cudaSuccess) err = cudaMalloc(&dev.scratch, scratch);
      if (err == cudaSuccess && !peer_pools.count(dev.card)) {
        err = SetUpPools(dev.card, &peer_pools[dev.card]);
      }
      if (err == cudaSuccess) dev.peer_pool = peer_pools[dev.card];
      devs_.push_back(dev);
      if (err != cudaSuccess) return CudaError("device setup", err);
    }
    return "";
  }

  // The card's default pool set to keep what is freed; with spans_cards_,
  // a new peer pool on the card that releases it (*peer stays null else).
  cudaError_t SetUpPools(int card, cudaMemPool_t* peer) {
    cudaMemPool_t pool;
    uint64_t keep = UINT64_MAX, release = 0;
    cudaError_t err = cudaDeviceGetDefaultMemPool(&pool, card);
    if (err == cudaSuccess) {
      err = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold,
                                    &keep);
    }
    if (err != cudaSuccess || !spans_cards_) return err;
    cudaMemPoolProps props = {};
    props.allocType = cudaMemAllocationTypePinned;
    props.handleTypes = cudaMemHandleTypeNone;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = card;
    err = cudaMemPoolCreate(peer, &props);
    if (err == cudaSuccess) {
      err = cudaMemPoolSetAttribute(*peer, cudaMemPoolAttrReleaseThreshold,
                                    &release);
    }
    return err;
  }

  ~CudaBackend() override {
    std::set<int> used;
    for (Dev& dev : devs_) {
      CardScope scope(dev.card);
      if (dev.stream != nullptr) {
        cudaStreamSynchronize(dev.stream);
        cudaStreamDestroy(dev.stream);
      }
      if (dev.scratch != nullptr) cudaFree(dev.scratch);
      if (used.insert(dev.card).second) {
        cudaMemPool_t pool;
        if (cudaDeviceGetDefaultMemPool(&pool, dev.card) == cudaSuccess) {
          cudaMemPoolTrimTo(pool, 0);
        }
        // Released once its last block is freed, if any is still out.
        if (dev.peer_pool != nullptr) cudaMemPoolDestroy(dev.peer_pool);
      }
    }
  }

  std::string platform() const override { return "brt_cuda"; }
  int device_count() const override { return int(devs_.size()); }
  int max_replicas() const override {
    return brt_device_programs_max_replicas();
  }

  std::string Alloc(int d, size_t bytes, void** out) override {
    return AllocFrom(d, bytes, nullptr, out);
  }
  std::string AllocPeer(int d, size_t bytes, void** out) override {
    return AllocFrom(d, bytes, devs_[size_t(d)].peer_pool, out);
  }
  bool SpansCards(int replicas) const override {
    return spans_cards_ && replicas > 1;
  }
  void Free(int d, void* p) override {
    const Dev& dev = devs_[size_t(d)];
    CardScope scope(dev.card);
    cudaFreeAsync(p, dev.stream);
  }
  std::string CopyIn(int d, void* dst, const void* src,
                     size_t bytes) override {
    return Copy(d, dst, src, bytes, cudaMemcpyHostToDevice);
  }
  std::string CopyOut(int d, void* dst, const void* src,
                      size_t bytes) override {
    return Copy(d, dst, src, bytes, cudaMemcpyDeviceToHost);
  }
  std::string CopyWithin(int d, void* dst, const void* src,
                         size_t bytes) override {
    return Copy(d, dst, src, bytes, cudaMemcpyDeviceToDevice);
  }

  std::string Record(int d, Marker* out) override {
    const Dev& dev = devs_[size_t(d)];
    CardScope scope(dev.card);
    cudaEvent_t ev = nullptr;
    cudaError_t err = scope.error();
    if (err == cudaSuccess) {
      err = cudaEventCreateWithFlags(
          &ev, cudaEventDisableTiming | cudaEventBlockingSync);
    }
    if (err == cudaSuccess) err = cudaEventRecord(ev, dev.stream);
    if (err != cudaSuccess) {
      if (ev != nullptr) cudaEventDestroy(ev);
      return CudaError("cudaEventRecord on device " + std::to_string(d), err);
    }
    *out = ev;
    return "";
  }
  std::string StreamWait(int d, Marker m) override {
    const Dev& dev = devs_[size_t(d)];
    CardScope scope(dev.card);
    cudaError_t err =
        cudaStreamWaitEvent(dev.stream, static_cast<cudaEvent_t>(m), 0);
    return err == cudaSuccess ? "" : CudaError("cudaStreamWaitEvent", err);
  }
  std::string Sync(Marker m) override {
    cudaError_t err = cudaEventSynchronize(static_cast<cudaEvent_t>(m));
    return err == cudaSuccess ? "" : CudaError("device work", err);
  }
  void Destroy(Marker m) override {
    cudaEventDestroy(static_cast<cudaEvent_t>(m));
  }

  std::string EnablePeers(int replicas) override {
    std::lock_guard<std::mutex> g(mu_);
    for (int a = 0; a < replicas; ++a) {
      for (int b = 0; b < replicas; ++b) {
        const int ca = devs_[size_t(a)].card, cb = devs_[size_t(b)].card;
        if (ca == cb || peers_.count({ca, cb})) continue;
        const int err = brt_enable_peer_access(ca, cb);
        if (err == -1) {
          return "card " + std::to_string(ca) + " cannot access card " +
                 std::to_string(cb) + "'s memory (no peer access)";
        }
        if (err != 0) return CudaError("enabling peer access", err);
        // cb's peer pool hands out the buffers ca's kernels read and write.
        cudaMemAccessDesc access = {};
        access.location.type = cudaMemLocationTypeDevice;
        access.location.id = ca;
        access.flags = cudaMemAccessFlagsProtReadWrite;
        cudaError_t e = cudaMemPoolSetAccess(devs_[size_t(b)].peer_pool,
                                             &access, 1);
        if (e != cudaSuccess) return CudaError("cudaMemPoolSetAccess", e);
        peers_.insert({ca, cb});
      }
    }
    return "";
  }
  bool TwoShot(int replicas, int64_t n) const override {
    return brt_all_reduce_two_shot(replicas, n) != 0;
  }

  std::string Add(int d, const float* a, const float* b, float* out,
                  int64_t n) override {
    const Dev& dev = devs_[size_t(d)];
    return Launched("add", brt_add_f32(a, b, out, n, dev.card, dev.stream));
  }
  std::string ReduceSum(int d, const float* x, float* out,
                        int64_t n) override {
    const Dev& dev = devs_[size_t(d)];
    return Launched("reduce_sum", brt_reduce_sum_f32(x, dev.scratch, out, n,
                                                     dev.card, dev.stream));
  }
  std::string GatherRows(int d, const float* table, const int32_t* ids,
                         float* out, int k, int rows, int dim) override {
    const Dev& dev = devs_[size_t(d)];
    CardScope scope(dev.card);
    if (scope.error() != cudaSuccess) {
      return CudaError("cudaSetDevice", scope.error());
    }
    return Launched("gather_rows", brt_gather_rows_f32(table, ids, out, k,
                                                       rows, dim, dev.stream));
  }
  std::string ScatterSub(int d, const float* table, const int32_t* ids,
                         const float* grads, const float* lr, float* out,
                         int k, int rows, int dim) override {
    const Dev& dev = devs_[size_t(d)];
    CardScope scope(dev.card);
    if (scope.error() != cudaSuccess) {
      return CudaError("cudaSetDevice", scope.error());
    }
    return Launched("scatter_sub",
                    brt_scatter_sub_f32(table, ids, grads, lr, out, k, rows,
                                        dim, dev.stream));
  }
  std::string AllReduce(int d, const float* const* inputs, int replicas,
                        float* const* outputs, int targets, int64_t begin,
                        int64_t end) override {
    const Dev& dev = devs_[size_t(d)];
    return Launched("all_reduce_sum",
                    brt_all_reduce_sum_f32(
                        reinterpret_cast<const void* const*>(inputs),
                        replicas, reinterpret_cast<void* const*>(outputs),
                        targets, begin, end, dev.card, dev.stream));
  }
  std::string AllGather(int d, const float* input, float* const* outputs,
                        int targets, int64_t offset, int64_t n) override {
    const Dev& dev = devs_[size_t(d)];
    return Launched("all_gather",
                    brt_all_gather_f32(input,
                                       reinterpret_cast<void* const*>(outputs),
                                       targets, offset, n, dev.card,
                                       dev.stream));
  }

 private:
  // From `pool` (the card's default where null) on d's stream.
  std::string AllocFrom(int d, size_t bytes, cudaMemPool_t pool,
                        void** out) {
    *out = nullptr;
    if (bytes == 0) return "";
    const Dev& dev = devs_[size_t(d)];
    CardScope scope(dev.card);
    cudaError_t err = scope.error();
    if (err == cudaSuccess) {
      err = pool == nullptr
                ? cudaMallocAsync(out, bytes, dev.stream)
                : cudaMallocFromPoolAsync(out, bytes, pool, dev.stream);
    }
    if (err == cudaSuccess) return "";
    // What the card had left, for the message (a peer's pool may hold it).
    size_t free_bytes = 0, total_bytes = 0;
    cudaMemGetInfo(&free_bytes, &total_bytes);
    return CudaError(std::string(pool == nullptr ? "cudaMallocAsync"
                                                 : "cudaMallocFromPoolAsync")
                         + " of " + std::to_string(bytes) + " bytes on device "
                         + std::to_string(d) + " (card "
                         + std::to_string(dev.card) + ": "
                         + std::to_string(free_bytes) + " of "
                         + std::to_string(total_bytes) + " bytes free)",
                     err);
  }

  std::string Copy(int d, void* dst, const void* src, size_t bytes,
                   cudaMemcpyKind kind) {
    const Dev& dev = devs_[size_t(d)];
    CardScope scope(dev.card);
    cudaError_t err = scope.error();
    if (err == cudaSuccess) {
      err = cudaMemcpyAsync(dst, src, bytes, kind, dev.stream);
    }
    return err == cudaSuccess ? "" : CudaError("cudaMemcpyAsync", err);
  }

  static std::string Launched(const char* kernel, int err) {
    return err == 0 ? "" : CudaError(std::string(kernel) + " launch", err);
  }

  std::vector<Dev> devs_;
  bool spans_cards_ = false;
  std::mutex mu_;
  std::set<std::pair<int, int>> peers_;  // (card, peer) pairs enabled
};

}  // namespace

std::shared_ptr<Backend> MakeBackend(int num_devices, std::string* error) {
  int cards = 0;
  cudaError_t err = cudaGetDeviceCount(&cards);
  if (err != cudaSuccess || cards < 1) {
    *error = "no CUDA device: the plugin runs only on the card (" +
             std::string(err != cudaSuccess ? cudaGetErrorString(err)
                                            : "0 devices") +
             ")";
    cudaGetLastError();
    return nullptr;
  }
  const int limit = brt_device_programs_max_replicas();
  int n = num_devices < 0 ? (cards < limit ? cards : limit) : num_devices;
  if (n > limit) {
    *error = "num_devices " + std::to_string(n) +
             ": the kernels take at most " + std::to_string(limit) +
             " replicas";
    return nullptr;
  }
  auto backend = std::make_shared<CudaBackend>();
  *error = backend->Init(n, cards);
  if (!error->empty()) return nullptr;
  return backend;
}

}  // namespace brt_pjrt
