// The device fabric's four remaining programs, for Hopper (sm_90a): K5a add,
// K5b reduce_sum, K4a all_reduce_sum and K4b all_gather, over f32 vectors.
//
// Replaces the StableHLO programs of cpp/device/pjrt_executable.cc that the
// reference's DeviceClient.mlir builds and runs through its native PJRT
// client: MlirAddF32 (:54), MlirReduceSumF32 (:64), MlirAllReduceSumF32
// (:76) and MlirAllGatherF32 (:87). None is a Pallas kernel. The
// reference's arithmetic is that of its test plugin
// (cpp/device/fake_pjrt_plugin.cc): add and the all-reduce round each f32
// addition once, the all-reduce sums replicas in order 0..R-1 starting from
// +0.0f (so one replica maps -0.0 to +0.0), the all-gather concatenates in
// replica order, reduce_sum sums sequentially in f32.
//
// Every kernel is one grid-stride pass, 16-byte accesses where every
// pointer it touches is 16-byte aligned, single floats otherwise, and is
// bound by bytes: nothing here computes more than one addition a float.
// The copy-like passes keep kUnroll 16-byte loads of each input in flight
// a thread: with one, a copy on one H100 ran at half of HBM's rate.
// No fast math: subnormals survive, as in the reference, and the additions
// are __fadd_rn so that nothing contracts or reorders them. A NaN result
// is the card's canonical NaN, where the reference's x86 arithmetic keeps
// an operand's payload: NaNs agree as NaNs, every other value bit for bit.
//
// K5a add: out = a + b, bit-equal to the reference. Bound: 3n floats of
// HBM traffic (0.030 ms at n = 8,388,608 at 3.35 TB/s).
//
// K5b reduce_sum: a 0-d f32. Deterministic and free of float atomics: each
// thread sums its grid-stride share in f64, each block folds its threads in
// a fixed warp-shuffle tree and writes one f64 partial to scratch, and a
// second one-block pass folds the partials in a fixed order and rounds to
// f32 once. The grid depends on n alone, so a launch gives the same bits
// every time, on every card; the result is within one f32 ulp of the
// exact sum, and within Higham's (n-1) * 2^-24 * sum|x| of the reference's
// sequential f32 sum. f64 costs nothing here: n additions against n * 4
// bytes keep the pass far below the H100's f64 rate.
//
// K4a all_reduce_sum: one-shot. Replica d's kernel, on device d, reads all
// R inputs through their device pointers (unified addressing; peer access
// enabled by brt_enable_peer_access), sums them in replica order from
// +0.0f and writes d's output. Every replica runs the same additions in the
// same order, so all outputs hold the same bytes. Each replica reads R
// inputs, R - 1 of them over NVLink: at R = 4 and 33.5 MB inputs that is
// 100.7 MB a card against the 50.3 MB a ring or two-shot all-reduce moves,
// so the one-shot design is expected to lose to NCCL at large n.
//
// K4b all_gather: replica d's kernel copies every input r into
// out[r * n, (r + 1) * n), peers over NVLink, one grid row per input.
//
// The C entry points take raw pointers, n, the replica count, the device of
// the replica whose output they write and that device's stream. This
// library links its own CUDA runtime, which keeps its own current device a
// thread, so each entry sets the device for its launch and restores it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
constexpr int kMaxReplicas = 8;   // one host's NVLink domain of H100s
constexpr int kReducePartials = 1024;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread an input
constexpr long long kReducePerThread = 16;

struct Inputs {
  const float* p[kMaxReplicas];
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

// Sets the device for one launch and restores the one this thread had.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    if (cudaGetDevice(&prev_) != cudaSuccess) prev_ = -1;
    err_ = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// ---- K5a -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
add_kernel(const float* __restrict__ a, const float* __restrict__ b,
           float* __restrict__ out, long long n, int vec) {
  const long long start = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nvec = n / 4;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long base = start; base < nvec; base += kUnroll * stride) {
      float4 x[kUnroll], y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * stride;
        if (i < nvec) x[u] = a4[i], y[u] = b4[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * stride;
        if (i < nvec) o4[i] = add4(x[u], y[u]);
      }
    }
    done = nvec * 4;
  }
  for (long long i = done + start; i < n; i += stride) {
    out[i] = __fadd_rn(a[i], b[i]);
  }
}

// ---- K5b -------------------------------------------------------------------

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// The block's f64 total, in a fixed order; valid in thread 0.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warps[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x / 32) ? warps[lane] : 0.0;
    v = warp_sum(v);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ x, long long n, int vec,
                       double* __restrict__ partials) {
  const long long start = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  double acc = 0.0;
  long long done = 0;
  if (vec) {
    const long long nvec = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = start; i < nvec; i += stride) {
      const float4 v = x4[i];
      acc += static_cast<double>(v.x);
      acc += static_cast<double>(v.y);
      acc += static_cast<double>(v.z);
      acc += static_cast<double>(v.w);
    }
    done = nvec * 4;
  }
  for (long long i = done + start; i < n; i += stride) {
    acc += static_cast<double>(x[i]);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
reduce_final_kernel(const double* __restrict__ partials, int count,
                    float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = __double2float_rn(acc);
}

// ---- K4a -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
all_reduce_kernel(Inputs in, int replicas, float* __restrict__ out,
                  long long n, int vec) {
  const long long start = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nvec = n / 4;
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long base = start; base < nvec; base += kUnroll * stride) {
      float4 acc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < kMaxReplicas; ++r) {
        if (r >= replicas) break;
        const float4* src = reinterpret_cast<const float4*>(in.p[r]);
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long i = base + u * stride;
          v[u] = i < nvec ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc[u] = add4(acc[u], v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * stride;
        if (i < nvec) o4[i] = acc[u];
      }
    }
    done = nvec * 4;
  }
  for (long long i = done + start; i < n; i += stride) {
    float acc = 0.f;
    for (int r = 0; r < replicas; ++r) acc = __fadd_rn(acc, in.p[r][i]);
    out[i] = acc;
  }
}

// ---- K4b -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
all_gather_kernel(Inputs in, float* __restrict__ out, long long n, int vec) {
  const int r = blockIdx.y;
  const long long start = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float* src = in.p[r];
  float* dst = out + r * n;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const long long nvec = n / 4;
    for (long long base = start; base < nvec; base += kUnroll * stride) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * stride;
        if (i < nvec) v[u] = s4[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * stride;
        if (i < nvec) d4[i] = v[u];
      }
    }
  } else {
    for (long long i = start; i < n; i += stride) dst[i] = src[i];
  }
}

bool fill_inputs(const void* const* inputs, int replicas, Inputs* in) {
  if (replicas < 1 || replicas > kMaxReplicas) return false;
  for (int r = 0; r < kMaxReplicas; ++r) {
    in->p[r] = r < replicas ? static_cast<const float*>(inputs[r]) : nullptr;
  }
  return true;
}

}  // namespace

extern "C" int brt_device_programs_max_replicas() { return kMaxReplicas; }

extern "C" int brt_reduce_sum_scratch_doubles() { return kReducePartials; }

// 0 when device may read peer's memory (enabled now or before), -1 when
// the pair has no peer access, else the CUDA error.
extern "C" int brt_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return -1;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: access is on, as wanted
    err = cudaSuccess;
  }
  return static_cast<int>(err);
}

extern "C" int brt_add_f32(const void* a, const void* b, void* out,
                           long long n, int device, void* stream) {
  if (n <= 0) return 0;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const int vec = aligned16(a) && aligned16(b) && aligned16(out);
  add_kernel<<<blocks_for(vec ? n / 4 / kUnroll : n), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

// scratch: brt_reduce_sum_scratch_doubles() f64 on the device. n == 0
// writes +0.0f.
extern "C" int brt_reduce_sum_f32(const void* x, void* scratch, void* out,
                                  long long n, int device, void* stream) {
  if (n < 0) n = 0;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (n + kThreads * kReducePerThread - 1) /
                     (kThreads * kReducePerThread);
  blocks = blocks < 1 ? 1 : (blocks > kReducePartials ? kReducePartials
                                                      : blocks);
  reduce_partials_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(x), n, aligned16(x),
      static_cast<double*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_final_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const double*>(scratch), static_cast<int>(blocks),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// inputs: a host array of `replicas` device pointers, one [n] f32 each;
// out: replica `device`'s [n] on that device.
extern "C" int brt_all_reduce_sum_f32(const void* const* inputs,
                                      int replicas, void* out, long long n,
                                      int device, void* stream) {
  Inputs in;
  if (!fill_inputs(inputs, replicas, &in)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  int vec = aligned16(out);
  for (int r = 0; r < replicas; ++r) vec = vec && aligned16(in.p[r]);
  all_reduce_kernel<<<blocks_for(vec ? n / 4 / kUnroll : n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      in, replicas, static_cast<float*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

// out: replica `device`'s [replicas * n] on that device.
extern "C" int brt_all_gather_f32(const void* const* inputs, int replicas,
                                  void* out, long long n, int device,
                                  void* stream) {
  Inputs in;
  if (!fill_inputs(inputs, replicas, &in)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  int vec = n % 4 == 0 && aligned16(out);
  for (int r = 0; r < replicas; ++r) vec = vec && aligned16(in.p[r]);
  const long long work = vec ? n / 4 / kUnroll : n;
  long long per_input = (work + kThreads - 1) / kThreads;
  const long long cap = kMaxBlocks / replicas;
  per_input = per_input < 1 ? 1 : (per_input > cap ? cap : per_input);
  all_gather_kernel<<<dim3(static_cast<unsigned>(per_input), replicas),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<float*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}
