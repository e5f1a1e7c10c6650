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
// Every kernel is one pass, 16-byte accesses where every pointer it touches
// is 16-byte aligned, single floats otherwise, and is bound by bytes:
// nothing here computes more than one addition a float. add keeps kUnroll
// 16-byte loads of each input in flight a thread over a grid stride: with
// one, a copy on one H100 ran at half of HBM's rate.
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
// K4a all_reduce_sum and K4b all_gather push: a replica's kernel writes
// its share into every replica's output with 16-byte stores over peer
// access (unified addressing; peer access enabled by
// brt_enable_peer_access), which NVLink carries as posted writes, where a
// remote load costs a round trip. One kernel a replica a call; no kernel
// reads what another kernel of the call writes, so nothing waits across
// cards inside a kernel. The wrapper orders the call around the kernels:
// before the launches each replica's stream waits for every other card's
// stream as the call found it (the ready events), which covers the inputs
// the peers read and the output blocks the peers write, however recently
// those blocks were freed with work still pending on their own stream;
// after the launches each card's stream waits for every replica's kernel
// (the join), so nothing later on a card reads an output before the pushes
// into it land, or overwrites an input a peer still reads.
//
// K4a all_reduce_sum, two routes, both one kernel a replica:
// - two-shot: [0, n) is cut into R slices on 4 KB boundaries (the wrapper's
//   slice rule; the tail goes to the last slice). Replica d's kernel reads
//   slice d of every input, R - 1 of them over NVLink, sums them and stores
//   the sums into slice d of every replica's output. Each card takes in
//   (R - 1)/R * n * 4 bytes by its loads and as many by its peers' stores:
//   the 2(R - 1)/R * n * 4 of a ring or two-shot all-reduce, half of what
//   the one-shot reads at R = 4.
// - one-shot: replica d's kernel reads all of every input and writes its
//   own output: (R - 1) * n * 4 bytes a card, all by remote loads. It
//   stays for small n, where the routes take the same time and the
//   two-shot's slices may be empty. At R = 2 both routes move n * 4 bytes
//   a card; the two-shot moves half of them by posted stores.
// brt_all_reduce_two_shot is the rule between them (see its comment).
// Either way each element is summed by one kernel in replica order 0..R-1
// from +0.0f with __fadd_rn, so every replica's output holds the same
// bytes, equal to the host's ordered sum, whichever route ran.
//
// K4b all_gather: replica d's kernel reads its own input once and stores it
// into out_r[d * n, (d + 1) * n) of every replica r, its own too. Each card
// takes in (R - 1) * n * 4 bytes, all by its peers' stores.
//
// The collectives' kernels give each block one contiguous tile of the
// range it moves (the all-reduce 32 KB of each input at R = 1, 16 KB at
// R = 2, 8 KB at R = 4: kLoadsInFlight 16-byte loads a thread, all in
// flight before the adds; the all-gather 16 KB), with .cs (streaming)
// loads and stores, as nothing is read again. Block b stores into the
// outputs starting at output b % targets, so that the cards' pushes are
// spread over every receiver at once rather than all going to one card
// first: on four H100s the all-gather at R = 4 went from slower than
// NCCL's to faster with it. At R = 1 both collectives are a copy of one
// card's [n] (the all-reduce adding +0.0f). On one H100 that layout ran
// the copy faster than an interleaved grid stride of 4096 blocks and as
// fast as cudaMemcpyAsync's, with .cs faster than plain loads and stores;
// a TMA bulk copy through shared memory was no faster, and could not add
// the all-reduce's +0.0f.
//
// The C entry points take raw pointers (the collectives an array of input
// or output pointers), the range, the device the kernel runs on and that
// device's stream. This library links its own CUDA runtime, which keeps its
// own current device a thread, so each entry sets the device for its launch
// and restores it.

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

// ---- K4 --------------------------------------------------------------------

// 16-byte loads of the collectives' inputs a thread keeps in flight, over
// all the inputs it sums; a block moves one tile of kThreads *
// unroll_for(R) vectors of each input.
constexpr int kLoadsInFlight = 8;
constexpr int kGatherUnroll = 4;  // the all-gather's, of its one input
// The least n whose all-reduce goes two-shot (brt_all_reduce_two_shot).
constexpr long long kTwoShotMinFloats = 1LL << 18;

__host__ __device__ constexpr int unroll_for(int inputs) {
  return kLoadsInFlight / inputs > 0 ? kLoadsInFlight / inputs : 1;
}

struct Outputs {
  float* p[kMaxReplicas];
};

// Output j of a block's turn: block b starts at output b % targets, so
// that at any moment a card's blocks store into every output alike.
__device__ __forceinline__ float* turn(const Outputs& out, int targets,
                                       int j) {
  int k = j + static_cast<int>(blockIdx.x % targets);
  if (k >= targets) k -= targets;
  float* p = out.p[0];
#pragma unroll
  for (int i = 1; i < kMaxReplicas; ++i) {
    if (k == i) p = out.p[i];
  }
  return p;
}

// The ordered sum of element i of the R inputs, stored into the first
// `targets` outputs, for i in [from, to) by a grid stride: the whole range
// when a pointer is not 16-byte aligned, else the last < 4 floats.
template <int R>
__device__ __forceinline__ void all_reduce_floats(const Inputs& in,
                                                  const Outputs& out,
                                                  int targets, long long from,
                                                  long long to) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = from + blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < to; i += stride) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) acc = __fadd_rn(acc, in.p[r][i]);
#pragma unroll
    for (int k = 0; k < kMaxReplicas; ++k) {
      if (k >= targets) break;
      out.p[k][i] = acc;
    }
  }
}

// Sums [begin, end) of the R inputs in replica order from +0.0f and stores
// the sums into [begin, end) of the first `targets` outputs. vec: begin is
// a multiple of 4 and every pointer 16-byte aligned; block b then moves
// tile b, its loads of every input in flight before the adds.
template <int R>
__global__ void __launch_bounds__(kThreads)
all_reduce_kernel(Inputs in, Outputs out, int targets, long long begin,
                  long long end, int vec) {
  if (!vec) {
    all_reduce_floats<R>(in, out, targets, begin, end);
    return;
  }
  constexpr int U = unroll_for(R);
  const long long nvec = (end - begin) / 4;
  const long long base =
      blockIdx.x * static_cast<long long>(kThreads * U) + threadIdx.x;
  float4 v[R][U];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4* src = reinterpret_cast<const float4*>(in.p[r] + begin);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * kThreads;
      v[r][u] = i < nvec ? __ldcs(src + i)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float4 acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[u] = add4(acc[u], v[r][u]);
  }
#pragma unroll
  for (int j = 0; j < kMaxReplicas; ++j) {
    if (j >= targets) break;
    float4* dst = reinterpret_cast<float4*>(turn(out, targets, j) + begin);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * kThreads;
      if (i < nvec) __stcs(dst + i, acc[u]);
    }
  }
  if (blockIdx.x == 0) {
    all_reduce_floats<R>(in, out, targets, begin + nvec * 4, end);
  }
}

using AllReduceKernel = void (*)(Inputs, Outputs, int, long long, long long,
                                 int);

AllReduceKernel all_reduce_kernel_for(int replicas) {
  switch (replicas) {
    case 1: return all_reduce_kernel<1>;
    case 2: return all_reduce_kernel<2>;
    case 3: return all_reduce_kernel<3>;
    case 4: return all_reduce_kernel<4>;
    case 5: return all_reduce_kernel<5>;
    case 6: return all_reduce_kernel<6>;
    case 7: return all_reduce_kernel<7>;
    default: return all_reduce_kernel<8>;
  }
}

// Element i of `in` stored at offset + i of the first `targets` outputs,
// for i in [from, to) by a grid stride.
__device__ __forceinline__ void all_gather_floats(const float* in,
                                                  const Outputs& out,
                                                  int targets,
                                                  long long offset,
                                                  long long from,
                                                  long long to) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = from + blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < to; i += stride) {
    const float x = in[i];
#pragma unroll
    for (int k = 0; k < kMaxReplicas; ++k) {
      if (k >= targets) break;
      out.p[k][offset + i] = x;
    }
  }
}

// Stores [0, n) of `in` into [offset, offset + n) of the first `targets`
// outputs. vec: every pointer, offsets included, 16-byte aligned; block b
// then moves tile b.
__global__ void __launch_bounds__(kThreads)
all_gather_kernel(const float* __restrict__ in, Outputs out, int targets,
                  long long offset, long long n, int vec) {
  if (!vec) {
    all_gather_floats(in, out, targets, offset, 0, n);
    return;
  }
  constexpr int U = kGatherUnroll;
  const long long nvec = n / 4;
  const long long base =
      blockIdx.x * static_cast<long long>(kThreads * U) + threadIdx.x;
  const float4* src = reinterpret_cast<const float4*>(in);
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = base + u * kThreads;
    if (i < nvec) v[u] = __ldcs(src + i);
  }
#pragma unroll
  for (int j = 0; j < kMaxReplicas; ++j) {
    if (j >= targets) break;
    float4* dst = reinterpret_cast<float4*>(turn(out, targets, j) + offset);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * kThreads;
      if (i < nvec) __stcs(dst + i, v[u]);
    }
  }
  if (blockIdx.x == 0) all_gather_floats(in, out, targets, offset, nvec * 4, n);
}

// Blocks for a range of `count` floats: one a tile on the 16-byte path
// (kThreads * unroll vectors), at least one for the tail; a grid stride of
// at most kMaxBlocks otherwise.
int collective_blocks(long long count, int vec, int unroll) {
  if (!vec) return blocks_for(count);
  const long long per = static_cast<long long>(kThreads) * unroll;
  const long long tiles = (count / 4 + per - 1) / per;
  return static_cast<int>(tiles < 1 ? 1 : tiles);
}

bool fill_inputs(const void* const* inputs, int replicas, Inputs* in) {
  if (replicas < 1 || replicas > kMaxReplicas) return false;
  for (int r = 0; r < kMaxReplicas; ++r) {
    in->p[r] = r < replicas ? static_cast<const float*>(inputs[r]) : nullptr;
  }
  return true;
}

bool fill_outputs(void* const* outputs, int targets, Outputs* out) {
  if (targets < 1 || targets > kMaxReplicas) return false;
  for (int k = 0; k < kMaxReplicas; ++k) {
    out->p[k] = k < targets ? static_cast<float*>(outputs[k]) : nullptr;
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

// The rule between K4a's routes: 1 for the two-shot, 0 for the one-shot.
// fabric_routes.py on four H100 SXM cards at 700 W, both routes in turns
// with NCCL: from n = 2^18 up the two-shot was faster at R = 4 (0.0330
// against 0.0406 ms at 2^18, 0.2081 against 0.3686 at 8,388,608, 1.2735
// against 2.2017 at 58,720,256) and at R = 2 from 2^20 up (0.1119 against
// 0.1185 at 8,388,608), but for 1 % at R = 2 and 58,720,256; at R = 2 and
// 2^18 the faster route changed from run to run. Below 2^18 the routes
// were within a few microseconds of each other, each call's cross-card
// events being most of its time, and the one-shot launches on every
// replica where the two-shot's slices may be empty (n < 1024 R).
extern "C" int brt_all_reduce_two_shot(int replicas, long long n) {
  return replicas > 1 && n >= kTwoShotMinFloats;
}

// inputs: a host array of `replicas` device pointers, one [n] f32 each;
// outputs: a host array of `targets` device pointers, one [n] f32 each.
// Sums [begin, end) of the inputs in replica order and stores it into
// [begin, end) of every output. The one-shot passes [0, n) and its own
// output, the two-shot its slice and every replica's output.
extern "C" int brt_all_reduce_sum_f32(const void* const* inputs,
                                      int replicas, void* const* outputs,
                                      int targets, long long begin,
                                      long long end, int device,
                                      void* stream) {
  Inputs in;
  Outputs out;
  if (!fill_inputs(inputs, replicas, &in) ||
      !fill_outputs(outputs, targets, &out) || begin < 0 || end < begin) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (end == begin) return 0;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  int vec = begin % 4 == 0;
  for (int r = 0; r < replicas; ++r) vec = vec && aligned16(in.p[r]);
  for (int k = 0; k < targets; ++k) vec = vec && aligned16(out.p[k]);
  all_reduce_kernel_for(replicas)<<<
      collective_blocks(end - begin, vec, unroll_for(replicas)), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(in, out, targets, begin, end, vec);
  return static_cast<int>(cudaGetLastError());
}

// input: one [n] f32 on `device`; outputs: a host array of `targets` device
// pointers, one [targets * n] f32 each. Stores the input into [offset,
// offset + n) of every output.
extern "C" int brt_all_gather_f32(const void* input, void* const* outputs,
                                  int targets, long long offset, long long n,
                                  int device, void* stream) {
  Outputs out;
  if (!fill_outputs(outputs, targets, &out) || offset < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  int vec = offset % 4 == 0 && aligned16(input);
  for (int k = 0; k < targets; ++k) vec = vec && aligned16(out.p[k]);
  all_gather_kernel<<<collective_blocks(n, vec, kGatherUnroll), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(input), out, targets, offset, n, vec);
  return static_cast<int>(cudaGetLastError());
}
