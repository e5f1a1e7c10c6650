// Row gather (K2) and ordered scatter-sub (K3) over an f32 embedding table,
// for Hopper (sm_90a): the two device programs of the parameter server's
// device shard.
//
// Replaces the StableHLO programs of cpp/device/pjrt_executable.cc that the
// reference's DevicePsShardServer (brpc_tpu/ps_remote.py) launches through
// its native PJRT client: MlirGatherRowsF32 (Lookup) and MlirScatterSubF32
// (ApplyGrad). Neither is a Pallas kernel.
//
// K2, gather_rows_kernel: out[i, :] = table[ids[i], :] for k int32 ids
// into a [rows, dim] table, out [k, dim]. One block per id; its threads
// stride over the row with float4 loads and stores when the row and both
// pointers allow 16-byte accesses, else with single floats. An id outside
// [0, rows) writes a row of zeros (the shard validates ids first). Bound:
// bytes. It reads each distinct id's row once and writes k rows: at
// Llama-3-8B width (dim 4096) and k = 2048 about 50 MB, some 15 us at
// 3.35 TB/s. Nothing to compute.
//
// K3, scatter_sub: out = table - scatter_add(ids, lr * grads) into a FRESH
// buffer (a pinned table generation is never written), applied exactly as
// numpy's np.subtract.at(out, ids, lr * grads) applies it: one occurrence
// at a time in batch order, each step rounded as f32,
//   row = fsub_rn(row, fmul_rn(lr, g)).
// The host tier, the backups and checkpoint replay apply updates that
// way, so a device primary's table must equal theirs bit for bit. So no
// float atomics (they sum duplicates in any order) and no contraction of
// the two roundings into one FMA: the explicit __fmul_rn/__fsub_rn keep
// them apart whatever nvcc's -fmad says. Subnormals are kept (no
// flush-to-zero), as numpy keeps them.
// The host function copies the table into the output with one
// device-to-device cudaMemcpyAsync, then launches one block per occurrence
// i. The block exits if an earlier occurrence j < i has the same id (that
// block owns the row); otherwise warp 0 collects the occurrences j >= i of
// the id, in order, into shared memory, a chunk at a time, and all threads
// apply them to their columns in that order. That costs O(k^2) id
// compares over the launch, small at the shard's buckets (k <= 8192); a
// sort that groups the ids is later work. Padding rows (id 0, grad 0)
// subtract zero and change nothing. An id outside [0, rows) is skipped.
// Bound: bytes, set by the fresh copy: the table read and written once,
// 2 * 2.10 GB at Llama-3-8B's 128256 x 4096, about 1.25 ms at 3.35 TB/s;
// ids and grads add 34 MB at k = 2048.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // occurrences collected per pass in K3

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table,
                   const int* __restrict__ ids, float* __restrict__ out,
                   int rows, int dim, int vec4) {
  const int i = blockIdx.x;
  const int id = ids[i];
  float* dst = out + static_cast<size_t>(i) * dim;
  const bool valid = id >= 0 && id < rows;
  const float* src = table + static_cast<size_t>(valid ? id : 0) * dim;
  if (vec4) {
    const int n4 = dim / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = threadIdx.x; c < n4; c += blockDim.x) {
      d4[c] = valid ? s4[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int c = threadIdx.x; c < dim; c += blockDim.x) {
      dst[c] = valid ? src[c] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_sub_kernel(float* __restrict__ out, const int* __restrict__ ids,
                   const float* __restrict__ grads,
                   const float* __restrict__ lr, int k, int rows, int dim) {
  __shared__ int matches[kChunk];
  __shared__ int n_matches;
  __shared__ int next_j;
  const int i = blockIdx.x;
  const int id = ids[i];
  if (id < 0 || id >= rows) return;
  // Does an earlier occurrence own this row?
  int earlier = 0;
  for (int j = threadIdx.x; j < i; j += blockDim.x) {
    earlier |= ids[j] == id;
  }
  if (__syncthreads_or(earlier)) return;

  const float l = *lr;
  float* row = out + static_cast<size_t>(id) * dim;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) next_j = i;
  __syncthreads();
  while (true) {
    // Warp 0 gathers up to kChunk occurrences j >= next_j, in order.
    if (threadIdx.x < 32) {
      int count = 0;
      int j0 = next_j;
      for (; j0 < k && count <= kChunk - 32; j0 += 32) {
        const int j = j0 + lane;
        const bool hit = j < k && ids[j] == id;
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (hit) matches[count + __popc(mask & ((1u << lane) - 1u))] = j;
        count += __popc(mask);
      }
      if (lane == 0) {
        n_matches = count;
        next_j = j0;
      }
    }
    __syncthreads();
    const int n = n_matches;
    for (int c = threadIdx.x; c < dim; c += blockDim.x) {
      float v = row[c];
      for (int m = 0; m < n; ++m) {
        const float g = grads[static_cast<size_t>(matches[m]) * dim + c];
        v = __fsub_rn(v, __fmul_rn(l, g));
      }
      row[c] = v;
    }
    const bool done = next_j >= k;
    __syncthreads();  // matches and next_j are rewritten by the next pass
    if (done) break;
  }
}

}  // namespace

// Every function returns the CUDA error of its launch (0 when none); the
// wrapper raises on any other value. Pointers are device pointers; the
// stream is PyTorch's current stream.

extern "C" int brt_gather_rows_f32(const void* table, const void* ids,
                                   void* out, int k, int rows, int dim,
                                   void* stream) {
  if (k <= 0 || dim <= 0) return 0;
  const int vec4 = dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int work = vec4 ? dim / 4 : dim;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < kThreads ? threads : kThreads;
  gather_rows_kernel<<<k, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(ids),
      static_cast<float*>(out), rows, dim, vec4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brt_scatter_sub_f32(const void* table, const void* ids,
                                   const void* grads, const void* lr,
                                   void* out, int k, int rows, int dim,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(rows) * dim * sizeof(float);
  cudaError_t err = cudaMemcpyAsync(out, table, bytes,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 0 || dim <= 0) return 0;
  int threads = ((dim + 31) / 32) * 32;
  threads = threads < kThreads ? threads : kThreads;
  scatter_sub_kernel<<<k, threads, 0, s>>>(
      static_cast<float*>(out), static_cast<const int*>(ids),
      static_cast<const float*>(grads), static_cast<const float*>(lr), k,
      rows, dim);
  return static_cast<int>(cudaGetLastError());
}
