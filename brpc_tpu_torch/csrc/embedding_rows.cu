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
// K3, scatter_sub_kernel: out = table - scatter_add(ids, lr * grads) into a
// FRESH buffer (a pinned table generation is never written), applied
// exactly as numpy's np.subtract.at(out, ids, lr * grads) applies it: one
// occurrence at a time in batch order, each step rounded as f32,
//   row = fsub_rn(row, fmul_rn(lr, g)).
// The host tier, the backups and checkpoint replay apply updates that
// way, so a device primary's table must equal theirs bit for bit. So no
// float atomics (they sum duplicates in any order) and no contraction of
// the two roundings into one FMA: the explicit __fmul_rn/__fsub_rn keep
// them apart whatever nvcc's -fmad says. Subnormals are kept (no
// flush-to-zero), as numpy keeps them. Padding rows (id 0, grad 0)
// subtract zero and change nothing. An id outside [0, rows) is skipped.
//
// Bound: bytes. The output is a fresh table, so the whole table is read
// once and written once: 2 * 2.10 GB at Llama-3-8B's 128256 x 4096, about
// 1.25 ms at 3.35 TB/s; ids and grads add 34 MB at k = 2048. The kernel is
// that one pass, in one launch:
//  - The table is cut into tiles: row ranges by column slices of at most
//    kSliceVecs vectors (2 KB of floats), one block each. Slicing the
//    columns spreads a hot row's gradients over several blocks (Zipf ids
//    put 194 of 2048 occurrences on one row). A tile holds at least
//    kMinTileBytes and four times the id list's bytes: 32 KB, 16 rows, at
//    Llama-3-8B width and k = 2048, some 64000 blocks. The hardware hands
//    them to SMs as SMs free up, and that balance is what lets the pass
//    keep pace with cudaMemcpy: a persistent grid of two blocks an SM, each
//    with a fixed share of the table, copied a table more slowly than
//    cudaMemcpy on an H100, whether its share was one range or ranges
//    spread over the table (the SMs do not stream at one rate).
//  - Grouping: every block reads the whole id list in coalesced steps and
//    appends the (row, position) pairs that fall in its row range to
//    shared memory, then sorts them by that key with a bitonic sort. The
//    positions are unique, so within one row the key order is batch order
//    whatever order the pairs were appended in. No block scans the ids
//    for each occurrence, so the cost is O(k) per block, not O(k^2), and
//    the tile's floor of four times the id bytes keeps all blocks' reads
//    of the list (from L2) under a quarter of the table's bytes.
//  - Touched rows: each distinct row of the tile is read once from the
//    input table, its occurrences are applied in key order, and it is
//    written once. The block's threads share the columns of its touched
//    rows and prefetch several occurrences' gradients at a time, so a hot
//    row runs at the block's bandwidth, not one thread's chain.
//  - Untouched rows are then copied input to output with 16-byte
//    accesses, kCopyUnroll in flight a thread, skipped where a shared
//    bitmap marks the row as touched.
//  - Overflow: when a block's pairs would exceed kCap, it applies what it
//    has (the pass above, the copy included) and starts a new chunk; every
//    pair of a later chunk lies later in the batch. A later chunk reads its
//    rows back from the output, which only this block writes, after a
//    block barrier. The id list is still read once.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// ---- K2 ------------------------------------------------------------------

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

// ---- K3 ------------------------------------------------------------------

constexpr int kBlocksPerSM = 2;           // registers: two blocks an SM
constexpr int kIdsPerThread = 8;
constexpr int kTile = kThreads * kIdsPerThread;  // ids read per step
constexpr int kCap = 2048;                 // (row, position) pairs a chunk
constexpr int kSliceVecs = 128;            // vectors of a column slice
constexpr int kMaxRangeRows = 32768;       // rows of a range (the bitmap)
constexpr int kMinTileBytes = 32 << 10;    // floor of a tile's bytes
constexpr int kCopyUnroll = 8;             // rows in flight a thread, copy
constexpr int kApplyUnroll = 8;            // gradients in flight, apply
static_assert(kTile <= kCap, "a step's pairs must fit an empty chunk");
static_assert(kIdsPerThread < 16, "a thread's hits are counted in 4 bits");
static_assert(kSliceVecs <= kThreads, "a slice is one vector a thread");

// One occurrence: v - lr * g, each operation rounded on its own.
__device__ __forceinline__ float4 sub_step(float4 v, float l, float4 g) {
  return make_float4(__fsub_rn(v.x, __fmul_rn(l, g.x)),
                     __fsub_rn(v.y, __fmul_rn(l, g.y)),
                     __fsub_rn(v.z, __fmul_rn(l, g.z)),
                     __fsub_rn(v.w, __fmul_rn(l, g.w)));
}
__device__ __forceinline__ float sub_step(float v, float l, float g) {
  return __fsub_rn(v, __fmul_rn(l, g));
}

__device__ __forceinline__ unsigned key_row(unsigned long long key) {
  return static_cast<unsigned>(key >> 32);
}

// Sorts keys[0, p) ascending; p is a power of two. Every thread calls it.
__device__ void bitonic_sort(unsigned long long* keys, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ascending) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The block's tile: rows [lo, lo + nrows) of the table, vectors [c0, c0 +
// width) of each row; W vectors a row. Thread t works on column
// c0 + (t % tpr) of rows t / tpr, t / tpr + rps, ...
struct Tile {
  int lo, nrows, c0, width, W;
  int cl, rl, rps;
  __device__ size_t at(int local_row) const {
    return static_cast<size_t>(lo + local_row) * W + c0 + cl;
  }
};

// Applies the chunk keys[0, n): sorts it, applies each touched row's
// occurrences in order and, in the first chunk, copies the untouched rows.
template <typename V>
__device__ void apply_chunk(const Tile& tile, const V* __restrict__ table,
                            const V* __restrict__ grads, V* out, float l,
                            int n, bool first, unsigned long long* keys,
                            int* groups, unsigned* touched, int* n_groups) {
  if (n > 0) {
    int p = 1;
    while (p < n) p <<= 1;
    for (int i = n + threadIdx.x; i < p; i += kThreads) keys[i] = ~0ull;
    if (threadIdx.x == 0) *n_groups = 0;
    __syncthreads();
    bitonic_sort(keys, p);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned row = key_row(keys[i]);
      if (i == 0 || row != key_row(keys[i - 1])) {
        groups[atomicAdd(n_groups, 1)] = i;
        if (first) atomicOr(&touched[row >> 5], 1u << (row & 31));
      }
    }
    __syncthreads();
    const int ng = *n_groups;
    const bool mine = tile.cl < tile.width;
    for (int g = tile.rl; mine && g < ng; g += tile.rps) {
      int m = groups[g];
      const unsigned row = key_row(keys[m]);
      const size_t at = tile.at(static_cast<int>(row));
      // A later chunk continues from this block's own output.
      V v = first ? __ldg(table + at) : out[at];
      bool more = true;
      while (more) {
        V gv[kApplyUnroll];
        bool ok[kApplyUnroll];
#pragma unroll
        for (int u = 0; u < kApplyUnroll; ++u) {
          const unsigned long long key = m + u < n ? keys[m + u] : ~0ull;
          ok[u] = key_row(key) == row;  // true for a prefix: keys sorted
          if (ok[u]) {
            const size_t pos = static_cast<unsigned>(key);
            gv[u] = __ldg(grads + pos * tile.W + tile.c0 + tile.cl);
          }
        }
#pragma unroll
        for (int u = 0; u < kApplyUnroll; ++u) {
          if (ok[u]) v = sub_step(v, l, gv[u]);
        }
        more = ok[kApplyUnroll - 1];
        m += kApplyUnroll;
      }
      out[at] = v;
    }
  }
  if (first && tile.cl < tile.width) {
    for (int r0 = tile.rl; r0 < tile.nrows; r0 += tile.rps * kCopyUnroll) {
      V v[kCopyUnroll];
      bool ok[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int r = r0 + u * tile.rps;
        ok[u] = r < tile.nrows && !((touched[r >> 5] >> (r & 31)) & 1u);
        if (ok[u]) v[u] = __ldg(table + tile.at(r));
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        if (ok[u]) out[tile.at(r0 + u * tile.rps)] = v[u];
      }
    }
  }
  __syncthreads();  // keys are rewritten, out rows read back, next chunk
}

// Block b is the tile of rows [q * range_rows, ...) and column slice s, q =
// b / slices, s = b % slices; vectors of V, W to a row.
template <typename V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
scatter_sub_kernel(const V* __restrict__ table, const int* __restrict__ ids,
                   const V* __restrict__ grads, const float* __restrict__ lr,
                   V* out, int k, int rows, int W, int slices,
                   int slice_vecs, int tpr_shift, int range_rows) {
  __shared__ unsigned long long keys[kCap];
  __shared__ int groups[kCap];
  __shared__ unsigned touched[kMaxRangeRows / 32];
  __shared__ int n_keys, n_groups;

  const int q = blockIdx.x / slices;
  const int s = blockIdx.x - q * slices;
  Tile tile;
  tile.lo = q * range_rows;
  tile.nrows = min(range_rows, rows - tile.lo);
  tile.c0 = s * slice_vecs;
  tile.width = min(slice_vecs, W - tile.c0);
  tile.W = W;
  tile.cl = threadIdx.x & ((1 << tpr_shift) - 1);
  tile.rl = threadIdx.x >> tpr_shift;
  tile.rps = kThreads >> tpr_shift;
  const int hi = tile.lo + tile.nrows;
  const float l = *lr;

  for (int i = threadIdx.x; i < (tile.nrows + 31) / 32; i += kThreads) {
    touched[i] = 0;
  }
  if (threadIdx.x == 0) n_keys = 0;
  __syncthreads();

  bool first = true;
  for (int base = 0; base < k; base += kTile) {
    int id[kIdsPerThread];
    int hits = 0;
#pragma unroll
    for (int j = 0; j < kIdsPerThread; ++j) {
      const int pos = base + j * kThreads + threadIdx.x;
      id[j] = pos < k ? __ldg(ids + pos) : -1;
      hits += id[j] >= tile.lo && id[j] < hi;
    }
    // The chunk's pairs so far, read before the barriers below: after them
    // a fast warp may already append this step's pairs, and every thread
    // must take the same branch.
    const int have = n_keys;
    // The step's pairs over the block: hits <= kIdsPerThread < 16.
    const int step = __syncthreads_count(hits & 1) +
                     2 * __syncthreads_count(hits & 2) +
                     4 * __syncthreads_count(hits & 4) +
                     8 * __syncthreads_count(hits & 8);
    if (have + step > kCap) {
      apply_chunk(tile, table, grads, out, l, have, first, keys, groups,
                  touched, &n_groups);
      first = false;
      if (threadIdx.x == 0) n_keys = 0;
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kIdsPerThread; ++j) {
      if (id[j] >= tile.lo && id[j] < hi) {
        const unsigned pos = base + j * kThreads + threadIdx.x;
        const unsigned row = id[j] - tile.lo;
        keys[atomicAdd(&n_keys, 1)] =
            (static_cast<unsigned long long>(row) << 32) | pos;
      }
    }
    __syncthreads();
  }
  apply_chunk(tile, table, grads, out, l, n_keys, first, keys, groups,
              touched, &n_groups);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename V>
cudaError_t launch_scatter_sub(const void* table, const void* ids,
                               const void* grads, const void* lr, void* out,
                               int k, int rows, int W, cudaStream_t stream) {
  const int slices = ceil_div(W, kSliceVecs);
  const int slice_vecs = ceil_div(W, slices);
  int tpr_shift = 0;
  while ((1 << tpr_shift) < slice_vecs) ++tpr_shift;
  const long long slice_bytes =
      static_cast<long long>(slice_vecs) * sizeof(V);
  long long tile_bytes = 4LL * k * sizeof(int);
  if (tile_bytes < kMinTileBytes) tile_bytes = kMinTileBytes;
  long long range_rows = (tile_bytes + slice_bytes - 1) / slice_bytes;
  if (range_rows > kMaxRangeRows) range_rows = kMaxRangeRows;
  if (range_rows > rows) range_rows = rows;
  const int ranges = ceil_div(rows, static_cast<int>(range_rows));
  scatter_sub_kernel<V><<<ranges * slices, kThreads, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int*>(ids),
      static_cast<const V*>(grads), static_cast<const float*>(lr),
      static_cast<V*>(out), k, rows, W, slices, slice_vecs, tpr_shift,
      static_cast<int>(range_rows));
  return cudaGetLastError();
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

// k <= 0 copies the table.
extern "C" int brt_scatter_sub_f32(const void* table, const void* ids,
                                   const void* grads, const void* lr,
                                   void* out, int k, int rows, int dim,
                                   void* stream) {
  if (rows <= 0 || dim <= 0) return 0;
  if (k < 0) k = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = dim % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(grads) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaError_t err =
      vec4 ? launch_scatter_sub<float4>(table, ids, grads, lr, out, k, rows,
                                        dim / 4, s)
           : launch_scatter_sub<float>(table, ids, grads, lr, out, k, rows,
                                       dim, s);
  return static_cast<int>(err);
}
