// Forward flash attention for Hopper (sm_90a): a tensor-core kernel for
// bf16 and the SIMT kernel of the first port for f32.
//
// Replaces the Pallas kernel of brpc_tpu/ops/flash_attention.py
// (`_kernel`, launched by `flash_attention` through `pl.pallas_call`) and
// computes what it computes: grouped-query attention, q [B,T,Hq,D] and k/v
// [B,T,Hkv,D] -> o [B,T,Hq,D] in q's dtype; query head h reads kv head
// h / (Hq/Hkv); scores are scaled by D^-0.5 in f32; the causal mask value
// is -1e30; an online softmax (running max, sum and accumulator in f32)
// streams the K/V tiles, and the output is acc / max(l, 1e-20). Causal K/V
// tiles wholly past the diagonal are skipped.
//
// Bound on the H100 SXM: the function needs 4*B*Hq*D operations for every
// (query, key) pair the mask keeps (2*B*Hq*T*(T+1)*D causal), against 989
// TFLOP/s of bf16 tensor-core rate, or 67 TFLOP/s of f32 outside the tensor
// cores for f32 inputs; it moves the q, k, v and o bytes once against
// 3.35 TB/s. At the Llama-3-8B head shapes (Hq 32, Hkv 8, D 128, T >= 512)
// the operations bound it.
//
// bf16: flash_fwd_wgmma_kernel. One block of three warpgroups per (128 query
// rows, query head, batch row), heaviest causal tiles first. Warpgroup 0
// loads: one thread issues TMA copies of the Q tile and of 64-row K and V
// tiles into a two-stage ring (separate K and V buffers, full and empty
// mbarriers for each), and the warpgroup gives up registers with
// setmaxnreg. Warpgroups 1 and 2 each own 64 query rows: S = Q K^T is
// wgmma m64n64k16 with both operands bf16 in shared memory in the
// 128-byte swizzle that TMA writes (64-byte at D=32), K-major; the scale
// D^-0.5*log2(e) enters after the product, in the fma of each exponent,
// p = 2^(s*c - m*c); the row max and sum take two quad shuffles; P stays
// in registers as the A fragment of O += P V, wgmma m64nDk16 with V read
// N-major (the transpose bit). Each warpgroup runs a software pipeline:
// S of tile n is issued with P V of tile n-1, and the softmax of tile n
// runs while that P V holds the tensor cores (fence_operands pins the
// softmax before the wait, or the compiler sinks it below). The two
// warpgroups take turns to issue (named barriers), so one's softmax
// overlaps the other's products. Only tiles that cross the diagonal or the
// end of the sequence are masked; columns >= T score -1e30 (TMA fills
// those K rows with zeros). The output is staged in the warpgroup's own Q
// rows in the same swizzle and written by a TMA store, which drops rows
// >= T. ptxas holds every thread to the 168 registers of the 384-thread
// launch bound (setmaxnreg does not raise its allocation), which is what
// keeps K/V tiles at 64 rows: 128-row tiles spill.
//
// Why P is split: the tensor cores take P as bf16, and P rounded once to
// bf16 misses the gate that holds this kernel to its plain version (one
// bf16 step of the output per element) at the serving head shapes, as
// tests/test_torch_flash_attention.py shows on the CPU. P goes in as two bf16 halves, p_hi = bf16(p) and p_lo =
// bf16(p - p_hi), both multiplied by V into one f32 accumulator; p_hi +
// p_lo carries p to about 2^-17 of itself. That second P V product is this
// kernel's cost (1.5x the bound's operations), not part of the bound.
//
// f32: flash_fwd_kernel, kept as the first port wrote it: a TF32
// tensor-core product would break the 2e-5 f32 bound, f32 is on no serving
// path, and this kernel runs at 27-38 % of the f32 bound. One block of 256
// threads per (64 query rows, query head, batch row); Q, one K or V tile
// and the 64x64 score tile in shared memory as f32; a 16x16 thread grid
// computes both products with f32 FMAs; four threads per query row reduce
// the row's max and sum with warp shuffles; K and padded Q rows are strided
// D+1 floats so that the product reads no bank twice.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per K/V tile
constexpr int kThreads = 256;  // a 16x16 grid of threads
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ) * (D + 1) + size_t(kBK) * (D + 1) +
          size_t(kBQ) * (kBK + 1) + kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int seq,
                     int hq, int hkv, int causal, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kCols = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                      // [kBQ][D + 1], pre-scaled
  float* kv_s = q_s + kBQ * (D + 1);      // K as [kBK][D + 1], then V [kBK][D]
  float* s_s = kv_s + kBK * (D + 1);      // [kBQ][kBK + 1], scores then P
  float* row_s = s_s + kBQ * (kBK + 1);   // [kBQ]: alpha per tile, l at the end

  // Heaviest causal q-tiles first, so the short ones fill the tail.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // product grid
  const int sr = tid / 4, part = tid % 4;  // softmax: 4 threads per row

  const int64_t q_stride = int64_t(hq) * D;  // between sequence positions
  const int64_t kv_stride = int64_t(hkv) * D;
  const int64_t q_off = (int64_t(b) * seq * hq + h) * D;
  const int64_t kv_off = (int64_t(b) * seq * hkv + h / (hq / hkv)) * D;
  const T* q_base = q + q_off;
  const T* k_base = k + kv_off;
  const T* v_base = v + kv_off;
  T* o_base = o + q_off;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    q_s[r * (D + 1) + d] = t < seq ? to_f32(q_base[t * q_stride + d]) * scale
                                   : 0.f;
  }

  float m_row = -INFINITY, l_row = 0.f;  // softmax state of row sr
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const int n_tiles_all = (seq + kBK - 1) / kBK;
  const int n_tiles =
      causal ? min((q0 + kBQ - 1) / kBK + 1, n_tiles_all) : n_tiles_all;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's readers of kv_s and s_s are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      kv_s[r * (D + 1) + d] = s < seq ? to_f32(k_base[s * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T; this thread owns rows ty*4+i and columns tx+16*j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < seq && (!causal || col <= row);
        s_s[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = keep ? sc[i][j] : kMasked;
      }
    }
    __syncthreads();

    // K is no longer read: stage V while the rows take their softmax step.
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      kv_s[r * D + d] = s < seq ? to_f32(v_base[s * kv_stride + d]) : 0.f;
    }
    {
      float* srow = s_s + sr * (kBK + 1) + part * (kBK / 4);
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kBK / 4; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // Column 0 lies in the first tile, so m_new is finite from there on
      // and a fully masked later tile gives alpha 1 and p 0.
      const float m_new = fmaxf(m_row, mx);
      const float alpha = expf(m_row - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kBK / 4; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_row = l_row * alpha + sum;
      m_row = m_new;
      if (part == 0) row_s[sr] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V; this thread owns rows ty*4+i, columns tx+16*j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = kv_s[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  __syncthreads();
  if (part == 0) row_s[sr] = l_row;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= seq) continue;
    const float l = fmaxf(row_s[ty * 4 + i], 1e-20f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      store(&o_base[t * q_stride + tx + 16 * j], acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int b, int seq, int hq, int hkv, int causal,
                     cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, hq, b);
  const float scale = float(1.0 / sqrt(double(D)));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, hq, hkv, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int seq, int hq, int hkv, int d, int causal, void* stream) {
  if (b <= 0 || seq <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return int(launch_d<T, 32>(q, k, v, o, b, seq, hq, hkv, causal, s));
    case 64: return int(launch_d<T, 64>(q, k, v, o, b, seq, hq, hkv, causal, s));
    case 128: return int(launch_d<T, 128>(q, k, v, o, b, seq, hq, hkv, causal, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace


// ---- bf16: wgmma and TMA --------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kBQ = 128;       // query rows per block, 64 per consumer
constexpr int kBK = 64;        // key rows per K/V tile
constexpr int kStages = 2;     // K/V tiles in flight
constexpr int kThreads = 384;  // warpgroup 0 loads, 1 and 2 compute
constexpr int kLoadRegs = 24, kMathRegs = 240;
constexpr float kMasked = -1e30f;

template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "D must be 32, 64 or 128");
  // A swizzled row holds one atom of the head dim: 64 bf16 in 128 bytes
  // (32 in 64 bytes at D=32); a tile is D / kAtom atoms side by side.
  static constexpr int kSwizzle = D >= 64 ? 128 : 64;
  static constexpr int kAtom = kSwizzle / 2;
  static constexpr int kAtoms = D / kAtom;
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
  static constexpr int kQAtomBytes = kBQ * kSwizzle;
  static constexpr int kKVAtomBytes = kBK * kSwizzle;
  static constexpr int kQBytes = kAtoms * kQAtomBytes;
  static constexpr int kKVBytes = kAtoms * kKVAtomBytes;
  static constexpr int kBarriers = 1 + 4 * kStages;
  // Q, the K ring, the V ring, the barriers, and room to align to 1024.
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers + 1024;

  // K-major operand (Q for S, K for S): 8-row groups kSwizzle*8 apart.
  static __device__ __forceinline__ uint64_t k_major(uint32_t addr) {
    return smem_desc(addr, 16, 8 * kSwizzle, kLayout);
  }
  // N-major operand (V for O): head-dim atoms kKVAtomBytes apart, 8-row
  // groups of keys kSwizzle*8 apart.
  static __device__ __forceinline__ uint64_t n_major(uint32_t addr) {
    return smem_desc(addr, kKVAtomBytes, 8 * kSwizzle, kLayout);
  }
};

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 128) wgmma_rs_m64n128k16(acc, a, desc_v);
  else if constexpr (D == 64) wgmma_rs_m64n64k16(acc, a, desc_v);
  else wgmma_rs_m64n32k16(acc, a, desc_v);
}

// 2^x on the special-function unit; subnormal inputs and results flush to
// zero, which moves no p by more than 2^-126.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o, int seq,
                           int group, int causal, float scale_log2) {
  using G = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + G::kQBytes;
  const uint32_t v_s = k_s + kStages * G::kKVBytes;
  const uint32_t bars = v_s + kStages * G::kKVBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  // Heaviest causal q-tiles first, so the short ones fill the tail.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int n_all = (seq + kBK - 1) / kBK;
  const int n_tiles = causal ? min((q0 + kBQ - 1) / kBK + 1, n_all) : n_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrival per consumer warp
      mbar_init(v_empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- loader: the whole life of warpgroup 0 ----
    setmaxnreg_dec<kLoadRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, G::kQBytes);
      for (int a = 0; a < G::kAtoms; ++a)
        tma_load_4d(q_s + a * G::kQAtomBytes, &tm_q, q_full, a * G::kAtom, h,
                    q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        const uint32_t free_parity = ((n / kStages) & 1) ^ 1;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), G::kKVBytes);
        for (int a = 0; a < G::kAtoms; ++a)
          tma_load_4d(k_s + s * G::kKVBytes + a * G::kKVAtomBytes, &tm_k,
                      k_full(s), a * G::kAtom, hk, n * kBK, b);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), G::kKVBytes);
        for (int a = 0; a < G::kAtoms; ++a)
          tma_load_4d(v_s + s * G::kKVBytes + a * G::kKVAtomBytes, &tm_v,
                      v_full(s), a * G::kAtom, hk, n * kBK, b);
      }
    }
  } else {
    // ---- consumers: warpgroups 1 and 2, 64 query rows each ----
    setmaxnreg_inc<kMathRegs>();
    const int w = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4;  // rows r0 and r0 + 8 of 64
    const int cq = 2 * (lane % 4);            // columns cq, cq+1 of each 8
    const int first_row = q0 + 64 * w;
    const int row0 = first_row + r0;
    const int n_mine =
        causal ? min((first_row + 63) / kBK + 1, n_all) : n_all;
    const uint32_t q_mine = q_s + 64 * w * G::kSwizzle;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kBK / 2];  // S of the newest tile, then its P in f32
    uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];  // P as A fragments
    float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
    float l[2] = {0.f, 0.f};              // this thread's share of the sum
    float alpha[2];                       // rescale of acc for the next P V

    // S = Q K^T of tile n over the head dim, 16 at a time (not committed).
    auto issue_s = [&](int n) {
      const uint32_t k_tile = k_s + (n % kStages) * G::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int atom = kk * 16 / G::kAtom, col = kk * 16 % G::kAtom;
        wgmma_ss_m64n64k16(
            sc, G::k_major(q_mine + atom * G::kQAtomBytes + 2 * col),
            G::k_major(k_tile + atom * G::kKVAtomBytes + 2 * col), kk > 0);
      }
    };
    // O += P_hi V + P_lo V of tile n, 16 keys at a time (not committed).
    auto issue_pv = [&](int n) {
      const uint32_t v_tile = v_s + (n % kStages) * G::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t desc_v = G::n_major(v_tile + kk * 16 * G::kSwizzle);
        wgmma_pv<D>(acc, p_hi[kk], desc_v);
        wgmma_pv<D>(acc, p_lo[kk], desc_v);
      }
    };
    // Mask and the online softmax step of tile n on sc, in registers;
    // leaves P in sc and the rescale of acc in alpha. The running max is
    // kept in unscaled units and D^-0.5*log2(e) enters each exponent in
    // one fma: p = 2^(s*c - m*c). Register i holds row r0 + 8*((i/2)%2),
    // column 8*(i/4) + cq + i%2.
    auto softmax = [&](int n) {
      const int k0 = n * kBK;
      if (k0 + kBK > seq || (causal && k0 + kBK - 1 > first_row)) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + cq + i % 2;
          const int row = row0 + 8 * ((i / 2) % 2);
          const bool masked = (col >= seq) | (causal & (col > row));
          sc[i] = masked ? kMasked : sc[i];
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float sum[2] = {0.f, 0.f}, mc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        // Column 0 lies in the first tile, so m is finite from there on and
        // a masked column gives p = 0.
        alpha[j] = fast_exp2((m[j] - mx[j]) * scale_log2);
        m[j] = mx[j];
        mc[j] = m[j] * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -mc[(i / 2) % 2]));
        sum[(i / 2) % 2] += sc[i];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + sum[j];
    };
    // P into A fragments, split in two bf16 halves. The accumulator layout
    // of 16 key columns is the A fragment of one k16 step.
    auto split_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = sc[8 * kk + 2 * j], y = sc[8 * kk + 2 * j + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          const float2 back = __bfloat1622float2(hi);
          p_hi[kk][j] = bf16x2_bits(hi);
          p_lo[kk][j] = bf16x2_bits(__floats2bfloat162_rn(x - back.x,
                                                          y - back.y));
        }
    };
    auto rescale_acc = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
    };
    auto parity = [](int n) { return uint32_t((n / kStages) & 1); };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // The two warpgroups take turns to issue their products (named
    // barriers 3 and 4: this warpgroup's 128 threads wait, the other's 128
    // arrive), so one's softmax runs while the other's products hold the
    // tensor cores. Both take one turn per tile of the block; warpgroup 0
    // goes first.
    const uint32_t my_turn = 3 + w, their_turn = 4 - w;
    if (w == 1) named_barrier_arrive(3, 256);
    mbar_wait(q_full, 0);

    // Tile 0, then a software pipeline: S of tile n runs beside P V of
    // tile n-1, and the softmax of tile n beside that P V.
    named_barrier(my_turn, 256);
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    named_barrier_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_operands(sc);
    release(k_empty(0));
    softmax(0);
    split_p();
    for (int n = 1; n < n_mine; ++n) {
      const int s = n % kStages, prev = (n - 1) % kStages;
      rescale_acc();
      named_barrier(my_turn, 256);
      mbar_wait(k_full(s), parity(n));
      mbar_wait(v_full(prev), parity(n - 1));
      wgmma_fence();
      issue_s(n);
      wgmma_commit();
      issue_pv(n - 1);
      wgmma_commit();
      named_barrier_arrive(their_turn, 256);
      wgmma_wait<1>();  // S of tile n
      fence_operands(sc);
      release(k_empty(s));
      softmax(n);
      fence_operands(sc);  // the softmax runs here, beside P V, not after it
      wgmma_wait<0>();  // P V of tile n-1
      fence_operands(acc);
      release(v_empty(prev));
      split_p();
    }
    {
      const int last = n_mine - 1;
      rescale_acc();
      mbar_wait(v_full(last % kStages), parity(last));
      wgmma_fence();
      issue_pv(last);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      release(v_empty(last % kStages));
    }
    // Tiles wholly past this warpgroup's diagonal: take the turn and hand
    // the buffers back once they hold the tile, so turns and phases stay
    // in step with the other warpgroup.
    for (int n = n_mine; n < n_tiles; ++n) {
      const int s = n % kStages;
      named_barrier(my_turn, 256);
      named_barrier_arrive(their_turn, 256);
      mbar_wait(k_full(s), parity(n));
      release(k_empty(s));
      mbar_wait(v_full(s), parity(n));
      release(v_empty(s));
    }

    // Epilogue: acc / max(l, 1e-20) rounded to bf16 into this warpgroup's
    // own Q rows (no longer read) in the swizzled layout, then a TMA store.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
      l[j] = fmaxf(l[j], 1e-20f);
    }
    named_barrier(1 + w, 128);  // every warp's last product read Q
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int half = (i / 2) % 2;
      const int col = 8 * (i / 4) + cq;
      const uint32_t bits = bf16x2_bits(
          __floats2bfloat162_rn(acc[i] / l[half], acc[i + 1] / l[half]));
      uint32_t off = (r0 + 8 * half) * G::kSwizzle + 2 * (col % G::kAtom);
      off ^= ((off >> 7) & (G::kSwizzle / 16 - 1)) << 4;
      st_shared_u32(q_mine + (col / G::kAtom) * G::kQAtomBytes + off, bits);
    }
    fence_proxy_async();
    named_barrier(1 + w, 128);
    if (t == 0 && first_row < seq) {
      for (int a = 0; a < G::kAtoms; ++a)
        tma_store_4d(&tm_o, q_mine + a * G::kQAtomBytes, a * G::kAtom, h,
                     first_row, b);
      tma_store_commit_and_wait();
    }
  }
}

// cuTensorMapEncodeTiled from the driver, reached through the runtime so
// that the library needs no link flag.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of a contiguous bf16 [B,T,H,D] tensor whose box is `rows` positions
// of one head and one atom of the head dim.
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int b, int seq, int heads,
            int rows) {
  using G = Tile<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2,
                                 cuuint64_t(heads) * D * 2,
                                 cuuint64_t(seq) * heads * D * 2};
  const cuuint32_t box[4] = {cuuint32_t(G::kAtom), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            G::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int b, int seq, int hq, int hkv, int causal,
                     cudaStream_t stream) {
  // TMA reads and writes 16-byte aligned tensors.
  if ((uintptr_t(q) | uintptr_t(k) | uintptr_t(v) | uintptr_t(o)) % 16)
    return cudaErrorMisalignedAddress;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!encode<D>(&tm_q, q, b, seq, hq, kBQ) ||
      !encode<D>(&tm_k, k, b, seq, hkv, kBK) ||
      !encode<D>(&tm_v, v, b, seq, hkv, kBK) ||
      !encode<D>(&tm_o, o, b, seq, hq, 64))
    return cudaErrorInvalidValue;
  constexpr int smem = Tile<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, hq, b);
  const float scale_log2 = float(1.4426950408889634 / sqrt(double(D)));
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, seq, hq / hkv, causal, scale_log2);
  return cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o, int b,
           int seq, int hq, int hkv, int d, int causal, void* stream) {
  if (b <= 0 || seq <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return int(launch_d<32>(q, k, v, o, b, seq, hq, hkv, causal, s));
    case 64: return int(launch_d<64>(q, k, v, o, b, seq, hq, hkv, causal, s));
    case 128: return int(launch_d<128>(q, k, v, o, b, seq, hq, hkv, causal, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace wg

// Each returns the cudaError_t of the launch (0 on success). Pointers are
// device pointers to contiguous [B,T,H,D] tensors; stream is a cudaStream_t.
extern "C" int brt_flash_attention_f32(const void* q, const void* k,
                                       const void* v, void* o, int b, int seq,
                                       int hq, int hkv, int d, int causal,
                                       void* stream) {
  return launch<float>(q, k, v, o, b, seq, hq, hkv, d, causal, stream);
}

extern "C" int brt_flash_attention_bf16(const void* q, const void* k,
                                        const void* v, void* o, int b, int seq,
                                        int hq, int hkv, int d, int causal,
                                        void* stream) {
  return wg::launch(q, k, v, o, b, seq, hq, hkv, d, causal, stream);
}
