// Forward flash attention for Hopper (sm_90a): two tensor-core kernels,
// one for bf16 and one for f32.
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
// TFLOP/s of bf16 tensor-core rate; it moves the q, k, v and o bytes once
// against 3.35 TB/s. At the Llama-3-8B head shapes (Hq 32, Hkv 8, D 128,
// T >= 512) the operations bound it. For f32 see below.
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
// f32: flash_fwd_split_tf32_kernel. An f32 product outside the tensor
// cores peaks at 67 TFLOP/s; the tensor cores take f32 only as TF32 (10
// mantissa bits, 495 TFLOP/s), and one TF32 product misses the f32 gate
// (2e-5 of the plain version) by far, as tests/test_torch_flash_attention.py
// shows on the CPU. So both products are split TF32: each f32 operand x is
// x_hi = tf32(x) and x_lo = tf32(x - x_hi), rounded as cvt.rna.tf32.f32
// rounds, and a product a*b is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, summed in
// f32. That carries about 21 bits of each operand; the dropped a_lo*b_lo is
// about 2^-22 of the product. Three TF32 products cost 3x the operations
// at 495 TFLOP/s, which is 2.5x the SIMT peak: the f32 bound is the smaller
// of the two, 3x the operations at 495e12 (chip_smoke.py prints both).
//
// The products are mma.sync m16n8k8 tf32, not wgmma: wgmma reads its B
// operand from shared memory only, so a split B would need hi and lo tiles
// written back to shared memory (twice the bytes of the raw tiles, and a
// pass and a barrier a tile), and tf32 wgmma takes only K-major operands,
// which V (keys are its rows) is not. mma.sync takes every operand from
// registers: each thread loads its fragments from the raw f32 tiles and
// splits them in registers, so shared memory holds raw tiles only and V is
// read row-major as it lies. One block of eight warps per (128 query rows,
// query head, batch row), heaviest causal tiles first; each warp owns 16
// query rows. Thread 0 issues TMA copies of the Q tile and of 64-row K and
// V tiles into a two-stage ring (separate K and V buffers, full and empty
// mbarriers for each), f32 rows in the 128-byte swizzle (32 floats a row,
// D/32 such atoms side by side): the first two tiles at the start, and
// each later one into the stage every warp has just released, so the next
// tile is in flight while the warps compute. No warp only loads: with
// nine warps one scheduler of the SM holds three, which caps every thread
// at 168 registers, and the products spill there; eight warps get 255.
// Each warp scales its Q rows by D^-0.5 in place once. S = Q K^T takes A
// fragments of Q and B fragments of K straight from the swizzled tiles
// (the swizzle makes every fragment load free of bank conflicts); the mask
// and the online softmax run on the accumulator in registers (row max and
// sum over the four threads of a row by shuffles, exponents as
// 2^(s*log2e - m*log2e)). P goes into O += P V from the registers that
// hold it: the accumulator gives a thread keys 2t and 2t+1 of each 8, and
// the k8 step's order of keys is free as long as A and B agree, so A's
// columns t and t+4 are keys 2t and 2t+1 and each thread loads V's rows
// 2t and 2t+1 for its B fragment. Each tile's P V goes into a fresh
// accumulator, added to O in f32 (the tensor cores' sums drift over long
// chains; see the loop). Shared memory at D=128: 64 KB of Q and 128 KB of
// K/V ring; no round trip of the scores. The output is written from the
// registers as float2, rows >= T dropped.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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

// A map of a contiguous [B,T,H,D] tensor of `elem`-byte elements whose box
// is `rows` positions of one head and `inner` elements of the head dim, in
// the given swizzle (64 or 128 bytes).
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                const void* ptr, int b, int seq, int heads, int d, int inner,
                int rows, int swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * elem,
                                 cuuint64_t(heads) * d * elem,
                                 cuuint64_t(seq) * heads * d * elem};
  const cuuint32_t box[4] = {cuuint32_t(inner), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// ---- f32: split TF32 products on the tensor cores -------------------------

namespace tf32 {

using namespace hopper;

constexpr int kWarps = 8;               // 16 query rows each
constexpr int kBQ = 16 * kWarps;        // query rows per block
constexpr int kBK = 64;                 // key rows per K/V tile
constexpr int kStages = 2;              // K/V tiles in flight
constexpr int kThreads = 32 * kWarps;  // thread 0 also issues the loads
constexpr int kRow = 32;                // floats in a 128-byte swizzled row
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "D must be 32, 64 or 128");
  // A tile is D / 32 atoms side by side, each [rows][32 floats] swizzled.
  static constexpr int kAtoms = D / kRow;
  static constexpr int kQAtom = kBQ * kRow;   // floats
  static constexpr int kKVAtom = kBK * kRow;
  static constexpr int kQFloats = kAtoms * kQAtom;
  static constexpr int kKVFloats = kAtoms * kKVAtom;
  static constexpr int kBarriers = 1 + 4 * kStages;
  // Q, the K ring, the V ring, the barriers, and room to align to 1024.
  static constexpr int kSmem =
      4 * (kQFloats + 2 * kStages * kKVFloats) + 8 * kBarriers + 1024;
};

// Float offset of (row, col) in a tile of atoms `atom` floats apart: TMA's
// 128-byte swizzle puts the row's 16-byte chunk c at c ^ (row % 8).
template <int kAtom>
__device__ __forceinline__ int at(int row, int col) {
  return (col / kRow) * kAtom + row * kRow +
         ((((col % kRow) / 4) ^ (row % 8)) << 2) + col % 4;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero: half an ulp of TF32 added to the magnitude, the 13 low bits
// cleared), in two integer operations, which issue faster than the cvt.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile, TF32 in, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split once, for every B fragment it meets.
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
  }
};

// d += a b, b split here: a_lo b_hi + a_hi b_lo + a_hi b_hi.
__device__ __forceinline__ void mma3(float (&d)[4], const SplitA& a,
                                     const float (&b)[2]) {
  uint32_t hi[2], lo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) split(b[i], hi[i], lo[i]);
  mma(d, a.lo, hi);
  mma(d, a.hi, lo);
  mma(d, a.hi, hi);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_split_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                float* __restrict__ o, int seq, int hq,
                                int group, int causal, float scale) {
  using G = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* const sm =
      reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  float* const q_t = sm;
  const float* const k_t = sm + G::kQFloats;  // kStages tiles
  const float* const v_t = k_t + kStages * G::kKVFloats;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + 4 * G::kQFloats;
  const uint32_t v_s = k_s + 4 * kStages * G::kKVFloats;
  const uint32_t bars = v_s + 4 * kStages * G::kKVFloats;
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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kThreads);  // every thread
      mbar_init(v_empty(s), kThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 loads: Q and the first kStages K/V tiles now, and each later
  // tile into the stage the block has just released (see the loop).
  auto load_kv = [&](int n) {
    const int s = n % kStages;
    mbar_expect_tx(k_full(s), 4 * G::kKVFloats);
    for (int a = 0; a < G::kAtoms; ++a)
      tma_load_4d(k_s + 4 * (s * G::kKVFloats + a * G::kKVAtom), &tm_k,
                  k_full(s), a * kRow, hk, n * kBK, b);
    mbar_expect_tx(v_full(s), 4 * G::kKVFloats);
    for (int a = 0; a < G::kAtoms; ++a)
      tma_load_4d(v_s + 4 * (s * G::kKVFloats + a * G::kKVAtom), &tm_v,
                  v_full(s), a * kRow, hk, n * kBK, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 4 * G::kQFloats);
    for (int a = 0; a < G::kAtoms; ++a)
      tma_load_4d(q_s + 4 * a * G::kQAtom, &tm_q, q_full, a * kRow, h, q0,
                  b);
    for (int n = 0; n < min(kStages, n_tiles); ++n) load_kv(n);
  }

  // ---- every warp: 16 query rows ----
  // Fragment coordinates of mma m16n8k8: row g and g + 8, column t and
  // t + 4 of A; column g, row t and t + 4 of B; row g and g + 8, columns
  // 2t and 2t + 1 of the accumulator.
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;  // this warp's first row in the tile
  const int first_row = q0 + r0;
  const int n_mine = causal ? min((first_row + 15) / kBK + 1, n_all) : n_all;

  float acc[D / 8][4];  // O, 8 head-dim columns a tile
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the sum

  mbar_wait(q_full, 0);
  // q * D^-0.5 in f32, as the reference scales it, in this warp's own rows.
#pragma unroll
  for (int a = 0; a < G::kAtoms; ++a)
    for (int i = lane; i < 16 * kRow; i += 32)
      q_t[a * G::kQAtom + r0 * kRow + i] *= scale;
  __syncwarp();

  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kStages;
    const uint32_t parity = (n / kStages) & 1;
    const bool mine = n < n_mine;
    float sc[kBK / 8][4];  // S, then P: 8 keys a tile

    mbar_wait(k_full(s), parity);
    if (mine) {
      const float* kt = k_t + s * G::kKVFloats;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int c = 8 * kk + t;
        const SplitA a({q_t[at<G::kQAtom>(r0 + g, c)],
                        q_t[at<G::kQAtom>(r0 + g + 8, c)],
                        q_t[at<G::kQAtom>(r0 + g, c + 4)],
                        q_t[at<G::kQAtom>(r0 + g + 8, c + 4)]});
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float bk[2] = {kt[at<G::kKVAtom>(8 * j + g, c)],
                               kt[at<G::kKVAtom>(8 * j + g, c + 4)]};
          mma3(sc[j], a, bk);
        }
      }
    }
    mbar_arrive(k_empty(s));

    if (mine) {
      // Mask, then one online-softmax step, in registers.
      const int k0 = n * kBK;
      if (k0 + kBK > seq || (causal && k0 + kBK - 1 > first_row)) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = k0 + 8 * j + 2 * t + i % 2;
            const int row = first_row + g + 8 * (i / 2);
            if (col >= seq || (causal && col > row)) sc[j][i] = kMasked;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], sc[j][i]);
      float alpha[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // Column 0 lies in the first tile, so m is finite from there on and
        // a masked column gives p = 0.
        alpha[r] = fast_exp2((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        mc[r] = mx[r] * kLog2e;
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[j][i] = fast_exp2(fmaf(sc[j][i], kLog2e, -mc[i / 2]));
          sum[i / 2] += sc[j][i];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] *= alpha[i / 2];
    }

    mbar_wait(v_full(s), parity);
    if (mine) {
      // O += P V, 8 keys at a time, into a fresh accumulator that is added
      // to O in f32 registers once a tile: the tensor cores' f32 sums
      // drift over a long chain (as sums rounded toward zero would), and
      // one chain over the whole sequence put the output 5-8e-6 from the
      // plain version at the serving shapes and the f32 request's logits
      // 1.1e-4 from dense attention; a chain of 24 products a tile gives
      // 2-4e-6 and 3.4e-5. A's columns t and t + 4 are keys 2t and 2t + 1,
      // the keys this thread's accumulator holds.
      const float* vt = v_t + s * G::kKVFloats;
      float pv[D / 8][4];
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[jd][i] = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const SplitA a({sc[j][0], sc[j][2], sc[j][1], sc[j][3]});
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd) {
          const int c = 8 * jd + g;
          const float bv[2] = {vt[at<G::kKVAtom>(8 * j + 2 * t, c)],
                               vt[at<G::kKVAtom>(8 * j + 2 * t + 1, c)]};
          mma3(pv[jd], a, bv);
        }
      }
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jd][i] += pv[jd][i];
    }
    mbar_arrive(v_empty(s));
    // Once every warp is done with this stage, the next tile but one
    // goes into it. Warp 0 waits here meanwhile; the others go on with
    // the tile the other stage holds.
    if (threadIdx.x == 0 && n + kStages < n_tiles) {
      mbar_wait(k_empty(s), parity);
      mbar_wait(v_empty(s), parity);
      load_kv(n + kStages);
    }
  }

  // Epilogue: acc / max(l, 1e-20) from the registers, rows >= T dropped.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-20f);
    const int row = first_row + g + 8 * r;
    if (row >= seq) continue;
    float* out = o + ((int64_t(b) * seq + row) * hq + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * r] / l[r], acc[j][2 * r + 1] / l[r]);
  }
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int b, int seq, int hq, int hkv, int causal,
                     cudaStream_t stream) {
  // TMA reads 16-byte aligned tensors; the output is written as float2.
  if ((uintptr_t(q) | uintptr_t(k) | uintptr_t(v) | uintptr_t(o)) % 16)
    return cudaErrorMisalignedAddress;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_map(&tm_q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, b, seq, hq,
                  D, kRow, kBQ, 128) ||
      !encode_map(&tm_k, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, k, b, seq, hkv,
                  D, kRow, kBK, 128) ||
      !encode_map(&tm_v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, v, b, seq, hkv,
                  D, kRow, kBK, 128))
    return cudaErrorInvalidValue;
  constexpr int smem = Tile<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_split_tf32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, hq, b);
  const float scale = float(1.0 / sqrt(double(D)));
  flash_fwd_split_tf32_kernel<D><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<float*>(o), seq, hq, hq / hkv, causal,
      scale);
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

}  // namespace tf32

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

// A map of a contiguous bf16 [B,T,H,D] tensor whose box is `rows` positions
// of one head and one atom of the head dim.
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int b, int seq, int heads,
            int rows) {
  using G = Tile<D>;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, b, seq,
                    heads, D, G::kAtom, rows, G::kSwizzle);
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
  return tf32::launch(q, k, v, o, b, seq, hq, hkv, d, causal, stream);
}

extern "C" int brt_flash_attention_bf16(const void* q, const void* k,
                                        const void* v, void* o, int b, int seq,
                                        int hq, int hkv, int d, int causal,
                                        void* stream) {
  return wg::launch(q, k, v, o, b, seq, hq, hkv, d, causal, stream);
}
