// The tensor-core pieces shared by the bf16 sweep kernels (sdf_core.cu,
// albedo.cu, nerf.cu): the per-point tile as a K-major bf16 A operand in
// 8x8 cores (the SDF core's kernels; the albedo and NeRF sweeps hold theirs
// in wgmma's 128-byte swizzle, wg_sweep.cuh), the net's widths and offsets
// in the weight image, the accumulator fragment map of wgmma, a
// warpgroup's own barrier, and the column sums of the epilogues. Every
// kernel is fed its weight stages by TMA (tma.cuh).
//
// A block owns a tile of WG_M = 64 points, the M of wgmma; every product of
// a chain is [64 x K] · [K x N] with A (layer input or cotangent row) in
// shared memory and B a K-step of 16 rows of the layer's weight tile, read
// MN-major for W (forward) or K-major for Wᵀ (reverse): no transposed copy.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

#define WG_M 64       // points per tile (the M of wgmma)

typedef __nv_bfloat16 rnb_bf16;

struct RnbWgNet {
  int n_layers, E;
  int in_dim[RNB_MAXL], out_dim[RNB_MAXL];
  int skip[RNB_MAXL];
  int hd[RNB_MAXL];            // skip layer: the input column where e starts
  long long w_off[RNB_MAXL];   // layer l's tile in the bf16 weight image
                               // (ops/wg.py pack_weights: [pad16(in),
                               // pad16(out)] as 8x8 cores, core (i/8, o/8)
                               // at ((i/8)·pad16(out)/8 + o/8)·64)
  long long a_off[RNB_MAXL];   // layer l's A rows in the bf16 dW scratch
  long long bb_off[RNB_MAXL];  // layer l's B rows in the bf16 dW scratch
  int b_off[RNB_MAXL];         // offset of b_l (and of db_l)
};

__host__ __device__ __forceinline__ int rnb_pad16(int x) {
  return (x + 15) & ~15;
}

// Element (p, k) of a K-major A tile: core (k/8, p/8) of 64 elements at
// ((k/8)·8 + p/8)·64, 16-byte rows of 8 k. LBO (along K) 1024 B, SBO 128 B.
__device__ __forceinline__ int wg_tidx(int p, int k) {
  return (((k >> 3) << 3) + (p >> 3)) * 64 + ((p & 7) << 3) + (k & 7);
}

__device__ __forceinline__ rnb_bf16 wg_bf(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float wg_f(rnb_bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void wg_put2(rnb_bf16* tile, int p, int k, float a,
                                        float b) {
  *reinterpret_cast<__nv_bfloat162*>(tile + wg_tidx(p, k)) =
      __halves2bfloat162(wg_bf(a), wg_bf(b));
}

// A barrier of the 128 threads of one warpgroup alone (named barrier `id`,
// 1-15; 0 is __syncthreads').
__device__ __forceinline__ void rnb_wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Accumulator fragment of an N-wide wgmma at warpgroup column base c0:
// register 4j + 2h + v holds row r0 + 8h, column c0 + 8j + cq + v.
#define WG_FRAG_ROWS                                                         \
  const int lt = threadIdx.x & 127, wg = threadIdx.x >> 7;                   \
  const int r0 = ((lt >> 5) << 4) + ((lt & 31) >> 2);                        \
  const int cq = 2 * (lt & 3)

// Column sums of a warpgroup's fragment over its 64 rows, NJ groups of 8
// columns at column base c0: cs[2j + v] holds this thread's sum over its
// two rows of column c0 + 8j + cq + v. Each warp's 16-row sum goes to
// red[warp][column] ([4][256] floats); after a barrier the caller adds the
// four warps in a fixed order (wg_colsum_get). Deterministic, no atomics.
template <int NJ>
__device__ __forceinline__ void wg_colsum_put(float (&cs)[2 * NJ], float* red,
                                              int c0) {
  const int lt = threadIdx.x & 127, lane = lt & 31, warp = lt >> 5;
  const int cq = 2 * (lt & 3);
#pragma unroll
  for (int i = 0; i < 2 * NJ; ++i) {
    float v = cs[i];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    cs[i] = v;
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        red[warp * 256 + c0 + 8 * j + cq + v] = cs[2 * j + v];
  }
}
__device__ __forceinline__ float wg_colsum_get(const float* red, int c) {
  return ((red[c] + red[256 + c]) + red[512 + c]) + red[768 + c];
}
