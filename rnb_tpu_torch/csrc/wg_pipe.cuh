// The tensor-core pipeline shared by the bf16 sweep kernels (sdf_core.cu,
// albedo.cu, nerf.cu): the per-point tile as a K-major bf16 A operand, the
// padded bf16 weight image streamed through a cp.async ring (the albedo
// and NeRF forwards; the backward sweeps and the SDF core's kernels are fed
// by TMA, tma.cuh), the
// accumulator fragment map of wgmma, a warpgroup's own barrier, and the
// epilogue helpers.
//
// A block owns a tile of WG_M = 64 points, the M of wgmma; every product of
// a chain is [64 x K] · [K x N] with A (layer input or cotangent row) in
// shared memory and B a K-step of 16 rows of the layer's weight tile, read
// MN-major for W (forward) or K-major for Wᵀ (reverse): no transposed copy.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

#define WG_M 64       // points per tile (the M of wgmma)

// Ring stages of the albedo and NeRF forwards (each one K-step of 16). Four
// ran fastest of the shapes tried (PERF.md).
#define WG_RS 4

typedef __nv_bfloat16 rnb_bf16;

struct RnbWgNet {
  int n_layers, E;
  int in_dim[RNB_MAXL], out_dim[RNB_MAXL];
  int skip[RNB_MAXL];
  int hd[RNB_MAXL];            // skip layer: the input column where e starts
  long long w_off[RNB_MAXL];   // layer l's tile in the bf16 weight image
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

// The weight image (built by ops/wg.py pack_weights): layer l is a
// [pad16(in), pad16(out)] bf16 tile of 8x8 cores, core (i/8, o/8) at
// ((i/8)·(pad16(out)/8) + o/8)·64, rows of 8 consecutive o; pads are zero.
//
// Forward K-step t (rows 16t..16t+15) into a stage as MN-major B: core
// (kb, ob) at (kb·nb + ob)·64; LBO = nb·128 B, SBO = 128 B. Cores past the
// layer's width are zero-filled (nb = 32, or 33 for the N = 8 tail).
__device__ __forceinline__ void wg_copy_fwd(rnb_bf16* st, const rnb_bf16* w,
                                            int npc, int nb, int t) {
  const int total = 2 * nb * 8;
  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    const int kb = q / (nb * 8), rem = q - kb * nb * 8;
    const int ob = rem >> 3, r = rem & 7;
    const bool ok = ob < npc;
    const rnb_bf16* src =
        ok ? w + ((long long)(2 * t + kb) * npc + ob) * 64 + r * 8 : w;
    rnb_cp_async16(st + (kb * nb + ob) * 64 + r * 8, src, ok);
  }
}

// Reverse K-step t (output columns 16t..16t+15 of W, i.e. rows of Wᵀ) into a
// stage as K-major B over N = the layer's inputs: core (ib, kb) at
// (ib·2 + kb)·64; LBO = 128 B, SBO = 256 B. Input blocks past kpc are zero.
__device__ __forceinline__ void wg_copy_rev(rnb_bf16* st, const rnb_bf16* w,
                                            int npc, int kpc, int ibn, int t) {
  const int total = ibn * 16;
  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    const int ib = q >> 4, kb = (q >> 3) & 1, r = q & 7;
    const bool ok = ib < kpc;
    const rnb_bf16* src =
        ok ? w + ((long long)ib * npc + 2 * t + kb) * 64 + r * 8 : w;
    rnb_cp_async16(st + (ib * 2 + kb) * 64 + r * 8, src, ok);
  }
}

// The K loop of one product over ns K-steps, one a stage of a ring of RS
// (>= 3).
// pipe_prologue starts the copies of the first RS-2 stages (it may run
// before the epilogue of the product before, whose closing barrier freed
// the ring). pipe_run, per stage t: waits for its copy, starts the copy of
// stage t+RS-2 into the buffer of stage t-2, issues t's wgmmas and waits
// only for those of t-1, so two stages' products are in flight; the
// barrier at the top of a stage thus also frees the buffer of t-2. It ends
// with a barrier: the ring and the A tiles are then free. One commit group
// per stage (empty ones too) keeps the wait count fixed.
template <int RS, int STG, class Copy>
__device__ __forceinline__ void pipe_prologue(rnb_bf16* ring, int ns,
                                              Copy copy) {
#pragma unroll
  for (int s = 0; s < RS - 2; ++s) {
    if (s < ns) copy(s, ring + s * STG);
    rnb_cp_async_commit();
  }
}

template <int RS, int STG, class Copy, class Mma>
__device__ __forceinline__ void pipe_run(rnb_bf16* ring, int ns, Copy copy,
                                         Mma mma) {
  for (int t = 0; t < ns; ++t) {
    rnb_cp_async_wait<RS - 3>();
    rnb_fence_proxy_async();
    __syncthreads();
    if (t + RS - 2 < ns) copy(t + RS - 2, ring + ((t + RS - 2) % RS) * STG);
    rnb_cp_async_commit();
    rnb_wgmma_fence();
    mma(t, ring + (t % RS) * STG);
    rnb_wgmma_commit();
    rnb_wgmma_wait<1>();
  }
  rnb_wgmma_wait<0>();
  __syncthreads();
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

// The product a bf16 sweep streams through the ring: layer l of the weight
// image, forward (N = `width` columns of W, K = its inputs) or reverse
// (N = `width` rows of W, K = its outputs). set() chooses it; the object,
// passed by value to pipe_prologue / pipe_run, copies K-step t into a stage.
struct WgProduct {
  const rnb_bf16* cw;  // the layer's tile in the weight image
  int npc, kpc, n8, rev, nk;
  __device__ __forceinline__ void set(const rnb_bf16* w, const RnbWgNet& net,
                                      int l, int r, int width) {
    cw = w + net.w_off[l];
    npc = rnb_pad16(net.out_dim[l]) >> 3;
    kpc = rnb_pad16(net.in_dim[l]) >> 3;
    n8 = width >> 3;
    rev = r;
    nk = rnb_pad16(r ? net.out_dim[l] : net.in_dim[l]) >> 4;
  }
  __device__ __forceinline__ void operator()(int t, rnb_bf16* st) const {
    if (rev) wg_copy_rev(st, cw, npc, kpc, n8, t);
    else wg_copy_fwd(st, cw, npc, n8, t);
  }
};

// Forward epilogue of a ReLU layer over a warpgroup's NJ groups of 8
// columns at base c0: zb = acc + b (b over the first `out` columns), its
// mask bit (zb > 0, bit 4j + 2h + v of the result), relu(zb) (zb itself
// for a linear layer, relu = false) rounded into the A tile X.
template <int NJ>
__device__ __forceinline__ uint32_t wg_relu_put(const float (&acc)[4 * NJ],
                                                const float* bl, int out,
                                                rnb_bf16* X, int c0,
                                                bool relu = true) {
  const int lt = threadIdx.x & 127;
  const int r0 = ((lt >> 5) << 4) + ((lt & 31) >> 2), cq = 2 * (lt & 3);
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 8 * j + cq;
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = 4 * j + 2 * h + u;
        const float zb = acc[idx] + (c + u < out ? bl[c + u] : 0.0f);
        bits |= (zb > 0.0f ? 1u : 0u) << idx;
        v[u] = relu ? fmaxf(zb, 0.0f) : zb;
      }
      wg_put2(X, r0 + 8 * h, c, v[0], v[1]);
    }
  return bits;
}

