// The fused albedo (rendering) network for Hopper (sm_90a), mode
// no_view_dir: albedo = sigmoid(MLP([PE(pts), PE(normals), feat])) with ReLU
// hidden layers, and its hand-derived VJP.
//
// Replaces rnb_tpu/ops/pallas_albedo.py: _fwd_kernel (:85) and _bwd_kernel
// (:101). Same algorithm:
//   forward   x0 = [PE(p), PE(n), feat]; z_l = x_l W_l + b_l;
//             x_{l+1} = relu(z_l); out = sigmoid(z_last)
//   backward  bar_z_last = c_out s(1-s); dW_l = x_lᵀ bar_z_l, db_l = Σ bar_z_l;
//             bar_x_l = bar_z_l W_lᵀ; bar_z_{l-1} = bar_x ⊙ [z > 0];
//             c_feat = bar_x0[:, 2E:]; c_normals by the reverse of PE(n).
//             The pts cotangent is zero.
//
// Two routes each, chosen by the op dtype (ops/albedo.py), never by
// failure: bf16 (the training step's) albedo_fwd_wg_kernel and
// albedo_bwd_wg_kernel on the tensor cores, designed below; f32 (the f32
// comparisons) albedo_fwd_kernel and albedo_bwd_kernel on the CUDA cores.
//
// What bounds the f32 route: arithmetic, ~0.15 M multiply-adds per point
// per chain at the shipped conf (310→256→256→3). The CUDA-core kernels
// compute one output column a thread; the f32 backward keeps the
// pre-activations it needs in a global scratch written and read by the same
// block, and its dW operands are reduced across points by the split-K
// kernels of common.cuh (deterministic, no atomics).
#include "common.cuh"

// [x, sin(f0 x), cos(f0 x), ...] by the double-angle recurrence, for one
// coordinate d of one point, into row e.
__device__ __forceinline__ void albedo_pe(float x, int d, int multires,
                                          float* e) {
  e[d] = x;
  float s = sinf(x), c = cosf(x);
  for (int k = 0; k < multires; ++k) {
    e[3 + 6 * k + d] = s;
    e[6 + 6 * k + d] = c;
    if (k + 1 < multires) {
      const float s2 = 2.0f * s * c;
      c = 1.0f - 2.0f * s * s;
      s = s2;
    }
  }
}

// x0 of the tile into X (f32)
__device__ __forceinline__ void albedo_input(
    const float* __restrict__ pts, const float* __restrict__ nrm,
    const float* __restrict__ feat, long long n, int F, int multires,
    long long n0, int LD, float* X) {
  constexpr int P = RNB_P;
  const int E = 3 * (1 + 2 * multires);
  for (int idx = threadIdx.x; idx < P * 3; idx += blockDim.x) {
    const int p = idx / 3, d = idx % 3;
    const long long row = n0 + p;
    const float xp = row < n ? pts[row * 3 + d] : 0.0f;
    const float xn = row < n ? nrm[row * 3 + d] : 0.0f;
    albedo_pe(xp, d, multires, X + p * LD);
    albedo_pe(xn, d, multires, X + p * LD + E);
  }
  for (int idx = threadIdx.x; idx < P * F; idx += blockDim.x) {
    const int p = idx / F, f = idx % F;
    const long long row = n0 + p;
    X[p * LD + 2 * E + f] = row < n ? feat[row * F + f] : 0.0f;
  }
  __syncthreads();
}

static __global__ void __launch_bounds__(RNB_NT)
albedo_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                  const float* __restrict__ feat, long long n, int F,
                  const float* __restrict__ w, const float* __restrict__ b,
                  RnbNet net, int multires, float* __restrict__ out) {
  constexpr int P = RNB_P;
  extern __shared__ __align__(16) float smem[];
  const int LD = net.ld;
  float* cur = smem;           // [P][LD]
  float* spare = cur + P * LD; // [P][LD]
  const long long n0 = (long long)blockIdx.x * P;
  const int L = net.n_layers;
  albedo_input(pts, nrm, feat, n, F, multires, n0, LD, cur);
  for (int l = 0; l < L; ++l) {
    const int in = net.in_dim[l], o = net.out_dim[l];
    const float* W = w + net.w_off[l];
    const float* bl = b + net.b_off[l];
    for (int c = threadIdx.x; c < o; c += blockDim.x) {
      float acc[P];
      rnb_dot_col<P>(cur, LD, in, W, o, c, acc);
      const float bc = bl[c];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float z = acc[p] + bc;
        if (l < L - 1) {
          spare[p * LD + c] = fmaxf(z, 0.0f);
        } else {
          const long long row = n0 + p;
          if (row < n) out[row * o + c] = rnb_sigmoid(z);
        }
      }
    }
    __syncthreads();
    float* t = cur; cur = spare; spare = t;
  }
}

static __global__ void __launch_bounds__(RNB_NT)
albedo_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                  const float* __restrict__ feat, long long n, int F,
                  const float* __restrict__ w, const float* __restrict__ wt,
                  const float* __restrict__ b, RnbNet net, int multires,
                  const float* __restrict__ cout,
                  float* __restrict__ rec, int rec_ld,
                  float* __restrict__ abuf, float* __restrict__ bbuf,
                  float* __restrict__ cnrm, float* __restrict__ cfeat) {
  constexpr int P = RNB_P;
  extern __shared__ __align__(16) float smem[];
  const int LD = net.ld;
  float* cur = smem;           // [P][LD]
  float* spare = cur + P * LD; // [P][LD]
  const long long n0 = (long long)blockIdx.x * P;
  const int L = net.n_layers;
  const int E = 3 * (1 + 2 * multires);
  albedo_input(pts, nrm, feat, n, F, multires, n0, LD, cur);

  // --- recompute, recording layer inputs (A rows) and pre-activations ---
  for (int l = 0; l < L; ++l) {
    const int in = net.in_dim[l], o = net.out_dim[l];
    float* A = abuf + net.a_off[l];
    for (int idx = threadIdx.x; idx < P * in; idx += blockDim.x) {
      const int p = idx / in, i = idx % in;
      const long long row = n0 + p;
      if (row < n) A[row * in + i] = cur[p * LD + i];
    }
    const float* W = w + net.w_off[l];
    const float* bl = b + net.b_off[l];
    for (int c = threadIdx.x; c < o; c += blockDim.x) {
      float acc[P];
      rnb_dot_col<P>(cur, LD, in, W, o, c, acc);
      const float bc = bl[c];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = n0 + p;
        const float z = acc[p] + bc;
        if (l < L - 1) {
          if (row < n) rec[((long long)l * n + row) * rec_ld + c] = z;
          spare[p * LD + c] = fmaxf(z, 0.0f);
        } else {
          // bar_z of the sigmoid head
          const float s = rnb_sigmoid(z);
          const float co = row < n ? cout[row * o + c] : 0.0f;
          spare[p * LD + c] = co * s * (1.0f - s);
        }
      }
    }
    __syncthreads();
    float* t = cur; cur = spare; spare = t;
  }

  // --- reverse sweep; `cur` holds bar_z of layer l (f32) ---
  for (int l = L - 1; l >= 0; --l) {
    const int in = net.in_dim[l], o = net.out_dim[l];
    float* B = bbuf + net.bb_off[l];
    for (int idx = threadIdx.x; idx < P * o; idx += blockDim.x) {
      const int p = idx / o, j = idx % o;
      const long long row = n0 + p;
      const float z = cur[p * LD + j];
      if (row < n) B[row * o + j] = z;
    }
    __syncthreads();
    const float* WT = wt + net.w_off[l];
    for (int c = threadIdx.x; c < in; c += blockDim.x) {
      float acc[P];
      rnb_dot_col<P>(cur, LD, o, WT, in, c, acc);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float v = acc[p];
        if (l > 0) {
          const long long row = n0 + p;
          const float zp =
              row < n ? rec[((long long)(l - 1) * n + row) * rec_ld + c] : 0.0f;
          v = zp > 0.0f ? v : 0.0f;
        }
        spare[p * LD + c] = v;
      }
    }
    __syncthreads();
    float* t = cur; cur = spare; spare = t;
  }

  // cur = bar_x0: feature and normal cotangents
  for (int idx = threadIdx.x; idx < P * F; idx += blockDim.x) {
    const int p = idx / F, f = idx % F;
    const long long row = n0 + p;
    if (row < n) cfeat[row * F + f] = cur[p * LD + 2 * E + f];
  }
  for (int idx = threadIdx.x; idx < P * 3; idx += blockDim.x) {
    const int p = idx / 3, d = idx % 3;
    const long long row = n0 + p;
    if (row >= n) continue;
    const float* bn = cur + p * LD + E;
    const float x = nrm[row * 3 + d];
    float cn = bn[d];
    float sk = sinf(x), ck = cosf(x), f = 1.0f;
    for (int k = 0; k < multires; ++k) {
      cn = cn + f * (ck * bn[3 + 6 * k + d] - sk * bn[6 + 6 * k + d]);
      if (k + 1 < multires) {
        const float s2 = 2.0f * sk * ck;
        ck = 1.0f - 2.0f * sk * sk;
        sk = s2;
      }
      f *= 2.0f;
    }
    cnrm[row * 3 + d] = cn;
  }
}

// The f32 route's forward (f32 operands).
extern "C" int rnb_albedo_fwd(const float* pts, const float* nrm,
                              const float* feat, long long n, int F,
                              const float* w, const float* b,
                              const int* in_dims, const int* out_dims,
                              int n_layers, int multires, float* out,
                              void* stream) {
  RnbNet net;
  if (rnb_make_net(&net, in_dims, out_dims, nullptr, n_layers, n, 1))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * 2 * RNB_P * net.ld;
  cudaError_t err = cudaFuncSetAttribute(
      albedo_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + RNB_P - 1) / RNB_P);
  albedo_fwd_kernel<<<grid, RNB_NT, smem, (cudaStream_t)stream>>>(
      pts, nrm, feat, n, F, w, b, net, multires, out);
  return (int)cudaGetLastError();
}

// The f32 route's backward (f32 operands).
extern "C" int rnb_albedo_bwd(const float* pts, const float* nrm,
                              const float* feat, long long n, int F,
                              const float* w, const float* wt, const float* b,
                              const int* in_dims, const int* out_dims,
                              int n_layers, int multires,
                              const float* cout, float* rec, int rec_ld,
                              float* abuf, float* bbuf, float* partial,
                              int splits, float* dw, float* db, float* cnrm,
                              float* cfeat, void* stream) {
  RnbNet net;
  if (rnb_make_net(&net, in_dims, out_dims, nullptr, n_layers, n, 1))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * 2 * RNB_P * net.ld;
  cudaError_t err = cudaFuncSetAttribute(
      albedo_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((n + RNB_P - 1) / RNB_P);
  albedo_bwd_kernel<<<grid, RNB_NT, smem, st>>>(
      pts, nrm, feat, n, F, w, wt, b, net, multires, cout, rec, rec_ld,
      abuf, bbuf, cnrm, cfeat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < n_layers; ++l) {
    err = rnb_reduce_layer(abuf + net.a_off[l], bbuf + net.bb_off[l], n, n,
                           in_dims[l], out_dims[l], 0, splits, partial,
                           dw + net.w_off[l], db + net.b_off[l], st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// ===========================================================================
// bf16 route: the forward and the backward on the tensor cores (wgmma,
// sm_90a)
// ===========================================================================
//
// albedo_fwd_wg_kernel replaces the forward TPU kernel (pallas_albedo.py
// _fwd_kernel :85) at bf16 operands; albedo_fwd_kernel above stays as the
// f32 route. What bounds it on the H100: 145,664 multiply-adds and 1,048 B
// of feature row read a point at the shipped conf, 0.019 ms of bf16 peak
// and 0.020 ms of HBM for 65,536 points. What the design does about it
// (albedo_fwd_wg_kernel below): the recompute half of albedo_bwd_wg_kernel
// on the same block, ring, phase walk and epilogues (wg_sweep.cuh): one
// block of 384 threads a pair of 64-point tiles, a producer warpgroup
// loading every weight stage by TMA into a ring of AF_RS slots in the order
// of the forward phase table (ops/albedo.py fwd_steps: 52 stages a pair),
// two consumer warpgroups each a whole tile at m64n256k16 taking turns at
// the ring; x0 built by albedo_wb_x0 (the features as float4 loads, eight
// in flight), the bias staged by cp.async, ReLU and rounding into the
// swizzled A tile with no branch an element, and the sigmoid head as one
// m64n8k16 written from the accumulators of the warpgroup that owns the
// tile, rows < n only; no mask bits, no operand rows. What held the
// cp.async forward it replaced (four warpgroups of N = 64 on one tile, a
// 4-stage ring, x0's features read a float at a time): the ring's block
// barriers and shared copies, 76% of its time (PERF.md §6). Each output is
// summed from the same bf16 operands in the same K order through the same
// epilogue as that forward's: the same bits.
//
// albedo_bwd_wg_kernel replaces the same TPU kernel (pallas_albedo.py
// _bwd_kernel :101) at bf16 operands; albedo_bwd_kernel above stays as the
// f32 route (wgmma has no f32 operands). What bounds it on the H100:
// arithmetic, at least 430,080 multiply-adds a point at the shipped conf
// (recompute 145,664; reverse 138,752, layer 0's only over the PE(n) and
// feat rows, as pts gets no cotangent; dW 145,664), 0.057 ms at the bf16
// peak for 65,536 points;
// the CUDA-core route reaches a few percent of that peak and spends its
// bandwidth on an f32 record of the pre-activations and f32 operand rows.
//
// What the design does about it (albedo_bwd_wg_kernel below: a
// producer-fed TMA ring shared by two 64-point tiles at N = 256, the
// operand rows by TMA store):
// every product runs on wgmma with the bf16 A tile in shared memory
// (K-major) and the weight image streamed in K-steps of 16, read MN-major
// for W and K-major for Wᵀ:
//   recompute  z_l = x_l W_l + b_l (N = 256; the head N = 3 -> 8), the
//              ReLU mask of each hidden
//              layer kept as one bit a fragment register in shared memory
//              (the reverse epilogue owns the same fragment), the A rows
//              x_l written as bf16 rows for dW;
//   reverse    bar_z2 Wᵀ2 (K 16), bar_z1 Wᵀ1 (K 256), then bar_z0 Wᵀ0 over
//              its columns 16..319 in two passes, whose epilogues write
//              c_feat from the accumulators and stages PE(n)'s cotangent
//              for c_normals; rnd(bar_z) goes back into the A tile and out
//              as the B rows; db from per-tile column sums of the unrounded
//              bar_z, summed over tiles in a fixed order;
//   dW         one grouped dW launch over the layers' bf16 rows
//              (dw_gemm.cu; ops/albedo.py through ops/wg.py dw_products).
// No pre-activation leaves the block; the only scratch is the bf16 operand
// rows (A 1.7 KB and B 1.1 KB a point), written and read once.

#include "wg_sweep.cuh"

#define ALB_KW 320     // widest A tile: x0 (2E + F = 310 -> 320)

// albedo_bwd_wg_kernel, the backward sweep on the tensor cores, designed
// for Hopper as nerf_bwd_wg_kernel is (nerf.cu; wg_sweep.cuh): one
// block of 384 threads a pair of 64-point tiles, a producer warpgroup
// whose one thread loads every weight stage by TMA into a ring of AB_RS
// slots in the order of the phase table (ops/albedo.py bwd_steps), two
// consumer warpgroups (232 registers) each a whole tile at m64n256k16,
// taking turns at the ring (RnbTurns) so one tile's epilogue runs under
// the other's products; the bias staged by cp.async, the epilogues without
// a branch an element, the column sums by the lane scatter, the operand
// rows by TMA stores. What held the cp.async sweep it replaced (four
// warpgroups of N = 64 on one tile): the same block barrier and shared
// copy at each of a tile's ~85 K-steps (PERF.md §6).
//
// Layer 0's reverse is 320 wide (x0 = [PE(p), PE(n), feat], 310 -> 320)
// and wgmma stops at N = 256; its first 27 columns (PE(p): pts gets no
// cotangent) are never needed. It runs as two passes over the same 16
// K-steps (the producer streams them twice): N = 48 over input cores
// 34..39 (columns 272..319, all c_feat), then N = 256 over cores 2..33
// (columns 16..271: PE(n)'s cotangent for c_normals, the rest c_feat),
// both into the registers of the one 128-accumulator set; after the second,
// PE(n)'s cotangent overlays the A tile.
// Each element is summed from the same bf16 operands in the same K order as
// the cp.async sweep's, the column sums in the same order: the same bits.
// Two wgmma groups in flight ran slower on one H100: 0.44 against 0.41 ms
// (PERF.md §6).
//
// ptxas (chip_smoke.py holds it to this note): albedo_bwd_wg_kernel<16, 0>
// 168 registers at launch (the consumers take 232 by setmaxnreg), 56 B
// stack frame, 20 B spill stores and loads (the batched feature loads);
// 231,696 B dynamic shared memory.

// x0 = [PE(p), PE(n), feat] of the tile in bf16 into the swizzled A tile X
// (wb_sidx; rows past n from 0), its pad columns up to kp0 zero, by the 128
// threads of one warpgroup (this one lt). The features (F a multiple of 4,
// rows 16-byte aligned) as float4 loads, eight a thread in flight at once:
// one at a time, each waits out its own trip to device memory, and the
// first products of the pair wait for them.
__device__ __forceinline__ void albedo_wb_x0(const float* __restrict__ pts,
                                             const float* __restrict__ nrm,
                                             const float* __restrict__ feat,
                                             long long n, int F, int multires,
                                             int E, int kp0, long long n0,
                                             rnb_bf16* X, int lt) {
  const int f4n = F >> 2, total = WG_M * f4n;
  for (int base = lt; base < total; base += 128 * 8) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + 128 * u;
      const int pp = idx / f4n, q = idx - pp * f4n;
      const long long row = n0 + pp;
      v[u] = idx < total && row < n
                 ? __ldg(reinterpret_cast<const float4*>(feat + row * F) + q)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + 128 * u;
      if (idx < total) {
        const int pp = idx / f4n, c = 2 * E + 4 * (idx - pp * f4n);
        wb_put2(X, pp, c, v[u].x, v[u].y);
        wb_put2(X, pp, c + 2, v[u].z, v[u].w);
      }
    }
  }
  for (int idx = lt; idx < WG_M * 6; idx += 128) {
    const int pp = idx / 6, q = (idx % 6) / 3, d = idx % 3;
    const long long row = n0 + pp;
    const float x = row < n ? (q ? nrm : pts)[row * 3 + d] : 0.0f;
    const int o = q * E;
    X[wb_sidx(pp, o + d)] = wg_bf(x);
    float s = sinf(x), c = cosf(x);
    for (int k = 0; k < multires; ++k) {
      X[wb_sidx(pp, o + 3 + 6 * k + d)] = wg_bf(s);
      X[wb_sidx(pp, o + 6 + 6 * k + d)] = wg_bf(c);
      if (k + 1 < multires) {
        const float s2 = 2.0f * s * c;
        c = 1.0f - 2.0f * s * s;
        s = s2;
      }
    }
  }
  const int fw = kp0 - 2 * E - F;
  for (int idx = lt; idx < WG_M * fw; idx += 128) {
    const int pp = idx / fw, c = 2 * E + F + idx % fw;
    X[wb_sidx(pp, c)] = wg_bf(0.0f);
  }
}

#define AB_RS 16        // the production ring depth (the deepest that fits)
#define AB_X (WG_M * ALB_KW * 2)                 // the A tile: 5 blocks of 64
#define AB_MB (2 * 128 * 16)                     // two hidden layers' masks
#define AB_TILE (AB_X + AB_MB + 4 * 256 * 4 + 256 * 4)   // + red + bias
#define AF_RS 18        // the forward's production ring depth (the deepest
                        // that fits: 231,728 B of shared memory)
#define AF_TILE (AB_X + 256 * 4)                 // the forward's: + bias

// The forward: out [n, d_out] (out0) = sigmoid of the head. RS: the ring's
// stages (AF_RS in production; the tune library's instances take 4 and 8
// too); SPLIT: a WgSplit (K_LOOPS_ONLY no wgmma and no epilogue,
// PRODUCTS_ONLY no epilogue: neither the tile nor the output written,
// NO_EPILOGUE the accumulators rounded into the tile and the head written
// raw).
//
// ptxas (chip_smoke.py holds it to this note): albedo_fwd_wg_kernel<18, 0>
// 168 registers at launch (the consumers take 232 by setmaxnreg), 32 B
// stack frame, no spill; 231,728 B dynamic shared memory.
template <int RS, int SPLIT = WB_FULL>
static __global__ void __launch_bounds__(WB_NT, 1)
albedo_fwd_wg_kernel(const __grid_constant__ WbParams p) {
  static_assert(RS >= 2 && wb_smem_bytes(RS, WB_STAGE, AF_TILE) <= 232448,
                "ring depth");
  constexpr bool k_mma = SPLIT != WB_K_LOOPS_ONLY;
  constexpr bool k_put = SPLIT == WB_FULL || SPLIT == WB_NO_EPILOGUE;
  constexpr bool k_epi = SPLIT == WB_FULL;
  extern __shared__ __align__(1024) unsigned char wb_smem[];
  RnbTurns<RS> turns = wb_begin<RS>(p, wb_smem, WB_STAGE, AF_TILE);
  if (threadIdx.x < 128) {   // the producer warpgroup
    wb_produce<RS>(p, turns.ring);
    return;
  }
  rnb_setmaxnreg_inc<232>();
  const int ci = turns.ci;
  if (ci >= turns.pair) return;
  const RnbWgNet& net = p.net;
  const long long n = p.n;
  const int lt = threadIdx.x & 127, bar_id = 1 + ci;
  const int r0 = ((lt >> 5) << 4) + ((lt & 31) >> 2), cq = 2 * (lt & 3);
  const long long n0 = (2 * (long long)blockIdx.x + ci) * WG_M;
  unsigned char* ta = wb_smem + ci * AF_TILE;
  rnb_bf16* X = reinterpret_cast<rnb_bf16*>(ta);   // A tile [64][320]
  float* sb = reinterpret_cast<float*>(ta + AB_X);  // the layer's bias
  const int L = net.n_layers;

  auto tail = [&] { wb_tail(lt); };
  auto product = [&](int nk, auto mma) {
    turns.template product<k_mma>(nk, mma, tail);
  };

  albedo_wb_x0(p.in0, p.in1, p.in2, n, p.F, p.multires, net.E,
               rnb_pad16(net.in_dim[0]), n0, X, lt);
  wb_written(bar_id);

  float acc[128];
  uint32_t bits[4];
  // --- the hidden layers: relu(x W + b) in bf16 back into the A tile ---
  for (int l = 0; l < L - 1; ++l) {
    if constexpr (k_epi) wb_stage_bias(sb, p.b + net.b_off[l], net.out_dim[l], lt);
    product(rnb_pad16(net.in_dim[l]) >> 4, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n256<0, 1>(acc, wb_desc_a(X, t),
                           rnb_desc(st, 32 * 128, 128), t > 0);
    });
    if constexpr (!k_put) continue;
    wb_fwd_put<32, true, k_epi>(acc, sb, X, bits);
    wb_written(bar_id);
  }

  // --- the sigmoid head (N = 8), from the accumulators ---
  float acc8[4];
  product(rnb_pad16(net.in_dim[L - 1]) >> 4, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n8<0, 1>(acc8, wb_desc_a(X, t), rnb_desc(st, 2 * 128, 128),
                       t > 0);
  });
  if constexpr (k_put) {
    const int o = net.out_dim[L - 1];
    const float* bl = p.b + net.b_off[L - 1];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long long row = n0 + r0 + 8 * h;
        const int c = cq + u;
        if (c < o && row < n)
          p.out0[row * o + c] =
              k_epi ? rnb_sigmoid(acc8[2 * h + u] + bl[c]) : acc8[2 * h + u];
      }
  }
}

// RS: the ring's stages (AB_RS in production; the tune library's instances
// take 4, 8 and 12 too); SPLIT: a WgSplit.
template <int RS, int SPLIT = WB_FULL>
static __global__ void __launch_bounds__(WB_NT, 1)
albedo_bwd_wg_kernel(const __grid_constant__ WbParams p) {
  static_assert(RS >= 2 && wb_smem_bytes(RS, WB_STAGE, AB_TILE) <= 232448,
                "ring depth");
  constexpr bool k_mma = SPLIT != WB_K_LOOPS_ONLY;
  constexpr bool k_epi = SPLIT == WB_FULL || SPLIT == WB_NO_ROWS;
  constexpr bool k_rows = SPLIT == WB_FULL || SPLIT == WB_NO_EPILOGUE;
  extern __shared__ __align__(1024) unsigned char wb_smem[];
  RnbTurns<RS> turns = wb_begin<RS>(p, wb_smem, WB_STAGE, AB_TILE);
  if (threadIdx.x < 128) {   // the producer warpgroup
    wb_produce<RS>(p, turns.ring);
    return;
  }
  rnb_setmaxnreg_inc<232>();
  const int ci = turns.ci;
  if (ci >= turns.pair) return;
  const RnbWgNet& net = p.net;
  const long long n = p.n;
  const int lt = threadIdx.x & 127, bar_id = 1 + ci;
  const int r0 = ((lt >> 5) << 4) + ((lt & 31) >> 2), cq = 2 * (lt & 3);
  const long long tile = 2 * (long long)blockIdx.x + ci, n0 = tile * WG_M;
  const bool live0 = n0 + r0 < n, live1 = n0 + r0 + 8 < n;
  unsigned char* ta = wb_smem + ci * AB_TILE;
  rnb_bf16* X = reinterpret_cast<rnb_bf16*>(ta);      // A tile [64][320]
  uint4* mb = reinterpret_cast<uint4*>(ta + AB_X);    // [2][128]
  float* red = reinterpret_cast<float*>(ta + AB_X + AB_MB);   // [4][256]
  float* sb = red + 4 * 256;                          // the layer's bias
  float* dbt = p.dbp + tile * p.db_len;
  const int L = net.n_layers, E = net.E, F = p.F, kp0 = rnb_pad16(net.in_dim[0]);

  auto stage_bias = [&](int l) {
    wb_stage_bias(sb, p.b + net.b_off[l], net.out_dim[l], lt);
  };
  auto tail = [&] { wb_tail(lt); };
  auto product = [&](int nk, auto mma) {
    turns.template product<k_mma>(nk, mma, tail);
  };
  auto rows_out = [&](const CUtensorMap* map, int kw) {
    wb_written(bar_id);
    if (k_rows && lt == 0) wb_rows_out(map, X, kw, n0);
  };
  auto db_out = [&](int l, int cols) {
    for (int c = lt; c < cols; c += 128)
      dbt[net.b_off[l] + c] = wg_colsum_get(red, c);
  };

  albedo_wb_x0(p.in0, p.in1, p.in2, n, F, p.multires, E, kp0, n0, X, lt);
  rows_out(&p.amap[0], kp0);

  float acc[128];
  uint32_t bits[4];
  // --- recompute the hidden layers: masks as bits, A rows out ---
  for (int l = 0; l < L - 1; ++l) {
    if constexpr (k_epi) stage_bias(l);
    product(rnb_pad16(net.in_dim[l]) >> 4, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n256<0, 1>(acc, wb_desc_a(X, t),
                           rnb_desc(st, 32 * 128, 128), t > 0);
    });
    if constexpr (!k_mma) continue;
    wb_fwd_put<32, true, k_epi>(acc, sb, X, bits);
    if (k_epi) mb[l * 128 + lt] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
    rows_out(&p.amap[l + 1], rnb_pad16(net.in_dim[l + 1]));
  }

  // --- the sigmoid head (N = 8): bar_z = c_out s (1 - s) ---
  float acc8[4];
  product(rnb_pad16(net.in_dim[L - 1]) >> 4, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n8<0, 1>(acc8, wb_desc_a(X, t),
                       rnb_desc(st, 2 * 128, 128), t > 0);
  });
  if constexpr (k_mma) {
    const int out = net.out_dim[L - 1];
    const float* bl = p.b + net.b_off[L - 1];
    for (int idx = lt; idx < WG_M * 8; idx += 128)
      X[wb_sidx(idx >> 3, 8 + (idx & 7))] = wg_bf(0.0f);
    float cs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pp = r0 + 8 * h;
      const long long row = n0 + pp;
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = cq + u;
        float bz = 0.0f;
        if (!k_epi) {
          bz = acc8[2 * h + u];
        } else if (cc < out && row < n) {
          const float s = rnb_sigmoid(acc8[2 * h + u] + bl[cc]);
          bz = p.cot0[row * out + cc] * s * (1.0f - s);
        }
        cs[u] += bz;
        v[u] = bz;
      }
      wb_put2(X, pp, cq, v[0], v[1]);
    }
    if (k_epi) wg_colsum_put<1>(cs, red, 0);
    rows_out(&p.bmap[L - 1], 16);
    if (k_epi) db_out(L - 1, out);
  }

  // --- reverse through the hidden layers: bar_z_{l-1} = bar_z_l Wᵀ ⊙ mask ---
  for (int l = L - 1; l >= 1; --l) {
    product(rnb_pad16(net.out_dim[l]) >> 4, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n256<0, 0>(acc, wb_desc_a(X, t),
                           rnb_desc(st, 128, 256), t > 0);
    });
    if constexpr (!k_mma) continue;
    wb_rev_put<32, true, k_epi>(
        acc, reinterpret_cast<const uint32_t*>(&mb[(l - 1) * 128 + lt]), X,
        red, live0, live1);
    rows_out(&p.bmap[l - 1], rnb_pad16(net.out_dim[l - 1]));
    if (k_epi) db_out(l - 1, net.out_dim[l - 1]);
  }

  // --- bar_x0 = bar_z0 Wᵀ0 in two passes: c_feat, c_normals ---
  // column c of bar_x0 (value v, row pp): PE(n)'s cotangent into bn, or
  // c_feat (a pair of columns 2f, 2f + 1 as one 8-byte store where both
  // are features)
  float* bn = reinterpret_cast<float*>(X);   // [64][E] after the products
  auto feat_out = [&](int c, int pp, float v0, float v1) {
    const long long row = n0 + pp;
    const int f = c - 2 * E;
    if (row >= n) return;
    if (f >= 0 && f + 1 < F && !(F & 1)) {
      *reinterpret_cast<float2*>(p.out1 + row * F + f) = make_float2(v0, v1);
    } else {
      if (f >= 0 && f < F) p.out1[row * F + f] = v0;
      if (f + 1 >= 0 && f + 1 < F) p.out1[row * F + f + 1] = v1;
    }
  };
  float (&a48)[24] = *reinterpret_cast<float(*)[24]>(acc);
  product(rnb_pad16(net.out_dim[0]) >> 4, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n48<0, 0>(a48, wb_desc_a(X, t),
                        rnb_desc(st, 128, 256), t > 0);
  });
  if constexpr (k_mma) {
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        feat_out(272 + 8 * j + cq, r0 + 8 * h, a48[4 * j + 2 * h],
                 a48[4 * j + 2 * h + 1]);
  }
  product(rnb_pad16(net.out_dim[0]) >> 4, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n256<0, 0>(acc, wb_desc_a(X, t),
                         rnb_desc(st, 128, 256), t > 0);
  });
  if constexpr (k_mma) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pp = r0 + 8 * h, c = 16 + 8 * j + cq;
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (c + u >= E && c + u < 2 * E) bn[pp * E + c + u - E] = acc[4 * j + 2 * h + u];
        if (c + 1 >= 2 * E)
          feat_out(c, pp, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    rnb_wg_sync(bar_id);
    for (int idx = lt; idx < WG_M * 3; idx += 128) {
      const int pp = idx / 3, d = idx % 3;
      const long long row = n0 + pp;
      if (row >= n) continue;
      const float* be = bn + pp * E;
      const float x = p.in1[row * 3 + d];
      float cn = be[d];
      float sk = sinf(x), ck = cosf(x), f = 1.0f;
      for (int k = 0; k < p.multires; ++k) {
        cn = cn + f * (ck * be[3 + 6 * k + d] - sk * be[6 + 6 * k + d]);
        if (k + 1 < p.multires) {
          const float s2 = 2.0f * sk * ck;
          ck = 1.0f - 2.0f * sk * sk;
          sk = s2;
        }
        f *= 2.0f;
      }
      p.out0[row * 3 + d] = cn;
    }
  }
  if (lt == 0) rnb_bulk_wait<0>();
}

// RnbWgNet of the albedo net (b and db offsets in layer order); a_off and
// bb_off may be null (the forward writes no operand rows). Checks the widths
// the tensor-core kernels take; returns the length of b, or -1.
static int albedo_wg_net(RnbWgNet* net, const int* in_dims,
                         const int* out_dims, const long long* w_off,
                         const long long* a_off, const long long* bb_off,
                         int n_layers, int multires, int F) {
  if (n_layers < 2 || n_layers > RNB_MAXL) return -1;
  net->n_layers = n_layers;
  net->E = 3 * (1 + 2 * multires);
  int db_len = 0;
  for (int l = 0; l < n_layers; ++l) {
    net->in_dim[l] = in_dims[l];
    net->out_dim[l] = out_dims[l];
    net->skip[l] = 0;
    net->hd[l] = in_dims[l];
    net->w_off[l] = w_off[l];
    net->a_off[l] = a_off ? a_off[l] : 0;
    net->bb_off[l] = bb_off ? bb_off[l] : 0;
    net->b_off[l] = db_len;
    db_len += out_dims[l];
    const bool in_ok = l == 0 ? in_dims[0] == 2 * net->E + F && in_dims[0] <= ALB_KW
                              : in_dims[l] == out_dims[l - 1];
    if (!in_ok || out_dims[l] > (l + 1 < n_layers ? 256 : 8) || w_off[l] % 8)
      return -1;
  }
  return db_len;
}

#define RNB_ALB_FWD_PARAMS                                                   \
  const float *pts, const float *nrm, const float *feat, long long n, int F, \
      const void *w, const float *b, const int *in_dims,                     \
      const int *out_dims, const long long *w_off, int n_layers,             \
      int multires, float *out, void *stream

// The forward's arguments: the net, the buffers and the phase table of its
// ring, in the products' order (ops/albedo.py fwd_steps): the hidden layers
// forward (box {64, 32, 2}), the head forward ({64, 2, 2}: N = 8). 0 on
// success.
static int albedo_fwd_params(WbParams* p, RNB_ALB_FWD_PARAMS) {
  // the feature rows as float4
  if (albedo_wg_net(&p->net, in_dims, out_dims, w_off, nullptr, nullptr,
                    n_layers, multires, F) < 0 ||
      F % 4 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(feat) % 16)
    return (int)cudaErrorInvalidValue;
  wb_init(p, n, b, WB_STAGE);
  p->in0 = pts;
  p->in1 = nrm;
  p->in2 = feat;
  p->out0 = out;
  p->F = F;
  p->multires = multires;
  int rc = 0;
  for (int l = 0; l < n_layers - 1 && !rc; ++l) rc = wb_phase(p, w, l, 0, 32, 0);
  if (!rc) rc = wb_phase(p, w, n_layers - 1, 0, 2, 0);
  return rc;
}

// The forward at ring depth RS.
template <int RS, int SPLIT = WB_FULL>
static int albedo_fwd_launch(const WbParams& p, cudaStream_t st) {
  constexpr int smem = wb_smem_bytes(RS, WB_STAGE, AF_TILE);
  cudaError_t err = cudaFuncSetAttribute(
      albedo_fwd_wg_kernel<RS, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.n + WG_M - 1) / WG_M;
  albedo_fwd_wg_kernel<RS, SPLIT>
      <<<(unsigned)((tiles + 1) / 2), WB_NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

#define RNB_ALB_FWD_SETUP                                                    \
  WbParams prm;                                                              \
  const int rc = albedo_fwd_params(&prm, pts, nrm, feat, n, F, w, b,         \
                                   in_dims, out_dims, w_off, n_layers,       \
                                   multires, out, stream);                   \
  if (rc) return rc;                                                         \
  cudaStream_t st = (cudaStream_t)stream

// The bf16 forward: out [n, d_out] = sigmoid of the head. w is the bf16
// weight image (ops/wg.py pack_weights) at w_off; feat's rows 16-byte
// aligned, F a multiple of 4.
extern "C" int rnb_albedo_fwd_wg(RNB_ALB_FWD_PARAMS) {
  RNB_ALB_FWD_SETUP;
  return albedo_fwd_launch<AF_RS>(prm, st);
}

// The backward sweep's arguments: the net, the buffers, the phase table of
// its ring and the tensor maps. The phases, in the products' order
// (ops/albedo.py bwd_steps): the hidden layers forward (box {64, 32, 2}),
// the head forward ({64, 2, 2}: N = 8); the head and the hidden layers but
// layer 0 reverse ({64, 2, 32}), layer 0's reverse as two passes, input
// cores 34..39 ({64, 2, 6}) then 2..33 ({64, 2, 32}). 0 on success.
static int albedo_bwd_params(WbParams* p, const float* pts,
                             const float* nrm, const float* feat, long long n,
                             int F, const void* w, const float* b,
                             const int* in_dims, const int* out_dims,
                             const long long* w_off, const long long* a_off,
                             const long long* bb_off, int n_layers,
                             int multires, const float* cout, void* abuf,
                             void* bbuf, float* dbp, float* cnrm,
                             float* cfeat) {
  const int db_len = albedo_wg_net(&p->net, in_dims, out_dims, w_off, a_off,
                                   bb_off, n_layers, multires, F);
  // two hidden layers' masks at most, PE(n) past layer 0's first pass-A
  // column (16), the feature rows as float4
  if (db_len < 0 || n_layers > 3 || p->net.E < 16 || F % 4 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(feat) % 16)
    return (int)cudaErrorInvalidValue;
  wb_init(p, n, b, WB_STAGE);
  p->in0 = pts;
  p->in1 = nrm;
  p->in2 = feat;
  p->cot0 = cout;
  p->dbp = dbp;
  p->out0 = cnrm;
  p->out1 = cfeat;
  p->db_len = db_len;
  p->C = 3;
  p->F = F;
  p->multires = multires;
  const int L = n_layers;
  int rc = 0;
  for (int l = 0; l < L - 1 && !rc; ++l) rc = wb_phase(p, w, l, 0, 32, 0);
  if (!rc) rc = wb_phase(p, w, L - 1, 0, 2, 0);
  for (int l = L - 1; l >= 1 && !rc; --l) rc = wb_phase(p, w, l, 1, 32, 0);
  if (!rc) rc = wb_phase(p, w, 0, 1, 6, 34);
  if (!rc) rc = wb_phase(p, w, 0, 1, 32, 2);
  if (!rc) rc = wb_rows(p, abuf, bbuf);
  return rc;
}

// The sweep at ring depth RS, then the fixed-order sum of the per-tile db
// partials (dbp) into db.
template <int RS, int SPLIT = WB_FULL>
static int albedo_bwd_launch(const WbParams& p, float* db,
                             cudaStream_t st) {
  constexpr int smem = wb_smem_bytes(RS, WB_STAGE, AB_TILE);
  cudaError_t err = cudaFuncSetAttribute(
      albedo_bwd_wg_kernel<RS, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.n + WG_M - 1) / WG_M;
  albedo_bwd_wg_kernel<RS, SPLIT>
      <<<(unsigned)((tiles + 1) / 2), WB_NT, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rnb_sum_splits_kernel<<<(unsigned)((p.db_len + 255) / 256), 256, 0, st>>>(
      p.dbp, (int)tiles, p.db_len, db);
  return (int)cudaGetLastError();
}

#define RNB_ALB_BWD_PARAMS                                                   \
  const float *pts, const float *nrm, const float *feat, long long n, int F, \
      const void *w, const float *b, const int *in_dims,                     \
      const int *out_dims, const long long *w_off, const long long *a_off,   \
      const long long *bb_off, int n_layers, int multires,                   \
      const float *cout, void *abuf, void *bbuf, float *dbp, float *db,      \
      float *cnrm, float *cfeat, void *stream
#define RNB_ALB_BWD_SETUP                                                    \
  WbParams prm;                                                              \
  const int rc = albedo_bwd_params(&prm, pts, nrm, feat, n, F, w, b,         \
                                   in_dims, out_dims, w_off, a_off, bb_off,  \
                                   n_layers, multires, cout, abuf, bbuf,     \
                                   dbp, cnrm, cfeat);                        \
  if (rc) return rc;                                                         \
  cudaStream_t st = (cudaStream_t)stream

// The bf16 backward sweep: fills the bf16 dW scratch (A rows at a_off, B
// rows at bb_off, n rows of pad16(width) each), writes db, c_normals and
// c_feat; the wrapper then runs rnb_dw_products over all layers. w is the
// bf16 weight image (ops/wg.py pack_weights) at w_off; dbp holds
// ceil(n/64)·Σ out floats.
extern "C" int rnb_albedo_bwd_wg(RNB_ALB_BWD_PARAMS) {
  RNB_ALB_BWD_SETUP;
  return albedo_bwd_launch<AB_RS>(prm, db, st);
}

// The dynamic shared memory of the production forward (bwd 0) or backward
// sweep (bwd 1), as they launch.
extern "C" int rnb_albedo_wg_smem(int bwd) {
  return bwd ? wb_smem_bytes(AB_RS, WB_STAGE, AB_TILE)
             : wb_smem_bytes(AF_RS, WB_STAGE, AF_TILE);
}

// The tune library's instances (ops/_build.py library("tune"), nvcc
// -DRNB_TUNE; tools/tune_kernel.py, tools/ablate_kernel.py --wg_bwd and
// --wg_fwd): the production sweep at ring depths 4, 8, 12 and 16 (AB_RS,
// the deepest that fits: 231,696 B of shared memory) and its timing split;
// the production forward at ring depths 4, 8 and 18 (AF_RS) and its timing
// split.
#ifdef RNB_TUNE
extern "C" int rnb_albedo_bwd_wg_tune(int rs, RNB_ALB_BWD_PARAMS) {
  RNB_ALB_BWD_SETUP;
  switch (rs) {
    case 4: return albedo_bwd_launch<4>(prm, db, st);
    case 8: return albedo_bwd_launch<8>(prm, db, st);
    case 12: return albedo_bwd_launch<12>(prm, db, st);
    case AB_RS: return albedo_bwd_launch<AB_RS>(prm, db, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The production sweep's timing split: split a WgSplit; only WB_FULL
// computes the function.
extern "C" int rnb_albedo_bwd_wg_split(int split, RNB_ALB_BWD_PARAMS) {
  RNB_ALB_BWD_SETUP;
  switch (split) {
    case WB_FULL: return albedo_bwd_launch<AB_RS, WB_FULL>(prm, db, st);
    case WB_K_LOOPS_ONLY:
      return albedo_bwd_launch<AB_RS, WB_K_LOOPS_ONLY>(prm, db, st);
    case WB_PRODUCTS_ONLY:
      return albedo_bwd_launch<AB_RS, WB_PRODUCTS_ONLY>(prm, db, st);
    case WB_NO_ROWS: return albedo_bwd_launch<AB_RS, WB_NO_ROWS>(prm, db, st);
    case WB_NO_EPILOGUE:
      return albedo_bwd_launch<AB_RS, WB_NO_EPILOGUE>(prm, db, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
extern "C" int rnb_albedo_fwd_wg_tune(int rs, RNB_ALB_FWD_PARAMS) {
  RNB_ALB_FWD_SETUP;
  switch (rs) {
    case 4: return albedo_fwd_launch<4>(prm, st);
    case 8: return albedo_fwd_launch<8>(prm, st);
    case AF_RS: return albedo_fwd_launch<AF_RS>(prm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The production forward's timing split: split one of WB_FULL,
// WB_K_LOOPS_ONLY, WB_PRODUCTS_ONLY, WB_NO_EPILOGUE; only WB_FULL computes
// the function.
extern "C" int rnb_albedo_fwd_wg_split(int split, RNB_ALB_FWD_PARAMS) {
  RNB_ALB_FWD_SETUP;
  switch (split) {
    case WB_FULL: return albedo_fwd_launch<AF_RS, WB_FULL>(prm, st);
    case WB_K_LOOPS_ONLY:
      return albedo_fwd_launch<AF_RS, WB_K_LOOPS_ONLY>(prm, st);
    case WB_PRODUCTS_ONLY:
      return albedo_fwd_launch<AF_RS, WB_PRODUCTS_ONLY>(prm, st);
    case WB_NO_EPILOGUE:
      return albedo_fwd_launch<AF_RS, WB_NO_EPILOGUE>(prm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // RNB_TUNE
