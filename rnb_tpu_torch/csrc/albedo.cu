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
// and 0.020 ms of HBM for 65,536 points. What the design does about it: the
// recompute half of albedo_bwd_wg_kernel below (x0 and every h in bf16 in
// shared memory, the two hidden products as 4 warpgroups x 64 columns from
// the streamed weight image, bias and ReLU in f32 in the epilogue), plus the
// sigmoid head as one N = 8 product by warpgroup 0, written from its
// accumulators; no mask bits, no operand rows. Two blocks an SM, so one
// block's x0 loads overlap another's products.
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
// What the design does about it: a block of four warpgroups owns a tile of
// 64 points; every product runs on wgmma with the bf16 A tile in shared
// memory (K-major) and the weight image streamed in K-steps of 16 through
// the cp.async ring of wg_pipe.cuh, read MN-major for W and K-major for Wᵀ:
//   recompute  z_l = x_l W_l + b_l (N = 256 as 4 x 64 columns; the head
//              N = 3 -> 8 by warpgroup 0), the ReLU mask of each hidden
//              layer kept as one bit a fragment register in shared memory
//              (the reverse epilogue owns the same fragment), the A rows
//              x_l written as bf16 rows for dW;
//   reverse    bar_z2 Wᵀ2 (K 16), bar_z1 Wᵀ1 (K 256), then bar_z0 Wᵀ0 at
//              N = 310 -> 320 as 4 x 80 columns, whose epilogue writes
//              c_feat from the accumulators and stages PE(n)'s cotangent
//              for c_normals; rnd(bar_z) goes back into the A tile and out
//              as the B rows; db from per-tile column sums of the unrounded
//              bar_z, summed over tiles in a fixed order;
//   dW         one grouped dW launch over the layers' bf16 rows
//              (dw_gemm.cu; ops/albedo.py through ops/wg.py dw_products).
// No pre-activation leaves the block; the only scratch is the bf16 operand
// rows (A 1.7 KB and B 1.1 KB a point), written and read once.

#include "wg_pipe.cuh"

#define ALB_NT 512     // four warpgroups of 64 columns
#define ALB_KW 320     // widest A tile: x0 (2E + F = 310 -> 320)
#define ALB_STG 5120   // ring stage: the 320-wide reverse product, 2 x 40 cores
#define ALB_FSTG 4096  // forward ring stage: N = 256, 2 x 32 cores

// x0 = [PE(p), PE(n), feat] of the tile in bf16 into the A tile X (rows past
// n from 0), its pad columns up to kp0 zero; ALB_NT threads (a constant
// stride, so the feature loads are unrolled and in flight together).
__device__ __forceinline__ void albedo_wg_x0(const float* __restrict__ pts,
                                             const float* __restrict__ nrm,
                                             const float* __restrict__ feat,
                                             long long n, int F, int multires,
                                             int E, int kp0, long long n0,
                                             rnb_bf16* X) {
  for (int idx = threadIdx.x; idx < WG_M * 6; idx += ALB_NT) {
    const int p = idx / 6, q = (idx % 6) / 3, d = idx % 3;
    const long long row = n0 + p;
    const float x = row < n ? (q ? nrm : pts)[row * 3 + d] : 0.0f;
    const int o = q * E;
    X[wg_tidx(p, o + d)] = wg_bf(x);
    float s = sinf(x), c = cosf(x);
    for (int k = 0; k < multires; ++k) {
      X[wg_tidx(p, o + 3 + 6 * k + d)] = wg_bf(s);
      X[wg_tidx(p, o + 6 + 6 * k + d)] = wg_bf(c);
      if (k + 1 < multires) {
        const float s2 = 2.0f * s * c;
        c = 1.0f - 2.0f * s * s;
        s = s2;
      }
    }
  }
  const int fw = kp0 - 2 * E;
  for (int idx = threadIdx.x; idx < WG_M * fw; idx += ALB_NT) {
    const int p = idx / fw, f = idx - p * fw;
    const long long row = n0 + p;
    X[wg_tidx(p, 2 * E + f)] =
        wg_bf(row < n && f < F ? feat[row * F + f] : 0.0f);
  }
  __syncthreads();
}

// Two blocks an SM (64 registers, no spill): one block an SM ran slower in
// a trial build on the H100.
static __global__ void __launch_bounds__(ALB_NT, 2)
albedo_fwd_wg_kernel(const float* __restrict__ pts,
                     const float* __restrict__ nrm,
                     const float* __restrict__ feat, long long n, int F,
                     const rnb_bf16* __restrict__ w, const float* __restrict__ b,
                     RnbWgNet net, int multires, float* __restrict__ out) {
  constexpr int RS = WG_RS;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  rnb_bf16* X = reinterpret_cast<rnb_bf16*>(wg_smem);  // A tile [64][320]
  rnb_bf16* ring = X + WG_M * ALB_KW;
  WG_FRAG_ROWS;
  const long long n0 = (long long)blockIdx.x * WG_M;
  const int L = net.n_layers;
  albedo_wg_x0(pts, nrm, feat, n, F, multires, net.E,
               rnb_pad16(net.in_dim[0]), n0, X);

  WgProduct prod;
  float acc[32];
  prod.set(w, net, 0, 0, 256);
  pipe_prologue<RS, ALB_FSTG>(ring, prod.nk, prod);
  // --- the hidden layers: relu(x W + b) in bf16 back into the A tile ---
  for (int l = 0; l < L - 1; ++l) {
    pipe_run<RS, ALB_FSTG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n64<0, 1>(acc, rnb_desc(X + t * 1024, 1024, 128),
                          rnb_desc(st + wg * 8 * 64, 32 * 128, 128), t > 0);
    });
    if (l + 1 < L - 1) prod.set(w, net, l + 1, 0, 256);
    else prod.set(w, net, L - 1, 0, 16);
    pipe_prologue<RS, ALB_FSTG>(ring, prod.nk, prod);
    wg_relu_put<8>(acc, b + net.b_off[l], net.out_dim[l], X, wg * 64);
  }
  // --- the sigmoid head (N = 8, warpgroup 0), from its accumulators ---
  float acc8[4];
  pipe_run<RS, ALB_FSTG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
    if (wg == 0)
      rnb_wgmma_n8<0, 1>(acc8, rnb_desc(X + t * 1024, 1024, 128),
                         rnb_desc(st, 2 * 128, 128), t > 0);
  });
  if (wg == 0) {
    const int o = net.out_dim[L - 1];
    const float* bl = b + net.b_off[L - 1];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long long row = n0 + r0 + 8 * h;
        const int c = cq + u;
        if (c < o && row < n) out[row * o + c] = rnb_sigmoid(acc8[2 * h + u] + bl[c]);
      }
  }
}

static __global__ void __launch_bounds__(ALB_NT, 1)
albedo_bwd_wg_kernel(const float* __restrict__ pts,
                     const float* __restrict__ nrm,
                     const float* __restrict__ feat, long long n, int F,
                     const rnb_bf16* __restrict__ w, const float* __restrict__ b,
                     RnbWgNet net, int multires,
                     const float* __restrict__ cout,
                     rnb_bf16* __restrict__ abuf, rnb_bf16* __restrict__ bbuf,
                     float* __restrict__ dbp, int db_len,
                     float* __restrict__ cnrm, float* __restrict__ cfeat) {
  constexpr int RS = WG_RS;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  rnb_bf16* X = reinterpret_cast<rnb_bf16*>(wg_smem);  // A tile [64][320]
  rnb_bf16* ring = X + WG_M * ALB_KW;
  float* red = reinterpret_cast<float*>(ring + RS * ALB_STG);      // [4][256]
  uint32_t* mbits = reinterpret_cast<uint32_t*>(red + 4 * 256);  // [L-1][512]
  WG_FRAG_ROWS;
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x, n0 = tile * WG_M;
  const int L = net.n_layers, E = net.E, kp0 = rnb_pad16(net.in_dim[0]);
  float* dbt = dbp + tile * db_len;

  albedo_wg_x0(pts, nrm, feat, n, F, multires, E, kp0, n0, X);
  wg_tile_out(X, kp0, n0, n, abuf + net.a_off[0]);

  WgProduct prod;
  float acc[32];
  prod.set(w, net, 0, 0, 256);
  pipe_prologue<RS, ALB_STG>(ring, prod.nk, prod);

  // --- recompute the hidden layers: masks as bits, A rows out ---
  for (int l = 0; l < L - 1; ++l) {
    pipe_run<RS, ALB_STG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n64<0, 1>(acc, rnb_desc(X + t * 1024, 1024, 128),
                          rnb_desc(st + wg * 8 * 64, 32 * 128, 128), t > 0);
    });
    if (l + 1 < L - 1) prod.set(w, net, l + 1, 0, 256);
    else prod.set(w, net, L - 1, 0, 16);
    pipe_prologue<RS, ALB_STG>(ring, prod.nk, prod);
    mbits[l * ALB_NT + tid] =
        wg_relu_put<8>(acc, b + net.b_off[l], net.out_dim[l], X, wg * 64);
    __syncthreads();
    wg_tile_out(X, rnb_pad16(net.in_dim[l + 1]), n0, n,
                abuf + net.a_off[l + 1]);
  }

  // --- the sigmoid head (N = 8, warpgroup 0): bar_z = c_out s (1 - s) ---
  float acc8[4];
  pipe_run<RS, ALB_STG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
    if (wg == 0)
      rnb_wgmma_n8<0, 1>(acc8, rnb_desc(X + t * 1024, 1024, 128),
                         rnb_desc(st, 2 * 128, 128), t > 0);
  });
  prod.set(w, net, L - 1, 1, 256);
  pipe_prologue<RS, ALB_STG>(ring, prod.nk, prod);
  {
    const int out = net.out_dim[L - 1];
    const float* bl = b + net.b_off[L - 1];
    for (int idx = tid; idx < WG_M * 8; idx += ALB_NT)
      X[wg_tidx(idx >> 3, 8 + (idx & 7))] = wg_bf(0.0f);
    if (wg == 0) {
      float cs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = r0 + 8 * h;
        const long long row = n0 + p;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int cc = cq + u;
          float bz = 0.0f;
          if (cc < out && row < n) {
            const float s = rnb_sigmoid(acc8[2 * h + u] + bl[cc]);
            bz = cout[row * out + cc] * s * (1.0f - s);
          }
          cs[u] += bz;
          v[u] = bz;
        }
        wg_put2(X, p, cq, v[0], v[1]);
      }
      wg_colsum_put<1>(cs, red, 0);
    }
    __syncthreads();
    if (tid < out) dbt[net.b_off[L - 1] + tid] = wg_colsum_get(red, tid);
    wg_tile_out(X, 16, n0, n, bbuf + net.bb_off[L - 1]);
  }

  // --- reverse through the hidden layers: bar_z_{l-1} = bar_z_l Wᵀ ⊙ mask ---
  for (int l = L - 1; l >= 1; --l) {
    pipe_run<RS, ALB_STG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n64<0, 0>(acc, rnb_desc(X + t * 1024, 1024, 128),
                          rnb_desc(st + wg * 8 * 128, 128, 256), t > 0);
    });
    prod.set(w, net, l - 1, 1, l > 1 ? 256 : ALB_KW);
    pipe_prologue<RS, ALB_STG>(ring, prod.nk, prod);
    const int out = net.out_dim[l - 1];
    wg_mask_put<8>(acc, mbits[(l - 1) * ALB_NT + tid], X, red, wg * 64, n0, n);
    __syncthreads();
    if (tid < out) dbt[net.b_off[l - 1] + tid] = wg_colsum_get(red, tid);
    wg_tile_out(X, rnb_pad16(out), n0, n, bbuf + net.bb_off[l - 1]);
  }

  // --- bar_x0 = bar_z0 Wᵀ0 (N = 320 as 4 x 80): c_feat, c_normals ---
  float acc80[40];
  pipe_run<RS, ALB_STG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n80<0, 0>(acc80, rnb_desc(X + t * 1024, 1024, 128),
                        rnb_desc(st + wg * 10 * 128, 128, 256), t > 0);
  });
  float* bn = reinterpret_cast<float*>(X);  // [64][E]: bar of PE(n)
#pragma unroll
  for (int j = 0; j < 10; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = r0 + 8 * h, cc = wg * 80 + 8 * j + cq + u;
        const long long row = n0 + p;
        const float v = acc80[4 * j + 2 * h + u];
        if (cc >= E && cc < 2 * E) bn[p * E + cc - E] = v;
        else if (cc >= 2 * E && cc < 2 * E + F && row < n)
          cfeat[row * F + cc - 2 * E] = v;
      }
  __syncthreads();
  for (int idx = tid; idx < WG_M * 3; idx += ALB_NT) {
    const int p = idx / 3, d = idx % 3;
    const long long row = n0 + p;
    if (row >= n) continue;
    const float* be = bn + p * E;
    const float x = nrm[row * 3 + d];
    float cn = be[d];
    float sk = sinf(x), ck = cosf(x), f = 1.0f;
    for (int k = 0; k < multires; ++k) {
      cn = cn + f * (ck * be[3 + 6 * k + d] - sk * be[6 + 6 * k + d]);
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

// The bf16 forward: out [n, d_out] = sigmoid of the head. w is the bf16
// weight image (ops/wg.py pack_weights) at w_off.
extern "C" int rnb_albedo_fwd_wg(const float* pts, const float* nrm,
                                 const float* feat, long long n, int F,
                                 const void* w, const float* b,
                                 const int* in_dims, const int* out_dims,
                                 const long long* w_off, int n_layers,
                                 int multires, float* out, void* stream) {
  RnbWgNet net;
  if (albedo_wg_net(&net, in_dims, out_dims, w_off, nullptr, nullptr,
                    n_layers, multires, F) < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(rnb_bf16) * (WG_M * ALB_KW + WG_RS * ALB_FSTG));
  cudaError_t err = cudaFuncSetAttribute(
      albedo_fwd_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + WG_M - 1) / WG_M;
  albedo_fwd_wg_kernel<<<(unsigned)tiles, ALB_NT, smem, (cudaStream_t)stream>>>(
      pts, nrm, feat, n, F, static_cast<const rnb_bf16*>(w), b, net, multires,
      out);
  return (int)cudaGetLastError();
}

// The bf16 backward sweep: fills the bf16 dW scratch (A rows at a_off, B
// rows at bb_off, n rows of pad16(width) each), writes db, c_normals and
// c_feat; the wrapper then runs rnb_dw_products over all layers. w is the bf16 weight
// image (ops/wg.py pack_weights) at w_off; dbp holds ceil(n/64)·Σ out
// floats.
extern "C" int rnb_albedo_bwd_wg(const float* pts, const float* nrm,
                                 const float* feat, long long n, int F,
                                 const void* w, const float* b,
                                 const int* in_dims, const int* out_dims,
                                 const long long* w_off,
                                 const long long* a_off,
                                 const long long* bb_off, int n_layers,
                                 int multires, const float* cout, void* abuf,
                                 void* bbuf, float* dbp, float* db,
                                 float* cnrm, float* cfeat, void* stream) {
  RnbWgNet net;
  const int db_len = albedo_wg_net(&net, in_dims, out_dims, w_off, a_off,
                                   bb_off, n_layers, multires, F);
  if (db_len < 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(rnb_bf16) * (WG_M * ALB_KW + WG_RS * ALB_STG) +
                         sizeof(float) * 4 * 256 +
                         sizeof(uint32_t) * (n_layers - 1) * ALB_NT);
  cudaError_t err = cudaFuncSetAttribute(
      albedo_bwd_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = (n + WG_M - 1) / WG_M;
  albedo_bwd_wg_kernel<<<(unsigned)tiles, ALB_NT, smem, st>>>(
      pts, nrm, feat, n, F, static_cast<const rnb_bf16*>(w), b, net, multires,
      cout, static_cast<rnb_bf16*>(abuf), static_cast<rnb_bf16*>(bbuf), dbp,
      db_len, cnrm, cfeat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rnb_sum_splits_kernel<<<(unsigned)((db_len + 255) / 256), 256, 0, st>>>(
      dbp, (int)tiles, db_len, db);
  return (int)cudaGetLastError();
}
