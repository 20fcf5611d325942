// The fused differentiable SDF core for Hopper (sm_90a): SDF value, feature
// and ∇SDF in one forward kernel, and the hand-derived collapsed-tangent VJP
// in one backward sweep followed by the deterministic dW/db reduction.
//
// Replaces rnb_tpu/ops/pallas_sdf_core.py: _fwd_kernel (:169) and
// _bwd_kernel (:232), and the forward's ablation variants of
// tools/ablate_kernel.py (make_kernel, :62). Same algorithm:
//   forward   PE(u = pts*scale) by the double-angle recurrence; L linear
//             layers with softplus(100·)/100, the skip input [h, e]/√2 in the
//             op dtype; then one reverse sweep seeded with W_last[:, 0] gives
//             grad = ∂sdf/∂x (the 1/scale and the input scale cancel).
//   backward  one directional tangent slab T' = Σ_d c_grad_d ∂e/∂u_d rides
//             the recomputed primal; the reverse sweep from (c_sdf/scale,
//             c_feat) and a unit tangent seed on the sdf column gives
//             dW_l = h_lᵀ bar_z_l + Th_lᵀ bar_T_l and db_l = Σ bar_z_l.
//             The pts cotangent is zero (sample points never need one).
//
// What bounds it on the H100: arithmetic. At the shipped conf a point costs
// ~0.52 M multiply-adds per primal chain (9 layers, ~256x256): the forward
// runs 2 chains, the backward 6 (primal+tangent, their reverse, dW). This
// first version runs them on the CUDA cores in fp32 (bf16-rounded operands
// on the main path); the products are the place for wgmma later.
//
// Per-point state: the reverse sweeps need, per hidden layer, the biased
// pre-activation (forward) and the (z, Tz) pair (backward): 8-16 KB per
// point, against 227 KB of shared memory per block. The design spills it to
// a global scratch written and read by the same block (L2-resident for the
// blocks in flight) instead of shrinking the tile or recomputing the chain
// per layer (quadratic in depth). The backward also writes its dW operands
// (layer inputs, pre-activation cotangents) to scratch, and the split-K
// kernels of common.cuh reduce them across points.
#include "common.cuh"

// Ablation variants of the forward kernel (counterparts of the variants in
// tools/ablate_kernel.py:62; for timing only, their numerics are wrong by
// design). Each strips one part and keeps the rest of the production kernel:
//   SDF_NO_PE        every PE channel holds the raw first coordinate; the
//                    tangent basis is the same broadcast (grad_d = Σ bar_e·e)
//   SDF_NO_ACT       softplus pair -> h = zb/4 forward, s = zb/2 in the sweep
//   SDF_PRIMAL_ONLY  no reverse sweep and no pre-activation record; grad = 0
// SDF_FULL is the production kernel: `if constexpr` keeps its code as it was.
enum SdfMode { SDF_FULL = 0, SDF_NO_PE = 1, SDF_NO_ACT = 2, SDF_PRIMAL_ONLY = 3 };

// Two blocks an SM: left free, ptxas gives this kernel 190 registers and one
// 256-thread block an SM; capped at 128 (a 72-byte spill) it ran 13.79 ->
// 11.73 ms at 65,536 points on an H100 (700 W). The other sweep kernels fit
// two or three blocks already and got slower under the same cap.
template <int MODE>
static __global__ void __launch_bounds__(RNB_NT, 2)
sdf_fwd_kernel(const float* __restrict__ pts, long long n,
               const float* __restrict__ w, const float* __restrict__ wt,
               const float* __restrict__ b, RnbNet net, int multires,
               float scale, int bf, float c16, float* __restrict__ rec,
               int rec_ld, float* __restrict__ sdf, float* __restrict__ feat,
               float* __restrict__ grad) {
  constexpr int P = RNB_P;
  extern __shared__ __align__(16) float smem[];
  const int E = net.in_dim[0];
  const int LDE = (E + 3) & ~3;
  const int LD = net.ld;
  float* sE = smem;               // [P][LDE] PE, f32
  float* sE16 = sE + P * LDE;     // [P][LDE] PE in the op dtype
  float* sBarE = sE16 + P * LDE;  // [P][LDE] cotangent of the PE
  float* cur = sBarE + P * LDE;   // [P][LD]
  float* spare = cur + P * LD;    // [P][LD]
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * P;
  const int L = net.n_layers;
  const float inv_sqrt2 = 0.70710678118654752f;

  if constexpr (MODE == SDF_NO_PE) {
    for (int idx = tid; idx < P * E; idx += blockDim.x) {
      const int p = idx / E, c = idx % E;
      const long long row = n0 + p;
      sE[p * LDE + c] = row < n ? pts[row * 3] : 0.0f;
    }
  } else {
    for (int idx = tid; idx < P * 3; idx += blockDim.x) {
      const int p = idx / 3, d = idx % 3;
      const long long row = n0 + p;
      const float u = row < n ? pts[row * 3 + d] * scale : 0.0f;
      float* e = sE + p * LDE;
      e[d] = u;
      float s = sinf(u), c = cosf(u);
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
  }
  __syncthreads();
  for (int idx = tid; idx < P * LDE; idx += blockDim.x) {
    sE16[idx] = rnb_rnd(sE[idx], bf);
    sBarE[idx] = 0.0f;
  }
  __syncthreads();

  // --- primal chain, recording the biased pre-activations ---
  const float* hin = sE16;
  int ldin = LDE;
  for (int l = 0; l < L; ++l) {
    const int in = net.in_dim[l], out = net.out_dim[l];
    if (net.skip[l]) {
      const int hd = in - E;
      for (int idx = tid; idx < P * in; idx += blockDim.x) {
        const int p = idx / in, i = idx % in;
        const float v = i < hd ? hin[p * ldin + i] : sE16[p * LDE + i - hd];
        spare[p * LD + i] = rnb_rnd(v * c16, bf);
      }
      __syncthreads();
      hin = spare;
      ldin = LD;
      float* t = cur; cur = spare; spare = t;
    }
    float* dst = spare;
    const float* W = w + net.w_off[l];
    const float* bl = b + net.b_off[l];
    for (int c = tid; c < out; c += blockDim.x) {
      float acc[P];
      rnb_dot_col<P>(hin, ldin, in, W, out, c, acc);
      const float bc = bl[c];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = n0 + p;
        const float zb = acc[p] + bc;
        if (l < L - 1) {
          if (MODE != SDF_PRIMAL_ONLY && row < n)
            rec[((long long)l * n + row) * rec_ld + c] = zb;
          if constexpr (MODE == SDF_NO_ACT) {
            dst[p * LD + c] = rnb_rnd(zb * 0.25f, bf);
          } else {
            float s, h;
            rnb_softplus100_pair(zb, &s, &h);
            dst[p * LD + c] = rnb_rnd(h, bf);
          }
        } else if (row < n) {
          if (c == 0) sdf[row] = zb / scale;
          else feat[row * (out - 1) + c - 1] = zb;
        }
      }
    }
    __syncthreads();
    hin = dst;
    ldin = LD;
    float* t = cur; cur = spare; spare = t;
  }

  if constexpr (MODE == SDF_PRIMAL_ONLY) {
    for (int idx = tid; idx < P * 3; idx += blockDim.x) {
      const long long row = n0 + idx / 3;
      if (row < n) grad[row * 3 + idx % 3] = 0.0f;
    }
    return;
  }

  // --- reverse sweep for ∇SDF; `cur` holds bar_h of the layer above ---
  {
    const int l = L - 1;
    const int in = net.in_dim[l], out = net.out_dim[l];
    const int hd = net.skip[l] ? in - E : in;
    const float* W = w + net.w_off[l];
    for (int idx = tid; idx < P * in; idx += blockDim.x) {
      const int p = idx / in, i = idx % in;
      const float v = W[(long long)i * out];  // unit seed on the sdf column
      if (i >= hd) sBarE[p * LDE + i - hd] += v * inv_sqrt2;
      else if (net.skip[l]) cur[p * LD + i] = v * inv_sqrt2;
      else if (l == 0) sBarE[p * LDE + i] += v;
      else cur[p * LD + i] = v;
    }
    __syncthreads();
  }
  for (int l = L - 2; l >= 0; --l) {
    const int in = net.in_dim[l], out = net.out_dim[l];
    const int hd = net.skip[l] ? in - E : in;
    for (int idx = tid; idx < P * out; idx += blockDim.x) {
      const int p = idx / out, j = idx % out;
      const long long row = n0 + p;
      const float zb = row < n ? rec[((long long)l * n + row) * rec_ld + j] : 0.0f;
      float s, h;
      if constexpr (MODE == SDF_NO_ACT) s = zb * 0.5f;
      else rnb_softplus100_pair(zb, &s, &h);
      spare[p * LD + j] = rnb_rnd(cur[p * LD + j] * s, bf);
    }
    __syncthreads();
    const float* WT = wt + net.w_off[l];
    for (int c = tid; c < in; c += blockDim.x) {
      float acc[P];
      rnb_dot_col<P>(spare, LD, out, WT, in, c, acc);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float v = acc[p];
        if (c >= hd) sBarE[p * LDE + c - hd] += v * inv_sqrt2;
        else if (net.skip[l]) cur[p * LD + c] = v * inv_sqrt2;
        else if (l == 0) sBarE[p * LDE + c] += v;
        else cur[p * LD + c] = v;
      }
    }
    __syncthreads();
  }

  // grad_d = Σ_c bar_e[c] ∂e_c/∂u_d; the tangents reuse the PE's (s, c)
  for (int idx = tid; idx < P * 3; idx += blockDim.x) {
    const int p = idx / 3, d = idx % 3;
    const long long row = n0 + p;
    if (row >= n) continue;
    const float* e = sE + p * LDE;
    const float* be = sBarE + p * LDE;
    float g;
    if constexpr (MODE == SDF_NO_PE) {
      g = 0.0f;
      for (int c = 0; c < E; ++c) g += be[c] * e[c];
    } else {
      g = be[d];
      float f = 1.0f;
      for (int k = 0; k < multires; ++k) {
        g += be[3 + 6 * k + d] * (f * e[6 + 6 * k + d]);
        g += be[6 + 6 * k + d] * (-f * e[3 + 6 * k + d]);
        f *= 2.0f;
      }
    }
    grad[row * 3 + d] = g;
  }
}

static __global__ void __launch_bounds__(RNB_NT)
sdf_bwd_kernel(const float* __restrict__ pts, long long n,
               const float* __restrict__ w, const float* __restrict__ wt,
               const float* __restrict__ b, RnbNet net, int multires,
               float scale, int bf, float c16, const float* __restrict__ csdf,
               const float* __restrict__ cfeat,
               const float* __restrict__ cgrad, float* __restrict__ rec_z,
               float* __restrict__ rec_t, int rec_ld,
               float* __restrict__ abuf, float* __restrict__ bbuf) {
  constexpr int P = RNB_P;
  extern __shared__ __align__(16) float smem[];
  const int E = net.in_dim[0];
  const int LDE = (E + 3) & ~3;
  const int LD = net.ld;
  float* sE16 = smem;             // [P][LDE]
  float* sT16 = sE16 + P * LDE;   // [P][LDE]
  float* h0 = sT16 + P * LDE;     // four [P][LD] buffers
  float* t0 = h0 + P * LD;
  float* h1 = t0 + P * LD;
  float* t1 = h1 + P * LD;
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * P;
  const int L = net.n_layers;
  const float inv_sqrt2 = 0.70710678118654752f;

  // --- PE and the directional tangent T' = Σ_d c_grad_d ∂e/∂u_d ---
  for (int idx = tid; idx < P * 3; idx += blockDim.x) {
    const int p = idx / 3, d = idx % 3;
    const long long row = n0 + p;
    const float u = row < n ? pts[row * 3 + d] * scale : 0.0f;
    const float cg = row < n ? cgrad[row * 3 + d] : 0.0f;
    float* e = sE16 + p * LDE;
    float* t = sT16 + p * LDE;
    e[d] = rnb_rnd(u, bf);
    t[d] = rnb_rnd(cg, bf);
    float s = sinf(u), c = cosf(u), f = 1.0f;
    for (int k = 0; k < multires; ++k) {
      e[3 + 6 * k + d] = rnb_rnd(s, bf);
      e[6 + 6 * k + d] = rnb_rnd(c, bf);
      t[3 + 6 * k + d] = rnb_rnd(cg * (f * c), bf);
      t[6 + 6 * k + d] = rnb_rnd(cg * (-f * s), bf);
      if (k + 1 < multires) {
        const float s2 = 2.0f * s * c;
        c = 1.0f - 2.0f * s * s;
        s = s2;
      }
      f *= 2.0f;
    }
  }
  __syncthreads();

  // --- recompute the primal with one tangent slab, recording (zb, Tz) and
  // the layer inputs (the A rows of dW) ---
  const float* hin = sE16;
  const float* tin = sT16;
  int ldin = LDE;
  float *hs = h0, *ts = t0, *hn = h1, *tn = t1;  // spare / next
  for (int l = 0; l < L; ++l) {
    const int in = net.in_dim[l], out = net.out_dim[l];
    if (net.skip[l]) {
      const int hd = in - E;
      for (int idx = tid; idx < P * in; idx += blockDim.x) {
        const int p = idx / in, i = idx % in;
        const float v = i < hd ? hin[p * ldin + i] : sE16[p * LDE + i - hd];
        const float tv = i < hd ? tin[p * ldin + i] : sT16[p * LDE + i - hd];
        hs[p * LD + i] = rnb_rnd(v * c16, bf);
        ts[p * LD + i] = rnb_rnd(tv * c16, bf);
      }
      __syncthreads();
      hin = hs; tin = ts; ldin = LD;
      float* a = hs; hs = hn; hn = a;
      a = ts; ts = tn; tn = a;
    }
    float* A = abuf + net.a_off[l];
    for (int idx = tid; idx < P * in; idx += blockDim.x) {
      const int p = idx / in, i = idx % in;
      const long long row = n0 + p;
      if (row < n) {
        A[row * in + i] = hin[p * ldin + i];
        A[(n + row) * in + i] = tin[p * ldin + i];
      }
    }
    if (l == L - 1) break;
    const float* W = w + net.w_off[l];
    const float* bl = b + net.b_off[l];
    for (int c = tid; c < out; c += blockDim.x) {
      float acc[P], tacc[P];
      rnb_dot_col2<P>(hin, tin, ldin, in, W, out, c, acc, tacc);
      const float bc = bl[c];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = n0 + p;
        const float zb = acc[p] + bc;
        if (row < n) {
          rec_z[((long long)l * n + row) * rec_ld + c] = zb;
          rec_t[((long long)l * n + row) * rec_ld + c] = tacc[p];
        }
        float s, h;
        rnb_softplus100_pair(zb, &s, &h);
        hs[p * LD + c] = rnb_rnd(h, bf);
        ts[p * LD + c] = rnb_rnd(tacc[p] * s, bf);
      }
    }
    __syncthreads();
    hin = hs; tin = ts; ldin = LD;
    float* a = hs; hs = hn; hn = a;
    a = ts; ts = tn; tn = a;
  }
  __syncthreads();

  // --- reverse sweep: bar_z from (c_sdf/scale, c_feat), unit tangent seed ---
  float *Z = h0, *Tb = t0, *Zn = h1, *Tn = t1;
  {
    const int outL = net.out_dim[L - 1];
    for (int idx = tid; idx < P * outL; idx += blockDim.x) {
      const int p = idx / outL, j = idx % outL;
      const long long row = n0 + p;
      float z = 0.0f;
      if (row < n) z = j == 0 ? csdf[row] / scale : cfeat[row * (outL - 1) + j - 1];
      Z[p * LD + j] = z;
      Tb[p * LD + j] = j == 0 ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    const int in = net.in_dim[l], out = net.out_dim[l];
    float* B = bbuf + net.bb_off[l];
    for (int idx = tid; idx < P * out; idx += blockDim.x) {
      const int p = idx / out, j = idx % out;
      const long long row = n0 + p;
      const float z = Z[p * LD + j], t = Tb[p * LD + j];
      if (row < n) {
        B[row * out + j] = z;
        B[(n + row) * out + j] = t;
      }
      Z[p * LD + j] = rnb_rnd(z, bf);
      Tb[p * LD + j] = rnb_rnd(t, bf);
    }
    if (l == 0) break;
    __syncthreads();
    const float* WT = wt + net.w_off[l];
    const int hd = net.skip[l] ? in - E : in;
    const float sc = net.skip[l] ? inv_sqrt2 : 1.0f;
    for (int c = tid; c < hd; c += blockDim.x) {
      float acc[P], tacc[P];
      rnb_dot_col2<P>(Z, Tb, LD, out, WT, in, c, acc, tacc);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = n0 + p;
        float zp = 0.0f, tzp = 0.0f;
        if (row < n) {
          zp = rec_z[((long long)(l - 1) * n + row) * rec_ld + c];
          tzp = rec_t[((long long)(l - 1) * n + row) * rec_ld + c];
        }
        float s, h;
        rnb_softplus100_pair(zp, &s, &h);
        const float bh = acc[p] * sc, bth = tacc[p] * sc;
        Zn[p * LD + c] = bh * s + (bth * tzp) * (100.0f * s * (1.0f - s));
        Tn[p * LD + c] = bth * s;
      }
    }
    __syncthreads();
    float* a = Z; Z = Zn; Zn = a;
    a = Tb; Tb = Tn; Tn = a;
  }
}

template <int MODE>
static int sdf_fwd_launch(const float* pts, long long n, const float* w,
                          const float* wt, const float* b, const int* in_dims,
                          const int* out_dims, const int* skip, int n_layers,
                          int multires, float scale, int bf, float c16,
                          float* rec, int rec_ld, float* sdf, float* feat,
                          float* grad, void* stream) {
  RnbNet net;
  if (rnb_make_net(&net, in_dims, out_dims, skip, n_layers, n, 2))
    return (int)cudaErrorInvalidValue;
  const int LDE = (in_dims[0] + 3) & ~3;
  const int smem = (int)sizeof(float) * (3 * RNB_P * LDE + 2 * RNB_P * net.ld);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_fwd_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + RNB_P - 1) / RNB_P);
  sdf_fwd_kernel<MODE><<<grid, RNB_NT, smem, (cudaStream_t)stream>>>(
      pts, n, w, wt, b, net, multires, scale, bf, c16, rec, rec_ld, sdf, feat,
      grad);
  return (int)cudaGetLastError();
}

extern "C" int rnb_sdf_fwd(const float* pts, long long n, const float* w,
                           const float* wt, const float* b,
                           const int* in_dims, const int* out_dims,
                           const int* skip, int n_layers, int multires,
                           float scale, int bf, float c16, float* rec,
                           int rec_ld, float* sdf, float* feat, float* grad,
                           void* stream) {
  return sdf_fwd_launch<SDF_FULL>(pts, n, w, wt, b, in_dims, out_dims, skip,
                                  n_layers, multires, scale, bf, c16, rec,
                                  rec_ld, sdf, feat, grad, stream);
}

// The forward kernel in ablation mode `mode` (an SdfMode); SDF_FULL is the
// production kernel itself.
extern "C" int rnb_sdf_fwd_ablate(int mode, const float* pts, long long n,
                                  const float* w, const float* wt,
                                  const float* b, const int* in_dims,
                                  const int* out_dims, const int* skip,
                                  int n_layers, int multires, float scale,
                                  int bf, float c16, float* rec, int rec_ld,
                                  float* sdf, float* feat, float* grad,
                                  void* stream) {
#define RNB_SDF_FWD_ARGS                                                      \
  pts, n, w, wt, b, in_dims, out_dims, skip, n_layers, multires, scale, bf,  \
      c16, rec, rec_ld, sdf, feat, grad, stream
  switch (mode) {
    case SDF_FULL: return sdf_fwd_launch<SDF_FULL>(RNB_SDF_FWD_ARGS);
    case SDF_NO_PE: return sdf_fwd_launch<SDF_NO_PE>(RNB_SDF_FWD_ARGS);
    case SDF_NO_ACT: return sdf_fwd_launch<SDF_NO_ACT>(RNB_SDF_FWD_ARGS);
    case SDF_PRIMAL_ONLY:
      return sdf_fwd_launch<SDF_PRIMAL_ONLY>(RNB_SDF_FWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RNB_SDF_FWD_ARGS
}

extern "C" int rnb_sdf_bwd(const float* pts, long long n, const float* w,
                           const float* wt, const float* b,
                           const int* in_dims, const int* out_dims,
                           const int* skip, int n_layers, int multires,
                           float scale, int bf, float c16, const float* csdf,
                           const float* cfeat, const float* cgrad,
                           float* rec_z, float* rec_t, int rec_ld,
                           float* abuf, float* bbuf, float* partial,
                           int splits, float* dw, float* db, void* stream) {
  RnbNet net;
  if (rnb_make_net(&net, in_dims, out_dims, skip, n_layers, n, 2))
    return (int)cudaErrorInvalidValue;
  const int LDE = (in_dims[0] + 3) & ~3;
  const int smem = (int)sizeof(float) * (2 * RNB_P * LDE + 4 * RNB_P * net.ld);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((n + RNB_P - 1) / RNB_P);
  sdf_bwd_kernel<<<grid, RNB_NT, smem, st>>>(
      pts, n, w, wt, b, net, multires, scale, bf, c16, csdf, cfeat, cgrad,
      rec_z, rec_t, rec_ld, abuf, bbuf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < n_layers; ++l) {
    err = rnb_reduce_layer(abuf + net.a_off[l], bbuf + net.bb_off[l], 2 * n,
                           n, in_dims[l], out_dims[l], bf, splits, partial,
                           dw + net.w_off[l], db + net.b_off[l], st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

extern "C" const char* rnb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
