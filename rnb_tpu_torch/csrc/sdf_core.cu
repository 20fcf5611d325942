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
// Two routes, chosen by the op dtype (ops/sdf_core.py), never by failure:
//   bf16 (the main path): sdf_fwd_wg_kernel<MODE> and sdf_bwd_sweep_kernel,
//             products on the tensor cores (wgmma, bf16 operands, f32
//             sums), then the grouped dW product of dw_gemm.cu; the designs
//             are in front of them below (the weights of both arrive by
//             TMA, their records by an L2 prefetch).
//   f32 (the f32 comparisons, e.g. the card-vs-CPU step parity):
//             sdf_fwd_kernel<MODE>, sdf_bwd_kernel and the split-K
//             reduction of common.cuh, products on the CUDA cores in fp32.
//             wgmma has no f32 operands (only TF32, ~3 decimal digits).
//
// What bounds them on the H100: arithmetic. At the shipped conf
// ([39→256] [256→256]x2 [256→217] [256→256]x4 [256→257]) a point costs
// 983,296 multiply-adds in the forward (the primal chain and its reverse
// sweep) and 2,975,744 in the backward (primal and tangent slabs, their
// reverse, dW over both rows): 128.9 and 390.0 GFLOP at 65,536 points, i.e.
// 0.130 and 0.394 ms at the bf16 peak of 989 TFLOP/s. Inputs and outputs
// are ≤ 135 MB (≤ 0.04 ms at 3.35 TB/s); what the kernels add is their
// scratch: the f32 record of the reverse sweeps (537 MB per pass in the
// forward, twice that in the backward) and, in the backward, the bf16 dW
// operand rows (~1.15 GB written and read once).
//
// Per-point state: the reverse sweeps need, per hidden layer, the biased
// pre-activation (forward) and the (z, Tz) pair (backward): 8-16 KB per
// point, against 227 KB of shared memory per block. Both routes spill it to
// a global scratch written and read by the same block (L2-resident for the
// blocks in flight) instead of shrinking the tile or recomputing the chain
// per layer (quadratic in depth).
//
// What the bf16 route does about it: the products run on the tensor cores
// (wgmma) from shared-memory operand tiles, the softplus pair of the
// epilogues uses the fast intrinsics, and the dW sums are one grouped wgmma
// launch over every layer's bf16 operand rows (dw_gemm.cu). What bounds it
// after that is the record's traffic and the CUDA-core epilogue between the
// products, which take turns with them (PERF.md, kernel table).
//
// ptxas (-Xptxas -v, in _build.build_info["main"]["log"]; chip_smoke.py
// prints it and holds the tensor-core lines to this note; the production
// instances are the forward at ring depth SF_RS = 16, the backward sweep at
// SW_RS = 16):
//   sdf_fwd_wg_kernel<SDF_FULL, 16, 0>  168 registers at launch (the
//                                consumers take 232 by setmaxnreg), 56 B
//                                stack frame, 24 B spill stores, 52 B
//                                spill loads (the 16 record loads held
//                                across a product, which bought ~2%);
//                                228,752 B dynamic shared memory
//   sdf_fwd_wg_kernel<SDF_VALUE, 16, 0>  168 registers at launch, 32 B
//                                stack frame, no spill (the up-sampling
//                                sweeps' value-only mode; 0.317 ms at
//                                65,536 points, 1.231 at 262,144 on one
//                                H100, PERF.md)
//   sdf_bwd_sweep_kernel<16, 0>  128 registers, 32 B stack frame, no
//                                spill; 217,344 B dynamic shared memory
//   sdf_fwd_kernel<SDF_FULL>     128 registers, 96 B stack frame, 64 B
//                                spill stores and loads (f32 route)
//   sdf_bwd_kernel               70 registers, no spill (f32 route)
#include "common.cuh"

// Ablation variants of the forward kernel (counterparts of the variants in
// tools/ablate_kernel.py:62; for timing only, their numerics are wrong by
// design). Each strips one part and keeps the rest of the production kernel:
//   SDF_NO_PE        every PE channel holds the raw first coordinate; the
//                    tangent basis is the same broadcast (grad_d = Σ bar_e·e)
//   SDF_NO_ACT       softplus pair -> h = zb/4 forward, s = zb/2 in the sweep
//   SDF_PRIMAL_ONLY  no reverse sweep and no pre-activation record; grad = 0
// SDF_FULL is the production kernel: `if constexpr` keeps its code as it was.
// The bf16 route's sdf_fwd_wg_kernel<MODE> takes the same modes, and one
// more, a production mode of its own:
//   SDF_VALUE        the no-grad up-sampling sweeps' forward: SDF_PRIMAL_ONLY's
//                    primal chain and head, storing the sdf alone (no feature,
//                    no gradient, no record; the head's column 256 not summed)
enum SdfMode {
  SDF_FULL = 0, SDF_NO_PE = 1, SDF_NO_ACT = 2, SDF_PRIMAL_ONLY = 3,
  SDF_VALUE = 4
};

// Two blocks an SM: left free, ptxas gives this kernel 190 registers and one
// 256-thread block an SM; capped at 128 (a 72-byte spill) it ran 13.79 ->
// 11.73 ms at 65,536 points on an H100 (700 W). The other sweep kernels fit
// two or three blocks already and got slower under the same cap.
template <int MODE>
static __global__ void __launch_bounds__(RNB_NT, 2)
sdf_fwd_kernel(const float* __restrict__ pts, long long n,
               const float* __restrict__ w, const float* __restrict__ wt,
               const float* __restrict__ b, RnbNet net, int multires,
               float scale, float c16, float* __restrict__ rec,
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
    sE16[idx] = sE[idx];
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
        spare[p * LD + i] = v * c16;
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
            dst[p * LD + c] = zb * 0.25f;
          } else {
            float s, h;
            rnb_softplus100_pair(zb, &s, &h);
            dst[p * LD + c] = h;
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
      spare[p * LD + j] = cur[p * LD + j] * s;
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
               float scale, float c16, const float* __restrict__ csdf,
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
    e[d] = u;
    t[d] = cg;
    float s = sinf(u), c = cosf(u), f = 1.0f;
    for (int k = 0; k < multires; ++k) {
      e[3 + 6 * k + d] = s;
      e[6 + 6 * k + d] = c;
      t[3 + 6 * k + d] = cg * (f * c);
      t[6 + 6 * k + d] = cg * (-f * s);
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
        hs[p * LD + i] = v * c16;
        ts[p * LD + i] = tv * c16;
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
        hs[p * LD + c] = h;
        ts[p * LD + c] = tacc[p] * s;
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
      Z[p * LD + j] = z;
      Tb[p * LD + j] = t;
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
                          int multires, float scale, float c16,
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
      pts, n, w, wt, b, net, multires, scale, c16, rec, rec_ld, sdf, feat,
      grad);
  return (int)cudaGetLastError();
}

extern "C" int rnb_sdf_fwd(const float* pts, long long n, const float* w,
                           const float* wt, const float* b,
                           const int* in_dims, const int* out_dims,
                           const int* skip, int n_layers, int multires,
                           float scale, float c16, float* rec,
                           int rec_ld, float* sdf, float* feat, float* grad,
                           void* stream) {
  return sdf_fwd_launch<SDF_FULL>(pts, n, w, wt, b, in_dims, out_dims, skip,
                                  n_layers, multires, scale, c16, rec,
                                  rec_ld, sdf, feat, grad, stream);
}

// The forward kernel in ablation mode `mode` (an SdfMode); SDF_FULL is the
// production kernel itself.
extern "C" int rnb_sdf_fwd_ablate(int mode, const float* pts, long long n,
                                  const float* w, const float* wt,
                                  const float* b, const int* in_dims,
                                  const int* out_dims, const int* skip,
                                  int n_layers, int multires, float scale,
                                  float c16, float* rec, int rec_ld,
                                  float* sdf, float* feat, float* grad,
                                  void* stream) {
#define RNB_SDF_FWD_ARGS                                                      \
  pts, n, w, wt, b, in_dims, out_dims, skip, n_layers, multires, scale, c16, \
      rec, rec_ld, sdf, feat, grad, stream
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
                           float scale, float c16, const float* csdf,
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
      pts, n, w, wt, b, net, multires, scale, c16, csdf, cfeat, cgrad,
      rec_z, rec_t, rec_ld, abuf, bbuf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < n_layers; ++l) {
    err = rnb_reduce_layer(abuf + net.a_off[l], bbuf + net.bb_off[l], 2 * n,
                           n, in_dims[l], out_dims[l], 0, splits, partial,
                           dw + net.w_off[l], db + net.b_off[l], st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// ===========================================================================
// bf16 route: the same two kernels on the tensor cores (wgmma, sm_90a)
// ===========================================================================
//
// Both kernels work on tiles of 64 points, the M of wgmma. Every product of
// a chain is [64 x K] · [K x N]:
//   * the A operand (layer input, or the reverse sweep's cotangent row) is a
//     bf16 tile in shared memory, K-major, written by the epilogue of the
//     product before; its values are exactly the op-dtype roundings of the
//     plain version, so the operand is exact;
//   * the B operand is the layer's bf16 weight tile, streamed from the
//     L2-resident weight image in K-steps of 16 by TMA through a ring of
//     stages; the forward product reads it MN-major (W), the reverse sweep
//     reads the same tile K-major (Wᵀ): no transposed copy.
// Ragged widths are padded with zeros: K to a multiple of 16 (39 -> 48,
// 217 -> 224, 257 -> 272), the 257-wide last layer is one N = 256 product
// plus one N = 8 product for column 256, the 39-wide reverse product of
// layer 0 is N = 48. A padded column of an epilogue is never written to the
// next A tile: the skip layer's input gets e at its own column (hd = 217 on
// the shipped net), every other pad gets 0.
//
// The per-point record of a reverse sweep stays f32 in global memory, in
// the accumulator's own layout: the thread that wrote a value in the primal
// sweep is the one that reads it back in the reverse sweep, and the 128
// threads of a warpgroup touch 512 consecutive bytes per register.

#include <type_traits>

#include "tma.cuh"
#include "wg_pipe.cuh"

#define WG_BWG 4      // warpgroups per block of the backward sweep (N = 256 / 4)
#define WG_TW 272     // widest A tile: K of the last layer's reverse product
#define WG_EP 48      // PE channels held per point (E <= 48)
#define WG_REC (WG_M * 256)  // record floats per tile and layer

// sigmoid(100 z) and softplus(100 z)/100 of the bf16 route, from the fast
// intrinsics (ex2 / lg2 approximations and an approximate division): several
// times cheaper than expf / log1pf, which the epilogues are bound by. log1p(t)
// is __logf(1 + t) for t >= 1e-2 (relative error ~4e-5) and its series
// t - t²/2 + t³/3 below (relative error < 3e-7), so h never underflows to
// max(z, 0) where 1 + t rounds to 1; both far inside the bf16 rounding of
// what they feed.
__device__ __forceinline__ void wg_softplus100_pair(float z, float* s,
                                                    float* h) {
  const float t = __expf(-100.0f * fabsf(z));
  const float inv = __fdividef(1.0f, 1.0f + t);
  *s = z >= 0.0f ? inv : t * inv;
  const float l1p = t < 1e-2f
                        ? t * fmaf(t, fmaf(t, 1.0f / 3.0f, -0.5f), 1.0f)
                        : __logf(1.0f + t);
  *h = fmaxf(z, 0.0f) + 0.01f * l1p;
}
__device__ __forceinline__ float wg_sigmoid100(float z) {
  float s, h;
  wg_softplus100_pair(z, &s, &h);  // h unused: its log is not computed
  return s;
}

// ---------------------------------------------------------------------------
// The bf16 forward (sdf_fwd_wg_kernel)
// ---------------------------------------------------------------------------
//
// What held the cp.async kernel it replaced (its timing split on one H100,
// PERF.md §6): its K loop. Two warpgroups a tile each copied a share of
// every weight stage and met the block's other warps at a barrier at each
// of a tile's 257 K-steps; the ring and its barriers alone took 0.49 of its
// 1.25 ms at 65,536 points, the products 0.47 more, the record and the
// softplus arithmetic 0.29 together.
//
// What the design does about it:
//   * one block of 384 threads a pair of 64-point tiles (2b, 2b + 1), one
//     block an SM (225,552 B of shared memory): a producer warpgroup whose
//     one thread loads every weight stage by TMA, and two consumer
//     warpgroups (setmaxnreg 40 / 232), each a whole tile: one m64n256k16
//     a K-step into 128 f32 accumulators a thread (and one m64n8k16 for
//     the 257-wide head's last column; N = 48 for layer 0's reverse);
//   * one ring stage feeds both tiles, so the weight traffic from L2 and
//     the handshakes a point halve: a stage is one K-step, one 3-D TMA box
//     of the 8x8-core weight image (forward {64, 32, 2}, {64, 33, 2} at
//     the head; reverse {64, 2, 32}, {64, 2, 6} at layer 0),
//     completing on the stage's full mbarrier; each consumer warp frees it
//     on its empty mbarrier (RnbRing, tma.cuh), and the producer refills a
//     slot once all of them did. The producer walks the stages in the
//     products' order (SfCursor, ops/sdf_core.py fwd_steps). No consumer
//     waits on another warp's release: a warpgroup meets only its own four
//     warps (a named barrier) around its epilogues;
//   * ping-pong: the two consumers take turns at their product phases (an
//     order mbarrier each, as CUTLASS's ping-pong GEMM), so that one tile's
//     epilogue (bias, softplus pair, rounding, record) runs under the other
//     tile's products. A consumer hands the turn on once it has issued
//     min(nk, RS) K-steps: at RS = 16 (no product here has more than 16)
//     that is its whole phase; at a shallower ring (the tune library's
//     depths) a later step would wait for a slot that only the other
//     tile's next turn frees;
//   * the record holds s = sigmoid(100 zb), which the primal epilogue's
//     softplus pair computes anyway, in place of zb: the reverse epilogue
//     reads the bits it used to recompute, with no MUFU op. It is written
//     and read as one float4 a thread and j (whole 512-byte runs a warp);
//     the layer the next epilogue reads is brought into L2 by one bulk
//     prefetch when a product phase starts, and its first 16 loads are
//     issued before that phase. It stays f32: a bf16 record would change
//     the function;
//   * the epilogues run on one warp an SMSP, so they are written to keep
//     many independent chains in flight: no branch an element (selects,
//     the skip input's e copied in by a short loop after), each layer's
//     bias staged in shared memory by cp.async under the products, the
//     reverse seed staged once a block, column tests against a per-layer
//     limit (cq + 8j per column would pin 64 registers), the head's
//     features stored as whole 32-byte sectors.
// Each element is summed from the same bf16 operands in the same K order
// as the cp.async kernel's (m64n256k16 sums an element as m64n128k16 did),
// and the rest is the same arithmetic: the same bits.
//
// What did not pay (one H100, PERF.md §6): more wgmma groups in flight
// (1-6), the consumers running free of their turns, one wgmma.fence a
// phase (ptxas then serializes), the epilogues in four 32-register chunks
// (ptxas then serializes for want of registers), L2 evict_last on the later
// half of the record or evict_first on the earlier half, and dropping each
// read record line from L2 (discard, ~2% slower).

#define SF_RS 16       // the production ring depth
#define SF_NT 384      // a producer warpgroup and two consumer warpgroups
#define SF_STAGE 8448  // bytes of a ring stage: 2 x 33 cores of 128 B
#define SF_PE 12288    // bytes of a tile's PE area: e [64][WG_EP] bf16 in the
                       // primal, bar_e [64][WG_EP] f32 over it in the reverse
#define SF_BIAS 272    // floats of a tile's bias area: the layer's b, zeros
                       // past its width

// Ablation variants of the forward kernel (counterparts of the variants in
// tools/ablate_kernel.py:62; for timing only, their numerics are wrong by
// design) are its MODE (SdfMode above). Its timing split
// (tools/ablate_kernel.py --fwd_split; the tune library only) is its SPLIT:
// each strips one part and keeps the rest.
enum SdfFwdSplit {
  FWD_FULL = 0,           // the production kernel
  FWD_NO_RECORD = 1,      // no record stores or loads
  FWD_NO_EPILOGUE = 2,    // no softplus arithmetic (zb recorded and passed on)
  FWD_K_LOOPS_ONLY = 3,   // the ring and its barriers: no wgmma, no epilogue
  FWD_PRODUCTS_ONLY = 4   // no record and no softplus arithmetic
};

// The launch's arguments in kernel parameter space (__grid_constant__: the
// tensor maps must lie in parameter, constant or global memory).
struct SdfFwdParams {
  RnbWgNet net;
  const float* pts;
  const rnb_bf16* w;  // the weight image: the reverse's seed W_last[:, 0]
  const float* b;
  float* rec;         // ceil(n/64)·(L-1)·WG_REC floats
  float* sdf;
  float* feat;
  float* grad;
  long long n;
  int multires;
  float scale, c16;
  CUtensorMap wf[RNB_MAXL];  // layer l's image as [kpc][npc][64]: forward box
  CUtensorMap wr[RNB_MAXL];  // the same, reverse box
};

template <int RS>
__host__ __device__ constexpr int sf_smem_bytes() {
  return 2 * WG_M * 256 * (int)sizeof(rnb_bf16) + RS * SF_STAGE + 2 * SF_PE +
         (2 * RS + 2) * 8 + (2 * SF_BIAS + 256) * (int)sizeof(float);
}

// The forward's ring stages in the order the products take them: layers
// 0..L-1 forward, pad16(in)/16 K-steps each, then (but in SDF_PRIMAL_ONLY)
// layers L-2..0 reverse, pad16(out)/16 each.
struct SfCursor {
  const SdfFwdParams* p;
  int l, t, rev, fin, primal_only;
  __device__ __forceinline__ bool done() const { return fin; }
  __device__ __forceinline__ void issue(unsigned char* st, uint64_t* bar) {
    const RnbWgNet& net = p->net;
    if (!rev) {
      const int nb = l == net.n_layers - 1 ? 33 : 32;
      rnb_mbar_expect_tx(bar, 2 * nb * 128);
      rnb_tma_load_3d(st, &p->wf[l], bar, 0, 0, 2 * t);
      if (++t < rnb_pad16(net.in_dim[l]) >> 4) return;
      t = 0;
      if (++l < net.n_layers) return;
      rev = 1;
      l = net.n_layers - 2;
      fin = primal_only;
    } else {
      const int ib = l == 0 ? WG_EP / 8 : 32;
      rnb_mbar_expect_tx(bar, 2 * ib * 128);
      rnb_tma_load_3d(st, &p->wr[l], bar, 0, 2 * t, 0);
      if (++t < rnb_pad16(net.out_dim[l]) >> 4) return;
      t = 0;
      fin = --l < 0;
    }
  }
};

// MODE: an SdfMode; RS: the ring's stages (SF_RS in production; the tune
// library's instances take 4, 8 and 12 too); SPLIT: an SdfFwdSplit.
template <int MODE, int RS = SF_RS, int SPLIT = FWD_FULL>
static __global__ void __launch_bounds__(SF_NT, 1)
sdf_fwd_wg_kernel(const __grid_constant__ SdfFwdParams p) {
  static_assert(RS >= 3 && sf_smem_bytes<RS>() <= 232448, "ring depth");
  constexpr bool value = MODE == SDF_VALUE;
  constexpr bool primal_only = MODE == SDF_PRIMAL_ONLY || value;
  constexpr bool k_mma = SPLIT != FWD_K_LOOPS_ONLY;
  constexpr bool k_rec =
      !primal_only && (SPLIT == FWD_FULL || SPLIT == FWD_NO_EPILOGUE);
  constexpr bool k_epi = SPLIT == FWD_FULL || SPLIT == FWD_NO_RECORD;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const RnbWgNet& net = p.net;
  const long long n = p.n, tiles = (n + WG_M - 1) / WG_M;
  const int pair = tiles > 2 * (long long)blockIdx.x + 1 ? 2 : 1;
  RnbRing<RS> ring;
  ring.base = wg_smem + 2 * WG_M * 256 * (int)sizeof(rnb_bf16);
  ring.bytes = SF_STAGE;
  ring.full =
      reinterpret_cast<uint64_t*>(ring.base + RS * SF_STAGE + 2 * SF_PE);
  ring.empty = ring.full + RS;
  uint64_t* order = ring.empty + RS;   // consumer c's turn at order[c]
  // the reverse sweep's seed W_last[:, 0], once a block for both tiles
  float* seed = reinterpret_cast<float*>(order + 2) + 2 * SF_BIAS;
  if (threadIdx.x < 256) {
    const int cc = threadIdx.x, inL = net.in_dim[net.n_layers - 1];
    const int npcL = rnb_pad16(net.out_dim[net.n_layers - 1]) >> 3;
    const rnb_bf16* WL = p.w + net.w_off[net.n_layers - 1];
    seed[cc] =
        cc < inL ? wg_f(WL[((cc >> 3) * npcL) * 64 + (cc & 7) * 8]) : 0.0f;
  }
  const int ci = (threadIdx.x >> 7) - 1;   // a consumer's tile of the pair
  RnbTurns<RS> turns{ring, order, ci, pair, 1 + ci};
  if (threadIdx.x == 0) {
    ring.init(4 * pair);
    turns.init();
    rnb_fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {   // the producer warpgroup
    rnb_setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      SfCursor cur{&p, 0, 0, 0, 0, primal_only};
      rnb_ring_produce<RS>(ring, cur);
    }
    return;
  }
  rnb_setmaxnreg_inc<232>();
  if (ci >= pair) return;
  const int lt = threadIdx.x & 127, bar_id = 1 + ci;
  const int r0 = ((lt >> 5) << 4) + ((lt & 31) >> 2), cq = 2 * (lt & 3);
  const long long tile = 2 * (long long)blockIdx.x + ci, n0 = tile * WG_M;
  const int L = net.n_layers, E = net.E;
  const float inv_sqrt2 = 0.70710678118654752f, c16 = p.c16;
  rnb_bf16* X = reinterpret_cast<rnb_bf16*>(wg_smem) + ci * WG_M * 256;
  rnb_bf16* e16 =
      reinterpret_cast<rnb_bf16*>(ring.base + RS * SF_STAGE + ci * SF_PE);
  float* bar_e = reinterpret_cast<float*>(e16);   // [64][WG_EP], reverse only
  float* sb = reinterpret_cast<float*>(order + 2) + ci * SF_BIAS;
  // layer l's bias into sb by cp.async, under the products before the
  // epilogue that reads it (product() waits for the copies)
  auto stage_bias = [&](int l) {
    const float* bl = p.b + net.b_off[l];
    const int out = net.out_dim[l];
    for (int c = lt; c < SF_BIAS; c += 128)
      rnb_cp_async4(sb + c, c < out ? bl + c : bl, c < out);
    rnb_cp_async_commit();
  };

  // --- PE of the tile (rows past n from u = 0), pads zero ---
  for (int idx = lt; idx < WG_M * 3; idx += 128) {
    const int pp = idx / 3, d = idx % 3;
    const long long row = n0 + pp;
    rnb_bf16* e = e16 + pp * WG_EP;
    if constexpr (MODE == SDF_NO_PE) {
      const rnb_bf16 x = wg_bf(row < n ? p.pts[row * 3] : 0.0f);
      for (int c = d; c < E; c += 3) e[c] = x;
    } else {
      const float u = row < n ? p.pts[row * 3 + d] * p.scale : 0.0f;
      e[d] = wg_bf(u);
      float s = sinf(u), c = cosf(u);
      for (int k = 0; k < p.multires; ++k) {
        e[3 + 6 * k + d] = wg_bf(s);
        e[6 + 6 * k + d] = wg_bf(c);
        if (k + 1 < p.multires) {
          const float s2 = 2.0f * s * c;
          c = 1.0f - 2.0f * s * s;
          s = s2;
        }
      }
    }
  }
  for (int idx = lt; idx < WG_M * (WG_EP - E); idx += 128) {
    const int pp = idx / (WG_EP - E), c = E + idx % (WG_EP - E);
    e16[pp * WG_EP + c] = wg_bf(0.0f);
  }
  rnb_wg_sync(bar_id);
  for (int idx = lt; idx < WG_M * WG_EP; idx += 128) {
    const int pp = idx / WG_EP, c = idx % WG_EP;
    X[wg_tidx(pp, c)] = e16[pp * WG_EP + c];
  }
  rnb_fence_proxy_async();
  rnb_wg_sync(bar_id);

  // One product phase over nk stages of the ring, its turn taken from, and
  // handed on to, the other tile of the pair (RnbTurns, tma.cuh); the
  // epilogue's bias (stage_bias) has landed when it returns.
  auto product = [&](int nk, auto mma) {
    turns.template product<k_mma>(nk, mma, [] { rnb_cp_async_wait<0>(); });
  };

  float acc[128];
  float acc8[4];

  // --- primal chain, recording s = sigmoid(100 zb); the head after it ---
  for (int l = 0; l < L - 1; ++l) {
    if constexpr (k_mma) stage_bias(l);
    product(rnb_pad16(net.in_dim[l]) >> 4, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n256<0, 1>(acc, rnb_desc(X + t * 1024, 1024, 128),
                           rnb_desc(st, 32 * 128, 128), t > 0);
    });
    if constexpr (!k_mma) continue;
    const int out = net.out_dim[l];
    // columns 8j + cq + u below out: 8j + u < lim (8j + u an immediate;
    // cq + 8j + u kept for every j would hold 64 registers the whole sweep)
    const int lim = out - cq;
    float* recl = p.rec + (tile * (L - 1) + l) * WG_REC;
    // bias, softplus pair, record, rounding into X; branch-free, so the
    // 128 elements' chains interleave (one warp an SMSP runs it). NS: the
    // next layer takes the skip input [h, e]/√2, e from column out on
    auto epilogue = [&](auto ns) {
      constexpr bool NS = decltype(ns)::value;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float s4[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * j + cq;
          float v[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float zb = acc[4 * j + 2 * h + u] + sb[c + u];
            float s = zb, hv = zb;
            if constexpr (MODE == SDF_NO_ACT) {
              s = zb * 0.5f;
              hv = zb * 0.25f;
            } else if constexpr (k_epi) {
              wg_softplus100_pair(zb, &s, &hv);
            }
            s4[2 * h + u] = s;
            if constexpr (NS) hv = wg_f(wg_bf(hv)) * c16;
            v[u] = 8 * j + u < lim ? hv : 0.0f;
          }
          wg_put2(X, r0 + 8 * h, c, v[0], v[1]);
        }
        if constexpr (k_rec)
          *reinterpret_cast<float4*>(recl + (j * 128 + lt) * 4) =
              make_float4(s4[0], s4[1], s4[2], s4[3]);
      }
    };
    if (net.skip[l + 1]) {
      epilogue(std::true_type{});
      rnb_wg_sync(bar_id);   // then e/√2 over the zeros past column out
      for (int idx = lt; idx < WG_M * E; idx += 128) {
        const int pp = idx / E, c = idx % E;
        X[wg_tidx(pp, out + c)] = wg_bf(wg_f(e16[pp * WG_EP + c]) * c16);
      }
    } else {
      epilogue(std::false_type{});
    }
    rnb_fence_proxy_async();
    rnb_wg_sync(bar_id);   // the layer's output is the next products' A
  }
  {
    // the head: N = 256 and one N = 8 product for its column 256 (a stage
    // of 33 output cores, zeros past the layer's width)
    if (k_rec && lt == 0)   // the first reverse epilogue's record
      rnb_prefetch_l2(p.rec + (tile * (L - 1) + L - 2) * WG_REC, WG_REC * 4);
    if constexpr (k_mma) stage_bias(L - 1);
    product(rnb_pad16(net.in_dim[L - 1]) >> 4,
            [&](int t, const rnb_bf16* st) {
              const uint64_t da = rnb_desc(X + t * 1024, 1024, 128);
              rnb_wgmma_n256<0, 1>(acc, da, rnb_desc(st, 33 * 128, 128),
                                   t > 0);
              if constexpr (!value)
                rnb_wgmma_n8<0, 1>(acc8, da,
                                   rnb_desc(st + 32 * 64, 33 * 128, 128),
                                   t > 0);
            });
    const int out = net.out_dim[L - 1];
    if constexpr (k_mma) {
      // sdf from column 0 (cq = 0), feat from the others. A whole tile of
      // a 257-wide head stores whole 32-byte sectors: each lane pairs its
      // column 8j + cq + 1 with the next one (its right neighbour's, or
      // the next j's first from lane cq = 0; column 256 from acc8) into
      // one 8-byte store at feat column 8j + cq
      const bool whole = n0 + WG_M <= n && out == 257;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = n0 + r0 + 8 * h;
        const bool live = row < n;
        if (cq == 0 && live) p.sdf[row] = (acc[2 * h] + sb[0]) / p.scale;
        if constexpr (value) continue;   // the sdf alone
        if (whole) {
          float* frow = p.feat + row * 256;
          float nxt = acc[2 * h] + sb[cq];   // column 8j + cq, j = 0
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float a1 = acc[4 * j + 2 * h + 1] + sb[8 * j + cq + 1];
            const float a0n =
                j < 31 ? acc[4 * j + 4 + 2 * h] + sb[8 * j + 8 + cq]
                       : acc8[2 * h] + sb[256 + cq];
            const float right = __shfl_down_sync(0xffffffffu, nxt, 1, 4);
            const float first = __shfl_sync(0xffffffffu, a0n, 0, 4);
            *reinterpret_cast<float2*>(frow + 8 * j + cq) =
                make_float2(a1, cq < 6 ? right : first);
            nxt = a0n;
          }
        } else {
          float* frow = p.feat + (live ? row : 0) * (out - 1) - 1;
#pragma unroll
          for (int j = 0; j < 32; ++j)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int cc = 8 * j + cq + u;
              if (live && cc > 0 && cc < out)
                frow[cc] = acc[4 * j + 2 * h + u] + sb[cc];
            }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int cc = 256 + cq + u;
            if (live && cc < out) frow[cc] = acc8[2 * h + u] + sb[cc];
          }
        }
      }
    }
  }

  if constexpr (primal_only) {
    if constexpr (!value)
      for (int idx = lt; idx < WG_M * 3; idx += 128) {
        const long long row = n0 + idx / 3;
        if (row < n) p.grad[row * 3 + idx % 3] = 0.0f;
      }
    return;
  }

  // --- reverse sweep for ∇SDF; seed bar_h = W_last[:, 0] in acc ---
  for (int idx = lt; idx < WG_M * WG_EP; idx += 128) bar_e[idx] = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float v = seed[8 * j + cq + u];
      acc[4 * j + u] = v;
      acc[4 * j + 2 + u] = v;
    }
  float4 rg[2][8];
  bool pre = false;
  auto load_group = [&](const float* rl, int g, float4 (&r)[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      r[k] = k_rec ? *reinterpret_cast<const float4*>(
                         rl + ((8 * g + k) * 128 + lt) * 4)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  for (int l = L - 2; l >= 0; --l) {
    // G_l = rnd(bar_h ⊙ σ'(z_l)) into the A tile; the record the next
    // epilogue reads is prefetched under this layer's products
    const int out = net.out_dim[l], lim = out - cq;
    const float* recl = p.rec + (tile * (L - 1) + l) * WG_REC;
    if constexpr (k_mma) {
      // the record as 32 float4 loads a thread in groups of 8, two groups
      // ahead of their use: the first two issued before the products of
      // the layer above (under them), the others as a group is used. One
      // at a time, as the register allocator otherwise issues them, each
      // load waits out its own trip to device memory.
      if (!pre) {
        load_group(recl, 0, rg[0]);
        load_group(recl, 1, rg[1]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = 8 * g + k;
          const float4 r = rg[g & 1][k];
          const float s4[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pp = r0 + 8 * h, c = 8 * j + cq;
            float v[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int idx = 4 * j + 2 * h + u;
              const float s = k_rec ? s4[2 * h + u] : acc[idx];
              v[u] = 8 * j + u < lim ? acc[idx] * s : 0.0f;
            }
            wg_put2(X, pp, c, v[0], v[1]);
          }
        }
        if (g < 2) load_group(recl, g + 2, rg[g & 1]);
      }
      rnb_fence_proxy_async();
    }
    rnb_wg_sync(bar_id);
    if (l == 0) break;   // layer 0's product: N = 48, below
    if (k_rec && lt == 0) rnb_prefetch_l2(recl - WG_REC, WG_REC * 4);
    if constexpr (k_mma) {   // the next epilogue's first 16 loads
      load_group(recl - WG_REC, 0, rg[0]);
      load_group(recl - WG_REC, 1, rg[1]);
      pre = true;
    }
    product(rnb_pad16(out) >> 4, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n256<0, 0>(acc, rnb_desc(X + t * 1024, 1024, 128),
                           rnb_desc(st, 128, 256), t > 0);
    });
    if (k_mma && net.skip[l]) {
      const int hd = net.hd[l], in = net.in_dim[l];
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int idx = 4 * j + 2 * h + u;
            const int pp = r0 + 8 * h, cc = 8 * j + cq + u;
            const float v = acc[idx] * inv_sqrt2;
            if (8 * j + u >= hd - cq && 8 * j + u < in - cq)
              bar_e[pp * WG_EP + cc - hd] += v;
            acc[idx] = 8 * j + u < hd - cq ? v : 0.0f;
          }
    }
  }
  {
    // layer 0's reverse product: N = 48, its PE channels
    float acc48[24];
    product(rnb_pad16(net.out_dim[0]) >> 4, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n48<0, 0>(acc48, rnb_desc(X + t * 1024, 1024, 128),
                          rnb_desc(st, 128, 256), t > 0);
    });
    const int in = net.in_dim[0];
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int pp = r0 + 8 * h, cc = 8 * j + cq + u;
          if (k_mma && cc < in)
            bar_e[pp * WG_EP + cc] += acc48[4 * j + 2 * h + u];
        }
  }
  rnb_wg_sync(bar_id);

  // grad_d = Σ_c bar_e[c] ∂e_c/∂u_d, the PE's (s, c) recomputed
  for (int idx = lt; idx < WG_M * 3; idx += 128) {
    const int pp = idx / 3, d = idx % 3;
    const long long row = n0 + pp;
    if (row >= n) continue;
    const float* be = bar_e + pp * WG_EP;
    float g;
    if constexpr (MODE == SDF_NO_PE) {
      const float x = p.pts[row * 3];
      g = 0.0f;
      for (int c = 0; c < E; ++c) g += be[c] * x;
    } else {
      const float u = p.pts[row * 3 + d] * p.scale;
      float s = sinf(u), c = cosf(u), f = 1.0f;
      g = be[d];
      for (int k = 0; k < p.multires; ++k) {
        g += be[3 + 6 * k + d] * (f * c);
        g += be[6 + 6 * k + d] * (-f * s);
        if (k + 1 < p.multires) {
          const float s2 = 2.0f * s * c;
          c = 1.0f - 2.0f * s * s;
          s = s2;
        }
        f *= 2.0f;
      }
    }
    p.grad[row * 3 + d] = g;
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward sweep (sdf_bwd_sweep_kernel)
// ---------------------------------------------------------------------------
//
// Replaces the sweep of rnb_tpu/ops/pallas_sdf_core.py _bwd_kernel (:232):
// recompute the primal with the tangent slab T', seed bar_z = (c_sdf/scale,
// c_feat) and a unit tangent, sweep back; write the bf16 dW operand rows
// (abuf: every layer's inputs, bbuf: its rounded pre-activation
// cotangents; the dW products are dw_gemm.cu's) and the per-tile db sums of
// the unrounded cotangents.
//
// What bounds it on the H100: not the products (2.6e11 FLOP a call at
// 65,536 points, ~0.26 ms at 989 TFLOP/s) but what surrounds them. Split on
// one H100 (PERF.md §6): of the cp.async sweep's 3.20 ms, the f32
// record's 2.15 GB round trip cost 1.24 ms, the epilogue arithmetic 0.74,
// the dW operand rows 0.58, and the products alone ran 1.22 ms: every one
// of the block's 512 threads copied weights, and a block-wide barrier
// closed each of ~240 K-steps.
//
// What the design does about it:
//   * The weight ring is fed by TMA: a stage is one K-step of 16 rows x 256
//     columns of the bf16 weight image (8 KB), one 3-D box of its 8x8 cores
//     (forward {64, 32, 2}: two rows of cores; reverse {64, 2, 32}: two
//     columns of cores, the Wᵀ read), zeros past the layer's width (the box
//     runs off the map), completing on the stage's full mbarrier. Each
//     warp frees the stage it has finished on its empty mbarrier; one
//     thread refills a stage once all 16 warps freed it, half the ring
//     behind the step it is at (so it seldom waits on the slowest warp),
//     and with SW_RS = 16 eight stages are loaded ahead: the next layer's
//     first weights arrive during this one's epilogue. No thread but that
//     one copies, and the warpgroups meet only at the two barriers a layer
//     that the in-place epilogue needs.
//   * The reverse sweep's record (the layer's (zb, Tz), 128 KB a tile) is
//     brought into L2 by one bulk prefetch when the layer's products start,
//     so the epilogue's loads find it there.
//   * The tile and its sums are the cp.async sweep's: four warpgroups of 64
//     columns, primal and tangent slab on one B stage (2 x 32 f32
//     accumulators a thread), the same bf16 operands in the same K order,
//     column sums in the same order: the same bits.
// What did not fit or did not pay (the H100, PERF.md §6): a
// producer warp beside the 16 consumer warps makes 17, which the SM
// allocates registers for as 20 (96 a thread: ptxas spilled 768 B; 120 a
// thread is refused at launch); two 64-point tiles a block (two consumer
// warpgroups of 128 columns a tile, primal and tangent as two passes so
// each layer is written over its input in place, one tile's epilogue under
// the other's products) spilled at 96 registers, streamed the weights
// twice and read the record twice (6.0 ms); two such blocks an SM (5.8 ms)
// the same. Recomputing (zb, Tz) in the reverse from abuf needs a second
// accumulator set or 64 KB more shared memory a tile; a bf16 record would
// change the function (the 100·s(1−s) term). The dW rows as TMA stores
// (3.03 ms) and stages of two K-steps (2.87 ms) ran slower than this
// design (2.71-2.74 ms); half the weight loads moved nothing: the sweep
// does not wait on L2. What bounds this sweep: its K loops alone, with no
// product and no epilogue, take 0.86 ms of its ~2.7 (the stage handshake,
// ~0.8 µs a stage of a tile), the products ~0.55 more, the record's loads
// ~0.68 (PERF.md §6-7).

#define SW_RS 16                          // the production ring depth
#define SW_NT (WG_BWG * 128)              // threads: four warpgroups
#define SW_STAGE 8192                     // bytes of a ring stage

// The backward sweep's timing split (tools/ablate_kernel.py --bwd; the tune
// library only): each strips one part and keeps the rest.
enum SdfBwdSplit {
  BWD_FULL = 0,           // the production sweep
  BWD_NO_RECORD = 1,      // no record stores or loads
  BWD_NO_EPILOGUE = 2,    // no softplus / sigmoid arithmetic (zb passed on)
  BWD_NO_ROWS = 3,        // no abuf / bbuf rows
  BWD_PRODUCTS_ONLY = 4   // none of the three
};

// The launch's arguments in kernel parameter space (__grid_constant__: the
// tensor maps must lie in parameter, constant or global memory).
struct SdfSweepParams {
  RnbWgNet net;
  const float* pts;
  const float* b;
  const float* csdf;
  const float* cfeat;
  const float* cgrad;
  float* rec_z;
  float* rec_t;
  rnb_bf16* abuf;
  rnb_bf16* bbuf;
  float* dbp;
  long long n;
  int db_len, multires;
  float scale, c16;
  CUtensorMap wf[RNB_MAXL];  // layer l's image as [kpc][npc][64]: forward box
  CUtensorMap wr[RNB_MAXL];  // the same, reverse box
};

template <int RS>
__host__ __device__ constexpr int sw_smem_bytes() {
  return (int)sizeof(rnb_bf16) * (2 * WG_M * WG_TW + 2 * WG_M * WG_EP) +
         RS * SW_STAGE + (int)sizeof(float) * 4 * 256 + 2 * RS * 8;
}

// The ring's stages in the order the products take them: the forward
// layers 0..L-2, pad16(in)/16 K-steps each, then the reverse layers
// L-1..1, pad16(out)/16 each (ops/sdf_core.py sweep_steps). issue() loads
// the next one into a stage.
struct SwCursor {
  int l = 0, t = 0, rev = 0;
  __device__ __forceinline__ bool done() const { return rev && l < 1; }
  __device__ __forceinline__ void issue(const SdfSweepParams& p,
                                        unsigned char* st, uint64_t* bar) {
    const RnbWgNet& net = p.net;
    const int nk = rnb_pad16(rev ? net.out_dim[l] : net.in_dim[l]) >> 4;
    rnb_mbar_expect_tx(bar, SW_STAGE);
    if (rev) rnb_tma_load_3d(st, &p.wr[l], bar, 0, 2 * t, 0);
    else rnb_tma_load_3d(st, &p.wf[l], bar, 0, 0, 2 * t);
    if (++t < nk) return;
    t = 0;
    if (rev) --l;
    else if (++l == net.n_layers - 1) rev = 1;
  }
};

// Stage `it` done by this warp (its products retired): free it; thread 0
// refills the stage of step it - (RS/2 - 1), whose frees by all 16 warps
// are then done or near, with that step + RS, so it seldom waits on the
// slowest warp, and RS/2 stages stay loaded ahead.
template <int RS>
__device__ __forceinline__ void sw_free(const SdfSweepParams& p,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, SwCursor& cur,
                                        int it) {
  constexpr int LAG = RS / 2 - 1;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) rnb_mbar_arrive(&empty[it % RS]);
  const int k = it - LAG;
  if (threadIdx.x == 0 && k >= 0 && !cur.done()) {
    rnb_mbar_wait(&empty[k % RS], (k / RS) & 1);
    cur.issue(p, ring + (k % RS) * SW_STAGE, &full[k % RS]);
  }
  __syncwarp();
}

// One product: (acc, tacc) = (H, T) · B over nk stages of the ring, for
// warpgroup wg's 64 columns. Forward: B MN-major from a stage of cores (kb,
// ob) at (kb·32 + ob)·64 (LBO 4 KB, SBO 128 B); reverse: B K-major (Wᵀ)
// from cores (ib, kb) at (ib·2 + kb)·64 (LBO 128 B, SBO 256 B). One wgmma
// group stays in flight; a stage is freed once its products retired.
// (Three groups in flight deadlocked a card test once, cause not found.)
template <int RS, bool REV>
__device__ __forceinline__ void sw_product(float (&acc)[32],
                                           float (&tacc)[32],
                                           const rnb_bf16* H,
                                           const rnb_bf16* T,
                                           const SdfSweepParams& p,
                                           unsigned char* ring,
                                           uint64_t* full, uint64_t* empty,
                                           SwCursor& cur, int& it, int nk,
                                           int wg) {
  for (int t = 0; t < nk; ++t, ++it) {
    const int s = it % RS;
    rnb_mbar_wait(&full[s], (it / RS) & 1);
    const rnb_bf16* st =
        reinterpret_cast<const rnb_bf16*>(ring + s * SW_STAGE);
    const uint64_t db = REV ? rnb_desc(st + wg * 8 * 128, 128, 256)
                            : rnb_desc(st + wg * 8 * 64, 32 * 128, 128);
    rnb_wgmma_fence();
    if constexpr (REV) {
      rnb_wgmma_n64<0, 0>(acc, rnb_desc(H + t * 1024, 1024, 128), db, t > 0);
      rnb_wgmma_n64<0, 0>(tacc, rnb_desc(T + t * 1024, 1024, 128), db, t > 0);
    } else {
      rnb_wgmma_n64<0, 1>(acc, rnb_desc(H + t * 1024, 1024, 128), db, t > 0);
      rnb_wgmma_n64<0, 1>(tacc, rnb_desc(T + t * 1024, 1024, 128), db, t > 0);
    }
    rnb_wgmma_commit();
    rnb_wgmma_wait<1>();
    if (t > 0) sw_free<RS>(p, ring, full, empty, cur, it - 1);
  }
  rnb_wgmma_wait<0>();
  sw_free<RS>(p, ring, full, empty, cur, it - 1);
}

// 16-byte rows of a tile pair (primal, tangent) to the dW scratch: row p of
// the tile to rows n0 + p and n + n0 + p of a [2n, ld] bf16 buffer.
__device__ __forceinline__ void wg_rows_out(const rnb_bf16* Ta,
                                            const rnb_bf16* Tb, int ld,
                                            long long n0, long long n,
                                            rnb_bf16* dst) {
  const int kb_n = ld >> 3;
  for (int q = threadIdx.x; q < 2 * WG_M * kb_n; q += blockDim.x) {
    const int s = q / (WG_M * kb_n), rem = q - s * WG_M * kb_n;
    const int p = rem / kb_n, kb = rem - p * kb_n;
    const long long row = n0 + p;
    if (row >= n) continue;
    const rnb_bf16* src = (s ? Tb : Ta) + (kb * 8 + (p >> 3)) * 64 + (p & 7) * 8;
    *reinterpret_cast<uint4*>(dst + (s * n + row) * ld + kb * 8) =
        *reinterpret_cast<const uint4*>(src);
  }
}

// RS: the ring's stages (SW_RS in production; the tune library's instances
// take 3-6). SPLIT: an SdfBwdSplit (BWD_FULL in production).
template <int RS, int SPLIT = BWD_FULL>
static __global__ void __launch_bounds__(SW_NT, 1)
sdf_bwd_sweep_kernel(const __grid_constant__ SdfSweepParams p) {
  static_assert(RS >= 2, "a stage is refilled once all warps freed it");
  constexpr int NW = 256 / WG_BWG;  // columns a warpgroup
  constexpr bool k_rec = SPLIT != BWD_NO_RECORD && SPLIT != BWD_PRODUCTS_ONLY;
  constexpr bool k_epi =
      SPLIT != BWD_NO_EPILOGUE && SPLIT != BWD_PRODUCTS_ONLY;
  constexpr bool k_rows = SPLIT != BWD_NO_ROWS && SPLIT != BWD_PRODUCTS_ONLY;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  rnb_bf16* H = reinterpret_cast<rnb_bf16*>(wg_smem);  // primal tile [64][272]
  rnb_bf16* T = H + WG_M * WG_TW;                      // tangent tile
  unsigned char* ring = reinterpret_cast<unsigned char*>(T + WG_M * WG_TW);
  rnb_bf16* e16 = reinterpret_cast<rnb_bf16*>(ring + RS * SW_STAGE);
  rnb_bf16* t16 = e16 + WG_M * WG_EP;                  // [64][WG_EP]
  float* red = reinterpret_cast<float*>(t16 + WG_M * WG_EP);  // [4][256]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 4 * 256);
  uint64_t* empty = full + RS;
  const RnbWgNet& net = p.net;
  WG_FRAG_ROWS;
  const int tid = threadIdx.x, lane = lt & 31, warp = lt >> 5;
  const long long tile = blockIdx.x, n0 = tile * WG_M, n = p.n;
  const int L = net.n_layers, E = net.E;
  const float inv_sqrt2 = 0.70710678118654752f, c16 = p.c16, scale = p.scale;
  float* dbt = p.dbp + tile * p.db_len;

  // the ring: barriers, then its first RS stages
  SwCursor cur;
  if (tid == 0) {
    for (int s = 0; s < RS; ++s) {
      rnb_mbar_init(&full[s], 1);
      rnb_mbar_init(&empty[s], SW_NT / 32);
    }
    rnb_fence_mbar_init();
    for (int s = 0; s < RS && !cur.done(); ++s)
      cur.issue(p, ring + s * SW_STAGE, &full[s]);
  }

  // --- PE and the directional tangent T' = Σ_d c_grad_d ∂e/∂u_d ---
  for (int idx = tid; idx < WG_M * 3; idx += SW_NT) {
    const int pp = idx / 3, d = idx % 3;
    const long long row = n0 + pp;
    const float u = row < n ? p.pts[row * 3 + d] * scale : 0.0f;
    const float cg = row < n ? p.cgrad[row * 3 + d] : 0.0f;
    rnb_bf16* e = e16 + pp * WG_EP;
    rnb_bf16* t = t16 + pp * WG_EP;
    e[d] = wg_bf(u);
    t[d] = wg_bf(cg);
    float s = sinf(u), c = cosf(u), f = 1.0f;
    for (int k = 0; k < p.multires; ++k) {
      e[3 + 6 * k + d] = wg_bf(s);
      e[6 + 6 * k + d] = wg_bf(c);
      t[3 + 6 * k + d] = wg_bf(cg * (f * c));
      t[6 + 6 * k + d] = wg_bf(cg * (-f * s));
      if (k + 1 < p.multires) {
        const float s2 = 2.0f * s * c;
        c = 1.0f - 2.0f * s * s;
        s = s2;
      }
      f *= 2.0f;
    }
  }
  for (int idx = tid; idx < WG_M * (WG_EP - E); idx += SW_NT) {
    const int pp = idx / (WG_EP - E), c = E + idx % (WG_EP - E);
    e16[pp * WG_EP + c] = wg_bf(0.0f);
    t16[pp * WG_EP + c] = wg_bf(0.0f);
  }
  __syncthreads();
  for (int idx = tid; idx < WG_M * WG_EP; idx += SW_NT) {
    const int pp = idx / WG_EP, c = idx % WG_EP;
    H[wg_tidx(pp, c)] = e16[pp * WG_EP + c];
    T[wg_tidx(pp, c)] = t16[pp * WG_EP + c];
  }
  rnb_fence_proxy_async();
  __syncthreads();

  int it = 0;
  float acc[NW / 2], tacc[NW / 2];

  // --- recompute the primal with one tangent slab, recording (zb, Tz) and
  // writing the layer inputs (the A rows of dW) ---
  for (int l = 0; l < L; ++l) {
    if (k_rows)
      wg_rows_out(H, T, rnb_pad16(net.in_dim[l]), n0, n, p.abuf + net.a_off[l]);
    if (l == L - 1) break;
    sw_product<RS, false>(acc, tacc, H, T, p, ring, full, empty, cur, it,
                          rnb_pad16(net.in_dim[l]) >> 4, wg);
    __syncthreads();   // every warp's products (and rows) read H and T
    const int out = net.out_dim[l];
    const bool nskip = net.skip[l + 1] != 0;
    const float* bl = p.b + net.b_off[l];
    const long long roff = ((tile * (L - 1) + l) * WG_BWG + wg) * (WG_M * NW);
    float* rz = p.rec_z + roff;
    float* rt = p.rec_t + roff;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pp = r0 + 8 * h, c = wg * NW + 8 * j + cq;
        float hv2[2], tv2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int idx = 4 * j + 2 * h + u, cc = c + u;
          const float zb = acc[idx] + (cc < out ? bl[cc] : 0.0f);
          const float tz = tacc[idx];
          if (k_rec) {
            rz[idx * 128 + lt] = zb;
            rt[idx * 128 + lt] = tz;
          }
          float s = 1.0f, hv = zb;
          if (k_epi) wg_softplus100_pair(zb, &s, &hv);
          const float tv = tz * s;
          if (cc < out) {
            hv2[u] = nskip ? wg_f(wg_bf(hv)) * c16 : hv;
            tv2[u] = nskip ? wg_f(wg_bf(tv)) * c16 : tv;
          } else if (nskip && cc < out + E) {
            hv2[u] = wg_f(e16[pp * WG_EP + cc - out]) * c16;
            tv2[u] = wg_f(t16[pp * WG_EP + cc - out]) * c16;
          } else {
            hv2[u] = 0.0f;
            tv2[u] = 0.0f;
          }
        }
        wg_put2(H, pp, c, hv2[0], hv2[1]);
        wg_put2(T, pp, c, tv2[0], tv2[1]);
      }
    rnb_fence_proxy_async();
    __syncthreads();   // the layer's output is the next products' operand
  }
  __syncthreads();

  // --- reverse sweep: seed bar_z = (c_sdf/scale, c_feat), unit tangent ---
  {
    const int out = net.out_dim[L - 1], kp = rnb_pad16(out);
    for (int idx = tid; idx < WG_M * kp; idx += SW_NT) {
      const int pp = idx / kp, j = idx % kp;
      const long long row = n0 + pp;
      float z = 0.0f;
      if (row < n && j < out)
        z = j == 0 ? p.csdf[row] / scale : p.cfeat[row * (out - 1) + j - 1];
      H[wg_tidx(pp, j)] = wg_bf(z);
      T[wg_tidx(pp, j)] = wg_bf(j == 0 ? 1.0f : 0.0f);
    }
    for (int j = tid; j < out; j += SW_NT) {
      float s = 0.0f;
      for (int pp = 0; pp < WG_M; ++pp) {
        const long long row = n0 + pp;
        if (row < n)
          s += j == 0 ? p.csdf[row] / scale : p.cfeat[row * (out - 1) + j - 1];
      }
      dbt[net.b_off[L - 1] + j] = s;
    }
  }
  rnb_fence_proxy_async();
  __syncthreads();
  for (int l = L - 1; l >= 1; --l) {
    const long long slab = (tile * (L - 1) + l - 1) * WG_BWG * (WG_M * NW);
    // the layer's record into L2 under the products (the epilogue reads it)
    if (k_rec && tid == 0) {
      rnb_prefetch_l2(p.rec_z + slab, WG_M * 256 * 4);
      rnb_prefetch_l2(p.rec_t + slab, WG_M * 256 * 4);
    }
    if (k_rows)
      wg_rows_out(H, T, rnb_pad16(net.out_dim[l]), n0, n,
                  p.bbuf + net.bb_off[l]);
    sw_product<RS, true>(acc, tacc, H, T, p, ring, full, empty, cur, it,
                         rnb_pad16(net.out_dim[l]) >> 4, wg);
    __syncthreads();   // every warp's products (and rows) read H and T
    const int hd = net.skip[l] ? net.hd[l] : net.in_dim[l];
    const float sc = net.skip[l] ? inv_sqrt2 : 1.0f;
    const int outp = net.out_dim[l - 1];
    const float* rz = p.rec_z + slab + wg * (WG_M * NW);
    const float* rt = p.rec_t + slab + wg * (WG_M * NW);
    float cs[NW / 4];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      cs[2 * j] = 0.0f;
      cs[2 * j + 1] = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pp = r0 + 8 * h, c = wg * NW + 8 * j + cq;
        const bool live = n0 + pp < n;
        float zn2[2], tn2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int idx = 4 * j + 2 * h + u;
          float zn = 0.0f, tn = 0.0f;
          if (c + u < hd) {
            const float bh = acc[idx] * sc, bth = tacc[idx] * sc;
            const float zp = k_rec ? rz[idx * 128 + lt] : bh;
            const float tzp = k_rec ? rt[idx * 128 + lt] : bth;
            if (k_epi) {
              const float s = wg_sigmoid100(zp);
              zn = bh * s + (bth * tzp) * (100.0f * s * (1.0f - s));
              tn = bth * s;
            } else {
              zn = k_rec ? fmaf(zp, tzp, bh) : bh;
              tn = bth;
            }
          }
          if (live) cs[2 * j + u] += zn;
          zn2[u] = zn;
          tn2[u] = tn;
        }
        wg_put2(H, pp, c, zn2[0], zn2[1]);
        wg_put2(T, pp, c, tn2[0], tn2[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      float v = cs[i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      cs[i] = v;
    }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          red[warp * 256 + wg * NW + 8 * j + cq + u] = cs[2 * j + u];
    }
    rnb_fence_proxy_async();
    __syncthreads();   // bar_z, bar_T': the next products' operands; red
    if (tid < outp)
      dbt[net.b_off[l - 1] + tid] =
          ((red[tid] + red[256 + tid]) + red[512 + tid]) + red[768 + tid];
  }
  if (k_rows)
    wg_rows_out(H, T, rnb_pad16(net.out_dim[0]), n0, n,
                p.bbuf + net.bb_off[0]);
}

// ---------------------------------------------------------------------------
// host side of the bf16 route
// ---------------------------------------------------------------------------

static int rnb_make_wg_net(RnbWgNet* net, const int* in_dims,
                           const int* out_dims, const int* skip, const int* hd,
                           const long long* w_off, const long long* a_off,
                           const long long* bb_off, int n_layers) {
  if (n_layers < 2 || n_layers > RNB_MAXL) return 1;
  net->n_layers = n_layers;
  net->E = in_dims[0];
  if (net->E > WG_EP || skip[0] || skip[n_layers - 1]) return 1;
  int boff = 0;
  for (int l = 0; l < n_layers; ++l) {
    net->in_dim[l] = in_dims[l];
    net->out_dim[l] = out_dims[l];
    net->skip[l] = skip[l];
    net->hd[l] = hd[l];
    net->w_off[l] = w_off[l];
    net->a_off[l] = a_off ? a_off[l] : 0;
    net->bb_off[l] = bb_off ? bb_off[l] : 0;
    net->b_off[l] = boff;
    boff += out_dims[l];
    if (in_dims[l] > 256 || out_dims[l] > (l + 1 < n_layers ? 256 : 264))
      return 1;
    if (w_off[l] % 8) return 1;
    if (skip[l] && (hd[l] != out_dims[l - 1] || hd[l] + net->E != in_dims[l]))
      return 1;
    if (!skip[l] && l > 0 && in_dims[l] != out_dims[l - 1]) return 1;
  }
  return 0;
}

// Layer l's tile in the weight image w ([kpc][npc][64] bf16: 8x8 cores,
// core (i/8, o/8) at ((i/8)·npc + o/8)·64) as a 3-D tensor map whose box
// is `box`; elements past the tile read as zero. 0 on success.
static int sdf_layer_map(CUtensorMap* map, const void* w, long long w_off,
                         int in, int out, const int box[3]) {
  const long long npc = rnb_pad16(out) >> 3, kpc = rnb_pad16(in) >> 3;
  const long long dims[3] = {64, npc, kpc}, strides[2] = {128, npc * 128};
  return rnb_tma_map_bf16_3d(map, static_cast<const rnb_bf16*>(w) + w_off,
                             dims, strides, box);
}

// The forward's arguments: the net, the buffers, and each layer's two
// tensor maps (forward box {64, 32, 2}, {64, 33, 2} at the head: its
// column 256 and zeros past it; reverse box {64, 2, 32}, {64, 2, 6} at
// layer 0).
static int sdf_fwd_params(SdfFwdParams* p, const float* pts, long long n,
                          const void* w, const float* b, const int* in_dims,
                          const int* out_dims, const int* skip, const int* hd,
                          const long long* w_off, int n_layers, int multires,
                          float scale, float c16, float* rec, float* sdf,
                          float* feat, float* grad) {
  if (rnb_make_wg_net(&p->net, in_dims, out_dims, skip, hd, w_off, nullptr,
                      nullptr, n_layers) ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  p->pts = pts;
  p->w = static_cast<const rnb_bf16*>(w);
  p->b = b;
  p->rec = rec;
  p->sdf = sdf;
  p->feat = feat;
  p->grad = grad;
  p->n = n;
  p->multires = multires;
  p->scale = scale;
  p->c16 = c16;
  for (int l = 0; l < n_layers; ++l) {
    const int fwd_box[3] = {64, l == n_layers - 1 ? 33 : 32, 2};
    const int rev_box[3] = {64, 2, l == 0 ? WG_EP / 8 : 32};
    int rc = sdf_layer_map(&p->wf[l], w, w_off[l], in_dims[l], out_dims[l],
                           fwd_box);
    if (!rc)
      rc = sdf_layer_map(&p->wr[l], w, w_off[l], in_dims[l], out_dims[l],
                         rev_box);
    if (rc) return rc;
  }
  return 0;
}

// One launch a pair of 64-point tiles.
template <int MODE, int RS = SF_RS, int SPLIT = FWD_FULL>
static int sdf_fwd_wg_launch(const SdfFwdParams& p, cudaStream_t st) {
  constexpr int smem = sf_smem_bytes<RS>();
  cudaError_t err = cudaFuncSetAttribute(
      sdf_fwd_wg_kernel<MODE, RS, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.n + WG_M - 1) / WG_M;
  sdf_fwd_wg_kernel<MODE, RS, SPLIT>
      <<<(unsigned)((tiles + 1) / 2), SF_NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

#define RNB_WG_FWD_PARAMS                                                   \
  const float *pts, long long n, const void *w, const float *b,             \
      const int *in_dims, const int *out_dims, const int *skip,             \
      const int *hd, const long long *w_off, int n_layers, int multires,    \
      float scale, float c16, float *rec, float *sdf, float *feat,          \
      float *grad, void *stream
#define RNB_WG_FWD_SETUP                                                     \
  SdfFwdParams prm;                                                          \
  const int rc = sdf_fwd_params(&prm, pts, n, w, b, in_dims, out_dims, skip, \
                                hd, w_off, n_layers, multires, scale, c16,   \
                                rec, sdf, feat, grad);                       \
  if (rc) return rc;                                                         \
  cudaStream_t st = (cudaStream_t)stream

// The bf16 forward (mode: an SdfMode; SDF_FULL on the main path, SDF_VALUE
// in the up-sampling sweeps). rec holds ceil(n/64)·(n_layers-1)·64·256 floats
// (SDF_FULL, SDF_NO_PE, SDF_NO_ACT); SDF_VALUE reads neither rec nor feat
// nor grad, which may be null.
extern "C" int rnb_sdf_fwd_wg(int mode, RNB_WG_FWD_PARAMS) {
  RNB_WG_FWD_SETUP;
  switch (mode) {
    case SDF_FULL: return sdf_fwd_wg_launch<SDF_FULL>(prm, st);
    case SDF_NO_PE: return sdf_fwd_wg_launch<SDF_NO_PE>(prm, st);
    case SDF_NO_ACT: return sdf_fwd_wg_launch<SDF_NO_ACT>(prm, st);
    case SDF_PRIMAL_ONLY: return sdf_fwd_wg_launch<SDF_PRIMAL_ONLY>(prm, st);
    case SDF_VALUE: return sdf_fwd_wg_launch<SDF_VALUE>(prm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward sweep's arguments: the net, the buffers, and for each layer
// the two tensor maps of its tile in the weight image w (sdf_layer_map).
// 0 on success.
static int sdf_sweep_params(SdfSweepParams* p, const float* pts, long long n,
                            const void* w, const float* b, const int* in_dims,
                            const int* out_dims, const int* skip,
                            const int* hd, const long long* w_off,
                            const long long* a_off, const long long* bb_off,
                            int n_layers, int multires, float scale, float c16,
                            const float* csdf, const float* cfeat,
                            const float* cgrad, float* rec_z, float* rec_t,
                            void* abuf, void* bbuf, float* dbp) {
  if (rnb_make_wg_net(&p->net, in_dims, out_dims, skip, hd, w_off, a_off,
                      bb_off, n_layers) ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  p->pts = pts;
  p->b = b;
  p->csdf = csdf;
  p->cfeat = cfeat;
  p->cgrad = cgrad;
  p->rec_z = rec_z;
  p->rec_t = rec_t;
  p->abuf = static_cast<rnb_bf16*>(abuf);
  p->bbuf = static_cast<rnb_bf16*>(bbuf);
  p->dbp = dbp;
  p->n = n;
  p->multires = multires;
  p->scale = scale;
  p->c16 = c16;
  p->db_len = 0;
  const int fwd_box[3] = {64, 32, 2}, rev_box[3] = {64, 2, 32};
  for (int l = 0; l < n_layers; ++l) {
    p->db_len += out_dims[l];
    int rc = sdf_layer_map(&p->wf[l], w, w_off[l], in_dims[l], out_dims[l],
                           fwd_box);
    if (!rc)
      rc = sdf_layer_map(&p->wr[l], w, w_off[l], in_dims[l], out_dims[l],
                         rev_box);
    if (rc) return rc;
  }
  return 0;
}

// The sweep at ring depth RS, then the fixed-order sum of the per-tile db
// partials (dbp) into db.
template <int RS, int SPLIT = BWD_FULL>
static int sdf_bwd_sweep_launch(const SdfSweepParams& p, float* db,
                                cudaStream_t st) {
  constexpr int smem = sw_smem_bytes<RS>();
  cudaError_t err = cudaFuncSetAttribute(
      sdf_bwd_sweep_kernel<RS, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.n + WG_M - 1) / WG_M;
  sdf_bwd_sweep_kernel<RS, SPLIT><<<(unsigned)tiles, SW_NT, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rnb_sum_splits_kernel<<<(unsigned)((p.db_len + 255) / 256), 256, 0, st>>>(
      p.dbp, (int)tiles, p.db_len, db);
  return (int)cudaGetLastError();
}

#define RNB_WG_BWD_PARAMS                                                   \
  const float *pts, long long n, const void *w, const float *b,             \
      const int *in_dims, const int *out_dims, const int *skip,             \
      const int *hd, const long long *w_off, const long long *a_off,        \
      const long long *bb_off, int n_layers, int multires, float scale,     \
      float c16, const float *csdf, const float *cfeat, const float *cgrad, \
      float *rec_z, float *rec_t, void *abuf, void *bbuf, float *dbp,       \
      float *db, void *stream
#define RNB_WG_BWD_SETUP                                                     \
  SdfSweepParams prm;                                                        \
  const int rc = sdf_sweep_params(                                           \
      &prm, pts, n, w, b, in_dims, out_dims, skip, hd, w_off, a_off, bb_off, \
      n_layers, multires, scale, c16, csdf, cfeat, cgrad, rec_z, rec_t,      \
      abuf, bbuf, dbp);                                                      \
  if (rc) return rc;                                                         \
  cudaStream_t st = (cudaStream_t)stream

// The bf16 backward sweep: fills the bf16 dW scratch (A rows at a_off, B
// rows at bb_off, 2n rows of pad16(width) each) and writes db; the wrapper
// then runs rnb_dw_products (dw_gemm.cu) over all layers. rec_z / rec_t as
// rec of rnb_sdf_fwd_wg; dbp holds ceil(n/64)·Σ out floats.
extern "C" int rnb_sdf_bwd_wg(RNB_WG_BWD_PARAMS) {
  RNB_WG_BWD_SETUP;
  return sdf_bwd_sweep_launch<SW_RS>(prm, db, st);
}

// The tile sweep's instances (rnb_tpu_torch/tools/tune_kernel.py): the
// production forward at ring depths 4, 8, 12 and 16 and the production
// backward sweep at 3-6, SDF_FULL; the timing splits of both; the
// forward's record hints. They are built only into the tune library
// (ops/_build.py library("tune"), nvcc -DRNB_TUNE); the production library
// holds the SF_RS forward and the SW_RS backward sweep alone. The
// forward's deepest ring, 16 stages, is its production depth (225,552 B
// of shared memory; 17 would pass the SM's 232,448); the backward sweep's
// depth 6 takes 122,944 B. Another depth returns cudaErrorInvalidValue.
#ifdef RNB_TUNE
#define RNB_TUNE_CASES(CALL) \
  case 3: return CALL(3);    \
  case 4: return CALL(4);    \
  case 5: return CALL(5);    \
  case 6: return CALL(6);

// rnb_sdf_fwd_wg's arguments but the mode (SDF_FULL), after the depth rs.
extern "C" int rnb_sdf_fwd_wg_tune(int rs, RNB_WG_FWD_PARAMS) {
  RNB_WG_FWD_SETUP;
  switch (rs) {
    case 4: return sdf_fwd_wg_launch<SDF_FULL, 4>(prm, st);
    case 8: return sdf_fwd_wg_launch<SDF_FULL, 8>(prm, st);
    case 12: return sdf_fwd_wg_launch<SDF_FULL, 12>(prm, st);
    case 16: return sdf_fwd_wg_launch<SDF_FULL, 16>(prm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The forward's timing split (tools/ablate_kernel.py --fwd_split): split an
// SdfFwdSplit, SDF_FULL, at the production depth; only FWD_FULL computes
// the function. rnb_sdf_fwd_wg's arguments after the split.
extern "C" int rnb_sdf_fwd_wg_split(int split, RNB_WG_FWD_PARAMS) {
  RNB_WG_FWD_SETUP;
  switch (split) {
    case FWD_FULL: return sdf_fwd_wg_launch<SDF_FULL, SF_RS, FWD_FULL>(prm, st);
    case FWD_NO_RECORD:
      return sdf_fwd_wg_launch<SDF_FULL, SF_RS, FWD_NO_RECORD>(prm, st);
    case FWD_NO_EPILOGUE:
      return sdf_fwd_wg_launch<SDF_FULL, SF_RS, FWD_NO_EPILOGUE>(prm, st);
    case FWD_K_LOOPS_ONLY:
      return sdf_fwd_wg_launch<SDF_FULL, SF_RS, FWD_K_LOOPS_ONLY>(prm, st);
    case FWD_PRODUCTS_ONLY:
      return sdf_fwd_wg_launch<SDF_FULL, SF_RS, FWD_PRODUCTS_ONLY>(prm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// rnb_sdf_bwd_wg's arguments after the depth rs.
extern "C" int rnb_sdf_bwd_wg_tune(int rs, RNB_WG_BWD_PARAMS) {
  RNB_WG_BWD_SETUP;
#define RNB_BWD_AT(RS) sdf_bwd_sweep_launch<RS>(prm, db, st)
  switch (rs) {
    RNB_TUNE_CASES(RNB_BWD_AT)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RNB_BWD_AT
}

// The backward sweep's timing split (tools/ablate_kernel.py --bwd): mode an
// SdfBwdSplit, at the production depth; only BWD_FULL computes the
// function. rnb_sdf_bwd_wg's arguments after the mode.
extern "C" int rnb_sdf_bwd_wg_split(int mode, RNB_WG_BWD_PARAMS) {
  RNB_WG_BWD_SETUP;
  switch (mode) {
    case BWD_FULL: return sdf_bwd_sweep_launch<SW_RS, BWD_FULL>(prm, db, st);
    case BWD_NO_RECORD:
      return sdf_bwd_sweep_launch<SW_RS, BWD_NO_RECORD>(prm, db, st);
    case BWD_NO_EPILOGUE:
      return sdf_bwd_sweep_launch<SW_RS, BWD_NO_EPILOGUE>(prm, db, st);
    case BWD_NO_ROWS:
      return sdf_bwd_sweep_launch<SW_RS, BWD_NO_ROWS>(prm, db, st);
    case BWD_PRODUCTS_ONLY:
      return sdf_bwd_sweep_launch<SW_RS, BWD_PRODUCTS_ONLY>(prm, db, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#undef RNB_TUNE_CASES
#endif  // RNB_TUNE

extern "C" const char* rnb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
