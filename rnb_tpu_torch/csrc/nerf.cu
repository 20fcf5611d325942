// The fused background NeRF (NeRF++ inverted-sphere net) for Hopper
// (sm_90a), and its VJP over the parameters only.
//
// Replaces rnb_tpu/ops/pallas_nerf.py: _fwd_kernel (:105) and _bwd_kernel
// (:122). Same algorithm (layers 0..D-1 trunk, D alpha, D+1 feature,
// D+2 views, D+3 rgb):
//   forward   e = PE(pts), v = PE(views) by the double-angle recurrence;
//             x_0 = e; z_i = x_i W_i + b_i; h_i = relu(z_i);
//             x_{i+1} = [e, h_i] if i in skips (PE first, unscaled) else h_i;
//             alpha = h W_a + b_a; feat = h W_f + b_f;
//             z_v = [feat, v] W_v + b_v; rgb = relu(z_v) W_rgb + b_rgb.
//             The heads are raw: softplus and sigmoid stay in the renderer.
//   backward  pts and views get no cotangent (sample points and view
//             directions never need one).
//             bar_z_v = (c_rgb W_rgbᵀ) ⊙ [z_v > 0];
//             bar_feat = (bar_z_v W_vᵀ)[:, :W]  (the PE(views) slice dropped);
//             bar_h = bar_feat W_fᵀ + c_alpha W_aᵀ;
//             bar_z_i = bar_h_i ⊙ [z_i > 0]; bar_h_{i-1} = bar_z_i W_iᵀ minus
//             its PE slice where i-1 in skips;
//             dW_l = x_lᵀ rnd(bar_z_l), db_l = Σ bar_z_l.
//
// What bounds it on the H100: arithmetic. At the womask conf a point costs
// ~0.60 M multiply-adds forward (8x256 trunk with an 84-wide PE and a
// 340-wide skip input, 256+1 heads, 283→128→3 views/rgb); the backward
// recomputes the forward, runs the reverse products (~0.55 M) and the dW
// reduction (~0.60 M). The f32 routes of both run on the CUDA cores in
// fp32, one thread per output column as the other CUDA-core sweep kernels
// do; the 1- and 3-wide heads leave most threads of their pass idle. The
// f32 backward records the layer inputs (A rows), the
// pre-activation cotangents (B rows) and the ReLU pre-activations in global
// scratch written and read by the same block; the split-K kernels of
// common.cuh reduce dW and db across points.
//
// Two routes each, chosen by the op dtype (ops/nerf.py), never by failure:
// bf16 (the training step's) nerf_fwd_wg_kernel and nerf_bwd_wg_kernel on
// the tensor cores, designed below; f32 (the f32 comparisons)
// nerf_fwd_kernel and nerf_bwd_kernel.
#include "common.cuh"

// [x, sin(f0 x), cos(f0 x), ...] of channel d of a C-channel input, by the
// double-angle recurrence, into row e.
__device__ __forceinline__ void nerf_pe(float x, int d, int C, int multires,
                                        float* e) {
  e[d] = x;
  float s = sinf(x), c = cosf(x);
  for (int k = 0; k < multires; ++k) {
    e[C * (1 + 2 * k) + d] = s;
    e[C * (2 + 2 * k) + d] = c;
    if (k + 1 < multires) {
      const float s2 = 2.0f * s * c;
      c = 1.0f - 2.0f * s * s;
      s = s2;
    }
  }
}

// PE(pts) of the tile into sE [P][LDE], PE(views) into sV [P][LDV]
__device__ __forceinline__ void nerf_inputs(
    const float* __restrict__ pts, const float* __restrict__ views,
    long long n, int C, int multires, int multires_view, long long n0,
    int LDE, int LDV, float* sE, float* sV) {
  constexpr int P = RNB_P;
  for (int idx = threadIdx.x; idx < P * C; idx += blockDim.x) {
    const int p = idx / C, d = idx % C;
    const long long row = n0 + p;
    nerf_pe(row < n ? pts[row * C + d] : 0.0f, d, C, multires, sE + p * LDE);
  }
  for (int idx = threadIdx.x; idx < P * 3; idx += blockDim.x) {
    const int p = idx / 3, d = idx % 3;
    const long long row = n0 + p;
    nerf_pe(row < n ? views[row * 3 + d] : 0.0f, d, 3, multires_view,
            sV + p * LDV);
  }
  __syncthreads();
}

// the tile's rows of X (width w) into the A rows of one layer
__device__ __forceinline__ void nerf_store_rows(const float* X, int LD, int w,
                                                long long n0, long long n,
                                                float* __restrict__ A) {
  for (int idx = threadIdx.x; idx < RNB_P * w; idx += blockDim.x) {
    const int p = idx / w, i = idx % w;
    const long long row = n0 + p;
    if (row < n) A[row * w + i] = X[p * LD + i];
  }
}

// The trunk and the heads up to hv = rnd(relu(z_v)) for one tile; returns
// the buffer (bufA or bufB) that holds hv. RECORD (the backward): the layer
// inputs go to the A rows, the trunk and views pre-activations to rec.
// Otherwise (the forward) the alpha head goes to `alpha`.
template <bool RECORD>
__device__ __forceinline__ float* nerf_primal(
    const float* __restrict__ w, const float* __restrict__ b,
    const RnbNet& net, unsigned skips, const float* sE, int LDE,
    const float* sV, int LDV, long long n0, long long n, float* bufA,
    float* bufB, float* __restrict__ rec, int rec_ld,
    float* __restrict__ abuf, float* __restrict__ alpha) {
  constexpr int P = RNB_P;
  const int tid = threadIdx.x, LD = net.ld;
  const int D = net.n_layers - 4;
  const int E = net.in_dim[0];
  const float* hin = sE;
  int ldin = LDE;
  float* dst = bufA;
  for (int i = 0; i < D; ++i) {
    const int in = net.in_dim[i], out = net.out_dim[i];
    if (RECORD) nerf_store_rows(hin, ldin, in, n0, n, abuf + net.a_off[i]);
    const int off = ((skips >> i) & 1u) ? E : 0;  // [e, h] after a skip
    for (int idx = tid; idx < P * off; idx += blockDim.x) {
      const int p = idx / off, k = idx % off;
      dst[p * LD + k] = sE[p * LDE + k];
    }
    const float* W = w + net.w_off[i];
    const float* bl = b + net.b_off[i];
    for (int c = tid; c < out; c += blockDim.x) {
      float acc[P];
      rnb_dot_col<P>(hin, ldin, in, W, out, c, acc);
      const float bc = bl[c];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float z = acc[p] + bc;
        if (RECORD) {
          const long long row = n0 + p;
          if (row < n) rec[((long long)i * n + row) * rec_ld + c] = z;
        }
        dst[p * LD + off + c] = fmaxf(z, 0.0f);
      }
    }
    __syncthreads();
    hin = dst;
    ldin = LD;
    dst = dst == bufA ? bufB : bufA;
  }

  // heads: h2 = [rnd(feat), PE(views)] into the free buffer; alpha (forward)
  const int la = D, lf = D + 1, lv = D + 2;
  const int oa = net.out_dim[la], of = net.out_dim[lf], ov = net.out_dim[lv];
  const int V = net.in_dim[lv] - of;
  float* h = dst == bufA ? bufB : bufA;  // the trunk output
  float* h2 = dst;
  if (RECORD) {
    nerf_store_rows(h, LD, net.in_dim[la], n0, n, abuf + net.a_off[la]);
    nerf_store_rows(h, LD, net.in_dim[lf], n0, n, abuf + net.a_off[lf]);
  }
  for (int idx = tid; idx < P * V; idx += blockDim.x) {
    const int p = idx / V, k = idx % V;
    h2[p * LD + of + k] = sV[p * LDV + k];
  }
  const int ncol = RECORD ? of : of + oa;
  for (int c = tid; c < ncol; c += blockDim.x) {
    float acc[P];
    if (c < of) {
      rnb_dot_col<P>(h, LD, net.in_dim[lf], w + net.w_off[lf], of, c, acc);
      const float bc = b[net.b_off[lf] + c];
#pragma unroll
      for (int p = 0; p < P; ++p) h2[p * LD + c] = acc[p] + bc;
    } else {
      const int ca = c - of;
      rnb_dot_col<P>(h, LD, net.in_dim[la], w + net.w_off[la], oa, ca, acc);
      const float bc = b[net.b_off[la] + ca];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long row = n0 + p;
        if (row < n) alpha[row * oa + ca] = acc[p] + bc;
      }
    }
  }
  __syncthreads();

  // views layer; hv overwrites the trunk output
  if (RECORD) nerf_store_rows(h2, LD, net.in_dim[lv], n0, n, abuf + net.a_off[lv]);
  for (int c = tid; c < ov; c += blockDim.x) {
    float acc[P];
    rnb_dot_col<P>(h2, LD, net.in_dim[lv], w + net.w_off[lv], ov, c, acc);
    const float bc = b[net.b_off[lv] + c];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float z = acc[p] + bc;
      if (RECORD) {
        const long long row = n0 + p;
        if (row < n) rec[((long long)D * n + row) * rec_ld + c] = z;
      }
      h[p * LD + c] = fmaxf(z, 0.0f);
    }
  }
  __syncthreads();
  if (RECORD) nerf_store_rows(h, LD, ov, n0, n, abuf + net.a_off[lv + 1]);
  return h;
}

static __global__ void __launch_bounds__(RNB_NT)
nerf_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ views,
                long long n, int C, const float* __restrict__ w,
                const float* __restrict__ b, RnbNet net, unsigned skips,
                int multires, int multires_view, float* __restrict__ alpha,
                float* __restrict__ rgb) {
  constexpr int P = RNB_P;
  extern __shared__ __align__(16) float smem[];
  const int D = net.n_layers - 4;
  const int LD = net.ld;
  const int LDE = (net.in_dim[0] + 3) & ~3;
  const int LDV = (net.in_dim[D + 2] - net.out_dim[D + 1] + 3) & ~3;
  float* sE = smem;              // [P][LDE] PE(pts), op dtype
  float* sV = sE + P * LDE;      // [P][LDV] PE(views), op dtype
  float* bufA = sV + P * LDV;    // [P][LD]
  float* bufB = bufA + P * LD;   // [P][LD]
  const long long n0 = (long long)blockIdx.x * P;
  nerf_inputs(pts, views, n, C, multires, multires_view, n0, LDE, LDV, sE, sV);
  const float* hv = nerf_primal<false>(w, b, net, skips, sE, LDE, sV, LDV, n0,
                                       n, bufA, bufB, nullptr, 0, nullptr,
                                       alpha);
  const int lr = D + 3;
  const int orr = net.out_dim[lr];
  for (int c = threadIdx.x; c < orr; c += blockDim.x) {
    float acc[P];
    rnb_dot_col<P>(hv, LD, net.in_dim[lr], w + net.w_off[lr], orr, c, acc);
    const float bc = b[net.b_off[lr] + c];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long row = n0 + p;
      if (row < n) rgb[row * orr + c] = acc[p] + bc;
    }
  }
}

// One reverse product of a tile: for c < cols,
//   v[p] = Σ_j X[p][j] M[j][c0 + c]   (M rows of width C; X already rounded)
//   bar  = v ⊙ [rec[p][c] > 0]        (no mask where rec is null)
// then the B rows of the layer below get bar, and Y[p][yoff + c] = bar.
__device__ __forceinline__ void nerf_reverse(
    const float* X, int LD, int R, const float* __restrict__ M, int C, int c0,
    int cols, const float* __restrict__ rec, int rec_ld, long long n0,
    long long n, float* __restrict__ B, float* Y, int yoff) {
  constexpr int P = RNB_P;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float acc[P];
    rnb_dot_col<P>(X, LD, R, M + c0, C, c, acc);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long row = n0 + p;
      float v = acc[p];
      if (rec != nullptr)
        v = (row < n && rec[row * rec_ld + c] > 0.0f) ? v : 0.0f;
      if (row < n) B[row * cols + c] = v;
      Y[p * LD + yoff + c] = v;
    }
  }
}

// Two blocks an SM: left free, ptxas gives this kernel 254 registers and one
// block an SM; capped at 128 (a 224-byte spill) the whole backward ran
// 27.34 -> 20.09 ms at 67,584 points, bf16, on an H100 (700 W), bitwise the
// same outputs.
static __global__ void __launch_bounds__(RNB_NT, 2)
nerf_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ views,
                long long n, int C, const float* __restrict__ w,
                const float* __restrict__ wt, const float* __restrict__ b,
                RnbNet net, unsigned skips, int multires, int multires_view,
                const float* __restrict__ calpha,
                const float* __restrict__ crgb, float* __restrict__ rec,
                int rec_ld, float* __restrict__ abuf,
                float* __restrict__ bbuf) {
  constexpr int P = RNB_P;
  extern __shared__ __align__(16) float smem[];
  const int D = net.n_layers - 4;
  const int la = D, lf = D + 1, lv = D + 2, lr = D + 3;
  const int LD = net.ld;
  const int E = net.in_dim[0];
  const int LDE = (E + 3) & ~3;
  const int LDV = (net.in_dim[lv] - net.out_dim[lf] + 3) & ~3;
  float* sE = smem;
  float* sV = sE + P * LDE;
  float* bufA = sV + P * LDV;
  float* bufB = bufA + P * LD;
  const long long n0 = (long long)blockIdx.x * P;
  const long long rstride = n * rec_ld;  // one layer's rec rows
  nerf_inputs(pts, views, n, C, multires, multires_view, n0, LDE, LDV, sE, sV);
  float* Y = nerf_primal<true>(w, b, net, skips, sE, LDE, sV, LDV, n0, n, bufA,
                               bufB, rec, rec_ld, abuf, nullptr);
  float* X = Y == bufA ? bufB : bufA;
  const int oa = net.out_dim[la], of = net.out_dim[lf];
  const int ov = net.out_dim[lv], orr = net.out_dim[lr];

  // rgb head: bar_z = c_rgb
  for (int idx = threadIdx.x; idx < P * orr; idx += blockDim.x) {
    const int p = idx / orr, j = idx % orr;
    const long long row = n0 + p;
    const float co = row < n ? crgb[row * orr + j] : 0.0f;
    if (row < n) bbuf[net.bb_off[lr] + row * orr + j] = co;
    X[p * LD + j] = co;
  }
  __syncthreads();
  // views layer: bar_z_v = (c_rgb W_rgbᵀ) ⊙ [z_v > 0]
  nerf_reverse(X, LD, orr, wt + net.w_off[lr], net.in_dim[lr], 0, ov,
               rec + D * rstride, rec_ld, n0, n, bbuf + net.bb_off[lv], Y, 0);
  __syncthreads();
  { float* t = X; X = Y; Y = t; }
  // feature head: bar_feat = (bar_z_v W_vᵀ)[:, :of]; alpha head: c_alpha.
  // Y becomes [rnd(c_alpha), rnd(bar_feat)].
  for (int idx = threadIdx.x; idx < P * oa; idx += blockDim.x) {
    const int p = idx / oa, j = idx % oa;
    const long long row = n0 + p;
    const float ca = row < n ? calpha[row * oa + j] : 0.0f;
    if (row < n) bbuf[net.bb_off[la] + row * oa + j] = ca;
    Y[p * LD + j] = ca;
  }
  nerf_reverse(X, LD, ov, wt + net.w_off[lv], net.in_dim[lv], 0, of, nullptr,
               rec_ld, n0, n, bbuf + net.bb_off[lf], Y, oa);
  __syncthreads();
  { float* t = X; X = Y; Y = t; }
  // bar_h = c_alpha W_aᵀ + bar_feat W_fᵀ in one product: in the flat Wᵀ
  // buffer the alpha layer's [oa, W] block is followed by the feature
  // layer's [of, W] block, one [oa+of, W] matrix.
  nerf_reverse(X, LD, oa + of, wt + net.w_off[la], net.in_dim[la], 0,
               net.in_dim[la], rec + (long long)(D - 1) * rstride, rec_ld, n0,
               n, bbuf + net.bb_off[D - 1], Y, 0);
  __syncthreads();
  { float* t = X; X = Y; Y = t; }
  // trunk: bar_z_{i-1} = (bar_z_i W_iᵀ)[PE slice dropped] ⊙ [z_{i-1} > 0]
  for (int i = D - 1; i >= 1; --i) {
    const int in = net.in_dim[i];
    const int off = ((skips >> (i - 1)) & 1u) ? E : 0;
    nerf_reverse(X, LD, net.out_dim[i], wt + net.w_off[i], in, off, in - off,
                 rec + (long long)(i - 1) * rstride, rec_ld, n0, n,
                 bbuf + net.bb_off[i - 1], Y, 0);
    __syncthreads();
    float* t = X; X = Y; Y = t;
  }
}

// RnbNet of the NeRF: layers [trunk..., alpha, feature, views, rgb]; checks
// the widths the kernels rely on and widens ld for the [c_alpha, bar_feat]
// row of the backward.
static int nerf_make_net(RnbNet* net, const int* in_dims, const int* out_dims,
                         int n_layers, unsigned skips, long long n, int C,
                         int multires, int multires_view) {
  if (n_layers < 5 || C < 1 ||
      rnb_make_net(net, in_dims, out_dims, nullptr, n_layers, n, 1))
    return 1;
  const int D = n_layers - 4;
  const int E = C * (1 + 2 * multires), V = 3 * (1 + 2 * multires_view);
  if ((skips >> (D - 1)) != 0u) return 1;  // no skip at the last trunk layer
  for (int i = 1; i < D; ++i)
    if (in_dims[i] != out_dims[i - 1] + (((skips >> (i - 1)) & 1u) ? E : 0))
      return 1;
  if (in_dims[0] != E || in_dims[D] != out_dims[D - 1] ||
      in_dims[D + 1] != out_dims[D - 1] ||
      in_dims[D + 2] != out_dims[D + 1] + V || in_dims[D + 3] != out_dims[D + 2])
    return 1;
  const int hw = out_dims[D] + out_dims[D + 1];
  if (hw > net->ld) net->ld = (hw + 3) & ~3;
  return 0;
}

static int nerf_smem(const RnbNet& net, int C, int multires, int multires_view) {
  const int LDE = (C * (1 + 2 * multires) + 3) & ~3;
  const int LDV = (3 * (1 + 2 * multires_view) + 3) & ~3;
  return (int)sizeof(float) * RNB_P * (LDE + LDV + 2 * net.ld);
}

// The f32 route's forward (f32 operands).
extern "C" int rnb_nerf_fwd(const float* pts, const float* views, long long n,
                            int C, const float* w, const float* b,
                            const int* in_dims, const int* out_dims,
                            int n_layers, int skips, int multires,
                            int multires_view, float* alpha, float* rgb,
                            void* stream) {
  RnbNet net;
  if (nerf_make_net(&net, in_dims, out_dims, n_layers, (unsigned)skips, n, C,
                    multires, multires_view))
    return (int)cudaErrorInvalidValue;
  const int smem = nerf_smem(net, C, multires, multires_view);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + RNB_P - 1) / RNB_P);
  nerf_fwd_kernel<<<grid, RNB_NT, smem, (cudaStream_t)stream>>>(
      pts, views, n, C, w, b, net, (unsigned)skips, multires, multires_view,
      alpha, rgb);
  return (int)cudaGetLastError();
}

// The f32 route's backward (f32 operands).
extern "C" int rnb_nerf_bwd(const float* pts, const float* views, long long n,
                            int C, const float* w, const float* wt,
                            const float* b, const int* in_dims,
                            const int* out_dims, int n_layers, int skips,
                            int multires, int multires_view,
                            const float* calpha, const float* crgb, float* rec,
                            int rec_ld, float* abuf, float* bbuf,
                            float* partial, int splits, float* dw, float* db,
                            void* stream) {
  RnbNet net;
  if (nerf_make_net(&net, in_dims, out_dims, n_layers, (unsigned)skips, n, C,
                    multires, multires_view))
    return (int)cudaErrorInvalidValue;
  const int smem = nerf_smem(net, C, multires, multires_view);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((n + RNB_P - 1) / RNB_P);
  nerf_bwd_kernel<<<grid, RNB_NT, smem, st>>>(
      pts, views, n, C, w, wt, b, net, (unsigned)skips, multires,
      multires_view, calpha, crgb, rec, rec_ld, abuf, bbuf);
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
// nerf_fwd_wg_kernel replaces the forward TPU kernel (pallas_nerf.py
// _fwd_kernel :105) at bf16 operands; nerf_fwd_kernel above stays as the
// f32 route. What bounds it on the H100: arithmetic, 603,520 multiply-adds
// a point at the womask conf (trunk, alpha and feature heads, views and rgb
// layers), 0.083 ms at the bf16 peak for 67,584 points.
//
// What the design does about it (nerf_fwd_wg_kernel below): the recompute
// half of nerf_bwd_wg_kernel on the same block, ring, phase walk and
// epilogues (wg_sweep.cuh): one block of 384 threads a pair of 64-point
// tiles, a producer warpgroup loading every weight stage by TMA into a ring
// of NF_RS slots in the order of the forward phase table (ops/nerf.py
// fwd_steps: 166 stages a pair), two consumer warpgroups each a whole tile
// at m64n256k16 (the views layer m64n128k16) taking turns at the ring, so
// one tile's epilogue runs under the other's products; the bias staged by
// cp.async, ReLU and rounding into the swizzled A tile with no branch an
// element; the skip input held as [h, e] (PE(pts) written once into
// columns 256..), PE(views) written after the feature head. Plus the two
// outputs the backward never computes, written raw from the accumulators of
// the warpgroup that owns the tile, rows < n only: the alpha column
// (column 256 of the fused [W_f | W_a] tile) as one m64n8k16 in the same
// K-steps as the feature block's m64n256k16, both from one box of the
// tile's 34 output cores a stage (NF_STAGE: a slot 512 B larger than the
// backward's costs one ring slot, 15 against 16, where a phase of its own
// would add 16 stages a pair), and the rgb head (128 -> 3) as one
// m64n8k16. No mask bits, no operand rows. What held the cp.async forward
// it replaced (four warpgroups of N = 64 on one tile, a 4-stage ring): a
// block barrier and a share of every stage's copy at each of a tile's 166
// K-steps, every warpgroup reading the whole A tile (its split: PERF.md §6).
// Each output is summed from the same bf16 operands in the same K order
// through the same epilogue as that forward's: the same bits.
//
// nerf_bwd_wg_kernel replaces the same TPU kernel (pallas_nerf.py
// _bwd_kernel :122, the heads at :159-183, the trunk at :185-196) at bf16
// operands; nerf_bwd_kernel above stays as the f32 route. What bounds it on
// the H100: arithmetic, at least 1.77 M multiply-adds a point at the womask
// conf (recompute without the alpha and rgb heads 603,520; reverse without
// layer 0 and the PE rows 557,696; dW 604,160), 0.241 ms at the bf16 peak
// for 67,584 points; the CUDA-core route reaches ~1% of it, leaves
// most threads idle in the 1- and 3-wide heads and moves ~2 GB of f32
// scratch (the pre-activation record and the operand rows).
//
// What the design does about it (nerf_bwd_wg_kernel below: a producer-fed
// TMA ring shared by two 64-point tiles at N = 256, the operand rows by TMA
// store): every product runs on wgmma from the bf16 A tile in shared
// memory and the weight image. The
// wrapper lays the image out in the order the products want (ops/nerf.py
// wg_weights):
//   * a skip layer's input [e, h] is held as [h, e] (its weight rows
//     permuted alike), so its reverse product is the N = 256 block of the h
//     rows and the PE slice is never computed;
//   * the alpha and feature heads read the same h: one [W_f | W_a] tile of
//     256 x 257, whose forward needs only the N = 256 feature block and
//     whose reverse [bar_feat | c_alpha] [W_f | W_a]ᵀ is one K = 272
//     product; its dW is one product too, split by the wrapper;
//   * the views layer's input [feat, v] keeps the feature rows first, so
//     its reverse is the N = 256 block of those rows.
// The nine ReLU masks (eight trunk layers and the views layer) are kept as
// one bit a fragment register in shared memory, set from the f32
// pre-activation (z > 0), and read back by the reverse epilogue that owns
// the same fragment. The A rows x_l and B rows rnd(bar_z_l) go out as bf16
// rows (5.3 + 4.9 KB a point, written and read once); db comes from
// per-tile column sums of the unrounded bar_z, summed in a fixed order;
// dW is one grouped launch over the 11 image layers (dw_gemm.cu). No f32
// record leaves the block.

#include "wg_sweep.cuh"

#define NRF_KW 352    // widest A tile: the skip input [h, e] (256 + 84 -> 352)
#define NRF_EW 96     // PE(pts) channels a point at most (E <= 96)
#define NRF_VW 32     // PE(views) channels a point at most (V <= 32)

// PE(pts) of the tile (C channels, rows past n from 0) in bf16 into
// columns 0..E-1 of the swizzled A tile X (layer 0's input) and
// 256..256+E-1 (the skip input [h, e]: the trunk's epilogues write columns
// 0..255 only), their pads up to pad16(E) zero; one warpgroup (thread lt).
__device__ __forceinline__ void nerf_wb_pe_pts(const float* __restrict__ pts,
                                               long long n, int C,
                                               int multires, int E,
                                               long long n0, rnb_bf16* X,
                                               int lt) {
  for (int idx = lt; idx < WG_M * C; idx += 128) {
    const int pp = idx / C, d = idx - pp * C;
    const long long row = n0 + pp;
    const float x = row < n ? pts[row * C + d] : 0.0f;
    auto put = [&](int c, float v) {
      const rnb_bf16 h = wg_bf(v);
      X[wb_sidx(pp, c)] = h;
      X[wb_sidx(pp, 256 + c)] = h;
    };
    put(d, x);
    float s = sinf(x), c = cosf(x);
    for (int k = 0; k < multires; ++k) {
      put(C * (1 + 2 * k) + d, s);
      put(C * (2 + 2 * k) + d, c);
      if (k + 1 < multires) {
        const float s2 = 2.0f * s * c;
        c = 1.0f - 2.0f * s * s;
        s = s2;
      }
    }
  }
  const int kp0 = rnb_pad16(E);
  for (int idx = lt; idx < WG_M * (kp0 - E); idx += 128) {
    const int pp = idx / (kp0 - E), c = E + idx % (kp0 - E);
    X[wb_sidx(pp, c)] = wg_bf(0.0f);
    X[wb_sidx(pp, 256 + c)] = wg_bf(0.0f);
  }
}

// PE(views) of the tile (rows past n from 0) in bf16 into columns 256.. of
// X, once the feature head's epilogue wrote rnd(feat) into 0..255: the
// views layer's input [rnd(feat), PE(views)], its pads up to 256 + kv zero;
// one warpgroup (thread lt).
__device__ __forceinline__ void nerf_wb_pe_views(
    const float* __restrict__ views, long long n, int multires_view, int kv,
    long long n0, rnb_bf16* X, int lt) {
  const int V = 3 * (1 + 2 * multires_view);
  for (int idx = lt; idx < WG_M * 3; idx += 128) {
    const int pp = idx / 3, d = idx - 3 * pp;
    const long long row = n0 + pp;
    const float x = row < n ? views[row * 3 + d] : 0.0f;
    X[wb_sidx(pp, 256 + d)] = wg_bf(x);
    float s = sinf(x), c = cosf(x);
    for (int k = 0; k < multires_view; ++k) {
      X[wb_sidx(pp, 256 + 3 * (1 + 2 * k) + d)] = wg_bf(s);
      X[wb_sidx(pp, 256 + 3 * (2 + 2 * k) + d)] = wg_bf(c);
      if (k + 1 < multires_view) {
        const float s2 = 2.0f * s * c;
        c = 1.0f - 2.0f * s * s;
        s = s2;
      }
    }
  }
  for (int idx = lt; idx < WG_M * (kv - V); idx += 128) {
    const int pp = idx / (kv - V), c = 256 + V + idx % (kv - V);
    X[wb_sidx(pp, c)] = wg_bf(0.0f);
  }
}

#define NF_RS 15        // the forward's production ring depth (the deepest
                        // that fits: 231,168 B of shared memory)
#define NF_STAGE 8704   // the forward's ring slot: the fused head's box of
                        // 34 output cores x 2
#define NF_TILE (WG_M * 384 * 2 + 256 * 4)   // the A tile (six swizzled
                                             // blocks of 64 columns) + bias

// The forward over the image layers (as nerf_bwd_wg_kernel's below): alpha
// [n, oa] (out0) and rgb [n, orr] (out1), raw, f32. RS: the ring's stages
// (NF_RS in production; the tune library's instances take 4 and 8 too);
// SPLIT: a WgSplit (K_LOOPS_ONLY no wgmma and no epilogue, PRODUCTS_ONLY no
// epilogue: neither the tile nor an output written, NO_EPILOGUE the
// accumulators rounded into the tile and the heads written raw).
//
// ptxas (chip_smoke.py holds it to this note): nerf_fwd_wg_kernel<15, 0>
// 168 registers at launch (the consumers take 232 by setmaxnreg), 32 B
// stack frame, no spill; 231,168 B dynamic shared memory.
template <int RS, int SPLIT = WB_FULL>
static __global__ void __launch_bounds__(WB_NT, 1)
nerf_fwd_wg_kernel(const __grid_constant__ WbParams p) {
  static_assert(RS >= 2 && wb_smem_bytes(RS, NF_STAGE, NF_TILE) <= 232448,
                "ring depth");
  constexpr bool k_mma = SPLIT != WB_K_LOOPS_ONLY;
  constexpr bool k_put = SPLIT == WB_FULL || SPLIT == WB_NO_EPILOGUE;
  constexpr bool k_epi = SPLIT == WB_FULL;
  extern __shared__ __align__(1024) unsigned char wb_smem[];
  RnbTurns<RS> turns = wb_begin<RS>(p, wb_smem, NF_STAGE, NF_TILE);
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
  unsigned char* ta = wb_smem + ci * NF_TILE;
  rnb_bf16* X = reinterpret_cast<rnb_bf16*>(ta);           // A tile [64][384]
  float* sb = reinterpret_cast<float*>(ta + WG_M * 384 * 2);   // the bias
  const int D = net.n_layers - 3, lh = D, lv = D + 1, lr = D + 2;

  auto tail = [&] { wb_tail(lt); };
  auto product = [&](int nk, auto mma) {
    turns.template product<k_mma>(nk, mma, tail);
  };
  // a head's N = 8 accumulators (rows r0, r0 + 8; columns cq, cq + 1) plus
  // its bias (none in the split) to out [n, o], columns < o, rows < n
  auto head_out = [&](const float (&a8)[4], const float* bh, int o,
                      float* out) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long long row = n0 + r0 + 8 * h;
        const int c = cq + u;
        if (c < o && row < n)
          out[row * o + c] = a8[2 * h + u] + (k_epi ? bh[c] : 0.0f);
      }
  };

  nerf_wb_pe_pts(p.in0, n, p.C, p.multires, net.E, n0, X, lt);
  wb_written(bar_id);

  float acc[128];
  float (&a64)[64] = *reinterpret_cast<float(*)[64]>(acc);
  uint32_t bits[4];
  // --- the trunk: h = relu(x W + b) in bf16 into columns 0..255 ---
  for (int l = 0; l < D; ++l) {
    if constexpr (k_epi) wb_stage_bias(sb, p.b + net.b_off[l], net.out_dim[l], lt);
    product(rnb_pad16(net.in_dim[l]) >> 4, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n256<0, 1>(acc, wb_desc_a(X, t),
                           rnb_desc(st, 32 * 128, 128), t > 0);
    });
    if constexpr (!k_put) continue;
    wb_fwd_put<32, true, k_epi>(acc, sb, X, bits);
    wb_written(bar_id);
  }

  // --- the fused head: the feature block (N = 256) and the alpha column
  // (N = 8 at core of / 8) from one box of the tile's output cores ---
  float acc8[4];
  if constexpr (k_epi) wb_stage_bias(sb, p.b + net.b_off[lh], net.out_dim[lh], lt);
  {
    const uint32_t lbo = (uint32_t)(rnb_pad16(net.out_dim[lh]) >> 3) * 128;
    const int ac = (p.of >> 3) * 64;
    product(rnb_pad16(net.in_dim[lh]) >> 4, [&](int t, const rnb_bf16* st) {
      const uint64_t da = wb_desc_a(X, t);
      rnb_wgmma_n256<0, 1>(acc, da, rnb_desc(st, lbo, 128), t > 0);
      rnb_wgmma_n8<0, 1>(acc8, da, rnb_desc(st + ac, lbo, 128), t > 0);
    });
  }
  if constexpr (k_put) {
    // [rnd(feat), PE(views)] is the views layer's input
    wb_fwd_put<32, false, k_epi>(acc, sb, X, bits);
    head_out(acc8, p.b + net.b_off[lh] + p.of, net.out_dim[lh] - p.of, p.out0);
    nerf_wb_pe_views(p.in1, n, p.multires_view,
                     rnb_pad16(net.in_dim[lv]) - 256, n0, X, lt);
    wb_written(bar_id);
  }

  // --- the views layer (N = 128): relu in bf16 into columns 0..127 ---
  if constexpr (k_epi) wb_stage_bias(sb, p.b + net.b_off[lv], net.out_dim[lv], lt);
  product(rnb_pad16(net.in_dim[lv]) >> 4, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n128<0, 1>(a64, wb_desc_a(X, t),
                         rnb_desc(st, 16 * 128, 128), t > 0);
  });
  if constexpr (k_put) {
    wb_fwd_put<16, true, k_epi>(a64, sb, X, *reinterpret_cast<uint32_t(*)[2]>(bits));
    wb_written(bar_id);
  }

  // --- the rgb head (N = 8) ---
  product(rnb_pad16(net.in_dim[lr]) >> 4, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n8<0, 1>(acc8, wb_desc_a(X, t), rnb_desc(st, 2 * 128, 128),
                       t > 0);
  });
  if constexpr (k_put) head_out(acc8, p.b + net.b_off[lr], net.out_dim[lr], p.out1);
}

// nerf_bwd_wg_kernel, the backward sweep on the tensor cores, designed for
// Hopper. What held the cp.async sweep it replaced (four
// warpgroups of N = 64 on one 64-point tile; its timing split on one H100
// in PERF.md §6): a block
// barrier and a share of every weight stage's copy at each of a tile's 296
// K-steps, every warpgroup reading the whole A tile at N = 64, and nothing
// under its epilogues and the 512 threads' operand-row stores.
//
// What the design does about it (the SDF forward's shape, sdf_core.cu):
//   * one block of 384 threads a pair of 64-point tiles (2b, 2b + 1), one
//     block an SM: a producer warpgroup (setmaxnreg 40) whose one thread
//     loads every weight stage by TMA into a ring of NB_RS slots in the
//     order of the phase table (WbCursor, wg_sweep.cuh; ops/nerf.py
//     bwd_steps), and two consumer warpgroups (232 registers), each a whole
//     tile: m64n256k16 for the trunk, the feature head, the views layer's
//     reverse (its feature rows), the fused head's reverse and the trunk's;
//     m64n128k16 for the views layer and the rgb head's reverse;
//   * one stage feeds both tiles; the consumers take turns at their
//     product phases (RnbTurns, tma.cuh), so one tile's epilogue runs under
//     the other's products;
//   * the epilogues: each layer's bias staged in shared memory by cp.async
//     under the products (zero past its width, so no column test), ReLU,
//     mask bits (4 words a thread and layer) and rounding with no branch an
//     element; the column sums of db reduced by a scatter over the lanes
//     (wb_colsum_put) in the butterfly's order; PE(pts) written once into
//     both places it is read (columns 0.. for layer 0, 256.. for the skip
//     input [h, e], which layers 1-4 never overwrite), PE(views) computed
//     into columns 256.. after the feature head: no PE area;
//   * the operand rows leave by TMA stores: the A tile is K-major in
//     wgmma's 128-byte swizzle (wb_sidx), so each block of 64 of its
//     columns is one box {64, 64} of the [n, ld] bf16 rows in the same
//     swizzle, written as whole 128-byte rows; one thread issues a layer's
//     stores after its epilogue, and the next epilogue writes the tile
//     once they have read it (the product's tail). (Boxes {8, 64} from the
//     8x8-core layout wrote 16-byte pieces of 64 rows: 0.45 ms of 0.89 in
//     the first build on the H100, PERF.md §6.)
// Each element is summed from the same bf16 operands in the same K order as
// the cp.async sweep's, the column sums in the same order: the same bits.
// What did not pay (one H100, PERF.md §6): two wgmma groups in flight
// (0.69 against 0.65 ms), the two heads' 64-row
// db sums with their loads unrolled (they spilled: 0.65 -> 0.75 ms).
//
// ptxas (chip_smoke.py holds it to this note): nerf_bwd_wg_kernel<10, 0>
// 168 registers at launch (the consumers take 232 by setmaxnreg), 32 B
// stack frame, no spill; 227,504 B dynamic shared memory.

#define NB_RS 10        // the production ring depth (the deepest that fits)
#define NB_MASKS 9      // ReLU masks kept: 8 trunk layers and the views layer
#define NB_X (WG_M * 384 * 2)   // the A tile: 6 blocks of 64 columns, the
                                // skip input [h, e] (256 + 84 -> 352) wide
#define NB_MB (NB_MASKS * 128 * 16)             // mask bits: a uint4 a thread
#define NB_TILE (NB_X + NB_MB + 4 * 256 * 4 + 256 * 4)   // + red + bias

// RS: the ring's stages (NB_RS in production; the tune library's instances
// take 4 and 8 too); SPLIT: a WgSplit.
template <int RS, int SPLIT = WB_FULL>
static __global__ void __launch_bounds__(WB_NT, 1)
nerf_bwd_wg_kernel(const __grid_constant__ WbParams p) {
  static_assert(RS >= 2 && wb_smem_bytes(RS, WB_STAGE, NB_TILE) <= 232448,
                "ring depth");
  constexpr bool k_mma = SPLIT != WB_K_LOOPS_ONLY;
  constexpr bool k_epi = SPLIT == WB_FULL || SPLIT == WB_NO_ROWS;
  constexpr bool k_rows = SPLIT == WB_FULL || SPLIT == WB_NO_EPILOGUE;
  extern __shared__ __align__(1024) unsigned char wb_smem[];
  RnbTurns<RS> turns = wb_begin<RS>(p, wb_smem, WB_STAGE, NB_TILE);
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
  const int r0 = ((lt >> 5) << 4) + ((lt & 31) >> 2);
  const long long tile = 2 * (long long)blockIdx.x + ci, n0 = tile * WG_M;
  const bool live0 = n0 + r0 < n, live1 = n0 + r0 + 8 < n;
  unsigned char* ta = wb_smem + ci * NB_TILE;
  rnb_bf16* X = reinterpret_cast<rnb_bf16*>(ta);      // A tile [64][384]
  uint4* mb = reinterpret_cast<uint4*>(ta + NB_X);    // [NB_MASKS][128]
  float* red = reinterpret_cast<float*>(ta + NB_X + NB_MB);   // [4][256]
  float* sb = red + 4 * 256;                          // the layer's bias
  float* dbt = p.dbp + tile * p.db_len;
  const int D = net.n_layers - 3, lh = D, lv = D + 1, lr = D + 2;
  const int E = net.E, kp0 = rnb_pad16(E);

  auto stage_bias = [&](int l) {
    wb_stage_bias(sb, p.b + net.b_off[l], net.out_dim[l], lt);
  };
  auto tail = [&] { wb_tail(lt); };
  auto product = [&](int nk, auto mma) {
    turns.template product<k_mma>(nk, mma, tail);
  };
  // the tile's writers are done; then one thread stores the first kw
  // columns as the rows of `map`
  auto rows_out = [&](const CUtensorMap* map, int kw) {
    wb_written(bar_id);
    if (k_rows && lt == 0) wb_rows_out(map, X, kw, n0);
  };
  // db of layer l from the column sums in red (a barrier after they were
  // written)
  auto db_out = [&](int l, int cols) {
    for (int c = lt; c < cols; c += 128)
      dbt[net.b_off[l] + c] = wg_colsum_get(red, c);
  };

  // --- PE(pts) into columns 0.. (layer 0's input) and 256.. (the skip
  // input [h, e], which layers 1-4 never overwrite) ---
  nerf_wb_pe_pts(p.in0, n, p.C, p.multires, E, n0, X, lt);
  rows_out(&p.amap[0], kp0);

  float acc[128];
  float (&a64)[64] = *reinterpret_cast<float(*)[64]>(acc);
  uint32_t bits[4];

  // --- recompute: the trunk (ReLU, masks as bits), then the feature head;
  // each epilogue writes the next A tile (h or rnd(feat)) into columns
  // 0..255, the slice after them already in place (e) or written here (v)
  for (int l = 0; l <= D; ++l) {
    if constexpr (k_epi) stage_bias(l);
    product(rnb_pad16(net.in_dim[l]) >> 4, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n256<0, 1>(acc, wb_desc_a(X, t),
                           rnb_desc(st, 32 * 128, 128), t > 0);
    });
    if constexpr (!k_mma) continue;
    if (l < D) {
      wb_fwd_put<32, true, k_epi>(acc, sb, X, bits);
      if (k_epi) mb[l * 128 + lt] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
    } else {
      wb_fwd_put<32, false, k_epi>(acc, sb, X, bits);
      // [rnd(feat), PE(views)] is the views layer's input
      nerf_wb_pe_views(p.in1, n, p.multires_view,
                       rnb_pad16(net.in_dim[lv]) - 256, n0, X, lt);
    }
    rows_out(&p.amap[l + 1], rnb_pad16(net.in_dim[l + 1]));
  }

  // --- the views layer (N = 128): its mask, the rgb head's A rows ---
  if constexpr (k_epi) stage_bias(lv);
  product(rnb_pad16(net.in_dim[lv]) >> 4, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n128<0, 1>(a64, wb_desc_a(X, t),
                         rnb_desc(st, 16 * 128, 128), t > 0);
  });
  if constexpr (k_mma) {
    wb_fwd_put<16, true, k_epi>(a64, sb, X, *reinterpret_cast<uint32_t(*)[2]>(bits));
    if (k_epi) mb[D * 128 + lt] = make_uint4(bits[0], bits[1], 0u, 0u);
    rows_out(&p.amap[lr], rnb_pad16(net.in_dim[lr]));

    // --- the rgb head: bar_z = c_rgb into the A tile once its rows left ---
    if (lt == 0) rnb_bulk_wait_read<0>();
    rnb_wg_sync(bar_id);
    const int orr = net.out_dim[lr];
    for (int idx = lt; idx < WG_M * 16; idx += 128) {
      const int pp = idx >> 4, j = idx & 15;
      const long long row = n0 + pp;
      X[wb_sidx(pp, j)] =
          wg_bf(row < n && j < orr ? p.cot1[row * orr + j] : 0.0f);
    }
    if (k_epi && lt < orr) {
      float s = 0.0f;
      for (int q = 0; q < WG_M && n0 + q < n; ++q) s += p.cot1[(n0 + q) * orr + lt];
      dbt[net.b_off[lr] + lt] = s;
    }
    rows_out(&p.bmap[lr], 16);
  }
  // --- bar_z_v = (c_rgb W_rgbᵀ) ⊙ mask_v (N = 128) ---
  product(rnb_pad16(net.out_dim[lr]) >> 4, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n128<0, 0>(a64, wb_desc_a(X, t),
                         rnb_desc(st, 128, 256), t > 0);
  });
  if constexpr (k_mma) {
    wb_rev_put<16, true, k_epi>(
        a64, reinterpret_cast<const uint32_t*>(&mb[D * 128 + lt]), X, red,
        live0, live1);
    rows_out(&p.bmap[lv], rnb_pad16(net.out_dim[lv]));
    if (k_epi) db_out(lv, net.out_dim[lv]);
  }
  // --- bar_feat = (bar_z_v W_vᵀ)[:, :of] (the feature rows of W_v, N =
  // 256, no mask); the head's B rows [rnd(bar_feat) | rnd(c_alpha)] are
  // the next A tile (K = 272) ---
  product(rnb_pad16(net.out_dim[lv]) >> 4, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n256<0, 0>(acc, wb_desc_a(X, t),
                         rnb_desc(st, 128, 256), t > 0);
  });
  if constexpr (k_mma) {
    wb_rev_put<32, false, k_epi>(acc, nullptr, X, red, live0, live1);
    const int of = p.of, oa = net.out_dim[lh] - of;
    const int kh = rnb_pad16(net.out_dim[lh]) - of;
    for (int idx = lt; idx < WG_M * kh; idx += 128) {
      const int pp = idx / kh, a = idx - pp * kh;
      const long long row = n0 + pp;
      X[wb_sidx(pp, of + a)] =
          wg_bf(a < oa && row < n ? p.cot0[row * oa + a] : 0.0f);
    }
    rows_out(&p.bmap[lh], of + kh);
    if (k_epi) {
      db_out(lh, of);
      if (lt < oa) {
        float s = 0.0f;
        for (int q = 0; q < WG_M && n0 + q < n; ++q) s += p.cot0[(n0 + q) * oa + lt];
        dbt[net.b_off[lh] + of + lt] = s;
      }
    }
  }
  // --- the head's reverse, then the trunk's: bar_z_{l-1} = (bar_z_l W_lᵀ)
  // [the h rows] ⊙ mask_{l-1}; layer 0 has no reverse ---
  for (int l = lh; l >= 1; --l) {
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
  if (lt == 0) rnb_bulk_wait<0>();
}

// RnbWgNet of the NeRF's image layers (b and db offsets in image order);
// a_off and bb_off may be null (the forward writes no operand rows). Checks
// the widths the tensor-core kernels take; returns the length of b, or -1.
static int nerf_wg_net(RnbWgNet* net, const int* in_dims, const int* out_dims,
                       const int* skip, const long long* w_off,
                       const long long* a_off, const long long* bb_off,
                       int n_layers, int of, int C, int multires,
                       int multires_view) {
  const int D = n_layers - 3;
  const int E = C * (1 + 2 * multires), V = 3 * (1 + 2 * multires_view);
  if (D < 1 || n_layers > RNB_MAXL || C < 1 || E > NRF_EW || V > NRF_VW)
    return -1;
  net->n_layers = n_layers;
  net->E = E;
  int db_len = 0;
  for (int l = 0; l < n_layers; ++l) {
    net->in_dim[l] = in_dims[l];
    net->out_dim[l] = out_dims[l];
    net->skip[l] = l < D ? skip[l] : 0;
    net->hd[l] = net->skip[l] ? out_dims[l - 1] : in_dims[l];
    net->w_off[l] = w_off[l];
    net->a_off[l] = a_off ? a_off[l] : 0;
    net->bb_off[l] = bb_off ? bb_off[l] : 0;
    net->b_off[l] = db_len;
    db_len += out_dims[l];
    if (w_off[l] % 8) return -1;
  }
  bool ok = skip[0] == 0;
  for (int l = 0; l < D; ++l) {
    const int want = l == 0 ? E : out_dims[l - 1] + (net->skip[l] ? E : 0);
    ok = ok && in_dims[l] == want && rnb_pad16(in_dims[l]) <= NRF_KW &&
         out_dims[l] == 256;
  }
  // the heads' N = 8 products: alpha (column of = 256 on) and rgb <= 8 wide
  ok = ok && in_dims[D] == out_dims[D - 1] && of == 256 && out_dims[D] > of &&
       out_dims[D] <= of + 8 && in_dims[D + 1] == of + V &&
       rnb_pad16(in_dims[D + 1]) <= NRF_KW && out_dims[D + 1] <= 128 &&
       in_dims[D + 2] == out_dims[D + 1] && out_dims[D + 2] <= 8;
  return ok ? db_len : -1;
}

#define RNB_NERF_FWD_PARAMS                                                  \
  const float *pts, const float *views, long long n, int C, const void *w,   \
      const float *b, const int *in_dims, const int *out_dims,               \
      const int *skip, const long long *w_off, int n_layers, int of,         \
      int multires, int multires_view, float *alpha, float *rgb, void *stream

// The forward's arguments: the net, the buffers and the phase table of its
// ring, in the products' order (ops/nerf.py fwd_steps): the trunk forward
// (box {64, 32, 2}), the fused head ({64, 34, 2}: the feature block and
// the alpha column from one box), the views layer ({64, 16, 2}: N = 128),
// the rgb head ({64, 2, 2}: N = 8). 0 on success.
static int nerf_fwd_params(WbParams* p, RNB_NERF_FWD_PARAMS) {
  if (nerf_wg_net(&p->net, in_dims, out_dims, skip, w_off, nullptr, nullptr,
                  n_layers, of, C, multires, multires_view) < 0 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const int D = n_layers - 3;
  wb_init(p, n, b, NF_STAGE);
  p->in0 = pts;
  p->in1 = views;
  p->out0 = alpha;
  p->out1 = rgb;
  p->C = C;
  p->multires = multires;
  p->multires_view = multires_view;
  p->of = of;
  int rc = 0;
  for (int l = 0; l < D && !rc; ++l) rc = wb_phase(p, w, l, 0, 32, 0);
  if (!rc) rc = wb_phase(p, w, D, 0, rnb_pad16(out_dims[D]) >> 3, 0);
  if (!rc) rc = wb_phase(p, w, D + 1, 0, 16, 0);
  if (!rc) rc = wb_phase(p, w, D + 2, 0, 2, 0);
  return rc;
}

// The forward at ring depth RS.
template <int RS, int SPLIT = WB_FULL>
static int nerf_fwd_launch(const WbParams& p, cudaStream_t st) {
  constexpr int smem = wb_smem_bytes(RS, NF_STAGE, NF_TILE);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_fwd_wg_kernel<RS, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.n + WG_M - 1) / WG_M;
  nerf_fwd_wg_kernel<RS, SPLIT>
      <<<(unsigned)((tiles + 1) / 2), WB_NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

#define RNB_NERF_FWD_SETUP                                                   \
  WbParams prm;                                                              \
  const int rc = nerf_fwd_params(&prm, pts, views, n, C, w, b, in_dims,      \
                                 out_dims, skip, w_off, n_layers, of,        \
                                 multires, multires_view, alpha, rgb,        \
                                 stream);                                    \
  if (rc) return rc;                                                         \
  cudaStream_t st = (cudaStream_t)stream

// The bf16 forward over the image layers (see nerf_fwd_wg_kernel): raw
// alpha [n, oa] and rgb [n, orr]. w is the bf16 weight image (ops/wg.py
// pack_weights) at w_off.
extern "C" int rnb_nerf_fwd_wg(RNB_NERF_FWD_PARAMS) {
  RNB_NERF_FWD_SETUP;
  return nerf_fwd_launch<NF_RS>(prm, st);
}

// The backward sweep's arguments: the net, the buffers, the phase table of
// its ring and the tensor maps (each phase's layer tile with its box, each
// layer's A and B rows). The phases, in the products' order (ops/nerf.py
// bwd_steps): the trunk and the feature head forward (box {64, 32, 2}),
// the views layer forward ({64, 16, 2}: N = 128); the rgb head reverse
// ({64, 2, 16}: N = 128), the views layer reverse ({64, 2, 32}: its
// feature rows), the fused head's and the trunk's reverse ({64, 2, 32}:
// the h rows). 0 on success.
static int nerf_bwd_params(WbParams* p, const float* pts,
                           const float* views, long long n, int C,
                           const void* w, const float* b, const int* in_dims,
                           const int* out_dims, const int* skip,
                           const long long* w_off, const long long* a_off,
                           const long long* bb_off, int n_layers, int of,
                           int multires, int multires_view,
                           const float* calpha, const float* crgb, void* abuf,
                           void* bbuf, float* dbp) {
  const int db_len = nerf_wg_net(&p->net, in_dims, out_dims, skip, w_off,
                                 a_off, bb_off, n_layers, of, C, multires,
                                 multires_view);
  const int D = n_layers - 3;
  if (db_len < 0 || D + 1 > NB_MASKS || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  wb_init(p, n, b, WB_STAGE);
  p->in0 = pts;
  p->in1 = views;
  p->cot0 = calpha;
  p->cot1 = crgb;
  p->dbp = dbp;
  p->db_len = db_len;
  p->C = C;
  p->multires = multires;
  p->multires_view = multires_view;
  p->of = of;
  int rc = 0;
  for (int l = 0; l <= D && !rc; ++l) rc = wb_phase(p, w, l, 0, 32, 0);
  if (!rc) rc = wb_phase(p, w, D + 1, 0, 16, 0);
  if (!rc) rc = wb_phase(p, w, D + 2, 1, 16, 0);
  for (int l = D + 1; l >= 1 && !rc; --l) rc = wb_phase(p, w, l, 1, 32, 0);
  if (!rc) rc = wb_rows(p, abuf, bbuf);
  return rc;
}

// The sweep at ring depth RS, then the fixed-order sum of the per-tile db
// partials (dbp) into db.
template <int RS, int SPLIT = WB_FULL>
static int nerf_bwd_launch(const WbParams& p, float* db, cudaStream_t st) {
  constexpr int smem = wb_smem_bytes(RS, WB_STAGE, NB_TILE);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_bwd_wg_kernel<RS, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.n + WG_M - 1) / WG_M;
  nerf_bwd_wg_kernel<RS, SPLIT>
      <<<(unsigned)((tiles + 1) / 2), WB_NT, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rnb_sum_splits_kernel<<<(unsigned)((p.db_len + 255) / 256), 256, 0, st>>>(
      p.dbp, (int)tiles, p.db_len, db);
  return (int)cudaGetLastError();
}

#define RNB_NERF_BWD_PARAMS                                                  \
  const float *pts, const float *views, long long n, int C, const void *w,   \
      const float *b, const int *in_dims, const int *out_dims,               \
      const int *skip, const long long *w_off, const long long *a_off,       \
      const long long *bb_off, int n_layers, int of, int multires,           \
      int multires_view, const float *calpha, const float *crgb, void *abuf, \
      void *bbuf, float *dbp, float *db, void *stream
#define RNB_NERF_BWD_SETUP                                                   \
  WbParams prm;                                                              \
  const int rc = nerf_bwd_params(&prm, pts, views, n, C, w, b, in_dims,      \
                                 out_dims, skip, w_off, a_off, bb_off,       \
                                 n_layers, of, multires, multires_view,      \
                                 calpha, crgb, abuf, bbuf, dbp);             \
  if (rc) return rc;                                                         \
  cudaStream_t st = (cudaStream_t)stream

// The bf16 backward sweep over the image layers (see nerf_bwd_wg_kernel):
// fills the bf16 dW scratch (A rows at a_off, B rows at bb_off, n rows of
// pad16(width) each) and writes db in image order; the wrapper then runs
// rnb_dw_products over the image layers and splits the head. dbp holds
// ceil(n/64)·Σ out floats.
extern "C" int rnb_nerf_bwd_wg(RNB_NERF_BWD_PARAMS) {
  RNB_NERF_BWD_SETUP;
  return nerf_bwd_launch<NB_RS>(prm, db, st);
}

// The dynamic shared memory of the production forward (bwd 0) or backward
// sweep (bwd 1), as they launch.
extern "C" int rnb_nerf_wg_smem(int bwd) {
  return bwd ? wb_smem_bytes(NB_RS, WB_STAGE, NB_TILE)
             : wb_smem_bytes(NF_RS, NF_STAGE, NF_TILE);
}

// The tune library's instances (ops/_build.py library("tune"), nvcc
// -DRNB_TUNE; tools/tune_kernel.py, tools/ablate_kernel.py --wg_bwd and
// --wg_fwd): the production sweep at ring depths 4, 8 and 10 (NB_RS, the
// deepest that fits: 227,504 B of shared memory; 11 would pass the SM's
// 232,448) and its timing split; the production forward at ring depths 4,
// 8 and 15 (NF_RS) and its timing split.
#ifdef RNB_TUNE
extern "C" int rnb_nerf_bwd_wg_tune(int rs, RNB_NERF_BWD_PARAMS) {
  RNB_NERF_BWD_SETUP;
  switch (rs) {
    case 4: return nerf_bwd_launch<4>(prm, db, st);
    case 8: return nerf_bwd_launch<8>(prm, db, st);
    case NB_RS: return nerf_bwd_launch<NB_RS>(prm, db, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The production sweep's timing split: split a WgSplit; only WB_FULL
// computes the function.
extern "C" int rnb_nerf_bwd_wg_split(int split, RNB_NERF_BWD_PARAMS) {
  RNB_NERF_BWD_SETUP;
  switch (split) {
    case WB_FULL: return nerf_bwd_launch<NB_RS, WB_FULL>(prm, db, st);
    case WB_K_LOOPS_ONLY:
      return nerf_bwd_launch<NB_RS, WB_K_LOOPS_ONLY>(prm, db, st);
    case WB_PRODUCTS_ONLY:
      return nerf_bwd_launch<NB_RS, WB_PRODUCTS_ONLY>(prm, db, st);
    case WB_NO_ROWS: return nerf_bwd_launch<NB_RS, WB_NO_ROWS>(prm, db, st);
    case WB_NO_EPILOGUE:
      return nerf_bwd_launch<NB_RS, WB_NO_EPILOGUE>(prm, db, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rnb_nerf_fwd_wg_tune(int rs, RNB_NERF_FWD_PARAMS) {
  RNB_NERF_FWD_SETUP;
  switch (rs) {
    case 4: return nerf_fwd_launch<4>(prm, st);
    case 8: return nerf_fwd_launch<8>(prm, st);
    case NF_RS: return nerf_fwd_launch<NF_RS>(prm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The production forward's timing split: split one of WB_FULL,
// WB_K_LOOPS_ONLY, WB_PRODUCTS_ONLY, WB_NO_EPILOGUE; only WB_FULL computes
// the function.
extern "C" int rnb_nerf_fwd_wg_split(int split, RNB_NERF_FWD_PARAMS) {
  RNB_NERF_FWD_SETUP;
  switch (split) {
    case WB_FULL: return nerf_fwd_launch<NF_RS, WB_FULL>(prm, st);
    case WB_K_LOOPS_ONLY:
      return nerf_fwd_launch<NF_RS, WB_K_LOOPS_ONLY>(prm, st);
    case WB_PRODUCTS_ONLY:
      return nerf_fwd_launch<NF_RS, WB_PRODUCTS_ONLY>(prm, st);
    case WB_NO_EPILOGUE:
      return nerf_fwd_launch<NF_RS, WB_NO_EPILOGUE>(prm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // RNB_TUNE
