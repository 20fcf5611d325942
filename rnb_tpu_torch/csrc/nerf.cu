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
// layers), 0.083 ms at the bf16 peak for 67,584 points. What the design
// does about it: the recompute half of nerf_bwd_wg_kernel below over the
// same image layers (trunk N = 256 as 4 x 64 with the skip input held as
// [h, e], views N = 128 as 4 x 32), with the two outputs the backward never
// computes: the alpha column (column 256 of the fused [W_f | W_a] tile) as
// one N = 8 product by warpgroup 0 in the same K loop as the N = 256
// feature block, and the rgb head (128 -> 3) as one N = 8 product by
// warpgroup 0; both written raw from their accumulators. No mask bits, no
// operand rows; two blocks an SM.
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
// What the design does about it: a block of four warpgroups owns a tile of
// 64 points, every product runs on wgmma from the bf16 A tile in shared
// memory and the weight image streamed through the cp.async ring of
// wg_pipe.cuh. The wrapper lays the image out in the order the products
// want (ops/nerf.py wg_weights):
//   * a skip layer's input [e, h] is held as [h, e] (its weight rows
//     permuted alike), so its reverse product is the N = 256 block of the h
//     rows and the PE slice is never computed;
//   * the alpha and feature heads read the same h: one [W_f | W_a] tile of
//     256 x 257, whose forward needs only the N = 256 feature block and
//     whose reverse [bar_feat | c_alpha] [W_f | W_a]ᵀ is one K = 272
//     product; its dW is one product too, split by the wrapper;
//   * the views layer's input [feat, v] keeps the feature rows first, so
//     its reverse is the N = 256 block of those rows.
// Recompute: trunk N = 256 (4 x 64), head N = 256, views N = 128 (4 x 32);
// the nine ReLU masks (eight trunk layers and the views layer) are kept as
// one bit a fragment register in shared memory, set from the f32
// pre-activation (z > 0), and read back by the reverse epilogue that owns
// the same fragment. The A rows x_l and B rows rnd(bar_z_l) go out as bf16
// rows (5.3 + 4.9 KB a point, written and read once); db comes from
// per-tile column sums of the unrounded bar_z, summed in a fixed order;
// dW is one grouped launch over the 11 image layers (dw_gemm.cu). No f32
// record leaves the block.

#include "wg_pipe.cuh"

#define NRF_NT 512    // four warpgroups of 64 columns
#define NRF_KW 352    // widest A tile: the skip input [h, e] (256 + 84 -> 352)
#define NRF_STG 4096  // ring stage: 2 x 32 cores
#define NRF_FSTG 4352 // forward ring stage: the fused head's 272 columns, 2 x 34 cores
#define NRF_EW 96     // PE(pts) channels held per point (E <= 96)
#define NRF_VW 32     // PE(views) channels held per point (V <= 32)

// PE(pts) into e16 [64][NRF_EW] and PE(views) into v16 [64][NRF_VW] in bf16
// (rows past n from 0, pads zero; e16 and v16 adjacent), and PE(pts) as the
// first A tile X, its pad columns up to pad16(E) zero. NRF_NT threads.
__device__ __forceinline__ void nerf_wg_pe(const float* __restrict__ pts,
                                           const float* __restrict__ views,
                                           long long n, int C, int multires,
                                           int multires_view, int E,
                                           long long n0, rnb_bf16* e16,
                                           rnb_bf16* v16, rnb_bf16* X) {
  for (int idx = threadIdx.x; idx < WG_M * (NRF_EW + NRF_VW); idx += NRF_NT)
    e16[idx] = wg_bf(0.0f);
  __syncthreads();
  for (int idx = threadIdx.x; idx < WG_M * (C + 3); idx += NRF_NT) {
    const int p = idx / (C + 3), d = idx % (C + 3);
    const long long row = n0 + p;
    const bool isv = d >= C;
    const int ch = isv ? 3 : C, dd = isv ? d - C : d;
    const int mr = isv ? multires_view : multires;
    rnb_bf16* e = isv ? v16 + p * NRF_VW : e16 + p * NRF_EW;
    const float x =
        row < n ? (isv ? views[row * 3 + dd] : pts[row * C + dd]) : 0.0f;
    e[dd] = wg_bf(x);
    float s = sinf(x), c = cosf(x);
    for (int k = 0; k < mr; ++k) {
      e[ch * (1 + 2 * k) + dd] = wg_bf(s);
      e[ch * (2 + 2 * k) + dd] = wg_bf(c);
      if (k + 1 < mr) {
        const float s2 = 2.0f * s * c;
        c = 1.0f - 2.0f * s * s;
        s = s2;
      }
    }
  }
  __syncthreads();
  const int kp0 = rnb_pad16(E);
  for (int idx = threadIdx.x; idx < WG_M * kp0; idx += NRF_NT) {
    const int p = idx / kp0, c = idx - p * kp0;
    X[wg_tidx(p, c)] = e16[p * NRF_EW + c];
  }
  __syncthreads();
}

// Columns 256..kn-1 of the A tile X: the slice appended after a 256-wide
// epilogue (ex [64][exld], exw wide; none where ex is null), pads zero.
// NRF_NT threads.
__device__ __forceinline__ void nerf_wg_append(rnb_bf16* X, int kn,
                                               const rnb_bf16* ex, int exld,
                                               int exw) {
  for (int idx = threadIdx.x; idx < WG_M * (kn - 256); idx += NRF_NT) {
    const int p = idx / (kn - 256), cc = idx % (kn - 256);
    X[wg_tidx(p, 256 + cc)] =
        ex != nullptr && cc < exw ? ex[p * exld + cc] : wg_bf(0.0f);
  }
}

// Image layers (net) as for nerf_bwd_wg_kernel below. Outputs: alpha [n, oa]
// and rgb [n, orr], raw, f32.
// Two blocks an SM (64 registers, no spill): one block an SM ran slower in
// a trial build on the H100.
static __global__ void __launch_bounds__(NRF_NT, 2)
nerf_fwd_wg_kernel(const float* __restrict__ pts,
                   const float* __restrict__ views, long long n, int C,
                   const rnb_bf16* __restrict__ w, const float* __restrict__ b,
                   RnbWgNet net, int of, int multires, int multires_view,
                   float* __restrict__ alpha, float* __restrict__ rgb) {
  constexpr int RS = WG_RS;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  rnb_bf16* X = reinterpret_cast<rnb_bf16*>(wg_smem);  // A tile [64][352]
  rnb_bf16* ring = X + WG_M * NRF_KW;
  rnb_bf16* e16 = ring + RS * NRF_FSTG;  // [64][96] PE(pts)
  rnb_bf16* v16 = e16 + WG_M * NRF_EW;   // [64][32] PE(views)
  WG_FRAG_ROWS;
  const long long n0 = (long long)blockIdx.x * WG_M;
  const int D = net.n_layers - 3, lh = D, lv = D + 1, lr = D + 2;
  const int E = net.E, V = 3 * (1 + 2 * multires_view);
  nerf_wg_pe(pts, views, n, C, multires, multires_view, E, n0, e16, v16, X);

  WgProduct prod;
  float acc[32];
  prod.set(w, net, 0, 0, 256);
  pipe_prologue<RS, NRF_FSTG>(ring, prod.nk, prod);
  // --- the trunk: h = relu(x W + b) in bf16, then e appended before a skip
  // layer (its input held as [h, e]) ---
  for (int l = 0; l < D; ++l) {
    pipe_run<RS, NRF_FSTG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n64<0, 1>(acc, rnb_desc(X + t * 1024, 1024, 128),
                          rnb_desc(st + wg * 8 * 64, 32 * 128, 128), t > 0);
    });
    if (l + 1 < D) prod.set(w, net, l + 1, 0, 256);
    else prod.set(w, net, lh, 0, rnb_pad16(net.out_dim[lh]));
    pipe_prologue<RS, NRF_FSTG>(ring, prod.nk, prod);
    wg_relu_put<8>(acc, b + net.b_off[l], 256, X, wg * 64);
    nerf_wg_append(X, rnb_pad16(net.in_dim[l + 1]),
                   net.skip[l + 1] ? e16 : nullptr, NRF_EW, E);
  }

  // --- the fused head: feature block N = 256 (4 x 64) and, by warpgroup 0
  // in the same K loop, the alpha column at 256 (N = 8) ---
  float acc8[4];
  {
    const uint32_t lbo = (uint32_t)prod.n8 * 128;
    pipe_run<RS, NRF_FSTG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n64<0, 1>(acc, rnb_desc(X + t * 1024, 1024, 128),
                          rnb_desc(st + wg * 8 * 64, lbo, 128), t > 0);
      if (wg == 0)
        rnb_wgmma_n8<0, 1>(acc8, rnb_desc(X + t * 1024, 1024, 128),
                           rnb_desc(st + (of >> 3) * 64, lbo, 128), t > 0);
    });
  }
  prod.set(w, net, lv, 0, 128);
  pipe_prologue<RS, NRF_FSTG>(ring, prod.nk, prod);
  // [rnd(feat), PE(views)] is the views layer's input
  wg_relu_put<8>(acc, b + net.b_off[lh], of, X, wg * 64, false);
  nerf_wg_append(X, rnb_pad16(net.in_dim[lv]), v16, NRF_VW, V);
  if (wg == 0) {
    const int oa = net.out_dim[lh] - of;
    const float* ba = b + net.b_off[lh] + of;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long long row = n0 + r0 + 8 * h;
        const int c = cq + u;
        if (c < oa && row < n) alpha[row * oa + c] = acc8[2 * h + u] + ba[c];
      }
  }

  // --- views layer (N = 128 as 4 x 32): relu in bf16 into columns 0..127 ---
  float acc16[16];
  pipe_run<RS, NRF_FSTG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n32<0, 1>(acc16, rnb_desc(X + t * 1024, 1024, 128),
                        rnb_desc(st + wg * 4 * 64, 16 * 128, 128), t > 0);
  });
  prod.set(w, net, lr, 0, 16);
  pipe_prologue<RS, NRF_FSTG>(ring, prod.nk, prod);
  wg_relu_put<4>(acc16, b + net.b_off[lv], net.out_dim[lv], X, wg * 32);

  // --- the rgb head (N = 8, warpgroup 0), from its accumulators ---
  pipe_run<RS, NRF_FSTG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
    if (wg == 0)
      rnb_wgmma_n8<0, 1>(acc8, rnb_desc(X + t * 1024, 1024, 128),
                         rnb_desc(st, 2 * 128, 128), t > 0);
  });
  if (wg == 0) {
    const int orr = net.out_dim[lr];
    const float* br = b + net.b_off[lr];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long long row = n0 + r0 + 8 * h;
        const int c = cq + u;
        if (c < orr && row < n) rgb[row * orr + c] = acc8[2 * h + u] + br[c];
      }
  }
}

// Image layers (net): 0..D-1 the trunk (skip[l]: input [h, e]), D the fused
// head [W_f | W_a] (feature columns 0..of-1), D+1 views, D+2 rgb; b and db
// in the same order.
static __global__ void __launch_bounds__(NRF_NT, 1)
nerf_bwd_wg_kernel(const float* __restrict__ pts,
                   const float* __restrict__ views, long long n, int C,
                   const rnb_bf16* __restrict__ w, const float* __restrict__ b,
                   RnbWgNet net, int of, int multires, int multires_view,
                   const float* __restrict__ calpha,
                   const float* __restrict__ crgb, rnb_bf16* __restrict__ abuf,
                   rnb_bf16* __restrict__ bbuf, float* __restrict__ dbp,
                   int db_len) {
  constexpr int RS = WG_RS;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  rnb_bf16* X = reinterpret_cast<rnb_bf16*>(wg_smem);  // A tile [64][352]
  rnb_bf16* ring = X + WG_M * NRF_KW;
  rnb_bf16* e16 = ring + RS * NRF_STG;  // [64][96] PE(pts)
  rnb_bf16* v16 = e16 + WG_M * NRF_EW;  // [64][32] PE(views)
  float* red = reinterpret_cast<float*>(v16 + WG_M * NRF_VW);    // [4][256]
  uint32_t* mbits = reinterpret_cast<uint32_t*>(red + 4 * 256);  // [D+1][512]
  const int tid = threadIdx.x, wg = tid >> 7;
  const long long tile = blockIdx.x, n0 = tile * WG_M;
  const int D = net.n_layers - 3, lh = D, lv = D + 1, lr = D + 2;
  const int E = net.E, V = 3 * (1 + 2 * multires_view);
  float* dbt = dbp + tile * db_len;

  nerf_wg_pe(pts, views, n, C, multires, multires_view, E, n0, e16, v16, X);
  wg_tile_out(X, rnb_pad16(E), n0, n, abuf + net.a_off[0]);

  WgProduct prod;
  float acc[32];
  prod.set(w, net, 0, 0, 256);
  pipe_prologue<RS, NRF_STG>(ring, prod.nk, prod);

  // --- recompute: the trunk (ReLU, masks as bits), then the feature head;
  // each epilogue writes the next A tile [h or rnd(feat), appended slice] ---
  for (int l = 0; l <= D; ++l) {
    pipe_run<RS, NRF_STG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n64<0, 1>(acc, rnb_desc(X + t * 1024, 1024, 128),
                          rnb_desc(st + wg * 8 * 64, 32 * 128, 128), t > 0);
    });
    if (l < D) prod.set(w, net, l + 1, 0, 256);
    else prod.set(w, net, lv, 0, 128);
    pipe_prologue<RS, NRF_STG>(ring, prod.nk, prod);
    // trunk and feature head are 256 wide (the wrapper holds them to it):
    // the epilogue fills columns 0..255, then the slice appended after
    // them: e before a skip layer (held as [h, e]), v before the views
    // layer, else none
    const bool head = l == D;
    const uint32_t bits =
        wg_relu_put<8>(acc, b + net.b_off[l], 256, X, wg * 64, !head);
    if (!head) mbits[l * NRF_NT + tid] = bits;
    const int kn = rnb_pad16(net.in_dim[l + 1]);
    nerf_wg_append(X, kn, head ? v16 : (net.skip[l + 1] ? e16 : nullptr),
                   head ? NRF_VW : NRF_EW, head ? V : E);
    __syncthreads();
    wg_tile_out(X, kn, n0, n, abuf + net.a_off[l + 1]);
  }

  // --- views layer (N = 128 as 4 x 32): its mask, the rgb head's A rows ---
  float acc16[16];
  pipe_run<RS, NRF_STG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n32<0, 1>(acc16, rnb_desc(X + t * 1024, 1024, 128),
                        rnb_desc(st + wg * 4 * 64, 16 * 128, 128), t > 0);
  });
  prod.set(w, net, lr, 1, 128);
  pipe_prologue<RS, NRF_STG>(ring, prod.nk, prod);
  mbits[D * NRF_NT + tid] = wg_relu_put<4>(acc16, b + net.b_off[lv],
                                           net.out_dim[lv], X, wg * 32);
  __syncthreads();
  wg_tile_out(X, rnb_pad16(net.out_dim[lv]), n0, n, abuf + net.a_off[lr]);
  __syncthreads();

  // --- rgb head: bar_z = c_rgb; then bar_z_v = (c_rgb W_rgbᵀ) ⊙ mask ---
  {
    const int orr = net.out_dim[lr];
    for (int idx = tid; idx < WG_M * 16; idx += NRF_NT) {
      const int p = idx >> 4, j = idx & 15;
      const long long row = n0 + p;
      X[wg_tidx(p, j)] = wg_bf(row < n && j < orr ? crgb[row * orr + j] : 0.0f);
    }
    if (tid < orr) {
      float s = 0.0f;
      for (int p = 0; p < WG_M && n0 + p < n; ++p) s += crgb[(n0 + p) * orr + tid];
      dbt[net.b_off[lr] + tid] = s;
    }
    __syncthreads();
    wg_tile_out(X, 16, n0, n, bbuf + net.bb_off[lr]);
  }
  pipe_run<RS, NRF_STG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n32<0, 0>(acc16, rnb_desc(X + t * 1024, 1024, 128),
                        rnb_desc(st + wg * 4 * 128, 128, 256), t > 0);
  });
  prod.set(w, net, lv, 1, 256);
  pipe_prologue<RS, NRF_STG>(ring, prod.nk, prod);
  {
    const int out = net.out_dim[lv];
    wg_mask_put<4>(acc16, mbits[D * NRF_NT + tid], X, red, wg * 32, n0, n);
    __syncthreads();
    if (tid < out) dbt[net.b_off[lv] + tid] = wg_colsum_get(red, tid);
    wg_tile_out(X, rnb_pad16(out), n0, n, bbuf + net.bb_off[lv]);
  }

  // --- bar_feat = (bar_z_v W_vᵀ)[:, :of]; the head's B rows
  // [rnd(bar_feat) | rnd(c_alpha)] become the next A tile (K = 272) ---
  pipe_run<RS, NRF_STG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
    rnb_wgmma_n64<0, 0>(acc, rnb_desc(X + t * 1024, 1024, 128),
                        rnb_desc(st + wg * 8 * 128, 128, 256), t > 0);
  });
  prod.set(w, net, lh, 1, 256);
  pipe_prologue<RS, NRF_STG>(ring, prod.nk, prod);
  {
    // the N = 256 block is the feature rows of W_v (of == 256): no mask
    wg_mask_put<8>(acc, 0xffffffffu, X, red, wg * 64, n0, n);
    __syncthreads();
    const int oa = net.out_dim[lh] - of, kh = rnb_pad16(net.out_dim[lh]);
    if (tid < of) dbt[net.b_off[lh] + tid] = wg_colsum_get(red, tid);
    for (int idx = tid; idx < WG_M * (kh - of); idx += NRF_NT) {
      const int p = idx / (kh - of), a = idx % (kh - of);
      const long long row = n0 + p;
      X[wg_tidx(p, of + a)] =
          wg_bf(a < oa && row < n ? calpha[row * oa + a] : 0.0f);
    }
    if (tid < oa) {
      float s = 0.0f;
      for (int p = 0; p < WG_M && n0 + p < n; ++p) s += calpha[(n0 + p) * oa + tid];
      dbt[net.b_off[lh] + of + tid] = s;
    }
    __syncthreads();
    wg_tile_out(X, kh, n0, n, bbuf + net.bb_off[lh]);
  }

  // --- the head's reverse, then the trunk's: bar_z_{l-1} = (bar_z_l W_lᵀ)
  // [the h rows] ⊙ mask_{l-1}; layer 0 has no reverse ---
  for (int l = lh; l >= 1; --l) {
    pipe_run<RS, NRF_STG>(ring, prod.nk, prod, [&](int t, const rnb_bf16* st) {
      rnb_wgmma_n64<0, 0>(acc, rnb_desc(X + t * 1024, 1024, 128),
                          rnb_desc(st + wg * 8 * 128, 128, 256), t > 0);
    });
    if (l > 1) {
      prod.set(w, net, l - 1, 1, 256);
      pipe_prologue<RS, NRF_STG>(ring, prod.nk, prod);
    }
    const int out = net.out_dim[l - 1];
    wg_mask_put<8>(acc, mbits[(l - 1) * NRF_NT + tid], X, red, wg * 64, n0, n);
    __syncthreads();
    if (tid < out) dbt[net.b_off[l - 1] + tid] = wg_colsum_get(red, tid);
    wg_tile_out(X, rnb_pad16(out), n0, n, bbuf + net.bb_off[l - 1]);
  }
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

// The bf16 forward over the image layers (see nerf_fwd_wg_kernel): raw
// alpha [n, oa] and rgb [n, orr].
extern "C" int rnb_nerf_fwd_wg(const float* pts, const float* views,
                               long long n, int C, const void* w,
                               const float* b, const int* in_dims,
                               const int* out_dims, const int* skip,
                               const long long* w_off, int n_layers, int of,
                               int multires, int multires_view, float* alpha,
                               float* rgb, void* stream) {
  RnbWgNet net;
  if (nerf_wg_net(&net, in_dims, out_dims, skip, w_off, nullptr, nullptr,
                  n_layers, of, C, multires, multires_view) < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(rnb_bf16) * (WG_M * (NRF_KW + NRF_EW + NRF_VW) +
                                             WG_RS * NRF_FSTG));
  cudaError_t err = cudaFuncSetAttribute(
      nerf_fwd_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + WG_M - 1) / WG_M;
  nerf_fwd_wg_kernel<<<(unsigned)tiles, NRF_NT, smem, (cudaStream_t)stream>>>(
      pts, views, n, C, static_cast<const rnb_bf16*>(w), b, net, of, multires,
      multires_view, alpha, rgb);
  return (int)cudaGetLastError();
}

// The bf16 backward sweep over the image layers (see nerf_bwd_wg_kernel):
// fills the bf16 dW scratch (A rows at a_off, B rows at bb_off, n rows of
// pad16(width) each) and writes db in image order; the wrapper then runs
// rnb_dw_products over the image layers and splits the head. dbp holds
// ceil(n/64)·Σ out floats.
extern "C" int rnb_nerf_bwd_wg(const float* pts, const float* views,
                               long long n, int C, const void* w,
                               const float* b, const int* in_dims,
                               const int* out_dims, const int* skip,
                               const long long* w_off, const long long* a_off,
                               const long long* bb_off, int n_layers, int of,
                               int multires, int multires_view,
                               const float* calpha, const float* crgb,
                               void* abuf, void* bbuf, float* dbp, float* db,
                               void* stream) {
  RnbWgNet net;
  const int db_len = nerf_wg_net(&net, in_dims, out_dims, skip, w_off, a_off,
                                 bb_off, n_layers, of, C, multires,
                                 multires_view);
  if (db_len < 0) return (int)cudaErrorInvalidValue;
  const int D = n_layers - 3;
  const int smem =
      (int)(sizeof(rnb_bf16) * (WG_M * (NRF_KW + NRF_EW + NRF_VW) +
                                WG_RS * NRF_STG) +
            sizeof(float) * 4 * 256 + sizeof(uint32_t) * (D + 1) * NRF_NT);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_bwd_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = (n + WG_M - 1) / WG_M;
  nerf_bwd_wg_kernel<<<(unsigned)tiles, NRF_NT, smem, st>>>(
      pts, views, n, C, static_cast<const rnb_bf16*>(w), b, net, of,
      multires, multires_view, calpha, crgb, static_cast<rnb_bf16*>(abuf),
      static_cast<rnb_bf16*>(bbuf), dbp, db_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rnb_sum_splits_kernel<<<(unsigned)((db_len + 255) / 256), 256, 0, st>>>(
      dbp, (int)tiles, db_len, db);
  return (int)cudaGetLastError();
}
