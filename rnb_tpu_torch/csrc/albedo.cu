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
// What bounds it: arithmetic, ~0.15 M multiply-adds per point per chain at
// the shipped conf (310→256→256→3), on the CUDA cores in this version. The
// pre-activations the backward needs go to a global scratch written and read
// by the same block; the dW operands are reduced across points by the
// split-K kernels of common.cuh (deterministic, no atomics).
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

// x0 of the tile into X (rounded to the op dtype)
__device__ __forceinline__ void albedo_input(
    const float* __restrict__ pts, const float* __restrict__ nrm,
    const float* __restrict__ feat, long long n, int F, int multires, int bf,
    long long n0, int in0, int LD, float* X) {
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
  for (int idx = threadIdx.x; idx < P * in0; idx += blockDim.x) {
    const int p = idx / in0, i = idx % in0;
    X[p * LD + i] = rnb_rnd(X[p * LD + i], bf);
  }
  __syncthreads();
}

static __global__ void __launch_bounds__(RNB_NT)
albedo_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                  const float* __restrict__ feat, long long n, int F,
                  const float* __restrict__ w, const float* __restrict__ b,
                  RnbNet net, int multires, int bf, float* __restrict__ out) {
  constexpr int P = RNB_P;
  extern __shared__ __align__(16) float smem[];
  const int LD = net.ld;
  float* cur = smem;           // [P][LD]
  float* spare = cur + P * LD; // [P][LD]
  const long long n0 = (long long)blockIdx.x * P;
  const int L = net.n_layers;
  albedo_input(pts, nrm, feat, n, F, multires, bf, n0, net.in_dim[0], LD, cur);
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
          spare[p * LD + c] = rnb_rnd(fmaxf(z, 0.0f), bf);
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
                  int bf, const float* __restrict__ cout,
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
  albedo_input(pts, nrm, feat, n, F, multires, bf, n0, net.in_dim[0], LD, cur);

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
          spare[p * LD + c] = rnb_rnd(fmaxf(z, 0.0f), bf);
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
      cur[p * LD + j] = rnb_rnd(z, bf);
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

extern "C" int rnb_albedo_fwd(const float* pts, const float* nrm,
                              const float* feat, long long n, int F,
                              const float* w, const float* b,
                              const int* in_dims, const int* out_dims,
                              int n_layers, int multires, int bf, float* out,
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
      pts, nrm, feat, n, F, w, b, net, multires, bf, out);
  return (int)cudaGetLastError();
}

extern "C" int rnb_albedo_bwd(const float* pts, const float* nrm,
                              const float* feat, long long n, int F,
                              const float* w, const float* wt, const float* b,
                              const int* in_dims, const int* out_dims,
                              int n_layers, int multires, int bf,
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
      pts, nrm, feat, n, F, w, wt, b, net, multires, bf, cout, rec, rec_ld,
      abuf, bbuf, cnrm, cfeat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < n_layers; ++l) {
    err = rnb_reduce_layer(abuf + net.a_off[l], bbuf + net.bb_off[l], n, n,
                           in_dims[l], out_dims[l], bf, splits, partial,
                           dw + net.w_off[l], db + net.b_off[l], st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
