// Shared pieces of the Hopper kernels (sdf_core.cu, albedo.cu, nerf.cu).
//
// Conventions of the CUDA-core kernels in this directory (the tensor-core
// kernels of the bf16 routes build on wg_pipe.cuh instead):
//   * fp32 tensors, row-major, contiguous; weights W_l are [in, out] and
//     arrive already rounded to the op dtype by the Python wrapper, which
//     also passes W_l^T ([out, in]) for the reverse products. Both are the
//     layers' matrices concatenated in one flat buffer, layer after layer.
//   * activations that are matmul operands are rounded to the op dtype
//     (bf16 or fp32) in the kernel, exactly where the TPU kernels cast them;
//     every sum accumulates in fp32.
//   * a point-tile of P points per block of NT threads; thread c computes
//     output column c of the tile's P rows (P accumulators in registers),
//     reading the operand rows from shared memory as float4 broadcasts and
//     the weight column from global memory (L2-resident: the nets are
//     2.4 MB). Products run on the CUDA cores.
//   * rows past n are computed from zero inputs and never stored, so a
//     ragged edge adds exactly nothing.
//   * the parameter gradients are sums over all points. Blocks run in
//     parallel, so the sweep kernels write per-point operands (A rows: layer
//     inputs, B rows: pre-activation cotangents) and dW = A^T B, db = sum B
//     are reduced by the split-K kernels below: per-split partial tiles,
//     then a sum over splits in a fixed order. Deterministic, no atomics.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define RNB_MAXL 16
#define RNB_P 16      // points per block in the sweep kernels
#define RNB_NT 256    // threads per block in the sweep kernels

struct RnbNet {
  int n_layers;
  int in_dim[RNB_MAXL];
  int out_dim[RNB_MAXL];
  int skip[RNB_MAXL];
  long long w_off[RNB_MAXL];  // offset of W_l (and of W_l^T) in the flat buffers
  long long b_off[RNB_MAXL];  // offset of b_l
  long long a_off[RNB_MAXL];  // offset of layer l's A rows in the A scratch
  long long bb_off[RNB_MAXL]; // offset of layer l's B rows in the B scratch
  int ld;                     // padded width of a shared activation row
};

// rows_per_point: 2 for the SDF core (primal and tangent rows), 1 for albedo
static inline int rnb_make_net(RnbNet* net, const int* in_dims,
                               const int* out_dims, const int* skip,
                               int n_layers, long long n, int rows_per_point) {
  if (n_layers < 1 || n_layers > RNB_MAXL) return 1;
  net->n_layers = n_layers;
  long long w = 0, b = 0, a = 0, bb = 0;
  int mx = 0;
  for (int l = 0; l < n_layers; ++l) {
    net->in_dim[l] = in_dims[l];
    net->out_dim[l] = out_dims[l];
    net->skip[l] = skip ? skip[l] : 0;
    net->w_off[l] = w;
    net->b_off[l] = b;
    net->a_off[l] = a;
    net->bb_off[l] = bb;
    w += (long long)in_dims[l] * out_dims[l];
    b += out_dims[l];
    a += rows_per_point * n * in_dims[l];
    bb += rows_per_point * n * out_dims[l];
    mx = in_dims[l] > mx ? in_dims[l] : mx;
    mx = out_dims[l] > mx ? out_dims[l] : mx;
  }
  net->ld = (mx + 3) & ~3;
  return 0;
}

__device__ __forceinline__ float rnb_rnd(float x, int bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// (sigmoid(100 z), softplus(100 z)/100) from one exp and one log1p, stable
// in both tails.
__device__ __forceinline__ void rnb_softplus100_pair(float z, float* s,
                                                     float* h) {
  float t = expf(-100.0f * fabsf(z));
  float inv = 1.0f / (1.0f + t);
  *s = z >= 0.0f ? inv : t * inv;
  *h = fmaxf(z, 0.0f) + log1pf(t) * 0.01f;
}

__device__ __forceinline__ float rnb_sigmoid(float z) {
  float t = expf(-fabsf(z));
  float inv = 1.0f / (1.0f + t);
  return z >= 0.0f ? inv : t * inv;
}

// acc[p] = sum_{r<R} X[p*ldx + r] * M[r*C + c]   (p < P)
// X in shared memory, ldx % 4 == 0, 16-byte aligned rows.
template <int P>
__device__ __forceinline__ void rnb_dot_col(const float* __restrict__ X,
                                            int ldx, int R,
                                            const float* __restrict__ M,
                                            int C, int c, float (&acc)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0f;
  int r = 0;
  for (; r + 4 <= R; r += 4) {
    const float m0 = __ldg(M + (long long)(r + 0) * C + c);
    const float m1 = __ldg(M + (long long)(r + 1) * C + c);
    const float m2 = __ldg(M + (long long)(r + 2) * C + c);
    const float m3 = __ldg(M + (long long)(r + 3) * C + c);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(X + p * ldx + r);
      acc[p] = fmaf(x.x, m0, acc[p]);
      acc[p] = fmaf(x.y, m1, acc[p]);
      acc[p] = fmaf(x.z, m2, acc[p]);
      acc[p] = fmaf(x.w, m3, acc[p]);
    }
  }
  for (; r < R; ++r) {
    const float m = __ldg(M + (long long)r * C + c);
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = fmaf(X[p * ldx + r], m, acc[p]);
  }
}

// Two operand slabs against the same weight column (primal and tangent).
template <int P>
__device__ __forceinline__ void rnb_dot_col2(const float* __restrict__ X,
                                             const float* __restrict__ TX,
                                             int ldx, int R,
                                             const float* __restrict__ M,
                                             int C, int c, float (&acc)[P],
                                             float (&tacc)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    acc[p] = 0.0f;
    tacc[p] = 0.0f;
  }
  int r = 0;
  for (; r + 4 <= R; r += 4) {
    const float m0 = __ldg(M + (long long)(r + 0) * C + c);
    const float m1 = __ldg(M + (long long)(r + 1) * C + c);
    const float m2 = __ldg(M + (long long)(r + 2) * C + c);
    const float m3 = __ldg(M + (long long)(r + 3) * C + c);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(X + p * ldx + r);
      const float4 t = *reinterpret_cast<const float4*>(TX + p * ldx + r);
      acc[p] = fmaf(x.x, m0, acc[p]);
      acc[p] = fmaf(x.y, m1, acc[p]);
      acc[p] = fmaf(x.z, m2, acc[p]);
      acc[p] = fmaf(x.w, m3, acc[p]);
      tacc[p] = fmaf(t.x, m0, tacc[p]);
      tacc[p] = fmaf(t.y, m1, tacc[p]);
      tacc[p] = fmaf(t.z, m2, tacc[p]);
      tacc[p] = fmaf(t.w, m3, tacc[p]);
    }
  }
  for (; r < R; ++r) {
    const float m = __ldg(M + (long long)r * C + c);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      acc[p] = fmaf(X[p * ldx + r], m, acc[p]);
      tacc[p] = fmaf(TX[p * ldx + r], m, tacc[p]);
    }
  }
}

// ---------------------------------------------------------------------------
// split-K reduction: C[M,N] = sum_{k<K} A[k,i] * rnd(B[k,j]); db = sum B
// ---------------------------------------------------------------------------

#define RNB_TILE 64
#define RNB_TK 16

// grid (ceil(N/64), ceil(M/64), splits); 256 threads, each a 4x4 sub-tile
static __global__ void __launch_bounds__(256)
rnb_atb_partial_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       long long K, int M, int N, long long kchunk, int bf,
                       float* __restrict__ partial) {
  __shared__ __align__(16) float As[RNB_TK][RNB_TILE];
  __shared__ __align__(16) float Bs[RNB_TK][RNB_TILE];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int j0 = blockIdx.x * RNB_TILE, i0 = blockIdx.y * RNB_TILE;
  const long long kb = (long long)blockIdx.z * kchunk;
  const long long ke = kb + kchunk < K ? kb + kchunk : K;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (long long k0 = kb; k0 < ke; k0 += RNB_TK) {
    for (int e = tid; e < RNB_TK * RNB_TILE; e += 256) {
      const int kk = e / RNB_TILE, ii = e % RNB_TILE;
      const long long k = k0 + kk;
      const bool kin = k < ke;
      const int i = i0 + ii, j = j0 + ii;
      As[kk][ii] = (kin && i < M) ? A[k * M + i] : 0.0f;
      Bs[kk][ii] = (kin && j < N) ? rnb_rnd(B[k * N + j], bf) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < RNB_TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = partial + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (j < N) out[(long long)i * N + j] = acc[r][c];
    }
  }
}

// grid (ceil(N/256), splits)
static __global__ void rnb_colsum_partial_kernel(const float* __restrict__ B,
                                                 long long K, int N,
                                                 long long kchunk,
                                                 float* __restrict__ partial) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const long long kb = (long long)blockIdx.y * kchunk;
  const long long ke = kb + kchunk < K ? kb + kchunk : K;
  float s = 0.0f;
  for (long long k = kb; k < ke; ++k) s += B[k * N + j];
  partial[(long long)blockIdx.y * N + j] = s;
}

static __global__ void rnb_sum_splits_kernel(const float* __restrict__ partial,
                                             int splits, long long len,
                                             float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= len) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[(long long)z * len + idx];
  out[idx] = s;
}

// dW[M,N] = sum_{k<K} A[k,:]^T rnd(B[k,:]), db[N] = sum_{k<Kb} B[k,:]
static inline cudaError_t rnb_reduce_layer(const float* A, const float* B,
                                           long long K, long long Kb, int M,
                                           int N, int bf, int splits,
                                           float* partial, float* dw,
                                           float* db, cudaStream_t st) {
  const long long kchunk = (K + splits - 1) / splits;
  dim3 g((N + RNB_TILE - 1) / RNB_TILE, (M + RNB_TILE - 1) / RNB_TILE, splits);
  rnb_atb_partial_kernel<<<g, 256, 0, st>>>(A, B, K, M, N, kchunk, bf, partial);
  const long long mn = (long long)M * N;
  rnb_sum_splits_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      partial, splits, mn, dw);
  const long long kbchunk = (Kb + splits - 1) / splits;
  dim3 gc((N + 255) / 256, splits);
  rnb_colsum_partial_kernel<<<gc, 256, 0, st>>>(B, Kb, N, kbchunk, partial);
  rnb_sum_splits_kernel<<<(unsigned)((N + 255) / 256), 256, 0, st>>>(
      partial, splits, N, db);
  return cudaGetLastError();
}
