// The dW products of the bf16 backwards on Hopper (sm_90a): for every layer
// l of one backward, dW_l[i, j] = Σ_k A_l[k, i]·B_l[k, j] over the bf16
// operand rows that the backward sweep wrote (A_l its inputs [K, lda_l], B_l
// its rounded pre-activation cotangents [K, ldb_l], row-major; K the points,
// or twice them for the SDF core's primal and tangent rows), f32 sums. One
// grouped launch covers all layers, then one fixed-order pass sums the row
// splits: deterministic, no float atomics.
//
// Replaces the dW sums inside three TPU kernels, each of which accumulated
// dW across its sequential grid in VMEM scratch:
//   rnb_tpu/ops/pallas_sdf_core.py _bwd_kernel (:232)  9 products, 2n rows
//   rnb_tpu/ops/pallas_albedo.py   _bwd_kernel (:101)  3 products, n rows
//   rnb_tpu/ops/pallas_nerf.py     _bwd_kernel (:122)  11 products, n rows
// Blocks on the card run in parallel and carry nothing over, so the sweeps
// write the operand rows and this kernel reduces them.
//
// What bounds it on the H100: bytes. A 256x256 layer does 128 FLOP a byte
// read, under the ~295 at which the tensor cores would be the limit. The
// SDF core's 9 products at 65,536 points read Σ(in + out) = 4,353 bf16
// columns x 131,072 rows = 1.141 GB: 0.341 ms at 3.35 TB/s (137.5 GFLOP,
// 0.139 ms at 989 TFLOP/s).
//
// What the design does about that:
//   * one persistent launch a backward over a work list of units (layer,
//     m-tile, n-tile, row split) built on the host (ops/wg.py dw_work), at
//     most one block an SM, each walking units blockIdx.x, +gridDim.x, ...;
//     the m-tiles of one layer's row split are neighbours in the list, so
//     the blocks that read one B slab run side by side and the second
//     reader finds it in L2;
//   * tiles of 128 (M) x BN (N), BN = 256, or 128 or 64 for a layer's last
//     columns (the 256x257 head: 256 + 64, the albedo's 3-wide head: 64;
//     64 is one swizzle row, the narrowest MN-major box): a 256-wide layer
//     reads its A slab once and its B slab twice (the second time from
//     L2);
//   * warp specialisation: one producer thread issues TMA loads (64 rows x
//     64 columns a box, 128-byte swizzle, zeros past K and past lda / ldb)
//     into a ring of DW_STAGES stages of 64 rows (A 64x128, B 64x256: 48 KB
//     each), full and empty mbarriers per stage; two consumer warpgroups,
//     each the 64 rows of M of its half of the tile, issue m64nBNk16 wgmma
//     from the swizzled boxes (both operands MN-major: the transpose bits
//     set) and free a stage once its products have retired; setmaxnreg
//     moves registers from the producer to the consumers (128 f32
//     accumulators a thread at BN = 256). No address arithmetic and no
//     block-wide barrier per stage;
//   * the split count depends only on the shapes (ops/wg.py dw_splits:
//     about one unit an SM), so partials are about splits x Σ M·N floats
//     (14 MB for the SDF core's group), written once by the consumers
//     while the producer already loads the next unit's rows, and summed in
//     split order 0..S-1 by rnb_sum_splits_kernel (common.cuh): two calls
//     on the same operands give the same bits.
//
// On the H100 (700 W) the SDF core's group takes 0.425 ms, 80% of its byte
// bound, against 0.705 ms for one torch.matmul a layer (PERF.md §6).
//
// ptxas (-Xptxas -v, in _build.build_info["main"]["log"]; chip_smoke.py
// prints it and holds it against this note):
//   rnb_dw_products_kernel       168 registers, no spill; 197,696 B dynamic
//                                shared memory. ptxas also reports C7518:
//                                the wgmmas are serialized (a warpgroup
//                                dependency wait in a branch it cannot prove
//                                uniform: the live test, the BN switch);
//                                at 80% of the byte bound it can cost at
//                                most the rest (PERF.md §7).
#include "tma.cuh"
#include "wg_pipe.cuh"

#define DW_BOX 64                               // rows and columns of a box
#define DW_BOX_BYTES (DW_BOX * DW_BOX * 2)      // 8 KB, 1024-B aligned
#define DW_STAGE_BYTES (6 * DW_BOX_BYTES)       // A: 2 boxes, B: 4 boxes
#define DW_STAGES 4
#define DW_THREADS 384      // producer warpgroup + two consumer warpgroups
#define DW_SMEM (DW_STAGES * DW_STAGE_BYTES + 1024 + 2 * DW_STAGES * 8)

// The launch's arguments, in kernel parameter space (__grid_constant__):
// the tensor maps must lie in parameter, constant or global memory.
struct DwParams {
  CUtensorMap a[RNB_MAXL];  // layer l's A rows: [k, lda_l] bf16
  CUtensorMap b[RNB_MAXL];  // layer l's B rows: [k, ldb_l] bf16
  int m[RNB_MAXL], n[RNB_MAXL];
  long long poff[RNB_MAXL];  // layer l's dW [m, n] within a split's slice
  long long tot;            // Σ m·n, the floats of one split's slice
  long long k, chunk;       // rows; rows a split (a multiple of DW_BOX)
  const int4* units;        // (layer | bn << 8, m0, n0, split)
  int n_units;
  float* partial;           // [splits, tot]
};

struct DwUnit {
  int l, bn, m0, n0, split, ns, m, n;
  long long k0;
};

__device__ __forceinline__ DwUnit dw_unit(const DwParams& p, int u) {
  const int4 w = __ldg(p.units + u);
  DwUnit d;
  d.l = w.x & 255;
  d.bn = w.x >> 8;
  d.m0 = w.y;
  d.n0 = w.z;
  d.split = w.w;
  d.k0 = (long long)d.split * p.chunk;
  const long long k1 = d.k0 + p.chunk < p.k ? d.k0 + p.chunk : p.k;
  d.ns = k1 > d.k0 ? (int)((k1 - d.k0 + DW_BOX - 1) / DW_BOX) : 0;
  d.m = p.m[d.l];
  d.n = p.n[d.l];
  return d;
}

// The producer thread: for each stage of each of its units, wait until the
// consumers freed the ring slot, then load A (one box, or two when the
// tile's second 64 rows of M hold a column of A) and B (BN/64 boxes).
__device__ __forceinline__ void dw_produce(const DwParams& p,
                                           unsigned char* ring,
                                           uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const DwUnit w = dw_unit(p, u);
    const int na = w.m - w.m0 > DW_BOX ? 2 : 1;
    const int nb = (w.bn + DW_BOX - 1) / DW_BOX;
    const unsigned bytes = (unsigned)((na + nb) * DW_BOX_BYTES);
    for (int t = 0; t < w.ns; ++t, ++it) {
      const int s = it % DW_STAGES;
      rnb_mbar_wait(&empty[s], ((it / DW_STAGES) & 1) ^ 1);
      unsigned char* st = ring + s * DW_STAGE_BYTES;
      const int row = (int)(w.k0 + (long long)t * DW_BOX);
      rnb_mbar_expect_tx(&full[s], bytes);
      for (int i = 0; i < na; ++i)
        rnb_tma_load_2d(st + i * DW_BOX_BYTES, &p.a[w.l], &full[s],
                        w.m0 + DW_BOX * i, row);
      for (int j = 0; j < nb; ++j)
        rnb_tma_load_2d(st + (2 + j) * DW_BOX_BYTES, &p.b[w.l], &full[s],
                        w.n0 + DW_BOX * j, row);
    }
  }
}

template <int BN>
__device__ __forceinline__ void dw_wgmma(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256) rnb_wgmma_n256<1, 1>(d, da, db, 1);
  else if constexpr (BN == 128) rnb_wgmma_n128<1, 1>(d, da, db, 1);
  else rnb_wgmma_n64<1, 1>(d, da, db, 1);
}

// One warp's release of a ring slot (the empty barriers count 8 warps).
__device__ __forceinline__ void dw_release(uint64_t* empty, int it) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) rnb_mbar_arrive(&empty[it % DW_STAGES]);
}

// Consumer warpgroup c (0, 1) of one unit: rows m0 + 64c .. +63 of the tile
// against its BN columns, summed over the unit's stages, then written to the
// unit's split slice of the partials. A warpgroup whose rows all lie past m
// ("not live") only frees the stages. One wgmma group stays in flight: the
// stage before is freed once its products retired.
template <int BN>
__device__ __forceinline__ void dw_consume(const DwParams& p,
                                           const unsigned char* ring,
                                           uint64_t* full, uint64_t* empty,
                                           int& it, const DwUnit& w, int c) {
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  const bool live = w.m0 + DW_BOX * c < w.m;
  for (int t = 0; t < w.ns; ++t, ++it) {
    const int s = it % DW_STAGES;
    rnb_mbar_wait(&full[s], (it / DW_STAGES) & 1);
    if (live) {
      const unsigned char* st = ring + s * DW_STAGE_BYTES;
      rnb_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DW_BOX / 16; ++kk) {
        // 16 rows of K are 16 swizzled 128-B rows: 2048 B into the box
        dw_wgmma<BN>(acc,
                     rnb_desc_sw128(st + c * DW_BOX_BYTES + kk * 2048,
                                    DW_BOX_BYTES),
                     rnb_desc_sw128(st + 2 * DW_BOX_BYTES + kk * 2048,
                                    DW_BOX_BYTES));
      }
      rnb_wgmma_commit();
      rnb_wgmma_wait<1>();
    }
    if (t > 0) dw_release(empty, it - 1);
  }
  if (live) rnb_wgmma_wait<0>();
  if (w.ns > 0) dw_release(empty, it - 1);
  if (!live) return;
  const int lt = threadIdx.x & 127;
  const int r = w.m0 + DW_BOX * c + ((lt >> 5) << 4) + ((lt & 31) >> 2);
  const int cq = 2 * (lt & 3);
  float* out = p.partial + (long long)w.split * p.tot + p.poff[w.l];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = r + 8 * h, jj = w.n0 + 8 * j + cq + v;
        if (i < w.m && jj < w.n)
          out[(long long)i * w.n + jj] = acc[4 * j + 2 * h + v];
      }
}

static __global__ void __launch_bounds__(DW_THREADS, 1)
rnb_dw_products_kernel(const __grid_constant__ DwParams p) {
  extern __shared__ unsigned char dw_smem_raw[];
  // the swizzle pattern follows address bits 4-9: boxes start 1024-B aligned
  unsigned char* ring =
      dw_smem_raw + ((1024u - (rnb_smem_addr(dw_smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DW_STAGES * DW_STAGE_BYTES);
  uint64_t* empty = full + DW_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      rnb_mbar_init(&full[s], 1);
      rnb_mbar_init(&empty[s], 8);
    }
    rnb_fence_mbar_init();
  }
  __syncthreads();
  const int wgi = threadIdx.x >> 7;
  if (wgi == 0) {
    rnb_setmaxnreg_dec<40>();
    if (threadIdx.x == 0) dw_produce(p, ring, full, empty);
  } else {
    rnb_setmaxnreg_inc<232>();
    int it = 0;
    for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
      const DwUnit w = dw_unit(p, u);
      switch (w.bn) {
        case 256: dw_consume<256>(p, ring, full, empty, it, w, wgi - 1); break;
        case 128: dw_consume<128>(p, ring, full, empty, it, w, wgi - 1); break;
        default: dw_consume<64>(p, ring, full, empty, it, w, wgi - 1); break;
      }
    }
  }
}

// dw = [dW_0, dW_1, ...] flat ([m_l, n_l] each, row-major) for the layers of
// one backward: layer l's A rows at a + a_off[l] ([k, lda_l]) and B rows at
// b + b_off[l] ([k, ldb_l]), bf16, 16-B aligned, lda_l and ldb_l multiples
// of 8. `units` (device, n_units int4) and (chunk, splits) come from
// ops/wg.py dw_work; partial holds splits·Σ m_l·n_l floats.
extern "C" int rnb_dw_products(const void* a, const void* b, int n_layers,
                               const int* m, const int* n, const int* lda,
                               const int* ldb, const long long* a_off,
                               const long long* b_off, long long k,
                               long long chunk, int splits, const void* units,
                               int n_units, float* partial, float* dw,
                               void* stream) {
  if (n_layers < 1 || n_layers > RNB_MAXL || k < 0 || chunk <= 0 ||
      chunk % DW_BOX || splits < 1 || (long long)splits * chunk < k ||
      n_units < 1)
    return (int)cudaErrorInvalidValue;
  DwParams p;
  long long tot = 0;
  for (int l = 0; l < n_layers; ++l) {
    const rnb_bf16* al = static_cast<const rnb_bf16*>(a) + a_off[l];
    const rnb_bf16* bl = static_cast<const rnb_bf16*>(b) + b_off[l];
    if (lda[l] % 8 || ldb[l] % 8 || m[l] < 1 || n[l] < 1 || m[l] > lda[l] ||
        n[l] > ldb[l] || reinterpret_cast<uintptr_t>(al) % 16 ||
        reinterpret_cast<uintptr_t>(bl) % 16)
      return (int)cudaErrorInvalidValue;
    int rc = rnb_tma_map_bf16(&p.a[l], al, lda[l], k, DW_BOX, DW_BOX);
    if (!rc) rc = rnb_tma_map_bf16(&p.b[l], bl, ldb[l], k, DW_BOX, DW_BOX);
    if (rc) return rc;
    p.m[l] = m[l];
    p.n[l] = n[l];
    p.poff[l] = tot;
    tot += (long long)m[l] * n[l];
  }
  p.tot = tot;
  p.k = k;
  p.chunk = chunk;
  p.units = static_cast<const int4*>(units);
  p.n_units = n_units;
  p.partial = partial;

  // per device, once a process: the SM count (where the blocks go, never
  // what they sum) and the ring's shared-memory size
  static int sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaFuncSetAttribute(rnb_dw_products_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DW_SMEM);
    if (err != cudaSuccess) return (int)err;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = count;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = n_units < sms[dev] ? n_units : sms[dev];
  rnb_dw_products_kernel<<<grid, DW_THREADS, DW_SMEM, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rnb_sum_splits_kernel<<<(unsigned)((tot + 255) / 256), 256, 0, st>>>(
      partial, splits, tot, dw);
  return (int)cudaGetLastError();
}
