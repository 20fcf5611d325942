// Hopper's Tensor Memory Accelerator (TMA) and shared-memory barriers
// (mbarrier) for the warp-specialised kernels (dw_gemm.cu, the SDF core's
// forward and backward sweep in sdf_core.cu, the albedo and NeRF forwards
// and backward sweeps through wg_sweep.cuh): 2-D and 3-D tiled tensor
// maps encoded on the host, the bulk tensor loads and stores that one thread issues for a
// whole box and its bulk prefetch into L2, the barriers that count its
// bytes and the consumers' releases, a ring of stages that one producer
// thread feeds (RnbRing, rnb_ring_produce), the turns two consumer
// warpgroups take at it (RnbTurns), register reallocation between
// warpgroups, and the wgmma descriptor of a 128-byte-swizzled box as TMA
// writes it.
//
// The host encoder (cuTensorMapEncodeTiled) lives in libcuda; it is fetched
// through the runtime's entry-point query, so the library links no libcuda
// of its own.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

// ---------------------------------------------------------------------------
// host: a [rows, ld] row-major bf16 matrix as a TMA tensor map whose box is
// box_rows x box_cols (box_cols·2 = 128 B: one swizzle row), 128-byte
// swizzle; elements past ld or rows read as zero.
// ---------------------------------------------------------------------------

typedef CUresult (*RnbEncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

static inline RnbEncodeTiled rnb_encode_tiled() {
  static RnbEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<RnbEncodeTiled>(p);
  }
  return fn;
}

// 0 on success, else a cudaError_t value.
static inline int rnb_tma_map_bf16(CUtensorMap* map, const void* base, int ld,
                                   long long rows, int box_cols,
                                   int box_rows) {
  RnbEncodeTiled fn = rnb_encode_tiled();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)ld,
                              (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// 0 on success, else a cudaError_t value. A bf16 tensor of dims[0] x dims[1]
// x dims[2] elements (dims[0] contiguous; strides[0], strides[1] the byte
// strides of dims 1 and 2, multiples of 16) as a TMA tensor map without
// swizzle whose box is box[0] x box[1] x box[2] (box[0]·2 a multiple of 16
// bytes), written to shared memory in that order, dims[0] fastest; elements
// past a dim read as zero.
static inline int rnb_tma_map_bf16_3d(CUtensorMap* map, const void* base,
                                      const long long dims[3],
                                      const long long strides[2],
                                      const int box[3]) {
  RnbEncodeTiled fn = rnb_encode_tiled();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t gd[3] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1],
                            (cuuint64_t)dims[2]};
  const cuuint64_t gs[2] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1]};
  const cuuint32_t bx[3] = {(cuuint32_t)box[0], (cuuint32_t)box[1],
                            (cuuint32_t)box[2]};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), gd, gs, bx, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device
// ---------------------------------------------------------------------------

__device__ __forceinline__ void rnb_mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   rnb_smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void rnb_fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more transaction bytes (the TMA
// loads of a stage complete them).
__device__ __forceinline__ void rnb_mbar_expect_tx(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   rnb_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void rnb_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   rnb_smem_addr(bar))
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed (a fresh
// barrier counts its phase of parity 1 as completed).
__device__ __forceinline__ void rnb_mbar_wait(uint64_t* bar,
                                              unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "RNB_MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra RNB_MBAR_DONE;\n"
      "bra RNB_MBAR_WAIT;\n"
      "RNB_MBAR_DONE:\n"
      "}\n" ::"r"(rnb_smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The box at (column c0, row r0) of `map` into shared memory at dst (1024-B
// aligned for the 128-byte swizzle), completing its bytes on `bar`. `map`
// lies in parameter, constant or global memory.
__device__ __forceinline__ void rnb_tma_load_2d(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0,
                                                int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(rnb_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(rnb_smem_addr(bar)), "r"(c0),
      "r"(r0)
      : "memory");
}

// The box at (c0, c1, c2) of a 3-D `map` into shared memory at dst (16-B
// aligned: no swizzle), completing its bytes on `bar`.
__device__ __forceinline__ void rnb_tma_load_3d(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0, int c1,
                                                int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(rnb_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(rnb_smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The box of `map` at (column c0, row r0) written from shared memory at src
// (128-B aligned), in this thread's current bulk group; rows past the
// map's are not written. The writers of src fence (rnb_fence_proxy_async)
// and meet the issuing thread at a barrier first.
__device__ __forceinline__ void rnb_tma_store_2d(const CUtensorMap* map,
                                                 const void* src, int c0,
                                                 int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(rnb_smem_addr(src)), "r"(c0), "r"(r0)
      : "memory");
}
__device__ __forceinline__ void rnb_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups still read shared
// memory (their source may then be written again).
template <int N>
__device__ __forceinline__ void rnb_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void rnb_bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts bringing `bytes` (a multiple of 16) of global memory at src
// (16-B aligned) into L2, without waiting; later loads of it hit L2.
__device__ __forceinline__ void rnb_prefetch_l2(const void* src,
                                                unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

// A ring of RS stages in shared memory that one producer thread fills
// (TMA loads completing on the stage's full barrier) and consumer warps
// drain: a consumer waits on full, and each of its warps frees the stage
// on its empty barrier once its reads are done; the producer refills a
// stage once every consumer warp freed it. Stage `it` (0, 1, ... in the
// order both sides walk) lies in slot it % RS; the parities follow the
// passes over the ring. Nothing waits on a warp other than through these
// two barriers.
template <int RS>
struct RnbRing {
  unsigned char* base;   // RS slots of `bytes` bytes
  uint64_t* full;        // [RS]
  uint64_t* empty;       // [RS]
  int bytes;
  __device__ __forceinline__ unsigned char* stage(int it) const {
    return base + (it % RS) * bytes;
  }
  // one thread, before the block's first barrier
  __device__ __forceinline__ void init(unsigned consumer_warps) const {
    for (int s = 0; s < RS; ++s) {
      rnb_mbar_init(&full[s], 1);
      rnb_mbar_init(&empty[s], consumer_warps);
    }
  }
  __device__ __forceinline__ void wait_full(int it) const {
    rnb_mbar_wait(&full[it % RS], (it / RS) & 1);
  }
  // one warp's release of stage `it` (all its lanes call it)
  __device__ __forceinline__ void release(int it) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) rnb_mbar_arrive(&empty[it % RS]);
  }
  __device__ __forceinline__ void wait_empty(int it) const {
    rnb_mbar_wait(&empty[it % RS], ((it / RS) & 1) ^ 1);
  }
};

// The producer thread's loop: every stage of `cur` (done(); issue(stage,
// full barrier) expects the stage's bytes and starts its loads) into the
// ring, each once its slot is free.
template <int RS, class Cursor>
__device__ __forceinline__ void rnb_ring_produce(const RnbRing<RS>& ring,
                                                 Cursor& cur) {
  for (int it = 0; !cur.done(); ++it) {
    ring.wait_empty(it);
    cur.issue(ring.stage(it), &ring.full[it % RS]);
  }
}

// The turns two consumer warpgroups of a block take at one ring (a
// ping-pong, as CUTLASS's ping-pong GEMM): both read every stage, each on
// its own tile, and they alternate their product phases through two order
// barriers (consumer c's turn at order[c], consumer 0 first), so that one
// tile's epilogue runs under the other tile's products. A consumer hands
// the turn on once it has issued min(nk, RS) K-steps of a phase: its whole
// phase where the ring is as deep as the phase, else the ring's reach, where
// a later step would wait for a slot that only the other tile's next turn
// frees. A block with one tile (pair == 1) takes no turns. One wgmma
// group stays in flight; a stage is freed once its products retired.
template <int RS>
struct RnbTurns {
  RnbRing<RS> ring;
  uint64_t* order;   // [2], count 1 each
  int ci, pair, bar_id;
  int it = 0, phase = 0;
  // one thread, before the block's first barrier
  __device__ __forceinline__ void init() const {
    rnb_mbar_init(&order[0], 1);
    rnb_mbar_init(&order[1], 1);
  }
  // One product phase over nk stages: mma(t, stage) issues K-step t's
  // wgmmas (none where MMA is false: the timing splits' K loops alone);
  // tail() runs once the products retired, before the stage is freed and
  // the warpgroup meets at its named barrier (1 + ci) to close the phase:
  // the products read the A tile, which the epilogue then writes.
  template <bool MMA, class Mma, class Tail>
  __device__ __forceinline__ void product(int nk, Mma mma, Tail tail) {
    const int lt = threadIdx.x & 127;
    const bool turns = pair == 2;
    if (turns) rnb_mbar_wait(&order[ci], (phase & 1) ^ (ci == 0));
    const int handoff = (nk < RS ? nk : RS) - 1;
    for (int t = 0; t < nk; ++t, ++it) {
      ring.wait_full(it);
      if constexpr (MMA) {
        rnb_wgmma_fence();
        mma(t, reinterpret_cast<const __nv_bfloat16*>(ring.stage(it)));
        rnb_wgmma_commit();
        rnb_wgmma_wait<1>();
      }
      if (t > 0) ring.release(it - 1);
      if (turns && t == handoff && lt == 0) rnb_mbar_arrive(&order[ci ^ 1]);
    }
    if constexpr (MMA) rnb_wgmma_wait<0>();
    tail();
    ring.release(it - 1);
    ++phase;
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
  }
};

// Register reallocation between the warpgroups of a warp-specialised block
// (sm_90a): the producer gives registers back, the consumers take them.
template <int R>
__device__ __forceinline__ void rnb_setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void rnb_setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma descriptor of an MN-major operand in TMA's 128-byte swizzle: rows of
// 64 bf16 (128 B) along M or N, consecutive K rows 128 B apart, the XOR
// pattern repeating every 8 rows (1024 B, the SBO); LBO the byte stride
// between 64-wide column blocks along M or N. Layout type 1 (128B swizzle),
// base offset 0: every block starts 1024-B aligned.
__device__ __forceinline__ uint64_t rnb_desc_sw128(const void* smem,
                                                   uint32_t lbo) {
  return rnb_desc(smem, lbo, 1024) | (1ull << 62);
}
