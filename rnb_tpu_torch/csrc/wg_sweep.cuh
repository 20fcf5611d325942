// The pieces shared by the bf16 sweeps of the albedo net and the
// background NeRF, forward and backward (albedo.cu albedo_fwd_wg_kernel,
// albedo_bwd_wg_kernel; nerf.cu nerf_fwd_wg_kernel, nerf_bwd_wg_kernel): one
// block a pair of 64-point tiles, a producer warpgroup whose one thread
// loads the weight image into a TMA ring (RnbRing, tma.cuh) in the order of
// a table of product phases, two consumer warpgroups that each own a whole
// tile at N = 256 and take turns at the ring (RnbTurns, tma.cuh), the bias
// staged by cp.async, branch-free epilogues into the K-major A tile (in
// wgmma's 128-byte swizzle), and, in the backward sweeps, the operand rows
// written by TMA stores from that tile (so that a store writes whole
// 128-byte rows).
//
// A phase is one product: nk K-steps of 16, each one 3-D box of the layer's
// tile of the 8x8-core weight image (dims {64, npc, kpc}, as sdf_core.cu's
// sdf_layer_map): the forward's K-step t at (0, 0, 2t), box {64, nb, 2}
// (nb output cores, MN-major B: LBO nb·128 B, SBO 128 B); the reverse's
// (the Wᵀ read) at (0, 2t, c2), box {64, 2, ib} (ib input cores from core
// c2, K-major B: LBO 128 B, SBO 256 B). Boxes past the tile read zeros.
// ops/albedo.py and ops/nerf.py fwd_steps / bwd_steps describe the same
// tables and the CPU tests hold them against the products of the plain
// versions.
#pragma once

#include "tma.cuh"
#include "wg_pipe.cuh"

#define WB_NT 384          // a producer warpgroup and two consumer warpgroups
#define WB_STAGE 8192      // bytes of a ring slot: 2 x 32 cores (the NeRF
                           // forward's slot is larger, nerf.cu NF_STAGE)
#define WB_MAXPH 24        // product phases a sweep may have

// The timing split of the sweeps (the tune library only; each instance
// strips one part and keeps the rest; ops/wg.py WG_BWD_SPLIT, and
// WG_FWD_SPLIT of the forwards, which write no rows).
enum WgSplit {
  WB_FULL = 0,            // the production kernel
  WB_K_LOOPS_ONLY = 1,    // the ring and its barriers: no wgmma, no epilogue
  WB_PRODUCTS_ONLY = 2,   // no epilogue arithmetic, no operand rows (the
                          // forwards: no epilogue, nothing written)
  WB_NO_ROWS = 3,         // no operand-row stores
  WB_NO_EPILOGUE = 4      // no bias, ReLU or mask work: acc rounded into X
                          // (the forwards: the heads written raw)
};

struct RnbPhase {
  int map;    // index of its tensor map (WbParams::wmap)
  int nk;     // K-steps
  int rev;    // 0: forward box at (0, 0, 2t); 1: reverse box at (0, 2t, c2)
  int c2;     // the reverse box's first input core
  int bytes;  // bytes of one box
};

// The launch's arguments in kernel parameter space (__grid_constant__: the
// tensor maps must lie in parameter, constant or global memory).
struct WbParams {
  RnbWgNet net;
  const float* in0;    // pts
  const float* in1;    // views (NeRF) / normals (albedo)
  const float* in2;    // feat (albedo)
  const float* b;      // biases in image order
  const float* cot0;   // c_alpha (NeRF) / c_out (albedo); backward
  const float* cot1;   // c_rgb (NeRF); backward
  float* dbp;          // per-tile db, ceil(n/64) x db_len; backward
  float* out0;         // c_normals (albedo backward), out (albedo forward),
                       // alpha (NeRF forward)
  float* out1;         // c_feat (albedo backward), rgb (NeRF forward)
  long long n;
  int db_len, C, F, multires, multires_view, of;
  int stage;           // bytes of a ring slot
  int n_ph;
  RnbPhase ph[WB_MAXPH];
  CUtensorMap wmap[WB_MAXPH];    // a phase's layer tile with its box
  CUtensorMap amap[RNB_MAXL];    // layer l's A rows [n, pad16(in)]; backward
  CUtensorMap bmap[RNB_MAXL];    // layer l's B rows [n, pad16(out)]; backward
};

// shared memory of a block: two tiles of `tile_bytes` (each 1 KB aligned),
// RS ring slots of `stage` bytes, the ring's full and empty barriers and
// the two turn barriers
__host__ __device__ constexpr int wb_smem_bytes(int rs, int stage,
                                                int tile_bytes) {
  return 2 * tile_bytes + rs * stage + (2 * rs + 2) * 8;
}

// The producer thread's walk over the phase table.
struct WbCursor {
  const WbParams* p;
  int i, t;
  __device__ __forceinline__ bool done() const { return i >= p->n_ph; }
  __device__ __forceinline__ void issue(unsigned char* st, uint64_t* bar) {
    const RnbPhase& ph = p->ph[i];
    rnb_mbar_expect_tx(bar, ph.bytes);
    if (ph.rev) rnb_tma_load_3d(st, &p->wmap[ph.map], bar, 0, 2 * t, ph.c2);
    else rnb_tma_load_3d(st, &p->wmap[ph.map], bar, 0, 0, 2 * t);
    if (++t == ph.nk) {
      t = 0;
      ++i;
    }
  }
};

// The start of a sweep block (WB_NT threads, tiles 2b and 2b + 1): the two
// tiles' areas of `tile` bytes at the front of shared memory, then RS ring
// slots of `stage` bytes, then the ring's and the turns' barriers, which
// thread 0 sets up. -> the turns of consumer warpgroup ci = threadIdx.x /
// 128 - 1 (its tile of the pair; the producer's threads get ci -1). The
// kernel then sends the producer warpgroup (threadIdx.x < 128) to
// wb_produce and returns it, and raises a consumer's registers
// (setmaxnreg) itself: code after a join of the two paths would be held to
// the lower register budget, and spill.
template <int RS>
__device__ __forceinline__ RnbTurns<RS> wb_begin(const WbParams& p,
                                                 unsigned char* smem,
                                                 int stage, int tile) {
  const long long tiles = (p.n + WG_M - 1) / WG_M;
  const int pair = tiles > 2 * (long long)blockIdx.x + 1 ? 2 : 1;
  RnbRing<RS> ring;
  ring.base = smem + 2 * tile;
  ring.bytes = stage;
  ring.full = reinterpret_cast<uint64_t*>(smem + 2 * tile + RS * stage);
  ring.empty = ring.full + RS;
  const int ci = (threadIdx.x >> 7) - 1;
  RnbTurns<RS> turns{ring, ring.empty + RS, ci, pair, 1 + ci};
  if (threadIdx.x == 0) {
    ring.init(4 * pair);
    turns.init();
    rnb_fence_mbar_init();
  }
  __syncthreads();
  return turns;
}

// The producer warpgroup: gives registers back; its one thread loads every
// stage of the phase table into the ring, each once its slot is free.
template <int RS>
__device__ __forceinline__ void wb_produce(const WbParams& p,
                                           const RnbRing<RS>& ring) {
  rnb_setmaxnreg_dec<40>();
  if (threadIdx.x == 0) {
    WbCursor cur{&p, 0, 0};
    rnb_ring_produce<RS>(ring, cur);
  }
}

// Layer l's bias (bl, `out` wide) into sb [256] by cp.async, under the
// products before the epilogue that reads it; zeros past its width (and
// past 256: the NeRF's fused head's alpha columns are never added there).
__device__ __forceinline__ void wb_stage_bias(float* sb, const float* bl,
                                              int out, int lt) {
  for (int c = lt; c < 256; c += 128)
    rnb_cp_async4(sb + c, c < out ? bl + c : bl, c < out);
  rnb_cp_async_commit();
}
// A product's tail, once its wgmmas retired: the bias has landed and the
// operand-row stores issued before the phase have read the tile.
__device__ __forceinline__ void wb_tail(int lt) {
  rnb_cp_async_wait<0>();
  if (lt == 0) rnb_bulk_wait_read<0>();
}
// The tile's writers are done: their writes made visible to the async
// proxy (wgmma, TMA) and the warpgroup met at its named barrier.
__device__ __forceinline__ void wb_written(int bar_id) {
  rnb_fence_proxy_async();
  rnb_wg_sync(bar_id);
}

// The A tile of these sweeps is K-major in wgmma's 128-byte swizzle:
// blocks of 64 columns (8 KB, 1 KB aligned), each 64 rows of 128 B, the
// 16-byte chunk c of row p at chunk c ^ (p % 8). Element (p, k):
__device__ __forceinline__ int wb_sidx(int p, int k) {
  return ((k >> 6) << 12) + (p << 6) + ((((k >> 3) & 7) ^ (p & 7)) << 3) +
         (k & 7);
}
__device__ __forceinline__ void wb_put2(rnb_bf16* tile, int p, int k, float a,
                                        float b) {
  *reinterpret_cast<__nv_bfloat162*>(tile + wb_sidx(p, k)) =
      __halves2bfloat162(wg_bf(a), wg_bf(b));
}
// The descriptor of K-step t (columns 16t..16t+15) of the A tile: its
// block's 8-row atoms 1 KB apart (SBO), the step 32 B into the swizzled
// rows (the swizzle applies to the whole address), layout type 1.
__device__ __forceinline__ uint64_t wb_desc_a(const rnb_bf16* X, int t) {
  return rnb_desc_sw128(X + ((t >> 2) << 12) + ((t & 3) << 4), 16);
}

// The A tile's first kw columns to rows n0.. of a [n, ld] bf16 row map
// (rnb_tma_map_bf16: box 64 x 64, 128-byte swizzle): one TMA store a block
// of 64 columns (whole 128-byte rows; columns past ld and rows past n are
// not written), one bulk group; one thread. The tile's writers fenced and
// met at a barrier before.
__device__ __forceinline__ void wb_rows_out(const CUtensorMap* map,
                                            const rnb_bf16* X, int kw,
                                            long long n0) {
  for (int kc = 0; kc < (kw + 63) >> 6; ++kc)
    rnb_tma_store_2d(map, X + (kc << 12), 64 * kc, (int)n0);
  rnb_bulk_commit();
}

// Forward epilogue of a layer over a whole tile at N = 8·NJ (one
// warpgroup; NJ a multiple of 8): zb = acc + sb (sb zero past the layer's
// width), its ReLU mask (zb > 0) as bit 4(j % 8) + 2h + v of word j / 8 of
// `bits`, relu(zb) (zb itself where RELU is false) rounded into the A tile
// X. EPI false (a timing split): acc rounded straight into X, no bits.
template <int NJ, bool RELU, bool EPI>
__device__ __forceinline__ void wb_fwd_put(const float (&acc)[4 * NJ],
                                           const float* sb, rnb_bf16* X,
                                           uint32_t (&bits)[NJ / 8]) {
  const int lt = threadIdx.x & 127;
  const int r0 = ((lt >> 5) << 4) + ((lt & 31) >> 2), cq = 2 * (lt & 3);
#pragma unroll
  for (int w = 0; w < NJ / 8; ++w) bits[w] = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float2 bb = EPI ? *reinterpret_cast<const float2*>(sb + 8 * j + cq)
                          : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = 4 * j + 2 * h + u;
        const float zb = EPI ? acc[idx] + (u ? bb.y : bb.x) : acc[idx];
        if constexpr (EPI && RELU)
          bits[j >> 3] |= (zb > 0.0f ? 1u : 0u) << (4 * (j & 7) + 2 * h + u);
        v[u] = EPI && RELU ? fmaxf(zb, 0.0f) : zb;
      }
      wb_put2(X, r0 + 8 * h, 8 * j + cq, v[0], v[1]);
    }
  }
}

// Column sums over a warp's 16 rows of a tile's 8·NJ columns (cs[2j + v]:
// this thread's sum over its two rows of column 8j + cq + v) into red
// [warp][column] ([4][256] floats), as wg_colsum_put's butterfly over the
// lanes (xor 4, 8, 16) sums them, but scattered: each step halves the
// values a lane carries, so the 8 lanes of one cq end with 2·NJ/8 sums
// each (3/4 fewer shuffles than the butterfly). The same additions of the
// same pairs: the same bits.
template <int NJ>
__device__ __forceinline__ void wb_colsum_put(const float (&cs)[2 * NJ],
                                              float* red) {
  const int lt = threadIdx.x & 127, lane = lt & 31, warp = lt >> 5;
  const int cq = 2 * (lt & 3);
  constexpr int A = NJ, B = NJ / 2, Q = NJ / 4;
  const bool b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
  float s1[A], s2[B], s3[Q];
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const float give = b2 ? cs[k] : cs[A + k];
    const float keep = b2 ? cs[A + k] : cs[k];
    s1[k] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
  }
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const float give = b3 ? s1[k] : s1[B + k];
    const float keep = b3 ? s1[B + k] : s1[k];
    s2[k] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const float give = b4 ? s2[k] : s2[Q + k];
    const float keep = b4 ? s2[Q + k] : s2[k];
    s3[k] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
  }
  const int base = (b2 ? A : 0) + (b3 ? B : 0) + (b4 ? Q : 0);
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int i = base + k;   // cs index 2j + v
    red[warp * 256 + 8 * (i >> 1) + cq + (i & 1)] = s3[k];
  }
}

// Reverse epilogue over a whole tile at N = 8·NJ: bar_z = acc where its
// bit of `keep` is set (a ReLU mask; all where MASK is false), rounded into
// X (the next product's operand and the layer's B rows), its unrounded
// sums over the tile's live rows into red (wb_colsum_put). EPI false (a
// timing split): acc rounded straight into X, no sums.
template <int NJ, bool MASK, bool EPI>
__device__ __forceinline__ void wb_rev_put(const float (&acc)[4 * NJ],
                                           const uint32_t* keep, rnb_bf16* X,
                                           float* red, bool live0,
                                           bool live1) {
  const int lt = threadIdx.x & 127;
  const int r0 = ((lt >> 5) << 4) + ((lt & 31) >> 2), cq = 2 * (lt & 3);
  uint32_t kw[NJ / 8 > 0 ? NJ / 8 : 1];
#pragma unroll
  for (int w = 0; w < NJ / 8; ++w) kw[w] = MASK ? keep[w] : 0xffffffffu;
  float cs[2 * NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    cs[2 * j] = 0.0f;
    cs[2 * j + 1] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = h ? live1 : live0;
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = 4 * j + 2 * h + u;
        const float bz =
            !EPI || (kw[j >> 3] >> (4 * (j & 7) + 2 * h + u)) & 1u ? acc[idx]
                                                                  : 0.0f;
        if (live) cs[2 * j + u] += bz;
        v[u] = bz;
      }
      wb_put2(X, r0 + 8 * h, 8 * j + cq, v[0], v[1]);
    }
  }
  if constexpr (EPI) wb_colsum_put<NJ>(cs, red);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// The arguments every sweep sets (the others null or 0): n points, the
// biases b in image order, ring slots of `stage` bytes, no phase yet.
static inline void wb_init(WbParams* p, long long n, const float* b,
                           int stage) {
  p->in0 = p->in1 = p->in2 = nullptr;
  p->b = b;
  p->cot0 = p->cot1 = nullptr;
  p->dbp = p->out0 = p->out1 = nullptr;
  p->n = n;
  p->db_len = p->C = p->F = p->multires = p->multires_view = p->of = 0;
  p->stage = stage;
  p->n_ph = 0;
}

// Appends layer l's tile of the weight image w as a phase: forward (rev 0)
// over pad16(in)/16 K-steps, box {64, nb, 2}; reverse over pad16(out)/16,
// box {64, 2, nb} from input core c2; the box within p->stage bytes. The map's dims are the tile's cores
// {64, npc, kpc} (sdf_core.cu sdf_layer_map). 0 on success.
static inline int wb_phase(WbParams* p, const void* w, int l, int rev,
                           int nb, int c2) {
  const RnbWgNet& net = p->net;
  const int k = p->n_ph;
  if (k >= WB_MAXPH || nb < 1 || 2 * nb * 128 > p->stage)
    return (int)cudaErrorInvalidValue;
  const long long npc = rnb_pad16(net.out_dim[l]) >> 3;
  const long long kpc = rnb_pad16(net.in_dim[l]) >> 3;
  const long long dims[3] = {64, npc, kpc}, strides[2] = {128, npc * 128};
  const int box[3] = {64, rev ? 2 : nb, rev ? nb : 2};
  const int rc = rnb_tma_map_bf16_3d(
      &p->wmap[k], static_cast<const rnb_bf16*>(w) + net.w_off[l], dims,
      strides, box);
  if (rc) return rc;
  p->ph[k] = RnbPhase{k, rnb_pad16(rev ? net.out_dim[l] : net.in_dim[l]) >> 4,
                      rev, c2, 2 * nb * 128};
  p->n_ph = k + 1;
  return 0;
}

// Each layer's A rows (abuf at a_off, [n, pad16(in)]) and B rows (bbuf at
// bb_off, [n, pad16(out)]) as row maps of 64 x 64 boxes in the 128-byte
// swizzle (rnb_tma_map_bf16). 0 on success.
static inline int wb_rows(WbParams* p, void* abuf, void* bbuf) {
  const RnbWgNet& net = p->net;
  for (int l = 0; l < net.n_layers; ++l) {
    int rc = rnb_tma_map_bf16(&p->amap[l],
                              static_cast<rnb_bf16*>(abuf) + net.a_off[l],
                              rnb_pad16(net.in_dim[l]), p->n, 64, 64);
    if (!rc)
      rc = rnb_tma_map_bf16(&p->bmap[l],
                            static_cast<rnb_bf16*>(bbuf) + net.bb_off[l],
                            rnb_pad16(net.out_dim[l]), p->n, 64, 64);
    if (rc) return rc;
  }
  return 0;
}
