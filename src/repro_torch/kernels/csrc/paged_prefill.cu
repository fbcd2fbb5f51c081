// Chunked-prefill paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// paged_prefill_bhsd (pallas_call at :264, body _paged_chunk_kernel at
// :138).  Each slot brings a C-token chunk whose KV is already scattered
// into the pool.  The rows of one (slot, kv-head) are flattened: row r is
// chunk position r / g of query head kv-head * g + r % g (g = Hq / Hkv), at
// absolute position pos0[b] + r / g.  Key position k is admitted when
// k <= pos0 + r / g and r / g < n_live[b] (resident prefix and intra-chunk
// causality in one predicate).  Rows at chunk positions >= n_live, and
// every row of an n_live == 0 slot, write exact zeros.  Table entries at
// j * bs >= pos0 + n_live are never read (they may hold ids outside the
// pool); block ids read are clamped to [0, N - 1].  Masked scores are
// -1e30, the softcap is softcap * tanh(s / softcap), and
// out = acc / max(l, 1e-30).
//
// Bound on the card: bytes.  The chunk's C * g rows share each K/V byte,
// so a call does about 4 * C * g flops per K/V element read, e.g. ~4.3
// GFLOP against 66.6 MB of K/V at qwen2.5-3b's heads (Hq 16 / Hkv 2, D
// 128, C 8) over 8 slots of ~8192 tokens: 65 flops per byte, far below the
// ~295 flops per byte where the bf16 tensor cores become the limit.  Byte
// bounds at the shapes chip_smoke.py times (bf16, 3.35 TB/s): smollm-360m's
// serving chunk (2 slots, pos0 36/32, Hq 15 / Hkv 5, D 64, bs 8) 0.00005
// ms; 8 slots of 8065-8192 tokens at qwen2.5-3b's heads 0.0199 ms, at
// smollm-360m's (83.3 MB) 0.0249 ms.
//
// The launch plan (kernel body, grid, cluster, rows per CTA, threads, key
// tile, ring stages, shared bytes) comes from repro_torch.kernels.ops.
// paged_prefill_plan; nothing here recomputes it.
//
// bfloat16: the tensor-core kernel (prefill_tc_kernel).  What holds a
// per-(slot, kv-head) scalar walk back, and what this design does about it:
//   - Too few CTAs (slots x kv-heads: 10-16 on 132 SMs).  The grid's x axis
//     walks row tiles of 64 or 128 rows (one consumer warpgroup per 64), so
//     any C * g fits, and the key range of a slot is split over a
//     thread-block cluster of up to 8 CTAs in the same launch: rank c takes
//     the c-th even share of the slot's live table entries ceil((pos0 +
//     n_live) / bs), read on the device.  The ranks' (m, l, acc) states are
//     merged through distributed shared memory: m = max m_i, weights
//     exp2(m_i - m), and a state with l = 0 (no live key for that row)
//     takes weight 0, never exp2(0) = 1.  Each rank merges and writes an
//     even share of the tile's rows, 4 columns per thread; no CTA leaves
//     before the last cluster barrier.
//   - Products as scalar FMAs from float32 copies of K/V.  S = Q K^T and
//     O += P V are wgmma m64nNk16 products (bf16 in, fp32 accumulate) from
//     128B-swizzled shared memory (wgmma_tile.cuh); P is converted to bf16
//     in registers and fed as the A operand of P V, as flash_attention.cu
//     does.  Head dims 64, 80, 96, 128, 256 (80 and 96 padded to 128
//     columns in shared memory).
//   - Blocks walked in series, one barrier-separated stage -> scores ->
//     softmax -> P V per block of 8-16 keys.  Keys go in 64-key tiles
//     through a ring of 2-3 stages filled by 16-byte cp.async copies: each
//     chunk of key row t comes from block table[b, t / bs] at offset t % bs
//     (any bs), the CTA's table entries copied to shared memory first.  The
//     next tiles load while the current one multiplies.  Rows past C * g
//     are zero-filled and never written; a tile whose rows are all past
//     n_live writes zeros and reads nothing.  The causal mask runs only on
//     key tiles that reach past the first row's limit (pos0 + its chunk
//     position) or the rank's share; tiles wholly before run unmasked.
//   - Online softmax in registers, in base 2, with a "safe" running max: a
//     row that has seen no live key keeps l = 0 and acc = 0 (p = exp2(-1e30
//     - 0) = 0), so a rank whose share holds no key of that row contributes
//     an empty state.
// float32: the scalar kernel (prefill_scalar_kernel over attn_tile.cuh),
//   IEEE float32 throughout (tensor cores would compute float32 as TF32 and
//   break the float32 token-parity checks).  Grid x walks row tiles of at
//   most 2048 / D rows (the CTA's register accumulator), so any C * g fits;
//   each tile walks its keys in tiles gathered through the table.
#include <cooperative_groups.h>

#include "attn_tile.cuh"
#include "wgmma_tile.cuh"

namespace cg = cooperative_groups;
using namespace attn;

namespace {

// ------------------------------------------------------------------------ //
// float32: scalar body
// ------------------------------------------------------------------------ //
__global__ void __launch_bounds__(NT) prefill_scalar_kernel(
    const float* __restrict__ q, const float* __restrict__ kp,
    const float* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ pos0, const int* __restrict__ n_live,
    float* __restrict__ out, int C, int Hq, int Hkv, int D, int bs, int M,
    int N, int rows, int keys, float scale, float softcap) {
  extern __shared__ float smem[];
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int g = Hq / Hkv;
  const int R = C * g;
  const int row0 = blockIdx.x * rows;
  const int nr = min(rows, R - row0);
  const Smem s = carve(smem, rows, keys, D);

  for (int e = threadIdx.x; e < nr * D; e += NT) {
    const int r = e / D, d = e - r * D;
    const int rg = row0 + r;
    const int c = rg / g, head = hkv * g + rg % g;
    s.sq[e] = q[(((size_t)b * C + c) * Hq + head) * D + d];
  }
  float acc[ACC];
  init_state(s, nr, acc);

  const int p0 = pos0[b], nl = n_live[b];
  const int c_lo = row0 / g;
  const int c_hi = min((row0 + nr - 1) / g, nl - 1);
  // keys the tile's live rows reach (none if every row is dead)
  const int kend = c_lo < nl ? min(p0 + c_hi + 1, M * bs) : 0;
  for (int k0 = 0; k0 < kend; k0 += keys) {
    const int n = min(keys, kend - k0);
    for (int e = threadIdx.x; e < n * D; e += NT) {
      const int t = e / D, d = e - t * D;
      const int key = k0 + t, j = key / bs;
      const int blk = min(max(tables[(size_t)b * M + j], 0), N - 1);
      const size_t off =
          (((size_t)blk * bs + key - j * bs) * Hkv + hkv) * D + d;
      stage_kv(s, t, d, D, kp + off, vp + off);
    }
    __syncthreads();
    fold_tile(s, nr, n, D, scale, softcap,
              [&](int r, int k) {
                const int c = (row0 + r) / g;
                return c < nl && k0 + k <= p0 + c;
              },
              acc);
  }

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e < nr * D) {
      const int r = e / D, d = e - r * D;
      const int rg = row0 + r;
      const int c = rg / g, head = hkv * g + rg % g;
      const float v = c < nl ? acc[i] / fmaxf(s.sl[r], 1e-30f) : 0.f;
      out[(((size_t)b * C + c) * Hq + head) * D + d] = v;
    }
  }
}

// ------------------------------------------------------------------------ //
// bfloat16: tensor-core body
// ------------------------------------------------------------------------ //
constexpr int BK = 64;           // keys per K/V tile
constexpr int WG = 128;          // threads per consumer warpgroup (64 rows)
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int padded(int D) { return (D + 63) / 64 * 64; }

// Folds state (m2, l2) into (m, l): returns the weight of the incoming
// state's acc and sets *keep to the weight of the current one.  A state
// with l = 0 (no live key) takes weight 0.
__device__ __forceinline__ float merge(float& m, float& l, float m2, float l2,
                                       float* keep) {
  const float mn = fmaxf(m, m2);
  const float a = l > 0.f ? exp2f(m - mn) : 0.f;
  const float b = l2 > 0.f ? exp2f(m2 - mn) : 0.f;
  l = l * a + l2 * b;
  m = mn;
  *keep = a;
  return b;
}

template <int D, int STAGES>
__global__ void __launch_bounds__(2 * WG, 1) prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ pos0, const int* __restrict__ n_live,
    __nv_bfloat16* __restrict__ out, int C, int Hq, int Hkv, int bs, int M_tbl,
    int N, int M, float scale, float softcap) {
  constexpr int DP = padded(D);        // shared-memory columns
  constexpr int CH = DP / 8;           // 16-byte chunks per shared row
  constexpr int DCH = D / 8;           // chunks holding data
  constexpr int TILE = BK * DP * 2;    // bytes of one K (or V) tile
  // dynamic shared memory, sized by ops.paged_prefill_plan: up to 1024
  // bytes of alignment, Q (M x DP bf16), STAGES stages of a K and a V
  // tile, the merge's m and l ([M] each), the rank's table entries.  After
  // the walk the merge's acc ([M][D] float32) reuses the Q and ring bytes.
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wgt::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t skv = sq + (uint32_t)M * DP * 2;   // stage s: K, then V
  uint8_t* base = smem_raw + (sq - raw);
  float* st_acc = reinterpret_cast<float*>(base);
  float* st_m = reinterpret_cast<float*>(base + (size_t)M * DP * 2 +
                                         (size_t)STAGES * 2 * TILE);
  float* st_l = st_m + M;
  int* tbl = reinterpret_cast<int*>(st_l + M);

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int g = Hq / Hkv, R = C * g;
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int row0 = (blockIdx.x / S) * M;
  const int nrow = min(M, R - row0);                 // real rows of the tile
  const int p0 = pos0[b], nl = n_live[b];
  const int c_lo = row0 / g;                         // first chunk position

  // the tile's rows rank c merges and writes: [c * share, (c + 1) * share),
  // in groups of 4 columns (8 bytes of output)
  constexpr int G = D / 4;
  const int share = (nrow + S - 1) / S;
  const int n_mine = max(0, min(nrow, (rank + 1) * share) - rank * share);
  auto dst = [&](int r) {                // row r of the tile in out
    const int rg = row0 + r;
    const int c = rg / g, j = rg - c * g;
    return out + (((size_t)b * C + c) * Hq + hkv * g + j) * D;
  };
  auto st4 = [](__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  };
  if (c_lo >= nl) {                    // every row dead: zeros, no reads
    for (int i = tid; i < n_mine * G; i += nthr)
      st4(dst(rank * share + i / G) + 4 * (i % G), make_float4(0, 0, 0, 0));
    return;                            // uniform over the cluster
  }
  const int c_hi = min((row0 + nrow - 1) / g, nl - 1);  // last live position

  // Q first: it needs no table entry
  for (int e = tid; e < M * CH; e += nthr) {
    const int r = e / CH, c = e - r * CH;
    const int rg = row0 + r;
    const __nv_bfloat16* src = q;
    int bytes = 0;
    if (r < nrow && c < DCH) {
      const int p = rg / g, j = rg - p * g;
      src = q + (((size_t)b * C + p) * Hq + hkv * g + j) * D + c * 8;
      bytes = 16;
    }
    wgt::cp_async16(sq + wgt::swz(r, c, M), src, bytes);
  }
  // the rank's share of the slot's live table entries
  const int nblk = min((p0 + nl + bs - 1) / bs, M_tbl);
  const int per = (nblk + S - 1) / S;
  const int e0 = min(rank * per, nblk), e1 = min(e0 + per, nblk);
  for (int i = tid; i < e1 - e0; i += nthr)
    tbl[i] = min(max(tables[(size_t)b * M_tbl + e0 + i], 0), N - 1);
  const int kb = e0 * bs;                            // the rank's first key
  const int ke = min(e1 * bs, p0 + c_hi + 1);        // past its last key
  const int ntiles = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  __syncthreads();                                   // tbl is visible

  // key tile it: keys kb + it * BK + r, each row from its own table entry
  // (a shift for a power-of-two block size).  A thread always copies chunk
  // tid % CH of rows tid / CH + k * (nthr / CH).
  const int sh = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
  const size_t kv_row = (size_t)Hkv * D;
  const int c_own = tid % CH, r_step = nthr / CH;
  const __nv_bfloat16* kp_h = kp + (size_t)hkv * D + c_own * 8;
  const __nv_bfloat16* vp_h = vp + (size_t)hkv * D + c_own * 8;
  auto load_kv = [&](int it, int stage) {
    const uint32_t sk = skv + stage * 2 * TILE, sv = sk + TILE;
    for (int r = tid / CH; r < BK; r += r_step) {
      const int t = kb + it * BK + r;
      size_t off = 0;
      int bytes = 0;
      if (t < ke && c_own < DCH) {
        const int j = sh >= 0 ? t >> sh : t / bs;
        off = (size_t)(tbl[j - e0] * bs + t - j * bs) * kv_row;
        bytes = 16;
      }
      const uint32_t o = wgt::swz(r, c_own, BK);
      wgt::cp_async16(sk + o, kp_h + off, bytes);
      wgt::cp_async16(sv + o, vp_h + off, bytes);
    }
  };
  // group 0: Q and the first tile; groups 1 .. STAGES - 2: the next tiles;
  // iteration it issues tile it + STAGES - 1 while its score product runs
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load_kv(i, i);
    wgt::cp_async_commit();
  }

  const int wg = tid / WG, lane = tid & 31, warp = (tid % WG) / 32;
  const int r_a = wg * 64 + warp * 16 + lane / 4;   // rows r_a, r_a + 8
  const int quad = 2 * (lane & 3);                  // fragment column
  // per fragment row, the last key it admits (-1: a dead or padded row)
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_a + 8 * h;
    const int c = (row0 + r) / g;
    lim[h] = r < nrow && c < nl ? min(p0 + c, ke - 1) : -1;
  }
  const int lim_lo = min(p0 + c_lo, ke - 1);        // least live limit

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t q_wg = sq + wg * 64 * 128;

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it % STAGES;
    const uint32_t sk = skv + stage * 2 * TILE, sv = sk + TILE;
    wgt::cp_async_wait<STAGES - 2>();   // this tile (and Q) have landed
    wgt::fence_async_shared();
    __syncthreads();

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgt::fence_regs(s);
    wgt::wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t col = (ks & 3) * 32;       // k16 step in a block
      const uint64_t da =
          wgt::desc(q_wg + (ks >> 2) * M * 128 + col, 16, 1024);
      const uint64_t db = wgt::desc(sk + (ks >> 2) * BK * 128 + col, 16, 1024);
      wgt::mma_ss_n64(s, da, db, ks > 0);
    }
    wgt::wg_commit();
    {
      // refill the ring while the tensor cores work: the stage of tile
      // it - 1, which every warpgroup left at the last barrier
      const int ahead = it + STAGES - 1;
      if (ahead < ntiles) load_kv(ahead, ahead % STAGES);
      wgt::cp_async_commit();
    }
    wgt::wg_wait<0>();
    wgt::fence_regs(s);

    const int k0 = kb + it * BK;
    const bool edge = k0 + BK - 1 > lim_lo;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x *= LOG2E;
      if (edge && k0 + 8 * (i >> 2) + quad + (i & 1) > lim[(i >> 1) & 1])
        x = NEG_INF;
      s[i] = x;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      // safe max: a row with no live key yet keeps l = 0 and acc = 0
      const float mb = mx > NEG_INF ? mx : 0.f;
      const float alpha = exp2f(m[h] - mb);
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[4 * j + 2 * h] = exp2f(s[4 * j + 2 * h] - mb);
        s[4 * j + 2 * h + 1] = exp2f(s[4 * j + 2 * h + 1] - mb);
        sum += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
      }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 2 * h] *= alpha;
        o[4 * j + 2 * h + 1] *= alpha;
      }
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = wgt::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = wgt::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = wgt::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = wgt::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgt::fence_regs(o);
    wgt::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgt::mma_rs<DP>(o, pa[kk],
                      wgt::desc(sv + kk * 16 * 128, BK * 128, 1024));
    wgt::wg_commit();
    wgt::wg_wait<0>();
    wgt::fence_regs(o);

    __syncthreads();                    // every warpgroup is done with stage
  }
  wgt::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
  }
  // each rank publishes its state, then merges its rows over the cluster
  __syncthreads();                      // Q and ring bytes are free now
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_a + 8 * h;
    float* row = st_acc + (size_t)r * D + quad;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c)
      if (8 * c < D)
        *reinterpret_cast<float2*>(row + 8 * c) =
            make_float2(o[4 * c + 2 * h], o[4 * c + 2 * h + 1]);
    if ((lane & 3) == 0) {
      st_m[r] = m[h];
      st_l[r] = l[h];
    }
  }
  cluster.sync();                       // every rank's state is visible
  for (int i = tid; i < n_mine * G; i += nthr) {
    const int r = rank * share + i / G, col = 4 * (i % G);
    const int c = (row0 + r) / g;
    float rm[MAX_CLUSTER], rl[MAX_CLUSTER];
    float4 ra[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < S) {
        rm[k] = *cluster.map_shared_rank(st_m + r, k);
        rl[k] = *cluster.map_shared_rank(st_l + r, k);
        ra[k] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(st_acc + (size_t)r * D + col, k));
      }
    }
    float mm = NEG_INF, ll = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < S) {
        float keep;
        const float take = merge(mm, ll, rm[k], rl[k], &keep);
        a.x = a.x * keep + ra[k].x * take;
        a.y = a.y * keep + ra[k].y * take;
        a.z = a.z * keep + ra[k].z * take;
        a.w = a.w * keep + ra[k].w * take;
      }
    }
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    st4(dst(r) + col, c < nl ? make_float4(a.x * inv, a.y * inv, a.z * inv,
                                           a.w * inv)
                             : make_float4(0.f, 0.f, 0.f, 0.f));
  }
  // no CTA leaves while another rank may still read its shared memory
  cluster.sync();
}

template <int D, int ST>
int launch_tc(const void* q, const void* kp, const void* vp,
              const void* tables, const void* pos0, const void* n_live,
              void* out, int B, int C, int Hq, int Hkv, int bs, int M_tbl,
              int N, int gx, int cluster, int rows, int threads, int smem,
              float scale, float softcap, cudaStream_t stream) {
  auto kern = prefill_tc_kernel<D, ST>;
  static int opted = 48 * 1024;         // once per instantiation and size
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, Hkv, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, (const int*)tables, (const int*)pos0,
      (const int*)n_live, (__nv_bfloat16*)out, C, Hq, Hkv, bs, M_tbl, N, rows,
      scale, softcap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D>
int by_stages(int stages, const void* q, const void* kp, const void* vp,
              const void* tables, const void* pos0, const void* n_live,
              void* out, int B, int C, int Hq, int Hkv, int bs, int M_tbl,
              int N, int gx, int cluster, int rows, int threads, int smem,
              float scale, float softcap, cudaStream_t st) {
  if (stages == 2)
    return launch_tc<D, 2>(q, kp, vp, tables, pos0, n_live, out, B, C, Hq,
                           Hkv, bs, M_tbl, N, gx, cluster, rows, threads,
                           smem, scale, softcap, st);
  if (stages == 3)
    return launch_tc<D, 3>(q, kp, vp, tables, pos0, n_live, out, B, C, Hq,
                           Hkv, bs, M_tbl, N, gx, cluster, rows, threads,
                           smem, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (scalar kernel: grid (gx, Hkv, B), rows per tile,
// keys per staged tile), 1 = bfloat16 (tensor-core kernel: grid (gx, Hkv,
// B) in clusters of (cluster, 1, 1), rows 64 or 128, stages 2 or 3).  All
// of gx, cluster, rows, threads, keys, stages and smem (dynamic shared
// bytes) come from ops.paged_prefill_plan.  Returns a cudaError_t (0 on
// success).
extern "C" int paged_prefill(int dtype, const void* q, const void* kp,
                             const void* vp, const void* tables,
                             const void* pos0, const void* n_live, void* out,
                             int B, int C, int Hq, int Hkv, int D, int bs,
                             int M, int N, int gx, int cluster, int rows,
                             int threads, int keys, int stages, int smem,
                             float scale, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    if (threads != NT || cluster != 1) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          prefill_scalar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
    }
    prefill_scalar_kernel<<<dim3(gx, Hkv, B), NT, smem, st>>>(
        (const float*)q, (const float*)kp, (const float*)vp,
        (const int*)tables, (const int*)pos0, (const int*)n_live,
        (float*)out, C, Hq, Hkv, D, bs, M, N, rows, keys, scale, softcap);
    return (int)cudaGetLastError();
  }
  if (keys != BK || threads != rows / 64 * WG)
    return (int)cudaErrorInvalidValue;
#define PAGED_PREFILL_D(DD)                                                  \
  case DD:                                                                   \
    return by_stages<DD>(stages, q, kp, vp, tables, pos0, n_live, out, B, C, \
                         Hq, Hkv, bs, M, N, gx, cluster, rows, threads, smem, \
                         scale, softcap, st);
  switch (D) {
    PAGED_PREFILL_D(64)
    PAGED_PREFILL_D(80)
    PAGED_PREFILL_D(96)
    PAGED_PREFILL_D(128)
    PAGED_PREFILL_D(256)
  }
#undef PAGED_PREFILL_D
  return (int)cudaErrorInvalidValue;
}
