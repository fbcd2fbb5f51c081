// Full-sequence GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (pallas_call at :362, body _kernel at :26).  q: (B,
// S, Hq, D), k, v: (B, T, Hkv, D), out: (B, S, Hq, D) — the model's own
// layout, so the wrapper neither transposes nor pads: ragged S and T edges
// are zero-filled by the copies and masked here.  Options: causal, sliding
// window (window > 0) and softcap (softcap > 0).
//
// bfloat16: a tensor-core kernel (flash_tc_kernel).
//   - Grid: one CTA per tile of M flattened rows (query position, q-head
//     within the GQA group) of one (batch, kv-head): row r is position
//     (q0 + r) / g and head hkv * g + (q0 + r) % g, so each K/V tile is
//     staged once for the g heads that share it.  M is 64 or 128 (one
//     consumer warpgroup per 64 rows), chosen by ops.flash_plan so the
//     grid fills the 132 SMs.  CTA x takes tile gridDim.x - 1 - x, so the
//     tiles with the most keys under a causal mask start first.
//   - S = Q K^T and O += P V are wgmma m64nNk16 products (bf16 in, fp32
//     accumulate) from 128B-swizzled shared memory (wgmma_tile.cuh); P is
//     converted to bf16 in registers and fed as the A operand of P V.
//   - K/V tiles of 64 keys go through a ring of two stages filled by
//     16-byte cp.async copies: the next tile loads while the current one
//     multiplies.  Keys past T are zero-filled (src-size 0), never read.
//   - Online softmax in registers, in base 2: scores (q.k) * scale, then
//     softcap * tanh(s / softcap), masked -1e30, times log2(e); row max
//     and sum per thread pair of rows, reduced over the 4 threads of a
//     quad by warp shuffles.  Out = O / max(l, 1e-30); rows past S are
//     never written.  KV tiles masked for every row of the CTA are
//     skipped; the per-element mask runs only on tiles crossing a boundary.
//   - Head dims 64, 80, 96, 128, 256 (the configs'), one template each;
//     80 and 96 are padded to 128 columns in shared memory.
// float32: the scalar kernel (flash_attention_kernel over attn_tile.cuh),
//   IEEE float32 throughout; tensor cores would compute float32 as TF32.
//   It is the parity tool of the float32 token checks; serving runs bf16.
//
// Bound on the card: operations at long prompts (4 * S * T * D * Hq flops
// under the causal triangle, 1.7e11 at recurrentgemma's prefill: 0.17 ms at
// 989 TFLOP/s), bytes at short ones (smollm's 96-token join prefill).  The
// products run on the tensor cores and each K/V byte is staged once per
// M-row tile; what remains between this kernel and the bound is the serial
// order inside a CTA (wait for S, softmax, wait for P V, no second
// warpgroup pipelining) — later work.
#include "attn_tile.cuh"
#include "wgmma_tile.cuh"

using namespace attn;

template <typename T>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int T_len, int Hq, int Hkv, int D, int bq,
    int bk, int causal, int window, float scale, float softcap) {
  extern __shared__ float smem[];
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hkv = h / (Hq / Hkv);
  const int q0 = qi * bq;
  const int q_hi = min(q0 + bq, S) - 1;         // last real row of the tile
  const Smem s = carve(smem, bq, bk, D);

  for (int e = threadIdx.x; e < bq * D; e += NT) {
    const int r = e / D, d = e - r * D;
    s.sq[e] = q0 + r < S ? ld(q + (((size_t)b * S + q0 + r) * Hq + h) * D + d)
                         : 0.f;
  }
  float acc[ACC];
  init_state(s, bq, acc);

  const int nk = (T_len + bk - 1) / bk;
  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * bk;
    if (causal && k0 > q_hi) break;                        // all in future
    if (window > 0 && k0 + bk <= q0 - window) continue;    // all too old
    const int n = min(bk, T_len - k0);
    for (int e = threadIdx.x; e < n * D; e += NT) {
      const int t = e / D, d = e - t * D;
      const size_t off = (((size_t)b * T_len + k0 + t) * Hkv + hkv) * D + d;
      stage_kv(s, t, d, D, k + off, v + off);
    }
    __syncthreads();
    fold_tile(s, bq, n, D, scale, softcap,
              [&](int r, int kk) {
                const int qp = q0 + r, kp = k0 + kk;
                return qp < S && (!causal || kp <= qp) &&
                       (window <= 0 || kp > qp - window);
              },
              acc);
  }

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e < bq * D) {
      const int r = e / D, d = e - r * D;
      if (q0 + r < S)
        st(out + (((size_t)b * S + q0 + r) * Hq + h) * D + d,
           acc[i] / fmaxf(s.sl[r], 1e-30f));
    }
  }
}

namespace tc {

constexpr int BK = 64;           // keys per K/V tile; the ring has 2 stages
constexpr int WG = 128;          // threads per consumer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int padded(int D) { return (D + 63) / 64 * 64; }

template <int D>
__global__ void __launch_bounds__(2 * WG, 1) flash_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int S, int T_len, int Hq, int Hkv, int M, int causal, int window,
    float scale, float softcap) {
  constexpr int DP = padded(D);        // shared-memory columns
  constexpr int CH = DP / 8;           // 16-byte chunks per shared row
  constexpr int DCH = D / 8;           // chunks holding data
  constexpr int TILE = BK * DP * 2;    // bytes of one K (or V) tile
  // dynamic shared memory, sized by ops.flash_plan: up to 1024 bytes of
  // alignment, Q (M x DP bf16), then 2 stages of a K and a V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wgt::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t skv = sq + (uint32_t)M * DP * 2;   // stage s: K, then V

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int g = Hq / Hkv;
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int rows = S * g;
  // the last tiles see the most keys under a causal mask: launch them first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * M;
  const int p_lo = row0 / g;                         // first position
  const int p_hi = (min(row0 + M, rows) - 1) / g;    // last real position
  // KV tiles some row of the CTA may attend to
  const int k_beg = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int k_end = causal ? min(T_len, p_hi + 1) : T_len;
  const int kt0 = k_beg / BK;
  const int kt1 = k_end > k_beg ? (k_end + BK - 1) / BK : kt0;

  for (int e = tid; e < M * CH; e += nthr) {
    const int r = e / CH, c = e - r * CH;
    const int rg = row0 + r;
    const __nv_bfloat16* src = q;
    int bytes = 0;
    if (rg < rows && c < DCH) {
      const int p = rg / g, j = rg - p * g;
      src = q + (((size_t)b * S + p) * Hq + hkv * g + j) * D + c * 8;
      bytes = 16;
    }
    wgt::cp_async16(sq + wgt::swz(r, c, M), src, bytes);
  }
  auto load_kv = [&](int kt, int stage) {
    const uint32_t sk = skv + stage * 2 * TILE, sv = sk + TILE;
    for (int e = tid; e < BK * CH; e += nthr) {
      const int r = e / CH, c = e - r * CH;
      const int t = kt * BK + r;
      size_t off = 0;
      int bytes = 0;
      if (t < T_len && c < DCH) {
        off = (((size_t)b * T_len + t) * Hkv + hkv) * D + c * 8;
        bytes = 16;
      }
      const uint32_t o = wgt::swz(r, c, BK);
      wgt::cp_async16(sk + o, k + off, bytes);
      wgt::cp_async16(sv + o, v + off, bytes);
    }
  };
  // group 0: Q and the first tile; group 1: the second tile (maybe empty)
  if (kt0 < kt1) load_kv(kt0, 0);
  wgt::cp_async_commit();
  if (kt0 + 1 < kt1) load_kv(kt0 + 1, 1);
  wgt::cp_async_commit();

  const int wg = tid / WG, lane = tid & 31, warp = (tid % WG) / 32;
  const int r_a = wg * 64 + warp * 16 + lane / 4;   // rows r_a, r_a + 8
  const int quad = 2 * (lane & 3);                  // fragment column
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = (row0 + r_a + 8 * h) / g;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t q_wg = sq + wg * 64 * 128;

  for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
    const int stage = it & 1;
    const uint32_t sk = skv + stage * 2 * TILE, sv = sk + TILE;
    wgt::cp_async_wait<1>();            // this tile (and Q) have landed
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
    wgt::wg_wait<0>();
    wgt::fence_regs(s);

    const int k0 = kt * BK;
    const bool edge = k0 + BK > T_len || (causal && k0 + BK - 1 > p_lo) ||
                      (window > 0 && k0 <= p_hi - window);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x *= LOG2E;
      if (edge) {
        const int kp = k0 + 8 * (i >> 2) + quad + (i & 1);
        const int qp = pos[(i >> 1) & 1];
        if (kp >= T_len || (causal && kp > qp) ||
            (window > 0 && kp <= qp - window))
          x = NEG_INF;
      }
      s[i] = x;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[h] - mx);
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[4 * j + 2 * h] = exp2f(s[4 * j + 2 * h] - mx);
        s[4 * j + 2 * h + 1] = exp2f(s[4 * j + 2 * h + 1] - mx);
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
    if (kt + 2 < kt1) load_kv(kt + 2, stage);
    wgt::cp_async_commit();
  }
  wgt::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int rg = row0 + r_a + 8 * h;
    if (rg < rows) {
      const int p = rg / g, j = rg - p * g;
      __nv_bfloat16* dst =
          out + (((size_t)b * S + p) * Hq + hkv * g + j) * D + quad;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c)
        if (8 * c < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
              __floats2bfloat162_rn(o[4 * c + 2 * h] * inv,
                                    o[4 * c + 2 * h + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int Hq, int Hkv, int M, int tiles, int smem,
           int causal, int window, float scale, float softcap,
           cudaStream_t stream) {
  if (M != 64 && M != 128) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(flash_tc_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(tiles, Hkv, B);
  flash_tc_kernel<D><<<grid, M / 64 * WG, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, T_len, Hq, Hkv, M,
      causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc

static int launch_scalar(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int T_len, int Hq, int Hkv,
                         int D, int bq, int tiles, int smem, int causal,
                         int window, float scale, float softcap,
                         cudaStream_t stream) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(flash_attention_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(tiles, Hq, B);
  flash_attention_kernel<float><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S,
      T_len, Hq, Hkv, D, bq, bq, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 (scalar kernel, rows = its query and key tile bq),
// 1 = bfloat16 (tensor-core kernel, rows = M, 64 or 128).  rows, tiles (the
// grid's x extent) and smem (dynamic shared bytes) come from
// ops.flash_plan, which holds the shared-memory layout's size for both
// kernels.  Returns cudaGetLastError().
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int S,
                               int T_len, int Hq, int Hkv, int D, int rows,
                               int tiles, int smem, int causal, int window,
                               float scale, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_scalar(q, k, v, out, B, S, T_len, Hq, Hkv, D, rows, tiles,
                         smem, causal, window, scale, softcap, st);
  switch (D) {
    case 64:
      return tc::launch<64>(q, k, v, out, B, S, T_len, Hq, Hkv, rows, tiles,
                            smem, causal, window, scale, softcap, st);
    case 80:
      return tc::launch<80>(q, k, v, out, B, S, T_len, Hq, Hkv, rows, tiles,
                            smem, causal, window, scale, softcap, st);
    case 96:
      return tc::launch<96>(q, k, v, out, B, S, T_len, Hq, Hkv, rows, tiles,
                            smem, causal, window, scale, softcap, st);
    case 128:
      return tc::launch<128>(q, k, v, out, B, S, T_len, Hq, Hkv, rows, tiles,
                             smem, causal, window, scale, softcap, st);
    case 256:
      return tc::launch<256>(q, k, v, out, B, S, T_len, Hq, Hkv, rows, tiles,
                             smem, causal, window, scale, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
