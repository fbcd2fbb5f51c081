// Decode-time paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// paged_attention_bhsd (body _paged_decode_kernel).  One query token per
// slot attends over the KV blocks its block-table row names; keys at
// positions >= context_lens[b] take no weight, a block at j * bs >= ctx is
// never read, and a zero-context row writes exact zeros.
//
// Bound on the card: bytes, in principle.  Each live K/V byte feeds about
// 2g flops (g = query rows per kv-head, at most 8 in the configs), far
// below the ~295 flops per byte where Hopper's tensor cores would become
// the limit, and wgmma wants 64 rows where decode has g: so the products
// run on the CUDA cores in float32.  Measured on an H100 (PERF.md, PR 16),
// the walk is instruction- and latency-bound at g = 8 all the same: the
// K/V stream alone runs at ~1.9 TB/s, the per-key math (dot, score
// reduction, softmax, P.V on 8 rows) adds more than the stream takes, and
// mma.sync tiles are the next step (ROADMAP).
//
// Launch plan (grid, cluster size S, rows, warps, lanes per key, chunks per
// lane, dynamic shared memory) comes from repro_torch.kernels.ops.
// paged_decode_plan; nothing here recomputes it.  Grid (S, Hq / R, B), one
// cluster of S CTAs per (slot, group of R query heads of one kv-head): R is
// the GQA group, or its largest divisor up to 8 (fused), or 1 (per-head).
//
// - Cluster split.  Rank c of a cluster takes the c-th even share of the
//   slot's live table entries ceil(ctx / bs), read on the device, so the
//   split follows the real context without a host synchronisation.
// - Warp split.  The CTA's keys are cut into steps of 2 * 32 / P keys (P
//   lanes per key, two keys per lane); warp w takes steps w, w + W, ...
//   Each lane owns one fixed 16-byte slice of D per chunk (8 bf16 or 4
//   float32 values); the P lanes of a key reduce its score with
//   __shfl_xor_sync.  Loads run ahead of the math in a per-warp ring of
//   8 KiB: each lane cp.async-copies its own 16-byte slices of K and V
//   into its own slots and reads back only those, so no barrier is needed
//   inside the walk and 3 steps (6 KiB) per warp stay in flight.  Block
//   ids come from a shared-memory copy of the CTA's table entries,
//   clamped to [0, N - 1], tracked per lane without a division per key.
// - Lean math: two keys per lane per step, whose score reduction starts
//   with a split (half the lanes of a key finish key 0, half key 1, so the
//   softmax runs once per score), scores scaled once into base-2 units,
//   ex2.approx, a short tanh for the softcap, and a lazy running
//   max: the accumulator is rescaled only on a step where some score in
//   the warp passes its row's max by more than 2^8 (a warp-uniform branch;
//   in practice the first live keys), so p stays below 256.
// - Online softmax per key slot of a warp (m, l, acc over the lane's
//   slices), merged by one rule at three levels (key slots of a warp with
//   shuffles, warps of a CTA in shared memory, CTAs of a cluster through
//   distributed shared memory, each rank merging and writing its share of
//   the output): m = max m_i, weights exp(m_i - m), and a state with l = 0
//   (no live key) takes weight 0, so an empty range never turns into
//   exp(0) = 1.  out = acc / max(l, 1e-30).
//
// Arithmetic follows the reference: score = (q . k) * scale (times log2(e)
// in the same multiply), softcap * tanh(s / softcap), a masked key takes
// no weight; exponentials in base 2.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_WARPS = 8;
constexpr int MAX_THREADS = 32 * MAX_WARPS;
constexpr int MAX_CLUSTER = 8;            // the portable cluster size
constexpr unsigned FULL = 0xffffffffu;
// a running max is raised only when a score passes it by more than this
// (base-2 units): p then stays below 2^8, and rescales are rare
constexpr float LAZY = 8.f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// tanh(x) = 1 - 2 / (2^(2 x log2 e) + 1): a few instructions where tanhf
// expands to hundreds inside the walk; about 1e-7 from tanhf
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, ex2(2.f * LOG2E * x) + 1.f);
}

__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Folds state (m2, l2) into (m, l): returns the weight of the incoming
// state's acc and sets *keep to the weight of the current one.
__device__ __forceinline__ float merge(float& m, float& l, float m2, float l2,
                                       float* keep) {
  const float mn = fmaxf(m, m2);
  const float a = l > 0.f ? ex2(m - mn) : 0.f;
  const float b = l2 > 0.f ? ex2(m2 - mn) : 0.f;
  l = l * a + l2 * b;
  m = mn;
  *keep = a;
  return b;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T_, int R, int CH>
__global__ void __launch_bounds__(MAX_THREADS) paged_decode_kernel(
    const T_* __restrict__ q, const T_* __restrict__ kp,
    const T_* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ ctx_lens, T_* __restrict__ out, int Hq, int Hkv,
    int D, int bs, int M, int N, int P, float scale, float softcap) {
  constexpr int VEC = 16 / sizeof(T_);  // values per 16-byte slice
  constexpr int E = VEC * CH;           // values per lane
  constexpr int T = 2;                  // keys per lane per step (the
                                        // score reduction splits them)
  constexpr int NS = 8 / (CH * T);      // ring stages per warp (8 KiB)
  constexpr int STAGE = T * 2 * CH * 32;  // 16-byte slots per stage
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.z;
  const int head0 = blockIdx.y * R;
  const int hkv = head0 / (Hq / Hkv);
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KPW = 32 / P;               // keys per warp step
  const int slot = lane / P, part = lane % P;

  // shared memory: each warp's ring of NS steps ([NS][K, V][CH][32 lanes]
  // 16-byte slices, every lane reading back only what it copied), the
  // per-warp states [W][R] m, l and [W][R][D] acc, the CTA's merged state
  // (m, l [R], acc [R][D]), and the CTA's table entries
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * NS * STAGE;
  float* ws_m = smem + W * NS * STAGE * 4;
  float* ws_l = ws_m + W * R;
  float* ws_acc = ws_l + W * R;
  float* cs_m = ws_acc + W * R * D;
  float* cs_l = cs_m + R;
  float* cs_acc = cs_l + R;
  int* tbl = reinterpret_cast<int*>(cs_acc + R * D);

  const int ctx = ctx_lens[b];
  const int nblk = ctx > 0 ? min((ctx + bs - 1) / bs, M) : 0;
  const int per = (nblk + S - 1) / S;
  const int c0 = min(rank * per, nblk);
  const int nb = min(c0 + per, nblk) - c0;
  for (int i = threadIdx.x; i < nb; i += blockDim.x)
    tbl[i] = min(max(tables[(size_t)b * M + c0 + i], 0), N - 1);

  // the lane's slices of q (all R rows) and of the accumulator
  int doff[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) doff[c] = (part + c * P) * VEC;
  float qr[R][E], acc[R][E], mr[R], lr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T_* qrow = q + ((size_t)b * Hq + head0 + r) * D;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (doff[c] < D) {
        const uint4 u = *reinterpret_cast<const uint4*>(qrow + doff[c]);
        unpack(u, &qr[r][c * VEC], T_());
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) qr[r][c * VEC + j] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
    mr[r] = NEG_INF;
    lr[r] = 0.f;
  }
  // zero the lane's ring slots: a slot no copy fills (a slice past D, a
  // dead key) then holds finite values, so p = 0 times it stays 0
  for (int j = 0; j < NS * STAGE; j += 32)
    ring[j + lane] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int nkeys = nb * bs;
  const int kbase = c0 * bs;                       // position of key 0
  const int KPS = KPW * T;                         // keys per warp step
  const int nsteps = (nkeys + KPS - 1) / KPS;
  const int nw = nsteps > warp ? (nsteps - warp + W - 1) / W : 0;
  const size_t row = (size_t)Hkv * D;              // token stride
  // the lane's t-th key of this warp's i-th step, if it is live
  auto live = [&](int i, int t, int* key) {
    *key = (warp + i * W) * KPS + t * KPW + slot;
    return *key < nkeys && kbase + *key < ctx;
  };
  // the next copy's t-th key as (key, table entry, token in block),
  // advanced by the warp's stride without a division per key
  int ckey[T], cblk[T], ctok[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    ckey[t] = warp * KPS + t * KPW + slot;
    cblk[t] = ckey[t] / bs;
    ctok[t] = ckey[t] - cblk[t] * bs;
  }
  const int stride = W * KPS, sblk = stride / bs, stok = stride - sblk * bs;
  // copy the lane's K and V slices of step i (the step after the last
  // copied one) into ring stage i % NS
  auto copy = [&](int i) {
    uint4* stage = ring + (i & (NS - 1)) * STAGE + lane;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int key = ckey[t], blk_j = cblk[t], tok = ctok[t];
      ckey[t] += stride;
      cblk[t] += sblk;
      ctok[t] += stok;
      if (ctok[t] >= bs) {
        ctok[t] -= bs;
        ++cblk[t];
      }
      if (key >= nkeys || kbase + key >= ctx) continue;
      const int blk = tbl[blk_j];
      const size_t off = ((size_t)blk * bs + tok) * row + (size_t)hkv * D;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (doff[c] < D) {
          cp_async16(stage + ((t * 2) * CH + c) * 32, kp + off + doff[c]);
          cp_async16(stage + ((t * 2 + 1) * CH + c) * 32, vp + off + doff[c]);
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nw) copy(i);
    cp_async_commit();
  }
  const float qscale = scale * (softcap > 0.f ? 1.f : LOG2E);
  for (int i = 0; i < nw; ++i) {
    if (i + NS - 1 < nw) copy(i + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();          // step i has landed
    const uint4* stage = ring + (i & (NS - 1)) * STAGE + lane;
    float x[T][R];
    bool ok[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      int key;
      ok[t] = live(i, t, &key);
      float kf[E];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        unpack(stage[((t * 2) * CH + c) * 32], &kf[c * VEC], T_());
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kf[e], d);
        x[t][r] = d;
      }
    }
    // reduce the scores over the key's P lanes, the first level as a
    // split: the lanes whose bit P / 2 is set keep key 1, the others key 0,
    // so the rest of the reduction and the softmax run on R values, not 2R
    const int h = P >> 1;
    const bool up = (part & h) != 0;
    float y[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float send = up ? x[0][r] : x[1][r];
      y[r] = (up ? x[1][r] : x[0][r]) + __shfl_xor_sync(FULL, send, h);
    }
    for (int o = h >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) y[r] += __shfl_xor_sync(FULL, y[r], o);
    }
    // scores in base-2 units; a dead key scores NEG_INF and takes p = 0
    const bool own = up ? ok[1] : ok[0];
    bool grow = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float z = y[r] * qscale;
      if (softcap > 0.f) z = softcap * tanh_fast(z / softcap) * LOG2E;
      y[r] = own ? z : NEG_INF;
      grow |= y[r] > mr[r] + LAZY;
    }
    // rescale only when some score in the warp passes its row's running
    // max by more than LAZY (warp-uniform; the first live key always does)
    if (__any_sync(FULL, grow)) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float other = __shfl_xor_sync(FULL, y[r], h);
        const float mn = fmaxf(mr[r], fmaxf(y[r], other));
        const float a = ex2(mr[r] - mn);
        lr[r] *= a;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= a;
        mr[r] = mn;
      }
    }
    float vf0[E], vf1[E];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      unpack(stage[(1 * CH + c) * 32], &vf0[c * VEC], T_());
      unpack(stage[(3 * CH + c) * 32], &vf1[c * VEC], T_());
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mine = own ? ex2(y[r] - mr[r]) : 0.f;
      const float theirs = __shfl_xor_sync(FULL, mine, h);
      const float p0 = up ? theirs : mine, p1 = up ? mine : theirs;
      lr[r] += p0 + p1;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[r][e] = fmaf(p1, vf1[e], fmaf(p0, vf0[e], acc[r][e]));
    }
  }
  cp_async_wait<0>();

  // merge the warp's key slots (lanes part, part + P, ...), then write the
  // warp's state; key slot 0 holds it afterwards
#pragma unroll
  for (int r = 0; r < R; ++r) {
    for (int o = P; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(FULL, mr[r], o);
      const float l2 = __shfl_xor_sync(FULL, lr[r], o);
      float keep;
      const float take = merge(mr[r], lr[r], m2, l2, &keep);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a2 = __shfl_xor_sync(FULL, acc[r][e], o);
        acc[r][e] = acc[r][e] * keep + a2 * take;
      }
    }
    if (slot == 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (doff[c] < D) {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            ws_acc[(warp * R + r) * D + doff[c] + j] = acc[r][c * VEC + j];
        }
      }
    }
    if (lane == 0) {
      ws_m[warp * R + r] = mr[r];
      ws_l[warp * R + r] = lr[r];
    }
  }
  __syncthreads();

  // merge the warps into the CTA's state
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D;
    float wm[MAX_WARPS], wl[MAX_WARPS], wa[MAX_WARPS];
#pragma unroll
    for (int w = 0; w < MAX_WARPS; ++w) {
      if (w < W) {
        wm[w] = ws_m[w * R + r];
        wl[w] = ws_l[w * R + r];
        wa[w] = ws_acc[w * R * D + i];
      }
    }
    float m = NEG_INF, l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < MAX_WARPS; ++w) {
      if (w < W) {
        float keep;
        const float take = merge(m, l, wm[w], wl[w], &keep);
        a = a * keep + wa[w] * take;
      }
    }
    cs_acc[i] = a;
    if (i - r * D == 0) {
      cs_m[r] = m;
      cs_l[r] = l;
    }
  }
  // every CTA's state is visible cluster-wide after this barrier; then
  // rank c merges the ranks' states for its share of the (R, D) output,
  // reading them through distributed shared memory
  cluster.sync();
  const int share = (R * D + S - 1) / S;
  const int i1 = min(R * D, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < i1; i += blockDim.x) {
    const int r = i / D;
    float rm[MAX_CLUSTER], rl[MAX_CLUSTER], ra[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < S) {
        const float* rs = cluster.map_shared_rank(cs_m, c);
        rm[c] = rs[r];
        rl[c] = rs[R + r];
        ra[c] = rs[2 * R + i];
      }
    }
    float m = NEG_INF, l = 0.f, a = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < S) {
        float keep;
        const float take = merge(m, l, rm[c], rl[c], &keep);
        a = a * keep + ra[c] * take;
      }
    }
    st(out + ((size_t)b * Hq + head0) * D + i, a / fmaxf(l, 1e-30f));
  }
  // no CTA leaves while another rank may still read its shared memory
  cluster.sync();
}

template <typename T, int R, int CH>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* ctx, void* out, int B, int Hq, int Hkv, int D, int bs,
           int M, int N, int gx, int gy, int cluster, int threads, int lanes,
           int smem, float scale, float softcap, cudaStream_t stream) {
  auto kern = paged_decode_kernel<T, R, CH>;
  static int opted = 48 * 1024;         // once per instantiation and size
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, B);
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
      &cfg, kern, (const T*)q, (const T*)kp, (const T*)vp,
      (const int*)tables, (const int*)ctx, (T*)out, Hq, Hkv, D, bs, M, N,
      lanes, scale, softcap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int CH>
int by_rows(int rows, const void* q, const void* kp, const void* vp,
            const void* tables, const void* ctx, void* out, int B, int Hq,
            int Hkv, int D, int bs, int M, int N, int gx, int gy,
            int cluster, int threads, int lanes, int smem, float scale,
            float softcap, cudaStream_t st) {
#define PAGED_DECODE_ROWS(R)                                                 \
  case R:                                                                    \
    return launch<T, R, CH>(q, kp, vp, tables, ctx, out, B, Hq, Hkv, D, bs,  \
                            M, N, gx, gy, cluster, threads, lanes, smem,     \
                            scale, softcap, st);
  switch (rows) {
    PAGED_DECODE_ROWS(1)
    PAGED_DECODE_ROWS(2)
    PAGED_DECODE_ROWS(3)
    PAGED_DECODE_ROWS(4)
    PAGED_DECODE_ROWS(5)
    PAGED_DECODE_ROWS(6)
    PAGED_DECODE_ROWS(7)
    PAGED_DECODE_ROWS(8)
  }
#undef PAGED_DECODE_ROWS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Grid (gx, gy, B) in clusters of
// (cluster, 1, 1); rows query heads per CTA; threads per CTA; lanes per
// key; chunks of 16 bytes per lane (1, or 2 for float32 above D 128); smem
// dynamic shared bytes.  Returns a cudaError_t (0 on success).
extern "C" int paged_decode(int dtype, const void* q, const void* kp,
                            const void* vp, const void* tables,
                            const void* ctx, void* out, int B, int Hq,
                            int Hkv, int D, int bs, int M, int N, int gx,
                            int gy, int cluster, int rows, int threads,
                            int lanes, int chunks, int smem, float scale,
                            float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && chunks == 2)
    return by_rows<float, 2>(rows, q, kp, vp, tables, ctx, out, B, Hq, Hkv,
                             D, bs, M, N, gx, gy, cluster, threads, lanes,
                             smem, scale, softcap, st);
  if (chunks != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return by_rows<float, 1>(rows, q, kp, vp, tables, ctx, out, B, Hq, Hkv,
                             D, bs, M, N, gx, gy, cluster, threads, lanes,
                             smem, scale, softcap, st);
  return by_rows<__nv_bfloat16, 1>(rows, q, kp, vp, tables, ctx, out, B, Hq,
                                   Hkv, D, bs, M, N, gx, gy, cluster,
                                   threads, lanes, smem, scale, softcap, st);
}
