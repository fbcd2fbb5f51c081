// Full-sequence GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (body _kernel).  q: (B, S, Hq, D), k, v: (B, T, Hkv,
// D), out: (B, S, Hq, D) — the model's own layout, so the wrapper neither
// transposes nor pads: ragged S and T edges are masked here.  Options:
// causal, sliding window (window > 0) and softcap (softcap > 0).
//
// Grid: one CTA per (q-tile of bq rows, q-head, batch); GQA reads kv-head
// h / g.  The CTA loops over kv tiles of bk keys in order (the TPU's
// sequential kv grid axis becomes this loop), skipping tiles that the
// causal or window predicate rules out for every row of the q tile, stages
// each K/V tile in shared memory and keeps the online-softmax accumulator
// in registers.
//
// Bound on the card: operations at long prompts (the score and PV products
// grow as S * T), bytes at the serving prompt lengths.  Scalar FMA is the
// simple first version; wgmma tiles fed by TMA are later work.
#include "attn_tile.cuh"

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

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int T_len, int Hq, int Hkv, int D, int bq,
                  int bk, int causal, int window, float scale, float softcap,
                  cudaStream_t stream) {
  const dim3 grid((S + bq - 1) / bq, Hq, B);
  const size_t smem = smem_bytes(bq, bk, D);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(flash_attention_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  flash_attention_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, T_len, Hq, Hkv, D,
      bq, bk, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int S,
                               int T_len, int Hq, int Hkv, int D, int bq,
                               int bk, int causal, int window, float scale,
                               float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, S, T_len, Hq, Hkv, D, bq, bk,
                         causal, window, scale, softcap, st);
  return launch<__nv_bfloat16>(q, k, v, out, B, S, T_len, Hq, Hkv, D, bq, bk,
                               causal, window, scale, softcap, st);
}
