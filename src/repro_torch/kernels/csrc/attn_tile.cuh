// Shared building block of the three attention kernels: one CTA owns a tile
// of R query rows and folds KV tiles into an online softmax.
//
// Layout of the CTA's dynamic shared memory (all float32):
//   sq [R * D]            the query tile, loaded once
//   sk [KT * (D + 1)]     the current KV tile's keys (rows padded by one
//                         float so score threads reading different keys hit
//                         different banks)
//   sv [KT * D]           the current tile's values
//   ss [R * KT]           scores, then probabilities
//   sm, sl, sa [R]        running max, running sum, per-tile rescale
// The output accumulator lives in registers: element e = tid + i * NT of
// the (R, D) tile belongs to thread tid, slot i < ACC.
//
// Arithmetic follows the reference: scores = (q . k) * scale, optional
// softcap * tanh(s / softcap), masked scores are -1e30, and
//   m' = max(m, rowmax(s));  p = exp(s - m');  a = exp(m - m');
//   l' = l * a + rowsum(p);  acc' = acc * a + p @ v;  out = acc / max(l, 1e-30).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr int NT = 128;          // threads per CTA
constexpr int ACC = 16;          // accumulator elements per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Smem {
  float *sq, *sk, *sv, *ss, *sm, *sl, *sa;
};

// Carve the dynamic shared memory for an (R rows, KT keys, D dims) tile.
__device__ __forceinline__ Smem carve(float* base, int R, int KT, int D) {
  Smem s;
  s.sq = base;
  s.sk = s.sq + R * D;
  s.sv = s.sk + KT * (D + 1);
  s.ss = s.sv + KT * D;
  s.sm = s.ss + R * KT;
  s.sl = s.sm + R;
  s.sa = s.sl + R;
  return s;
}

inline size_t smem_bytes(int R, int KT, int D) {
  return sizeof(float) *
         (size_t(R) * D + size_t(KT) * (D + 1) + size_t(KT) * D +
          size_t(R) * KT + 3 * size_t(R));
}

// Zero the accumulator and the running statistics.  Ends with a barrier.
__device__ __forceinline__ void init_state(const Smem& s, int R,
                                           float acc[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += NT) {
    s.sm[r] = NEG_INF;
    s.sl[r] = 0.f;
  }
  __syncthreads();
}

// Fold one staged KV tile of n keys (n <= KT) into the running state.
// ok(r, k) says whether query row r may attend to tile key k.  Expects
// sq/sk/sv staged and visible (a barrier after staging); ends with a barrier
// so the caller may restage sk/sv.
template <class Ok>
__device__ __forceinline__ void fold_tile(const Smem& s, int R, int n, int D,
                                          float scale, float softcap, Ok ok,
                                          float acc[ACC]) {
  const int tid = threadIdx.x;
  for (int p = tid; p < R * n; p += NT) {
    const int r = p / n, k = p - r * n;
    const float* q = s.sq + r * D;
    const float* kk = s.sk + k * (D + 1);
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(q[d], kk[d], dot);
    dot *= scale;
    if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
    s.ss[r * n + k] = ok(r, k) ? dot : NEG_INF;
  }
  __syncthreads();
  for (int r = tid; r < R; r += NT) {
    float* row = s.ss + r * n;
    const float m_prev = s.sm[r];
    float m_new = m_prev;
    for (int k = 0; k < n; ++k) m_new = fmaxf(m_new, row[k]);
    float sum = 0.f;
    for (int k = 0; k < n; ++k) {
      const float e = expf(row[k] - m_new);
      row[k] = e;
      sum += e;
    }
    const float a = expf(m_prev - m_new);
    s.sl[r] = s.sl[r] * a + sum;
    s.sm[r] = m_new;
    s.sa[r] = a;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * NT;
    if (e < R * D) {
      const int r = e / D, d = e - r * D;
      const float* prow = s.ss + r * n;
      float v = acc[i] * s.sa[r];
      for (int k = 0; k < n; ++k) v = fmaf(prow[k], s.sv[k * D + d], v);
      acc[i] = v;
    }
  }
  __syncthreads();
}

// Stage one KV row of D values (key row padded to D + 1) for tile slot k.
template <typename T>
__device__ __forceinline__ void stage_kv(const Smem& s, int k, int d, int D,
                                         const T* kp, const T* vp) {
  s.sk[k * (D + 1) + d] = ld(kp);
  s.sv[k * D + d] = ld(vp);
}

}  // namespace attn
