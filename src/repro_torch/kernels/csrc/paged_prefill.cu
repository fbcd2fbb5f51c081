// Chunked-prefill paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// paged_prefill_bhsd (body _paged_chunk_kernel).  Each slot brings a C-token
// chunk whose KV is already scattered into the pool; chunk position c sits
// at absolute position pos0[b] + c and attends to every key at position
// <= pos0[b] + c (resident prefix and intra-chunk causality in one
// predicate).  Rows c >= n_live[b] — every row of an n_live == 0 slot —
// write exact zeros.
//
// Grid: one CTA per (slot, kv-head).  The CTA owns the group's whole
// (C * g, D) query tile, row r = chunk position r / g of query head
// kv-head * g + r % g, read straight from the model's (B, C, Hq, D) layout,
// so each KV block is read from device memory once per group.  It walks
// table entries j while j * bs < pos0 + n_live (blocks beyond the chunk's
// reach are skipped), staging each (bs, D) K/V block in shared memory; the
// online-softmax accumulator stays in registers.
//
// Bound on the card: bytes at the serving shapes (C = 8, g = 3: 24 query
// rows share each staged block, still well under the ridge point).  Scalar
// FMA is the simple first version; wgmma over the (C * g, bs) score tile is
// later work.
#include "attn_tile.cuh"

using namespace attn;

template <typename T>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ pos0, const int* __restrict__ n_live,
    T* __restrict__ out, int C, int Hq, int Hkv, int D, int bs, int M, int N,
    float scale, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, hkv = blockIdx.y;
  const int g = Hq / Hkv;
  const int R = C * g;
  const Smem s = carve(smem, R, bs, D);

  for (int e = threadIdx.x; e < R * D; e += NT) {
    const int r = e / D, d = e - r * D;
    const int c = r / g, head = hkv * g + r % g;
    s.sq[e] = ld(q + (((size_t)b * C + c) * Hq + head) * D + d);
  }
  float acc[ACC];
  init_state(s, R, acc);

  const int p0 = pos0[b], nl = n_live[b];
  const int nblk = nl > 0 ? min((p0 + nl + bs - 1) / bs, M) : 0;
  for (int j = 0; j < nblk; ++j) {
    const int blk = min(max(tables[(size_t)b * M + j], 0), N - 1);
    for (int e = threadIdx.x; e < bs * D; e += NT) {
      const int t = e / D, d = e - t * D;
      const size_t off = (((size_t)blk * bs + t) * Hkv + hkv) * D + d;
      stage_kv(s, t, d, D, kp + off, vp + off);
    }
    __syncthreads();
    const int base = j * bs;
    fold_tile(s, R, bs, D, scale, softcap,
              [&](int r, int k) {
                const int c = r / g;
                return c < nl && base + k <= p0 + c;
              },
              acc);
  }

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e < R * D) {
      const int r = e / D, d = e - r * D;
      const int c = r / g, head = hkv * g + r % g;
      const float v = c < nl ? acc[i] / fmaxf(s.sl[r], 1e-30f) : 0.f;
      st(out + (((size_t)b * C + c) * Hq + head) * D + d, v);
    }
  }
}

template <typename T>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* tables, const void* pos0, const void* n_live,
                  void* out, int B, int C, int Hq, int Hkv, int D, int bs,
                  int M, int N, float scale, float softcap,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(C * (Hq / Hkv), bs, D);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(paged_prefill_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  paged_prefill_kernel<T><<<dim3(B, Hkv), NT, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)tables,
      (const int*)pos0, (const int*)n_live, (T*)out, C, Hq, Hkv, D, bs, M, N,
      scale, softcap);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int paged_prefill(int dtype, const void* q, const void* kp,
                             const void* vp, const void* tables,
                             const void* pos0, const void* n_live, void* out,
                             int B, int C, int Hq, int Hkv, int D, int bs,
                             int M, int N, float scale, float softcap,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, kp, vp, tables, pos0, n_live, out, B, C, Hq, Hkv,
                         D, bs, M, N, scale, softcap, st);
  return launch<__nv_bfloat16>(q, kp, vp, tables, pos0, n_live, out, B, C,
                               Hq, Hkv, D, bs, M, N, scale, softcap, st);
}
