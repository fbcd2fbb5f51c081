// Decode-time paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// paged_attention_bhsd (body _paged_decode_kernel).  One query token per
// slot attends over the KV blocks its block-table row names; keys at
// positions >= context_lens[b] are masked, a zero-context row writes exact
// zeros.
//
// Grid: one CTA per (slot, head group).  Fused (the default) is one CTA per
// (slot, kv-head) owning the group's g query rows, so every KV block is read
// from device memory once per group; per-head (fused = 0) is one CTA per
// (slot, q-head) with a single row, the A/B baseline.  The CTA walks its
// table entries j < ceil(ctx / bs) in order (a loop in the block takes the
// place of the TPU's sequential grid axis), stages each (bs, D) K and V
// block in shared memory and keeps the online-softmax accumulator in
// registers.
//
// Bound on the card: bytes.  Each live KV position is read once per group
// (2 * Hkv * D elements per token) for 4 * g * D flops per kv-head, far
// below Hopper's ridge point; the design moves each byte once and fuses the
// gather, scores, softmax and PV product into one pass.  Scalar FMA over
// shared memory is the simple first version (wgmma/TMA and a split over
// block ranges for long contexts are later work).
#include "attn_tile.cuh"

using namespace attn;

template <typename T>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ ctx_lens, T* __restrict__ out, int Hq, int Hkv,
    int D, int bs, int M, int N, int gq, float scale, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int head0 = blockIdx.y * gq;          // first query head of the tile
  const int hkv = head0 / (Hq / Hkv);
  const int R = gq;
  const Smem s = carve(smem, R, bs, D);

  const T* qb = q + ((size_t)b * Hq + head0) * D;
  for (int e = threadIdx.x; e < R * D; e += NT) s.sq[e] = ld(qb + e);
  float acc[ACC];
  init_state(s, R, acc);

  const int ctx = ctx_lens[b];
  const int nblk = ctx > 0 ? min((ctx + bs - 1) / bs, M) : 0;
  for (int j = 0; j < nblk; ++j) {
    // out-of-range ids clamp, as the reference's gather does
    const int blk = min(max(tables[(size_t)b * M + j], 0), N - 1);
    for (int e = threadIdx.x; e < bs * D; e += NT) {
      const int t = e / D, d = e - t * D;
      const size_t off = (((size_t)blk * bs + t) * Hkv + hkv) * D + d;
      stage_kv(s, t, d, D, kp + off, vp + off);
    }
    __syncthreads();
    const int base = j * bs;
    fold_tile(s, R, bs, D, scale, softcap,
              [&](int, int k) { return base + k < ctx; }, acc);
  }

  T* ob = out + ((size_t)b * Hq + head0) * D;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e < R * D) st(ob + e, acc[i] / fmaxf(s.sl[e / D], 1e-30f));
  }
}

template <typename T>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* tables, const void* ctx, void* out, int B,
                  int Hq, int Hkv, int D, int bs, int M, int N, int fused,
                  float scale, float softcap, cudaStream_t stream) {
  const int gq = fused ? Hq / Hkv : 1;
  const dim3 grid(B, fused ? Hkv : Hq);
  const size_t smem = smem_bytes(gq, bs, D);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(paged_decode_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  paged_decode_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)tables,
      (const int*)ctx, (T*)out, Hq, Hkv, D, bs, M, N, gq, scale, softcap);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int paged_decode(int dtype, const void* q, const void* kp,
                            const void* vp, const void* tables,
                            const void* ctx, void* out, int B, int Hq,
                            int Hkv, int D, int bs, int M, int N, int fused,
                            float scale, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, kp, vp, tables, ctx, out, B, Hq, Hkv, D, bs, M,
                         N, fused, scale, softcap, st);
  return launch<__nv_bfloat16>(q, kp, vp, tables, ctx, out, B, Hq, Hkv, D,
                               bs, M, N, fused, scale, softcap, st);
}
