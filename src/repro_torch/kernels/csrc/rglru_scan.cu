// RG-LRU linear recurrence (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py::
// rglru_scan_bsr (body _kernel).  Elementwise over the R channels:
//
//   h_t = a_t * h_{t-1} + b_t,   h_0 = h0 (zeros when h0 is null)
//
// a, b: (B, S, R) float32; h0, h_last: (B, R) float32; h: (B, S, R) in the
// output dtype (float32 or bfloat16, the fp32 state rounded once on the
// store).  These are the model's own layouts: any S >= 0 and any R, with
// no padding (the TPU wrapper pads S to its tile with a = 1, b = 0 steps,
// which only a tiled grid needs).
//
// Design: one thread per (batch, channel), channels across the threads of
// a CTA so every load and store is coalesced, the fp32 state in a register
// for the whole sequence (the TPU kernel carries it in VMEM scratch across
// a sequential grid axis; here the sequence is a loop in the thread).  The
// loop runs in chunks of U steps: the next chunk's 2U loads are started
// before the current chunk's dependent chain, so the loads overlap it.
//
// Arithmetic: a separately rounded multiply and add (__fmul_rn, __fadd_rn),
// not fmaf.  That is the sequential plain version's arithmetic exactly (an
// eager `a_t * h + b_t` is two rounded operations), so the kernel matches
// it bit for bit and the model's kernel path matches its plain path in
// every RG-LRU layer; nvcc would otherwise contract a * h + b into an FMA.
//
// Bound on the card: bytes.  Each step moves 8 bytes in and 2-4 out for 2
// flops.  At the serving shape (B 8, S 2048, R 2560, bf16 out) that is
// about 420 MB, 0.13 ms at 3.35 TB/s; only B * R = 20480 threads exist, so
// the loads in flight per thread (2U) set how close it comes.  A chunked
// two-pass scan over S that uses more of the card is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;      // channels per CTA
constexpr int U = 16;            // steps per chunk (loads in flight: 2U)

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, T* __restrict__ h,
    float* __restrict__ h_last, int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (r >= R) return;
  float state = h0 != nullptr ? h0[(size_t)bi * R + r] : 0.f;
  const size_t base = (size_t)bi * S * R + r;     // (bi, t = 0, r)
  float ca[U], cb[U], na[U], nb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool live = u < S;
    ca[u] = live ? a[base + (size_t)u * R] : 0.f;
    cb[u] = live ? b[base + (size_t)u * R] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {                 // prefetch the next chunk
      const int t = t0 + U + u;
      const bool live = t < S;
      na[u] = live ? a[base + (size_t)t * R] : 0.f;
      nb[u] = live ? b[base + (size_t)t * R] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < S) {
        state = __fadd_rn(__fmul_rn(ca[u], state), cb[u]);
        st(h + base + (size_t)t * R, state);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  h_last[(size_t)bi * R + r] = state;
}

template <typename T>
int launch(const float* a, const float* b, const float* h0, void* h,
           float* h_last, int B, int S, int R, cudaStream_t stream) {
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(a, b, h0, (T*)h, h_last,
                                                     S, R);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of h: 0 = float32, 1 = bfloat16; a, b, h0 and h_last are float32,
// h0 may be null (zero initial state).  Requires B, R >= 1 and S >= 0.
// Returns cudaGetLastError().
extern "C" int rglru_scan(int dtype, const void* a, const void* b,
                          const void* h0, void* h, void* h_last, int B,
                          int S, int R, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* af = (const float*)a;
  const float* bf = (const float*)b;
  const float* h0f = (const float*)h0;
  float* hl = (float*)h_last;
  if (dtype == 0) return launch<float>(af, bf, h0f, h, hl, B, S, R, st);
  return launch<__nv_bfloat16>(af, bf, h0f, h, hl, B, S, R, st);
}
