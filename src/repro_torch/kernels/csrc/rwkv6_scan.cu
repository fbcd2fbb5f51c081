// RWKV-6 WKV recurrence (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py::
// rwkv6_scan_bhsn (body _kernel).  Per (batch, head), with an N x N float32
// state S (rows: key channel i, columns: value channel j):
//
//   y_t = r_t^T (S + diag(u) k_t v_t^T)   = r_t^T S + (sum_i r_i u_i k_i) v_t
//   S   <- diag(w_t) S + k_t v_t^T
//
// r, k, v, y: (B, S, H, N) in the model dtype; w: (B, S, H, N) float32
// (the model computes the decay in float32, and rounding it to bf16 would
// change the recurrence); u: (H, N) float32; s0, s_final: (B, H, N, N)
// float32, s0 may be null (zeros).  These are the model's own layouts, so
// the wrapper neither transposes nor pads, and ragged or single-step
// sequences need nothing.
//
// Design: one CTA per (head, batch); thread j owns column j of the state,
// N floats in registers, for the whole sequence (the TPU kernel keeps the
// state in VMEM scratch across a sequential grid axis; here the sequence
// is a loop inside the CTA).  Each step stages r_t, k_t and w_t in shared
// memory (double-buffered, so one barrier per step), reduces the bonus
// sum_i r_i u_i k_i once with warp shuffles, and prefetches the next
// step's four values into registers while the current step computes.
//
// Bound on the card: at the serving shape (B 8, S 64, H 64, N 64, bf16)
// the kernel moves about 34 MB and does 5 B S H N^2 = 0.67 GFLOP in
// float32, 10 us of either at peak; 512 CTAs of 64 threads and a 64-step
// dependent chain per CTA make it latency-bound, not bandwidth- or
// FLOP-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAXN = 64;         // state columns a thread can hold

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(MAXN) rwkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, T* __restrict__ y,
    float* __restrict__ s_final, int S, int H, int N) {
  __shared__ float sr[2][MAXN], sk[2][MAXN], sw[2][MAXN];
  __shared__ float part[2][MAXN / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int j = threadIdx.x;
  const bool own = j < N;
  const int lane = j & 31, warp = j >> 5, nwarps = blockDim.x >> 5;

  // column j of the state
  float st_col[MAXN];
  const size_t sbase = ((size_t)b * H + h) * N * N;
#pragma unroll
  for (int i = 0; i < MAXN; ++i)
    st_col[i] = (own && i < N && s0 != nullptr) ? s0[sbase + (size_t)i * N + j]
                                                : 0.f;
  const float uj = own ? u[(size_t)h * N + j] : 0.f;

  const size_t step = (size_t)H * N;            // elements between steps
  size_t off = ((size_t)b * S * H + h) * N + j;  // (b, t=0, h, j)
  float nr = 0.f, nk = 0.f, nv = 0.f, nw = 0.f;
  if (own && S > 0) {
    nr = ld(r + off); nk = ld(k + off); nv = ld(v + off); nw = w[off];
  }
  for (int t = 0; t < S; ++t, off += step) {
    const float rj = nr, kj = nk, vj = nv, wj = nw;
    if (own && t + 1 < S) {                       // prefetch step t + 1
      nr = ld(r + off + step); nk = ld(k + off + step);
      nv = ld(v + off + step); nw = w[off + step];
    }
    const int buf = t & 1;
    sr[buf][j] = rj;
    sk[buf][j] = kj;
    sw[buf][j] = wj;
    float p = rj * uj * kj;                       // 0 on idle lanes
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) part[buf][warp] = p;
    __syncthreads();
    float bonus = 0.f;
    for (int q = 0; q < nwarps; ++q) bonus += part[buf][q];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < N) {
        acc = fmaf(sr[buf][i], st_col[i], acc);
        st_col[i] = fmaf(sw[buf][i], st_col[i], sk[buf][i] * vj);
      }
    }
    if (own) st(y + off, acc + bonus * vj);
  }
  if (own) {
#pragma unroll
    for (int i = 0; i < MAXN; ++i)
      if (i < N) s_final[sbase + (size_t)i * N + j] = st_col[i];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_final, int B,
           int S, int H, int N, cudaStream_t stream) {
  const dim3 grid(H, B);
  const int threads = ((N + 31) / 32) * 32;
  rwkv6_scan_kernel<T><<<grid, threads, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, (T*)y, s_final, S, H,
      N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of r, k, v and y: 0 = float32, 1 = bfloat16; w, u, s0 and s_final
// are float32, s0 may be null (zero initial state).  Requires
// 1 <= N <= 64.  Returns cudaGetLastError().
extern "C" int rwkv6_scan(int dtype, const void* r, const void* k,
                          const void* v, const void* w, const void* u,
                          const void* s0, void* y, void* s_final, int B,
                          int S, int H, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* wf = (const float*)w;
  const float* uf = (const float*)u;
  const float* s0f = (const float*)s0;
  float* sf = (float*)s_final;
  if (dtype == 0)
    return launch<float>(r, k, v, wf, uf, s0f, y, sf, B, S, H, N, st);
  return launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, y, sf, B, S, H, N, st);
}
