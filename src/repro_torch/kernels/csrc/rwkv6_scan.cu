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
// Bound on the card: at the serving shape (B 8, S 64, H 64, N 64, bf16)
// the kernel moves about 34 MB and does 5 B S H N^2 = 0.67 GFLOP in
// float32, 10 us of either at peak; past S ~ 100 the float32 operations
// bound it (S 2048: 0.32 ms against 0.24 ms of bytes).  Each state element
// costs three CUDA-core instructions per step (the output FMA, k_i v_j and
// the update FMA).  Two other limits shape the design.  Shared memory hands
// an SM's lanes 4 bytes each per cycle (a warp's 16-byte load takes four
// cycles however many lanes read one address), against four FMAs per lane
// per cycle, so a lane must do many FMAs per float it reads: one lane per
// state column is bound by shared memory at ~4x the FMA time.  And a
// (batch, head) is a serial chain of steps, so the card holds few warps
// (B H CTAs), and whatever a step waits on shows: the copies and the bonus
// must stay off the lanes that step.
//
// Design (the launch plan -- grid, lanes, chunk, ring depth, shared
// memory -- is ops.rwkv6_scan_plan's; the entry point computes none of it):
// - N is padded to NP = 64.  A CTA owns one (batch, head) (grid: H x B):
//   64 consumer lanes and one producer warp.
// - Consumers: each group of C = 8 columns has R = 8 adjacent lanes; lane q
//   keeps rows 4 (R m + q) + e (m < 2, e < 4) of all 8 columns in
//   registers, 64 floats.  Per step it reads 8 values each of r, k and w
//   and 8 of v (bf16 widened in registers: a shift or a mask), and does
//   24 x 8 FMAs: eight independent output chains of 8 fmaf, and the
//   update.  The 8 partials of a column leave by a reduce-scatter over
//   the group: at distance 1, 2, 4 a lane keeps the first half of its
//   slots and adds its partner's second half (7 shuffles for 8 columns).
//   Lane q's slot s holds column s ^ bitrev3(q) of its group, so a
//   partner's second half is always the same columns as the first half,
//   and slot 0 ends as column bitrev3(q), summed ((p0 + p1) + (p2 + p3)) +
//   ((p4 + p5) + (p6 + p7)) over the lanes' partials.  A step's shuffles
//   run under the next step's FMAs (one basic block), and its y goes
//   straight to global memory (eight lanes of a group write 16 contiguous
//   bytes).  A consumer waits on one mbarrier per chunk (staged, bonus
//   computed) and arrives on one (stage read).
// - The producer warp stages chunks of `chunk` steps into a ring of
//   `stages` buffers with four tensor copies a chunk (the Tensor Memory
//   Accelerator: boxes of chunk rows of the (B S, H N) views of r, k, w and
//   v, completing on the stage's mbarrier), `stages` - 1 chunks ahead, and
//   computes every step's bonus sum_i r_i u_i k_i (it does not depend on
//   the state: 4 lanes per step, a quarter of the channels each, then two
//   shuffles) before it releases the chunk to the consumers.  Rows past S
//   in a ragged last chunk are staged and never read.  Where N is under 64
//   (rows and columns padded with zeros in shared memory) or a pointer is
//   not 16-byte aligned, the producer copies element by element.
// - s0 and s_final pass through a shared tile, read and written in 16-byte
//   pieces by all lanes.
// Float32 stays IEEE float32 on the CUDA cores: S <- fmaf(w_i, S_ij,
// k_i v_j) with k_i v_j rounded first, y = fmaf(bonus, v_j, sum).  No
// tensor core: a matmul form of a chunk needs exp(-cumulative log w),
// which overflows float32 for RWKV's decays (the TPU kernel's docstring),
// and would round the state.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NP = 64;                  // N, padded
constexpr int R = 8;                    // lanes per group of C columns
constexpr int C = 8;                    // columns per lane
constexpr int M = NP / (4 * R);         // float4 row pieces per lane
constexpr int CONSUMERS = NP / C * R;   // 64
constexpr int MAX_THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int MIN_CTAS = 4;             // per SM: up to 168 registers
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// four consecutive values as float32 (a bf16 is the top half of one)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *(const float4*)p;
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 x = *(const uint2*)p;
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// a (rows x width) box at column x, row y of a 2-D tensor map into shared
// `dst` (128-byte aligned), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"((unsigned long long)map), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory: `stages` ring stages of [chunk][NP] w (float32), r, k and
// v (model dtype) and [chunk] bonus (float32), each part on 128 bytes, then
// the mbarriers landed, full and empty per stage; the state tile
// [N][NP + 4] float32 overlays the front before and after the chunks.
template <typename T>
struct Stage {
  float* w;
  T* r;
  T* k;
  T* v;
  float* bonus;
};

template <typename T>
struct Layout {
  int chunk, stages;
  __device__ int bytes() const {           // one stage
    return chunk * NP * (4 + 3 * (int)sizeof(T)) +
           (chunk * 4 + 127) / 128 * 128;
  }
  __device__ Stage<T> at(char* smem, int s) const {
    char* p = smem + (size_t)s * bytes();
    Stage<T> st;
    st.w = (float*)p;
    st.r = (T*)(st.w + chunk * NP);
    st.k = st.r + chunk * NP;
    st.v = st.k + chunk * NP;
    st.bonus = (float*)(st.v + chunk * NP);
    return st;
  }
  __device__ unsigned long long* bars(char* smem) const {
    return (unsigned long long*)(smem + (size_t)stages * bytes());
  }
};

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, MIN_CTAS) rwkv6_scan_kernel(
    const __grid_constant__ CUtensorMap map_r,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_w, const T* __restrict__ r,
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, T* __restrict__ y,
    float* __restrict__ s_final, int S, int H, int N, int chunk, int stages,
    int vec) {
  extern __shared__ __align__(128) float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nchunks = (S + chunk - 1) / chunk;
  const size_t step = (size_t)H * N;    // elements between steps
  const int ld = NP + 4;                // row stride of the state tile
  const Layout<T> L{chunk, stages};
  unsigned long long* landed = L.bars(smem);
  unsigned long long* full = landed + stages;
  unsigned long long* empty = full + stages;
  float* tile = (float*)smem;

  // the state tile <-> the global state of (b, h)
  const size_t sbase = ((size_t)b * H + h) * N * N;
  auto tile_io = [&](bool store) {
    const int pc = vec ? N / 4 : N;     // pieces per row
    for (int x = tid; x < N * pc; x += nthreads) {
      const int i = x / pc, c = x - i * pc;
      float* sm = tile + i * ld;
      const size_t gi = sbase + (size_t)i * N;
      if (vec && store)
        *(float4*)(s_final + gi + 4 * c) = *(const float4*)(sm + 4 * c);
      else if (vec)
        *(float4*)(sm + 4 * c) = *(const float4*)(s0 + gi + 4 * c);
      else if (store)
        s_final[gi + c] = sm[c];
      else
        sm[c] = s0[gi + c];
    }
  };

  // consumer lane: rows 4 (R m + q) + e, columns jc + (s ^ g) (s < C)
  const int q = tid % R;
  const int jc = (tid / R) * C;
  const int g = ((q & 1) << 2) | (q & 2) | ((q >> 2) & 1);  // bitrev3(q)
  float st[4 * M][C];
  if (s0 != nullptr) {
    tile_io(false);
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int s = 0; s < C; ++s) {
        const int i = 4 * (R * m + q) + e, j = jc + (s ^ g);
        st[4 * m + e][s] = (s0 != nullptr && tid < CONSUMERS && i < N &&
                            j < N) ? tile[i * ld + j] : 0.f;
      }
  if (s0 != nullptr) __syncthreads();    // the tile has been read
  // plain loads: the padding rows and columns of the ring read as zeros
  // (the tensor copies write every byte the consumers read)
  if (!vec)
    for (int x = tid; x < stages * L.bytes() / 16; x += nthreads)
      smem4[x] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the tile's accesses come before the tensor copies' writes to the same
  // bytes, which go through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(landed + s, 1);
      mbar_init(full + s, 32);
      mbar_init(empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto chunk_base = [&](int c) {          // element offset of (b, c*chunk, h)
    return (((size_t)b * S + (size_t)c * chunk) * H + h) * N;
  };
  auto steps_of = [&](int c) { return min(chunk, S - c * chunk); };

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    // chunk c into stage c % stages, once the consumers have released the
    // stage's previous chunk: four tensor copies (vec), else plain loads
    auto load = [&](int c) {
      if (c >= nchunks) return;
      const int s = c % stages;
      if (c >= stages) mbar_wait(empty + s, (c / stages - 1) & 1);
      const Stage<T> sg = L.at(smem, s);
      if (vec) {
        if (lane == 0) {
          mbar_expect(landed + s, chunk * NP * (4 + 3 * sizeof(T)));
          const int row = b * S + c * chunk;
          tma_load(sg.w, &map_w, h * N, row, landed + s);
          tma_load(sg.r, &map_r, h * N, row, landed + s);
          tma_load(sg.k, &map_k, h * N, row, landed + s);
          tma_load(sg.v, &map_v, h * N, row, landed + s);
        }
        return;
      }
      const int n = steps_of(c);
      const size_t g0 = chunk_base(c);
      for (int t = 0; t < n; ++t) {
        const size_t gt = g0 + (size_t)t * step;
        for (int i = lane; i < N; i += 32) {
          sg.r[t * NP + i] = r[gt + i];
          sg.k[t * NP + i] = k[gt + i];
          sg.w[t * NP + i] = w[gt + i];
          sg.v[t * NP + i] = v[gt + i];
        }
      }
    };
    // the lane's quarter of the channels for the bonus: u once
    constexpr int QN = NP / 4;
    const int part = lane & 3;
    float uq[QN];
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      const int ch = part * QN + i;
      uq[i] = ch < N ? u[(size_t)h * N + ch] : 0.f;
    }
    for (int c = 0; c < stages - 1; ++c) load(c);
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % stages, n = steps_of(c);
      if (vec)
        mbar_wait(landed + s, (c / stages) & 1);
      else
        __syncwarp();                    // the plain loads are the warp's
      const Stage<T> sg = L.at(smem, s);
      // bonus: lane (t, part) sums channels part * QN .. part * QN + QN - 1
      for (int t0 = 0; t0 < n; t0 += 8) {
        const int t = t0 + (lane >> 2);
        float p = 0.f;
        if (t < n) {
#pragma unroll
          for (int i = 0; i < QN; i += 4) {
            const float4 r4 = ld4(sg.r + t * NP + part * QN + i);
            const float4 k4 = ld4(sg.k + t * NP + part * QN + i);
            p = fmaf(__fmul_rn(r4.x, uq[i]), k4.x, p);
            p = fmaf(__fmul_rn(r4.y, uq[i + 1]), k4.y, p);
            p = fmaf(__fmul_rn(r4.z, uq[i + 2]), k4.z, p);
            p = fmaf(__fmul_rn(r4.w, uq[i + 3]), k4.w, p);
          }
        }
        p = __fadd_rn(p, __shfl_xor_sync(FULL, p, 1));
        p = __fadd_rn(p, __shfl_xor_sync(FULL, p, 2));
        if (t < n && part == 0) sg.bonus[t] = p;
      }
      mbar_arrive(full + s);             // release: the chunk is ready
      load(c + stages - 1);
    }
  } else {
    // ----------------------------------------------------------- consumers
    // one step: the lane's 4 M rows of its C columns -> C partials of y
    auto fma_step = [&](const Stage<T>& sg, int t, float (&acc)[C],
                        float& v0) {
      const T* rr = sg.r + t * NP + 4 * q;
      const T* kk = sg.k + t * NP + 4 * q;
      const float* ww = sg.w + t * NP + 4 * q;
      const T* vv = sg.v + t * NP + jc;
      float vj[C];
#pragma unroll
      for (int s = 0; s < C; ++s) {
        vj[s] = to_f(vv[s ^ g]);
        acc[s] = 0.f;
      }
      v0 = vj[0];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 r4 = ld4(rr + 4 * R * m);
        const float4 k4 = ld4(kk + 4 * R * m);
        const float4 w4 = ld4(ww + 4 * R * m);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int s = 0; s < C; ++s) {
            float& x = st[4 * m + e][s];
            acc[s] = fmaf(rv[e], x, acc[s]);
            x = fmaf(wv[e], x, __fmul_rn(kv[e], vj[s]));
          }
      }
    };
    // the partials of a step -> its y: lane q keeps slots [0, K) and adds
    // its partner q ^ (C / 2K)'s [K, 2K): its slot s is column jc + (s ^ g)
    // and its partner's slot s + K the same column, so after three levels
    // slot 0 holds column jc + g summed over the group's 8 lanes
    const bool writes = jc + g < N;
    auto reduce = [&](float (&acc)[C], float v0, float bonus, T* yt) {
#pragma unroll
      for (int kk2 = C / 2, o = 1; kk2 >= 1; kk2 >>= 1, o <<= 1)
#pragma unroll
        for (int s = 0; s < kk2; ++s)
          acc[s] = __fadd_rn(acc[s], __shfl_xor_sync(FULL, acc[s + kk2], o));
      if (writes) *yt = from_f<T>(fmaf(bonus, v0, acc[0]));
    };
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % stages, n = steps_of(c);
      mbar_wait(full + s, (c / stages) & 1);
      const Stage<T> sg = L.at(smem, s);
      T* yc = y + chunk_base(c) + jc + g;
      // step t's FMAs run under step t - 1's shuffles: one basic block,
      // so the shuffles' latency hides behind independent FMAs (not
      // unrolled: two steps per block lost 4% at 2048 tokens, PERF.md §6)
      float acc[C], v0;
      fma_step(sg, 0, acc, v0);
      for (int t = 1; t < n; ++t) {
        float nacc[C], nv0;
        fma_step(sg, t, nacc, nv0);
        reduce(acc, v0, sg.bonus[t - 1], yc + (t - 1) * step);
#pragma unroll
        for (int s2 = 0; s2 < C; ++s2) acc[s2] = nacc[s2];
        v0 = nv0;
      }
      reduce(acc, v0, sg.bonus[n - 1], yc + (n - 1) * step);
      mbar_arrive(empty + s);            // release: the stage is read
    }
  }

  __syncthreads();                       // every chunk done
  // the tile may overlay the mbarriers: retire them first
  if (tid == 0)
    for (int x = 0; x < 3 * stages; ++x) mbar_inval(landed + x);
  __syncthreads();
  if (tid < CONSUMERS) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int s = 0; s < C; ++s) {
          const int i = 4 * (R * m + q) + e, j = jc + (s ^ g);
          if (i < N && j < N) tile[i * ld + j] = st[4 * m + e][s];
        }
  }
  __syncthreads();
  tile_io(true);
}

template <typename T>
int opt_in(int smem) {
  static int opted = -1;                 // once per instantiation and size
  if (smem > opted) {
    auto kern = rwkv6_scan_kernel<T>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)                // room for the plan's CTAs per SM
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  return 0;
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion,
                            CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
Encode encoder() {
  static Encode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (Encode)p;
  }
  return fn;
}

// a map of the (B S rows, H N columns) view of a model-layout tensor whose
// boxes are `width` columns by `rows` rows; false if it cannot be encoded
bool encode(CUtensorMap* map, const void* base, CUtensorMapDataType type,
            int elem, int B, int S, int H, int N, int width, int rows) {
  const Encode fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)H * N, (cuuint64_t)B * S};
  const cuuint64_t strides[1] = {(cuuint64_t)H * N * elem};
  const cuuint32_t box[2] = {(cuuint32_t)width, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *r, *k, *v;
  const float *w, *u, *s0;
  void* y;
  float* s_final;
  int B, S, H, N, threads, chunk, stages, smem, vec;
  cudaStream_t stream;
};

template <typename T>
int launch(const Args& a) {
  if (const int e = opt_in<T>(a.smem)) return e;
  CUtensorMap maps[4] = {};               // r, k, v, w; unread unless vec
  if (a.vec && a.S > 0) {
    const CUtensorMapDataType type =
        sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const int z = sizeof(T);
    if (!encode(&maps[0], a.r, type, z, a.B, a.S, a.H, a.N, a.N, a.chunk) ||
        !encode(&maps[1], a.k, type, z, a.B, a.S, a.H, a.N, a.N, a.chunk) ||
        !encode(&maps[2], a.v, type, z, a.B, a.S, a.H, a.N, a.N, a.chunk) ||
        !encode(&maps[3], a.w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.B, a.S,
                a.H, a.N, a.N, a.chunk))
      return (int)cudaErrorInvalidValue;
  }
  rwkv6_scan_kernel<T>
      <<<dim3(a.H, a.B), a.threads, a.smem, a.stream>>>(
          maps[0], maps[1], maps[2], maps[3], (const T*)a.r, (const T*)a.k,
          (const T*)a.v, a.w, a.u, a.s0, (T*)a.y, a.s_final, a.S, a.H, a.N,
          a.chunk, a.stages, a.vec);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int threads, int smem) {
  if (const int e = opt_in<T>(smem)) return -e;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, rwkv6_scan_kernel<T>, threads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

// the instantiation of a dtype
template <typename F>
int dispatch(int dtype, F&& f) {
  if (dtype == 0) return f.template go<float>();
  if (dtype == 1) return f.template go<__nv_bfloat16>();
  return (int)cudaErrorInvalidValue;
}

struct Launch {
  const Args& a;
  template <typename T>
  int go() { return launch<T>(a); }
};

struct Occupancy {
  int threads, smem;
  template <typename T>
  int go() { return occupancy<T>(threads, smem); }
};

}  // namespace

// dtype of r, k, v and y: 0 = float32, 1 = bfloat16; w, u, s0 and s_final
// are float32, s0 may be null (zero initial state).  The launch is
// ops.rwkv6_scan_plan's: grid (H, B) of `threads` lanes (64 consumers and
// the producer warp), `chunk` steps per ring stage, `stages` stages,
// `smem` dynamic shared bytes; vec = 1 (tensor copies) when N is 64 and
// every pointer is 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int rwkv6_scan(int dtype, const void* r, const void* k,
                          const void* v, const void* w, const void* u,
                          const void* s0, void* y, void* s_final, int B,
                          int S, int H, int N, int threads, int chunk,
                          int stages, int smem, int vec, void* stream) {
  const Args a{r,      k,    (const void*)v, (const float*)w,
               (const float*)u, (const float*)s0, y, (float*)s_final,
               B,      S,    H,    N,    threads, chunk, stages, smem, vec,
               (cudaStream_t)stream};
  return dispatch(dtype, Launch{a});
}

// CTAs of the kernel for `dtype` resident on one SM at `threads` lanes and
// `smem` dynamic shared bytes (the card's own count, to hold
// ops.rwkv6_scan_plan's ctas_per_sm to); a negative cudaError_t on
// failure.
extern "C" int rwkv6_scan_occupancy(int dtype, int threads, int smem) {
  return dispatch(dtype, Occupancy{threads, smem});
}
