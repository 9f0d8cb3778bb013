// Weighted Gaussian-KDE log-density on Hopper (sm_90a).
//
// Replaces the TPU kernel pyabc_tpu/ops/kde_pallas.py (_kernel /
// weighted_kde_logpdf_pallas).  For query rows x_i, support rows s_j with
// log weights lw_j and a lower-triangular bandwidth factor L it computes
//
//     out_i = log sum_j exp(lw_j - 0.5 * ||z_i - z_j||^2) + log_norm,
//     z = L^-1 (. - c),  c = softmax(lw) . s  (the weighted support mean).
//
// What bounds it on this card: one exp per (query, support) pair.  The
// inputs are (M + N) * (d + 1) * 4 bytes, and every pair is one exp plus
// 2d + 3 FP32 instructions, so the kernel is bound by exp throughput on
// the 16-lane MUFU unit of an SM (d <= 2) or by FP32 issue (d >= 3), never
// by bytes.  At d <= 2 one exp in eight runs on the FMA pipe instead
// (ex2_fma).  Design against that, four launches per call:
//
//   kde_prep_kernel    one block: the weighted centre c (an online softmax
//                      over all N rows) and A = sqrt(log2(e) / 2) * L^-1
//                      (forward substitution, one column per thread).
//   kde_pack_kernel    one thread per support row: the packed row
//                      (A (s_j - c), lw_j * log2(e)), P floats, so that
//                      ||A(x - s)||^2 = log2(e)/2 * ||z_i - z_j||^2 and the
//                      base-2 logit is l = lw' - ||z'_i - z'_j||^2 with no
//                      scaling multiply; exp2(l) = exp(lw - ||dz||^2 / 2).
//   kde_partial_kernel one block per (query block, support split).  One
//                      bulk copy (cp.async.bulk, completing on an mbarrier)
//                      stages the whole split in shared memory while the
//                      threads load and whiten their Q query rows; there is
//                      no __syncthreads() in the loop.  Each thread then
//                      walks the split in sub-tiles of K rows: for each of
//                      its Q queries it forms K logits, takes their max,
//                      raises its running max once, rescales its sum once
//                      and adds K exps.  No branch depends on the data, so
//                      a sorted support (the grid-compressed 1-D support,
//                      whose logits rise row after row) costs what a
//                      shuffled one does.  One broadcast vector load of a
//                      packed row serves Q pairs.
//   kde_merge_kernel   combines the splits' (max, sum) and converts back to
//                      natural log once: out = (max + log2(sum)) ln 2 + ...
//
// The logit is formed from the coordinate difference, not from the TPU
// kernel's augmented product [z_i, -a_i, 1] . [z_j, 1, b_j]: in float32
// that expansion cancels at |z| of a few tens, the whitened range of a
// large posterior.  Tensor cores are not used: at d = 1 a pair's product
// has depth 1 (three FP32 operations against one ex2), so the exp, not the
// product, bounds the kernel.
//
// Traps:
//   * The running max starts at NEG_BIG2 = -1e30 * log2(e), the base-2
//     image of the -1e30 that pad rows (pad_params) and empty grid cells
//     (_compress_support) carry, never at -inf: exp2(-inf - -inf) is NaN.
//     An all-pad split leaves (NEG_BIG2, count), so an all-pad support
//     gives -1e30 (to float32 rounding) as the plain version does, and the
//     first real row rescales a pad-only sum by exp2(NEG_BIG2 - l) = 0.
//   * Ragged N: the packed buffer is rounded up to a multiple of G rows
//     with filler rows whose logit is NEVER = -3e38.  A filler never raises
//     the max (it lies below NEG_BIG2) and adds exp2(-3e38 - max) = 0, so
//     fillers are masked by value, not counted.  Ragged M: rows past M
//     compute on the centre (z = 0) and are not stored.
//   * Launch errors: kde_logpdf_launch returns cudaGetLastError() after
//     each launch; the Python wrapper raises on any non-zero value.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_BIG (-1e30f)
#define LOG2E 1.4426950408889634f
#define LN2 0.6931471805599453f
// sqrt(log2(e) / 2): folds the 1/2 and the change of base into A
#define HALF_LOG2E_SQRT 0.8493218002880191f
#define NEG_BIG2 (NEG_BIG * LOG2E)
#define NEVER (-3e38f)
#define BLOCK 128
#define PREP_THREADS 512
#define PACK_THREADS 256
#define MAX_D 32
// support rows per split are a multiple of G (bulk-copy alignment, K)
#define G 16
// dynamic shared memory the partial kernel may take (the wrapper plans
// splits of at most 48 KB)
#define MAX_SMEM (64 * 1024)
// params buffer: centre [MAX_D], then A [d * d] row-major
#define PARAMS_A MAX_D

static __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

static __device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp2 on the FMA pipe, for x <= 0: x = j + f with j an integer (rounded
// to nearest by the 1.5 * 2^23 shift) and f in [-0.5, 0.5]; 2^f by a
// degree-5 polynomial (relative error <= 1e-6 on [-126, 0], CPU-tested
// through kde_cuda.exp2_fma); 2^j added to the exponent bits.  x is
// clamped at -126 so the exponent field never underflows: anything lower
// returns <= 2^-125, which a sum holding its max term (1) absorbs.
#define EXP2_C0 1.0000001192092896f
#define EXP2_C1 0.6931469440460205f
#define EXP2_C2 0.24022120237350464f
#define EXP2_C3 0.05550713092088699f
#define EXP2_C4 0.009675541892647743f
#define EXP2_C5 0.0013276472454890609f
static __device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float p = fmaf(EXP2_C5, f, EXP2_C4);
  p = fmaf(p, f, EXP2_C3);
  p = fmaf(p, f, EXP2_C2);
  p = fmaf(p, f, EXP2_C1);
  p = fmaf(p, f, EXP2_C0);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

// Packed row stride in floats for a fixed dimension D (D <= 8); the
// generic path (D == MAX_D) uses d + 1 at run time.  Q * K logits live in
// registers; at Q = 4, K = 16 nvcc put them in local memory and the d = 1
// kernel ran ten times slower, so K = 8.  E of the K exps of a sub-tile
// go to the FMA pipe: at d <= 2 the 16-lane MUFU, not FP32 issue, is the
// limit, and one in eight measured fastest; at d >= 3 FP32 issue is.
template <int D>
struct Geometry {
  static constexpr int P = D == 1 ? 2 : ((D + 1 + 3) / 4) * 4;
  static constexpr int Q = D == MAX_D ? 2 : 4;   // queries per thread
  static constexpr int K = D == MAX_D ? 4 : 8;  // rows per sub-tile
  static constexpr int E = D <= 2 ? 1 : 0;      // exps on the FMA pipe
};

// ------------------------------------------------------------------ prep

// (max, sum, weighted sums) of one online softmax, merged pairwise.
template <int D>
struct Soft {
  float m, s, v[D];
};

template <int D>
__device__ __forceinline__ void soft_merge(Soft<D>& a, const Soft<D>& b,
                                           int d) {
  const float mn = fmaxf(a.m, b.m);
  const float ea = __expf(a.m - mn), eb = __expf(b.m - mn);
  a.s = a.s * ea + b.s * eb;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k < d) a.v[k] = a.v[k] * ea + b.v[k] * eb;
  }
  a.m = mn;
}

template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
kde_prep_kernel(const float* __restrict__ support,
                const float* __restrict__ lw, const float* __restrict__ chol,
                int N, int d, float* __restrict__ params) {
  __shared__ Soft<D> s_part[PREP_THREADS / 32];
  Soft<D> a;
  a.m = NEG_BIG;
  a.s = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) a.v[k] = 0.f;
  for (int64_t j = threadIdx.x; j < N; j += PREP_THREADS) {
    const float w = lw[j];
    const float mn = fmaxf(a.m, w);
    const float sc = __expf(a.m - mn), e = __expf(w - mn);
    a.s = fmaf(a.s, sc, e);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k < d) a.v[k] = fmaf(a.v[k], sc, e * support[j * d + k]);
    }
    a.m = mn;
  }
  for (int off = 16; off > 0; off >>= 1) {
    Soft<D> b;
    b.m = __shfl_down_sync(0xffffffffu, a.m, off);
    b.s = __shfl_down_sync(0xffffffffu, a.s, off);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      b.v[k] = __shfl_down_sync(0xffffffffu, a.v[k], off);
    }
    soft_merge<D>(a, b, d);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) s_part[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < PREP_THREADS / 32; ++w) soft_merge<D>(a, s_part[w], d);
    for (int k = 0; k < d; ++k) params[k] = a.v[k] / a.s;
  }
  // column k of L^-1 by forward substitution, scaled into A
  const int k = threadIdx.x;
  if (k < d) {
    float col[MAX_D];
    for (int i = 0; i < d; ++i) {
      float acc = i == k ? 1.f : 0.f;
      for (int j = k; j < i; ++j) acc = fmaf(-chol[i * d + j], col[j], acc);
      col[i] = i < k ? 0.f : acc / chol[i * d + i];
      params[PARAMS_A + i * d + k] = HALF_LOG2E_SQRT * col[i];
    }
  }
}

// ------------------------------------------------------------------ pack

// z = A (p - c) for one row p of d coordinates; A lower-triangular.
template <int D>
__device__ __forceinline__ void whiten_row(const float* __restrict__ p,
                                           const float* __restrict__ params,
                                           int d, float* z) {
  float u[D];
#pragma unroll
  for (int k = 0; k < D; ++k) u[k] = k < d ? p[k] - params[k] : 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      if (i < d) acc = fmaf(params[PARAMS_A + i * d + k], u[k], acc);
    }
    z[i] = acc;
  }
}

template <int D, bool FIXED>
__global__ void __launch_bounds__(PACK_THREADS)
kde_pack_kernel(const float* __restrict__ support,
                const float* __restrict__ lw,
                const float* __restrict__ params, int N, int n_pad, int d,
                float* __restrict__ packed) {
  const int64_t j = (int64_t)blockIdx.x * PACK_THREADS + threadIdx.x;
  if (j >= n_pad) return;
  const int dd = FIXED ? D : d;
  const int P = FIXED ? Geometry<D>::P : d + 1;
  float* row = packed + j * P;
  float z[D];
  if (j < N) whiten_row<D>(support + j * dd, params, dd, z);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k < dd) row[k] = j < N ? z[k] : 0.f;
  }
  row[dd] = j < N ? lw[j] * LOG2E : NEVER;
  for (int k = dd + 1; k < P; ++k) row[k] = 0.f;
}

// --------------------------------------------------------------- partial

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Packed row r of a fixed-D layout: D coordinates and the base-2 weight.
template <int D>
__device__ __forceinline__ void load_row(const float* s, int r, float* z,
                                         float& w) {
  constexpr int P = Geometry<D>::P;
  if constexpr (P == 2) {
    const float2 v = reinterpret_cast<const float2*>(s)[r];
    z[0] = v.x;
    w = v.y;
  } else {
    float t[P];
#pragma unroll
    for (int u = 0; u < P / 4; ++u) {
      const float4 v = reinterpret_cast<const float4*>(s + r * P)[u];
      t[4 * u] = v.x;
      t[4 * u + 1] = v.y;
      t[4 * u + 2] = v.z;
      t[4 * u + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) z[k] = t[k];
    w = t[D];
  }
}

// D is the dimension when FIXED is true; otherwise D = MAX_D is a register
// bound and the run-time d selects the columns (packed stride d + 1).
template <int D, bool FIXED>
__global__ void __launch_bounds__(BLOCK)
kde_partial_kernel(const float* __restrict__ x,
                   const float* __restrict__ packed,
                   const float* __restrict__ params, int M, int N, int d,
                   int chunk, float* __restrict__ pmax,
                   float* __restrict__ psum) {
  constexpr int Q = Geometry<D>::Q;
  constexpr int K = Geometry<D>::K;
  extern __shared__ __align__(16) float s_rows[];
  __shared__ __align__(8) uint64_t s_bar;
  const int dd = FIXED ? D : d;
  const int P = FIXED ? Geometry<D>::P : d + 1;
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int cnt = (int)min64((int64_t)chunk, (int64_t)N - j0);
  const int cnt_pad = (cnt + G - 1) / G * G;
  const uint32_t bar = smem_addr(&s_bar);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)cnt_pad * (uint32_t)P * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem_addr(s_rows)), "l"(packed + j0 * P), "r"(bytes), "r"(bar)
        : "memory");
  }

  // while the split arrives: load and whiten this thread's Q query rows
  const int64_t i0 = (int64_t)blockIdx.x * BLOCK * Q + threadIdx.x;
  float zq[Q][D];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t i = i0 + (int64_t)q * BLOCK;
    float p[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      p[k] = (i < M && k < dd) ? x[i * dd + k] : params[k < dd ? k : 0];
    }
    whiten_row<D>(p, params, dd, zq[q]);
  }

  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(0u) : "memory");
  }

  float mx[Q], sm[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    mx[q] = NEG_BIG2;
    sm[q] = 0.f;
  }
  for (int r0 = 0; r0 < cnt_pad; r0 += K) {
    float l[Q][K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float z[D], w;
      if constexpr (FIXED) {
        load_row<D>(s_rows, r0 + k, z, w);
      } else {
        const float* row = s_rows + (r0 + k) * P;
#pragma unroll
        for (int c = 0; c < D; ++c) z[c] = c < dd ? row[c] : 0.f;
        w = row[dd];
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float acc = w;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          if (FIXED || c < dd) {
            const float df = zq[q][c] - z[c];
            acc = fmaf(-df, df, acc);
          }
        }
        l[q][k] = acc;
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float mn = mx[q];
#pragma unroll
      for (int k = 0; k < K; ++k) mn = fmaxf(mn, l[q][k]);
      float e = sm[q] * ex2(mx[q] - mn);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        e += k < K - Geometry<D>::E ? ex2(l[q][k] - mn) : ex2_fma(l[q][k] - mn);
      }
      sm[q] = e;
      mx[q] = mn;
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t i = i0 + (int64_t)q * BLOCK;
    if (i < M) {
      const int64_t o = (int64_t)blockIdx.y * M + i;
      pmax[o] = mx[q];
      psum[o] = sm[q];
    }
  }
}

// ----------------------------------------------------------------- merge

__global__ void __launch_bounds__(256)
kde_merge_kernel(const float* __restrict__ pmax,
                 const float* __restrict__ psum, int M, int S,
                 const float* __restrict__ log_norm_ptr, float log_norm_val,
                 float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= M) return;
  float mx = NEG_BIG2;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, pmax[(int64_t)s * M + i]);
  float tot = 0.f;
  for (int s = 0; s < S; ++s) {
    const int64_t o = (int64_t)s * M + i;
    tot = fmaf(psum[o], exp2f(pmax[o] - mx), tot);
  }
  const float ln = log_norm_ptr ? log_norm_ptr[0] : log_norm_val;
  out[i] = (mx + log2f(tot)) * LN2 + ln;
}

// ---------------------------------------------------------------- launch

template <int D, bool FIXED>
static int launch_all(cudaStream_t st, const float* x, const float* support,
                      const float* lw, const float* chol, int M, int N,
                      int d, int chunk, int S, float* params, float* packed,
                      float* pmax, float* psum) {
  const int P = FIXED ? Geometry<D>::P : d + 1;
  const int n_pad = (N + G - 1) / G * G;
  kde_prep_kernel<D><<<1, PREP_THREADS, 0, st>>>(support, lw, chol, N, d,
                                                 params);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kde_pack_kernel<D, FIXED><<<(n_pad + PACK_THREADS - 1) / PACK_THREADS,
                              PACK_THREADS, 0, st>>>(support, lw, params, N,
                                                     n_pad, d, packed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)chunk * P * sizeof(float);
  // the split plus the static mbarrier may pass the 48 KB a block gets
  // without opting in; opt in once per template, for every size it takes
  static bool opted_in = false;
  if (!opted_in) {
    err = cudaFuncSetAttribute(kde_partial_kernel<D, FIXED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int qb = BLOCK * Geometry<D>::Q;
  dim3 grid((unsigned)((M + qb - 1) / qb), (unsigned)S);
  kde_partial_kernel<D, FIXED><<<grid, BLOCK, smem, st>>>(
      x, packed, params, M, N, d, chunk, pmax, psum);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch prep, pack, partial and merge on `stream`.  `params` holds
// MAX_D + MAX_D^2 floats, `packed` ceil(N / G) * G * P floats (16-byte
// aligned), pmax / psum S * M floats.  log_norm is read from
// `log_norm_ptr` when it is not null, else `log_norm_val`.  Returns 0 or
// the first CUDA error code; the launches are asynchronous.
int kde_logpdf_launch(const float* x, const float* support, const float* lw,
                      const float* chol, const float* log_norm_ptr,
                      float log_norm_val, int M, int N, int d, int chunk,
                      int S, float* params, float* packed, float* pmax,
                      float* psum, float* out, void* stream) {
  if (M <= 0) return 0;
  if (N <= 0 || d < 1 || d > MAX_D || chunk <= 0 || chunk % G != 0 ||
      S <= 0 || (int64_t)S * chunk < N || (int64_t)(S - 1) * chunk >= N ||
      S > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  switch (d) {
#define CASE(DD) \
  case DD: rc = launch_all<DD, true>(st, x, support, lw, chol, M, N, d, \
                                     chunk, S, params, packed, pmax, psum); \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      rc = launch_all<MAX_D, false>(st, x, support, lw, chol, M, N, d, chunk,
                                    S, params, packed, pmax, psum);
      break;
  }
  if (rc != 0) return rc;
  kde_merge_kernel<<<(unsigned)((M + 255) / 256), 256, 0, st>>>(
      pmax, psum, M, S, log_norm_ptr, log_norm_val, out);
  return (int)cudaGetLastError();
}

const char* kde_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
