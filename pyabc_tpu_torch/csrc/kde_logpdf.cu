// Weighted Gaussian-KDE log-density on Hopper (sm_90a).
//
// Replaces the TPU kernel pyabc_tpu/ops/kde_pallas.py (_kernel /
// weighted_kde_logpdf_pallas).  It computes, for every whitened query row
// z_i and whitened support rows z_j with log weights lw_j,
//
//     out_i = log sum_j exp(lw_j - 0.5 * ||z_i - z_j||^2) + log_norm
//
// What bounds it on this card: one exp per (query, support) pair.  The
// inputs are (M + N) * (d + 1) * 4 bytes and every pair is a handful of
// FP32 instructions plus one ex2 on the 16-lane MUFU unit of each SM, so
// the kernel is bound by exp throughput and FP32 issue, never by bytes.
// Design against that:
//   * one thread per query row, its coordinates in registers;
//   * support rows staged tile by tile in shared memory; every thread
//     reads the same row, so the reads are broadcasts (no bank conflicts);
//   * one __expf per pair: the running (max, sum) is updated with the
//     branch "new max -> rescale the sum once, else add exp(l - max)";
//   * the support axis is split over gridDim.y so that small query counts
//     (16384 queries = 64 blocks) still fill 132 SMs; each split writes a
//     partial (max, sum) and kde_merge_kernel combines them.  The split
//     also bounds each thread's float32 sum to at most one chunk of terms.
// The wgmma / exp-emulation redesign is later work.
//
// The logit is formed from the coordinate difference, not from the TPU
// kernel's augmented product [z_i, -a_i, 1] . [z_j, 1, b_j]: in float32
// that expansion cancels at |z| of a few tens, the whitened range of a
// large posterior.  It costs d extra subtractions per pair.
//
// Traps:
//   * The running max starts at -1e30, not -inf, as the TPU kernel's does.
//     Pad rows (pad_params) and empty grid cells (_compress_support) carry
//     lw = -1e30.  A tile of pads only leaves (max ~ -1e30, sum = count);
//     the first real row then rescales that sum by exp(-1e30 - l) = 0, so
//     pads contribute exactly nothing.  Starting from -inf, an all-pad or
//     empty split would compute exp(-inf - -inf) = NaN.
//   * Ragged M and N: rows past M compute on zeros and are not stored;
//     rows past the split's end are never read (the tile loop is bounded
//     by the split's own row count).
//   * Launch errors: kde_logpdf_launch returns cudaGetLastError() after
//     each launch; the Python wrapper raises on any non-zero value.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_BIG (-1e30f)
#define BLOCK 256
#define TILE 256
#define MAX_D 32

static __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <int D>
__device__ __forceinline__ void load_query(const float* __restrict__ zx,
                                           int64_t i, int M, int d,
                                           float* q) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    q[k] = (i < M && k < d) ? zx[i * d + k] : 0.f;
  }
}

// D is the dimension when FIXED is true; otherwise D = MAX_D is a register
// bound and the runtime d selects the columns.
template <int D, bool FIXED>
__global__ void __launch_bounds__(BLOCK)
kde_partial_kernel(const float* __restrict__ zx, const float* __restrict__ zs,
                   const float* __restrict__ lw, int M, int N, int d,
                   int chunk, float* __restrict__ pmax,
                   float* __restrict__ psum) {
  __shared__ float s_z[TILE * D];
  __shared__ float s_w[TILE];
  const int dd = FIXED ? D : d;
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  const int64_t j0 = (int64_t)blockIdx.y * chunk;
  const int64_t j1 = min64((int64_t)N, j0 + chunk);

  float q[D];
  load_query<D>(zx, i, M, dd, q);

  float mx = NEG_BIG;
  float sm = 0.f;
  for (int64_t t0 = j0; t0 < j1; t0 += TILE) {
    const int cnt = (int)min64((int64_t)TILE, j1 - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int r = threadIdx.x; r < cnt; r += BLOCK) {
      s_w[r] = lw[t0 + r];
    }
    for (int e = threadIdx.x; e < cnt * dd; e += BLOCK) {
      s_z[e] = zs[t0 * dd + e];
    }
    __syncthreads();
    for (int r = 0; r < cnt; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (FIXED || k < dd) {
          const float df = q[k] - s_z[r * dd + k];
          acc = fmaf(df, df, acc);
        }
      }
      const float l = fmaf(-0.5f, acc, s_w[r]);
      if (l > mx) {
        sm = fmaf(sm, __expf(mx - l), 1.f);
        mx = l;
      } else {
        sm += __expf(l - mx);
      }
    }
  }
  if (i < M) {
    const int64_t o = (int64_t)blockIdx.y * M + i;
    pmax[o] = mx;
    psum[o] = sm;
  }
}

__global__ void __launch_bounds__(BLOCK)
kde_merge_kernel(const float* __restrict__ pmax,
                 const float* __restrict__ psum, int M, int S,
                 const float* __restrict__ log_norm,
                 float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= M) return;
  float mx = NEG_BIG;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, pmax[(int64_t)s * M + i]);
  float tot = 0.f;
  for (int s = 0; s < S; ++s) {
    const int64_t o = (int64_t)s * M + i;
    tot = fmaf(psum[o], expf(pmax[o] - mx), tot);
  }
  out[i] = mx + logf(tot) + log_norm[0];
}

template <int D, bool FIXED>
static void launch_partial(dim3 grid, cudaStream_t st, const float* zx,
                           const float* zs, const float* lw, int M, int N,
                           int d, int chunk, float* pmax, float* psum) {
  kde_partial_kernel<D, FIXED><<<grid, BLOCK, 0, st>>>(zx, zs, lw, M, N, d,
                                                       chunk, pmax, psum);
}

extern "C" {

// Launch the partial and merge kernels on `stream`.  Returns 0 or the
// first CUDA error code; the launches are asynchronous.
int kde_logpdf_launch(const float* zx, const float* zs, const float* lw,
                      const float* log_norm, int M, int N, int d, int chunk,
                      int S, float* pmax, float* psum, float* out,
                      void* stream) {
  if (M <= 0) return 0;
  if (N <= 0 || d < 1 || d > MAX_D || chunk <= 0 || S <= 0 ||
      (int64_t)S * chunk < N || S > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)((M + BLOCK - 1) / BLOCK), (unsigned)S);
  switch (d) {
    case 1: launch_partial<1, true>(grid, st, zx, zs, lw, M, N, d, chunk, pmax, psum); break;
    case 2: launch_partial<2, true>(grid, st, zx, zs, lw, M, N, d, chunk, pmax, psum); break;
    case 3: launch_partial<3, true>(grid, st, zx, zs, lw, M, N, d, chunk, pmax, psum); break;
    case 4: launch_partial<4, true>(grid, st, zx, zs, lw, M, N, d, chunk, pmax, psum); break;
    case 5: launch_partial<5, true>(grid, st, zx, zs, lw, M, N, d, chunk, pmax, psum); break;
    case 6: launch_partial<6, true>(grid, st, zx, zs, lw, M, N, d, chunk, pmax, psum); break;
    case 7: launch_partial<7, true>(grid, st, zx, zs, lw, M, N, d, chunk, pmax, psum); break;
    case 8: launch_partial<8, true>(grid, st, zx, zs, lw, M, N, d, chunk, pmax, psum); break;
    default: launch_partial<MAX_D, false>(grid, st, zx, zs, lw, M, N, d, chunk, pmax, psum); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kde_merge_kernel<<<(unsigned)((M + BLOCK - 1) / BLOCK), BLOCK, 0, st>>>(
      pmax, psum, M, S, log_norm, out);
  return (int)cudaGetLastError();
}

const char* kde_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
