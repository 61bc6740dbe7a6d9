// K1: block-stencil normal-operator apply y = (A^T A) x, batched over samples.
//
// Replaces the TPU kernel mech_nn_discovery_pde_tpu/ops/normal_stencil.py
// `_stencil_kernel_body` (launched by `_pallas_single`), and the batched
// variant in benchmarks/pallas_grid_batched.py (`pallas_apply_batched`).
//
// Operands (one sample b of bs):
//   coef  (bs, NC, N)   channel-major assembled stencil: channels 0..m*m-1
//                       hold the dense offset-0 block (row-major), channel
//                       bands[k].ch holds band k's coefficient field g_k
//   x     (bs, N, m)    flat point-major solver vector (index p*m + c)
//   bands (nb, 4) int   per band: coefficient channel, flat stride s,
//                       channel ci at p, channel cj at p+s
//
// Gather form (no atomics): the thread of grid point p computes all m
// outputs of p,
//   y[c] = sum_j D[c,j](p) x[p,j]
//        + sum_{bands with ci == c} g(p)   x[p+s, cj]   (p + s < N)
//        + sum_{bands with cj == c} g(p-s) x[p-s, ci]   (p >= s)
// The assembled band coefficients are zero wherever p+s crosses an axis
// edge, which makes this exact on the C-order flat grid.
//
// Epilogue (one launch per Chebyshev step's stencil half):
//   out = rin - y   if rin != nullptr, else out = y
//   xout = xin + x  if xout != nullptr (xin == nullptr reads as zero)
// out may alias rin and xout may alias xin (each thread reads and writes
// only its own point there); neither may alias x, which is read at
// neighbouring points.
//
// Stored-operand types (the JAX package's mg_precond_dtype): coef is f32 or
// f64 with vectors of the same type, or bf16 with f32 vectors ('bf16'
// mode).  A bf16 coefficient is widened to f32 in-register as it is loaded,
// and every sum is taken in the vector type, as the TPU kernel upcasts its
// stored operands (fused_smoother.py `_fused_chebyshev_kernel`).
//
// Bound on an H100: bytes.  Per apply it must read coef (NC*N values) and x
// and write y, (NC*sizeof(coef) + 2*m*sizeof(x))*N bytes per sample, at
// ~2*(m*m + 2*nb) flops per point: far below the card's flop/byte ratio.
// The design reads each coefficient at p coalesced across threads
// (channel-major layout); the backward terms re-read coef at p - s, which a
// neighbouring block has just brought into L2.  Tiling for speed is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// TC: stored coefficient type; T: vector and accumulation type
template <typename TC, typename T>
__global__ void k1_stencil_apply(const TC* coef, const T* x, const int* bands,
                                 int nb, int m, int N, int NC, const T* rin,
                                 T* out, const T* xin, T* xout) {
  extern __shared__ int sb[];
  for (int i = threadIdx.x; i < 4 * nb; i += blockDim.x) sb[i] = bands[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const size_t b = blockIdx.y;
  const TC* cb = coef + b * (size_t)NC * N;
  const T* xb = x + b * (size_t)N * m;

  T xp[kMaxM];
  T y[kMaxM];
  for (int j = 0; j < m; ++j) xp[j] = xb[(size_t)p * m + j];
  for (int i = 0; i < m; ++i) {
    T acc = T(0);
    for (int j = 0; j < m; ++j) acc += T(widen(cb[(size_t)(i * m + j) * N + p])) * xp[j];
    y[i] = acc;
  }
  for (int k = 0; k < nb; ++k) {
    const int ch = sb[4 * k], s = sb[4 * k + 1];
    const int ci = sb[4 * k + 2], cj = sb[4 * k + 3];
    const TC* g = cb + (size_t)ch * N;
    if (p + s < N) y[ci] += T(widen(g[p])) * xb[(size_t)(p + s) * m + cj];
    if (p >= s) y[cj] += T(widen(g[p - s])) * xb[(size_t)(p - s) * m + ci];
  }

  const size_t o = (b * (size_t)N + p) * m;
  for (int i = 0; i < m; ++i) {
    out[o + i] = rin ? rin[o + i] - y[i] : y[i];
    if (xout) xout[o + i] = (xin ? xin[o + i] : T(0)) + xp[i];
  }
}

template <typename TC, typename T>
int launch(const TC* coef, const T* x, const int* bands, int nb, int m, int N,
           int NC, int bs, const T* rin, T* out, const T* xin, T* xout,
           cudaStream_t stream) {
  if (m > kMaxM || m < 1 || N < 1 || bs < 1 || nb < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kThreads - 1) / kThreads, bs);
  size_t smem = sizeof(int) * 4 * (size_t)(nb > 0 ? nb : 1);
  k1_stencil_apply<TC, T><<<grid, kThreads, smem, stream>>>(coef, x, bands, nb, m, N,
                                                           NC, rin, out, xin, xout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int k1_stencil_apply_f32(const float* coef, const float* x, const int* bands,
                         int nb, int m, int N, int NC, int bs, const float* rin,
                         float* out, const float* xin, float* xout,
                         void* stream) {
  return launch<float, float>(coef, x, bands, nb, m, N, NC, bs, rin, out, xin, xout,
                              (cudaStream_t)stream);
}

int k1_stencil_apply_f64(const double* coef, const double* x, const int* bands,
                         int nb, int m, int N, int NC, int bs, const double* rin,
                         double* out, const double* xin, double* xout,
                         void* stream) {
  return launch<double, double>(coef, x, bands, nb, m, N, NC, bs, rin, out, xin, xout,
                                (cudaStream_t)stream);
}

// bf16 coefficients, f32 vectors
int k1_stencil_apply_bf16(const __nv_bfloat16* coef, const float* x,
                          const int* bands, int nb, int m, int N, int NC, int bs,
                          const float* rin, float* out, const float* xin,
                          float* xout, void* stream) {
  return launch<__nv_bfloat16, float>(coef, x, bands, nb, m, N, NC, bs, rin, out, xin,
                                      xout, (cudaStream_t)stream);
}

const char* k1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
