// Time-line block-Jacobi applies with a Chebyshev epilogue, batched over
// (sample, spatial line):
//
//   K2  t = B^-1 r       B^-1 stored f32, or bf16 ('bf16' mode)
//   K3  t = W (W^T r)    W = L^-T stored bf16, B^-1 = W W^T
//                        ('bf16_factored' mode; L the Cholesky factor of B)
//
// Replace the block half of the TPU kernel
// mech_nn_discovery_pde_tpu/ops/fused_smoother.py `_fused_chebyshev_kernel`
// (launched by `_fused_single`): K2 its `_emit_block_apply`, K3 its
// `_emit_factored_block_apply`.
//
// Operands:
//   binv / w (bs, S, bw, bw)   row-major block (inverse, or factor W),
//                              bw = nt * m, block row i = ti * m + mi
//   r    (bs, N, m)      f32   flat point-major vector, N = nt * S; line s,
//                              block row i lives at ((ti * S + s) * m + mi)
//   d    (bs, N, m)      f32   updated in place: d = c1[b] d + c2[b] t
//   c1, c2 (bs,)         f32   per-sample Chebyshev coefficients; c1 ==
//                              nullptr reads as 0 (d is then not read, so it
//                              may hold garbage), c2 == nullptr as 1
//
// r is read straight from the flat vector through the line index map (the
// JAX package's line_vec_to_blocks), with no gather copy.  A bf16 block
// entry is widened to f32 in-register as it is loaded; every sum is f32,
// and K3 keeps u = W^T r in f32 (the TPU kernel's `us`).
//
// One block per (line, sample).  The block stages the line's bw values of r
// in shared memory.  K2 then lets each warp take rows of B^-1, its lanes
// striding the row (coalesced), and reduces with shuffles.  K3 first stages
// the whole bw x bw bf16 W (6.1 KiB at bw = 56) in shared memory with
// 16-byte loads, so W is read from device memory once for both passes;
// pass 1 (u = W^T r) gives each thread one column and a share of its rows,
// pass 2 (t = W u) is K2's warp-per-row product.
//
// Bound on an H100: bytes.  The block is bw*bw*sizeof(entry) bytes per line
// (12.25 MiB per GL fine-level sample in f32, 6.1 MiB as bf16 W) and each
// entry is used once (K3: twice, from shared memory) per apply, at 2 (K3: 4)
// flops per entry.  W is upper-triangular; skipping its zero half, tensor
// cores and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// rl[j] = r at block row j of line s (the line index map)
__device__ __forceinline__ void stage_line(float* rl, const float* rb, int s,
                                           int m, int nt, int S) {
  const int bw = nt * m;
  for (int j = threadIdx.x; j < bw; j += blockDim.x) {
    const int tj = j / m, mj = j % m;
    rl[j] = rb[((size_t)tj * S + s) * m + mj];
  }
}

// t = M v for the row-major bw x bw block M (global or shared memory), one
// warp per row, then the Chebyshev epilogue into d
template <typename TB>
__device__ __forceinline__ void rows_times(const TB* M, const float* v, float* d,
                                           const float* c1, const float* c2,
                                           size_t b, int s, int m, int nt, int S) {
  const int bw = nt * m;
  const size_t N = (size_t)nt * S;
  const float a1 = c1 ? c1[b] : 0.f;
  const float a2 = c2 ? c2[b] : 1.f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < bw; i += nwarps) {
    const TB* row = M + (size_t)i * bw;
    float acc = 0.f;
    for (int j = lane; j < bw; j += 32) acc += widen(row[j]) * v[j];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const int ti = i / m, mi = i % m;
      const size_t o = (b * N + (size_t)ti * S + s) * m + mi;
      float t = a2 * acc;
      if (c1) t += a1 * d[o];
      d[o] = t;
    }
  }
}

template <typename TB>
__global__ void k2_line_block_apply(const TB* binv, const float* r, float* d,
                                    const float* c1, const float* c2, int m,
                                    int nt, int S) {
  extern __shared__ float rl[];
  const int bw = nt * m;
  const int s = blockIdx.x;
  const size_t b = blockIdx.y;
  stage_line(rl, r + b * (size_t)nt * S * m, s, m, nt, S);
  __syncthreads();
  rows_times(binv + (b * S + s) * (size_t)bw * bw, rl, d, c1, c2, b, s, m, nt, S);
}

// K3's shared memory: W (bw*bw bf16, padded to 16 bytes), then f32 r (bw),
// u (bw) and the pass-1 partial sums (groups * bw)
__host__ __device__ inline int k3_groups(int bw) {
  return bw < kThreads ? kThreads / bw : 1;
}
__host__ __device__ inline size_t k3_w_bytes(int bw) {
  return ((size_t)bw * bw * sizeof(__nv_bfloat16) + 15) / 16 * 16;
}
__host__ __device__ inline size_t k3_smem_bytes(int bw) {
  return k3_w_bytes(bw) + sizeof(float) * (size_t)bw * (2 + k3_groups(bw));
}

__global__ void k3_factored_line_block_apply(const __nv_bfloat16* w, const float* r,
                                             float* d, const float* c1,
                                             const float* c2, int m, int nt, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bw = nt * m;
  const int nw = bw * bw;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);
  float* rl = reinterpret_cast<float*>(smem + k3_w_bytes(bw));
  float* u = rl + bw;
  float* part = u + bw;
  const int s = blockIdx.x;
  const size_t b = blockIdx.y;

  const __nv_bfloat16* Wg = w + (b * S + s) * (size_t)nw;
  if (nw % 8 == 0 && (reinterpret_cast<uintptr_t>(Wg) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(Wg);
    uint4* dst = reinterpret_cast<uint4*>(Ws);
    for (int i = threadIdx.x; i < nw / 8; i += blockDim.x) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < nw; i += blockDim.x) Ws[i] = Wg[i];
  }
  stage_line(rl, r + b * (size_t)nt * S * m, s, m, nt, S);
  __syncthreads();

  // pass 1: u_j = sum_i W[i, j] r_i, rows split over G groups of bw threads
  const int G = k3_groups(bw);
  for (int idx = threadIdx.x; idx < G * bw; idx += blockDim.x) {
    const int j = idx % bw, g = idx / bw;
    float acc = 0.f;
    for (int i = g; i < bw; i += G) acc += __bfloat162float(Ws[i * bw + j]) * rl[i];
    part[idx] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < bw; j += blockDim.x) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += part[g * bw + j];
    u[j] = acc;
  }
  __syncthreads();

  // pass 2: t = W u, then the epilogue
  rows_times(Ws, u, d, c1, c2, b, s, m, nt, S);
}

bool bad_shape(int m, int nt, int S, int bs) {
  return m < 1 || nt < 1 || S < 1 || bs < 1;
}

template <typename TB>
int k2_launch(const TB* binv, const float* r, float* d, const float* c1,
              const float* c2, int m, int nt, int S, int bs, void* stream) {
  if (bad_shape(m, nt, S, bs)) return (int)cudaErrorInvalidValue;
  dim3 grid(S, bs);
  k2_line_block_apply<TB><<<grid, kThreads, sizeof(float) * nt * m, (cudaStream_t)stream>>>(
      binv, r, d, c1, c2, m, nt, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int k2_line_block_apply_f32(const float* binv, const float* r, float* d,
                            const float* c1, const float* c2, int m, int nt,
                            int S, int bs, void* stream) {
  return k2_launch<float>(binv, r, d, c1, c2, m, nt, S, bs, stream);
}

// bf16 B^-1, f32 vectors
int k2_line_block_apply_bf16(const __nv_bfloat16* binv, const float* r, float* d,
                             const float* c1, const float* c2, int m, int nt,
                             int S, int bs, void* stream) {
  return k2_launch<__nv_bfloat16>(binv, r, d, c1, c2, m, nt, S, bs, stream);
}

// bf16 W, f32 vectors
int k3_factored_line_block_apply_bf16(const __nv_bfloat16* w, const float* r,
                                      float* d, const float* c1, const float* c2,
                                      int m, int nt, int S, int bs, void* stream) {
  if (bad_shape(m, nt, S, bs)) return (int)cudaErrorInvalidValue;
  const size_t smem = k3_smem_bytes(nt * m);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k3_factored_line_block_apply,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(S, bs);
  k3_factored_line_block_apply<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      w, r, d, c1, c2, m, nt, S);
  return (int)cudaGetLastError();
}

const char* k2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
