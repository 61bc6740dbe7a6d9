// K2: time-line block-Jacobi apply t = B^-1 r with a Chebyshev epilogue,
// batched over (sample, spatial line).
//
// Replaces the block half of the TPU kernel
// mech_nn_discovery_pde_tpu/ops/fused_smoother.py `_fused_chebyshev_kernel`
// (its `_emit_block_apply`, launched by `_fused_single`).
//
// Operands:
//   binv (bs, S, bw, bw) f32   row-major inverse of each time-line block,
//                              bw = nt * m, block row i = ti * m + mi
//   r    (bs, N, m)      f32   flat point-major vector, N = nt * S; line s,
//                              block row i lives at ((ti * S + s) * m + mi)
//   d    (bs, N, m)      f32   updated in place: d = c1[b] d + c2[b] B^-1 r
//   c1, c2 (bs,)         f32   per-sample Chebyshev coefficients; c1 ==
//                              nullptr reads as 0 (d is then not read, so it
//                              may hold garbage), c2 == nullptr as 1
//
// r is read straight from the flat vector through the line index map (the
// JAX package's line_vec_to_blocks), with no gather copy.
//
// One block per (line, sample).  The block stages the line's bw values of r
// in shared memory; each warp then takes rows of B^-1, its lanes striding
// the row (coalesced), and reduces with shuffles.
//
// Bound on an H100: bytes.  B^-1 is bw*bw*4 bytes per line (12.25 MiB per
// GL fine-level sample) and each value of it is used once per apply, at
// 2 flops per 4 bytes.  Shared-memory staging of a whole line and tensor
// cores are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void k2_line_block_apply(const float* binv, const float* r, float* d,
                                    const float* c1, const float* c2, int m,
                                    int nt, int S) {
  extern __shared__ float rl[];
  const int bw = nt * m;
  const int s = blockIdx.x;
  const size_t b = blockIdx.y;
  const size_t N = (size_t)nt * S;
  const float* rb = r + b * N * m;
  for (int j = threadIdx.x; j < bw; j += blockDim.x) {
    const int tj = j / m, mj = j % m;
    rl[j] = rb[((size_t)tj * S + s) * m + mj];
  }
  __syncthreads();

  const float* B = binv + (b * S + s) * (size_t)bw * bw;
  const float a1 = c1 ? c1[b] : 0.f;
  const float a2 = c2 ? c2[b] : 1.f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < bw; i += nwarps) {
    const float* row = B + (size_t)i * bw;
    float acc = 0.f;
    for (int j = lane; j < bw; j += 32) acc += row[j] * rl[j];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const int ti = i / m, mi = i % m;
      const size_t o = (b * N + (size_t)ti * S + s) * m + mi;
      float v = a2 * acc;
      if (c1) v += a1 * d[o];
      d[o] = v;
    }
  }
}

}  // namespace

extern "C" {

int k2_line_block_apply_f32(const float* binv, const float* r, float* d,
                            const float* c1, const float* c2, int m, int nt,
                            int S, int bs, void* stream) {
  if (m < 1 || nt < 1 || S < 1 || bs < 1) return (int)cudaErrorInvalidValue;
  const int bw = nt * m;
  dim3 grid(S, bs);
  k2_line_block_apply<<<grid, kThreads, sizeof(float) * bw, (cudaStream_t)stream>>>(
      binv, r, d, c1, c2, m, nt, S);
  return (int)cudaGetLastError();
}

const char* k2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
