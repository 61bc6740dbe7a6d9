// Point-block applies with a Chebyshev epilogue: the time-line block
// kernels K2 and K3 of line_block.cu at nt = 1, where a block is the
// n_mi x n_mi diagonal block of one grid point (mg_block_smoother='point'):
//
//   K2  t = B^-1 r       B^-1 stored f32, or bf16 ('bf16' mode)
//   K3  t = W (W^T r)    W = L^-T stored bf16, B^-1 = W W^T
//                        ('bf16_factored' mode)
//
// Replace the block half of the TPU kernel
// mech_nn_discovery_pde_tpu/ops/fused_smoother.py `_fused_chebyshev_kernel`
// (launched by `_fused_single`) at point blocks: K2 its `_emit_block_apply`
// (:87-101), K3 its `_emit_factored_block_apply` (:104-125).
//
// Operands (nt = 1: item k = (sample b, point s), k = b * S + s):
//   binv / w (bs, S, bw, bw)   row-major block per item; W upper-triangular
//                              (K3 reads only its upper triangle)
//   r    (bs, S, bw)     f32   item k's line is r[k * bw : (k + 1) * bw]
//   d    (bs, S, bw)     f32   updated in place: d = c1[b] d + c2[b] t
//   c1, c2 (bs,)         f32   per-sample coefficients; c1 == nullptr reads
//                              as 0 (d is then not read), c2 == nullptr as 1
// bw is a template parameter: 2, 3, 4, 5 or 7, the n_mi of VariableSet's six
// layouts (ops/fused_smoother.POINT_WIDTHS).
//
// Bound on an H100: bytes.  At the GL fine level (bs 32, S 8192, bw 7) the
// blocks are 51.4 MB in f32 (25.7 MB in bf16) and r and d 7.3 MB each, for
// 2 bw^2 flops per item (K3: 4 bw^2 on the dense count): 0.44 flop per byte,
// against a ridge of 20 for the f32 units.  Bound 0.0197 ms (f32), 0.0120
// ms (bf16, K3).
//
// Why not line_block.cu's streamed kernel.  It moves one block per ring
// stage with one thread per block row: at bw 7 that is 7 working threads of
// 32, a 196-byte block that the bulk copy cannot take (not a multiple of 16
// bytes), and a full- and an empty-barrier round trip per 196 bytes.  It ran
// at 6 % of its bound there.
//
// Design.  At nt = 1 the items are contiguous in the blocks, in r and in d,
// so a run of P consecutive items is one contiguous span of each: the apply
// is a flat batch of small matvecs, tiled by P items.
//   - Stages hold tiles.  A ring stage holds P * bw^2 block entries and P bw
//     floats of r; P is a multiple of 32 (ops/fused_smoother.
//     point_block_geometry: 32 at bw 5 and 7, 64 at bw 3 and 4, 128 at bw
//     2), so each full tile's two spans are multiples of 16 bytes at 16-byte
//     offsets, and the producer warp's lane 0 moves each with one 1-D bulk
//     copy (cp.async.bulk ... complete_tx) completing on the stage's `full`
//     mbarrier: 6,272 + 896 B per stage at bw 7 in f32.  The last, partial
//     tile, and every tile of a launch whose operands are not 16-byte
//     aligned, takes the in-kernel load path: the producer lanes copy it
//     with plain loads, and lane 0 arrives on `full` after a __syncwarp.
//   - Persistent CTAs walk the tiles c, c + grid, c + 2 grid, ...: 4 CTAs
//     per SM with enough stages that at least 64 KB of blocks are in flight
//     per SM while each CTA computes on one tile (4 stages in f32 at bw 7,
//     7 in bf16; at most 8).
//   - Consumers: one thread per block row of the tile, P bw threads (224 at
//     bw 7: 7 full warps), every one of them working.  Thread q computes row
//     q % bw of item q / bw, sums in f32, and writes d at q's place in the
//     tile, so the warps' reads and writes of d are contiguous, and the
//     thread that reads d(o) is the one that writes it (in-place d is race
//     free).  Each thread prefetches its d entry and c1, c2 before it waits
//     on `full`; once the warp has read the stage (__syncwarp), its lane 0
//     arrives on `empty`: one arrival a warp, on either barrier.
//   - K3: pass 1 u_j = sum_{i<=j} W[i,j] r_i (thread (item, j)), u kept in
//     f32 in shared memory (double-buffered across tiles), one named barrier
//     over the consumer warps (bar.sync 1; the producer keeps loading), pass
//     2 t_i = sum_{j>=i} W[i,j] u_j (thread (item, i)).  W is read only in
//     its upper triangle, by predicated loads (`lds_bf16_if`): every thread
//     runs bw steps of each pass with no branch, the steps outside the
//     triangle reading nothing and adding 0, where a branch a step would
//     split each warp (its lanes hold different rows) bw times a pass.  The
//     copy still moves the zeros, so the bound is unchanged.
//
// Shared-memory banks.  Thread q reads its block row at words q bw + c.  At
// an odd bw in f32 the 32 threads of a warp fall in 32 distinct banks; at bw
// 2 and 4 the rows wrap the 32 banks every 32 / bw threads, so thread q
// starts at column (q bw / 32) mod bw and wraps, which makes each step
// conflict-free.  In bf16 a warp's 32 rows span 16 bw words, and a step is
// at most 2-way (the same skew at bw 2 and 4; none at odd bw).  r and u are
// read at an item's words, broadcast within the item.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, on the H100
// machine; chip_smoke.py checks the stack and spills of all 15
// instantiations): 40 registers (48 at bw 2 and 4; K3 48, 40 at bw 2), no
// stack, no spills, no static shared memory; __launch_bounds__(288, 4)
// leaves room for 4 CTAs an SM.  The dynamic shared memory is the
// geometry's (GL fine level: 28,736 B for K2 f32, 28,336 B for K2 bf16,
// 30,128 B for K3 per CTA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the largest tile in block rows (consumer threads), and the CTAs per SM the
// geometry plans for (ops/fused_smoother.py mirrors both)
constexpr int kMaxConsumers = 256;
constexpr int kCtasPerSm = 4;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- shared-memory layout (ops/fused_smoother.point_block_smem_bytes mirrors it)
//   [full mbarriers: stages x 8 B][empty mbarriers: stages x 8 B]
//   [u: 2 x P bw f32, K3 only, padded to 16 B]
//   stages x [blocks: P bw^2 entries, padded to 16 B][r: P bw f32, padded to 16 B]
__host__ __device__ inline size_t pad16(size_t n) { return (n + 15) / 16 * 16; }

struct Layout {
  size_t blk_bytes, blk_pad, r_bytes, stage_bytes, u_off, stage_off, total;
};

__host__ __device__ inline Layout make_layout(int bw, int tile, int stages, int esize,
                                              bool factored) {
  Layout L;
  L.blk_bytes = (size_t)tile * bw * bw * esize;
  L.blk_pad = pad16(L.blk_bytes);
  L.r_bytes = sizeof(float) * (size_t)tile * bw;
  L.stage_bytes = L.blk_pad + pad16(L.r_bytes);
  L.u_off = 16 * (size_t)stages;
  L.stage_off = L.u_off + (factored ? pad16(2 * L.r_bytes) : 0);
  L.total = L.stage_off + (size_t)stages * L.stage_bytes;
  return L;
}

// ---- mbarrier and bulk-copy primitives (sm_90), as in line_block.cu
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 state;\n\tmbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned),
// completing its bytes on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a bf16 from shared memory as f32 where `pred`, else 0 without reading:
// one predicated load, no branch
__device__ __forceinline__ float lds_bf16_if(const __nv_bfloat16* p, bool pred) {
  unsigned short v = 0;
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q ld.shared.u16 %0, [%1];\n\t}"
      : "+h"(v)
      : "r"(smem_addr(p)), "r"((int)pred));
  return __uint_as_float((uint32_t)v << 16);
}

// named barrier 1 over the consumer warps
__device__ __forceinline__ void consumers_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// warp 0: fill the ring with this CTA's tiles, `stages` ahead of the consumers
template <typename TB, int BW>
__device__ __forceinline__ void produce(uint64_t* full, uint64_t* empty, unsigned char* stage0,
                                        const Layout& L, const TB* __restrict__ blocks,
                                        const float* __restrict__ r, int items, int tile,
                                        int stages, bool bulk) {
  const int lane = threadIdx.x;
  const int tiles = (items + tile - 1) / tile;
  int stage = 0;
  uint32_t round = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
    unsigned char* st = stage0 + (size_t)stage * L.stage_bytes;
    TB* blk = reinterpret_cast<TB*>(st);
    float* rt = reinterpret_cast<float*>(st + L.blk_pad);
    const size_t i0 = (size_t)t * tile;
    const int n = min(tile, items - (int)i0);  // items in this tile
    const TB* bsrc = blocks + i0 * BW * BW;
    const float* rsrc = r + i0 * BW;
    if (bulk && n == tile) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], (uint32_t)(L.blk_bytes + L.r_bytes));
        bulk_g2s(blk, bsrc, (uint32_t)L.blk_bytes, &full[stage]);
        bulk_g2s(rt, rsrc, (uint32_t)L.r_bytes, &full[stage]);
      }
    } else {
#pragma unroll 4
      for (int e = lane; e < n * BW * BW; e += 32) blk[e] = bsrc[e];
      for (int e = lane; e < n * BW; e += 32) rt[e] = rsrc[e];
      __syncwarp();  // orders every lane's stores before lane 0's release
      if (lane == 0) mbar_arrive(&full[stage]);
    }
    if (++stage == stages) {
      stage = 0;
      ++round;
    }
  }
}

// thread q's first column: the wrap count of its row over the 32 banks at an
// even bw (see the bank note); 0 at an odd one
template <typename TB, int BW>
__device__ __forceinline__ int row_skew(int q) {
  if constexpr (BW % 2 == 0)
    return (q * BW * (int)sizeof(TB) / 128) % BW;
  else
    return 0;
}

// K2 (FACTORED false: B^-1 in TB) or K3 (true: W in bf16) on the point
// blocks: the body of both kernels
template <typename TB, int BW, bool FACTORED>
__device__ __forceinline__ void point_block_body(const TB* __restrict__ blocks,
                                                 const float* __restrict__ r, float* d,
                                                 const float* c1, const float* c2, int S,
                                                 int items, int tile, int stages, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(BW, tile, stages, sizeof(TB), FACTORED);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  unsigned char* stage0 = smem + L.stage_off;
  const int consumers = blockDim.x - 32;
  if (threadIdx.x == 0) {
    // one arrival a warp: the producer's lane 0 (with the bulk copies' bytes)
    // on `full`, each consumer warp's lane 0 on `empty`
    for (int k = 0; k < stages; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    produce<TB, BW>(full, empty, stage0, L, blocks, r, items, tile, stages, bulk != 0);
    return;
  }
  const int q = threadIdx.x - 32;  // block row q % BW of the tile's item q / BW
  const int li = q / BW;
  const int row = q - li * BW;
  const int skew = row_skew<TB, BW>(q);
  const int tiles = (items + tile - 1) / tile;
  float* u2 = reinterpret_cast<float*>(smem + L.u_off);
  int stage = 0;
  uint32_t round = 0;
  int k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const int item = t * tile + li;
    const bool live = item < items;
    const size_t o = (size_t)t * tile * BW + q;  // d's entry: row `row` of `item`
    float a1 = 0.f, a2 = 1.f, dold = 0.f;
    if (live) {
      const int b = item / S;
      if (c1) {
        a1 = c1[b];
        dold = d[o];
      }
      if (c2) a2 = c2[b];
    }
    mbar_wait(&full[stage], round & 1);
    const unsigned char* st = stage0 + (size_t)stage * L.stage_bytes;
    const TB* blk = reinterpret_cast<const TB*>(st);
    const float* rv = reinterpret_cast<const float*>(st + L.blk_pad) + li * BW;
    const TB* brow = blk + (size_t)q * BW;  // row `row` of item li
    float acc = 0.f;
    if constexpr (FACTORED) {
      // u alternates between two buffers: the named barrier of tile k + 1
      // orders every pass-2 read of tile k before tile k + 2's pass-1 writes
      float* u = u2 + (k & 1) * tile * BW;
      // Both passes run BW steps in every thread with no branch: a step
      // outside the upper triangle is a predicated-off load that leaves 0
      // (`lds_bf16_if`), and adds 0.
      // pass 1: u_j = sum_{i <= j} W[i, j] r_i, j = row (column j of the block)
      const TB* wcol = blk + (size_t)li * BW * BW + row;
      float uj = 0.f;
#pragma unroll
      for (int i = 0; i < BW; ++i) uj = fmaf(lds_bf16_if(wcol + i * BW, i <= row), rv[i], uj);
      u[q] = uj;
      consumers_sync(consumers);
      // pass 2: t_i = sum_{j >= i} W[i, j] u_j, i = row
      const float* uv = u + li * BW;
#pragma unroll
      for (int c = 0; c < BW; ++c) {
        int j = c + skew;
        if (j >= BW) j -= BW;
        acc = fmaf(lds_bf16_if(brow + j, j >= row), uv[j], acc);
      }
    } else {
#pragma unroll
      for (int c = 0; c < BW; ++c) {
        int j = c + skew;
        if (j >= BW) j -= BW;
        acc = fmaf(widen(brow[j]), rv[j], acc);
      }
    }
    __syncwarp();  // orders the warp's reads of the stage before its release
    if ((q & 31) == 0) mbar_arrive(&empty[stage]);
    if (live) {
      float v = a2 * acc;
      if (c1) v += a1 * dold;
      d[o] = v;
    }
    if (++stage == stages) {
      stage = 0;
      ++round;
    }
  }
}

template <typename TB, int BW>
__global__ void __launch_bounds__(32 + kMaxConsumers, kCtasPerSm)
    k2_point_block_apply(const TB* __restrict__ binv, const float* __restrict__ r, float* d,
                         const float* c1, const float* c2, int S, int items, int tile,
                         int stages, int bulk) {
  point_block_body<TB, BW, false>(binv, r, d, c1, c2, S, items, tile, stages, bulk);
}

template <int BW>
__global__ void __launch_bounds__(32 + kMaxConsumers, kCtasPerSm)
    k3_point_block_apply(const __nv_bfloat16* __restrict__ w, const float* __restrict__ r,
                         float* d, const float* c1, const float* c2, int S, int items, int tile,
                         int stages, int bulk) {
  point_block_body<__nv_bfloat16, BW, true>(w, r, d, c1, c2, S, items, tile, stages, bulk);
}

// Check the launch geometry against the shapes and the layout; returns a
// CUDA error code (0 if the launch may go ahead)
int check_launch(const void* blocks, const float* r, int bw, int S, int bs, int ctas, int tile,
                 int stages, int smem_bytes, int bulk, int esize, bool factored) {
  if (S < 1 || bs < 1 || ctas < 1 || stages < 1 || tile < 32 || tile % 32)
    return (int)cudaErrorInvalidValue;
  if ((long long)bs * S + tile > 0x7fffffff) return (int)cudaErrorInvalidValue;  // int items
  if (tile * bw > kMaxConsumers) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(bw, tile, stages, esize, factored);
  if ((size_t)smem_bytes != L.total) return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(blocks) | reinterpret_cast<uintptr_t>(r)) & 15) == 0;
  if (bulk && (L.blk_bytes % 16 != 0 || L.r_bytes % 16 != 0 || !aligned))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// raise the kernel's dynamic shared-memory limit when the launch needs more
// than the default 48 KiB (once per size and kernel), then launch it
template <typename K, typename... Args>
int launch(K kernel, int* allowed, int ctas, int threads, int smem_bytes, void* stream,
           Args... args) {
  if (smem_bytes > 48 * 1024 && smem_bytes > *allowed) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    *allowed = smem_bytes;
  }
  kernel<<<ctas, threads, smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename TB, int BW, bool FACTORED>
int launch_bw(const TB* blocks, const float* r, float* d, const float* c1, const float* c2,
              int S, int bs, int ctas, int tile, int stages, int smem_bytes, int bulk,
              void* stream) {
  static int allowed = 0;
  const int threads = 32 + tile * BW;
  if constexpr (FACTORED)
    return launch(k3_point_block_apply<BW>, &allowed, ctas, threads, smem_bytes, stream, blocks,
                  r, d, c1, c2, S, bs * S, tile, stages, bulk);
  else
    return launch(k2_point_block_apply<TB, BW>, &allowed, ctas, threads, smem_bytes, stream,
                  blocks, r, d, c1, c2, S, bs * S, tile, stages, bulk);
}

template <typename TB, bool FACTORED>
int point_block_launch(const TB* blocks, const float* r, float* d, const float* c1,
                       const float* c2, int bw, int S, int bs, int ctas, int tile, int stages,
                       int smem_bytes, int bulk, void* stream) {
  int code = check_launch(blocks, r, bw, S, bs, ctas, tile, stages, smem_bytes, bulk,
                          sizeof(TB), FACTORED);
  if (code) return code;
  switch (bw) {
    case 2:
      return launch_bw<TB, 2, FACTORED>(blocks, r, d, c1, c2, S, bs, ctas, tile, stages,
                                        smem_bytes, bulk, stream);
    case 3:
      return launch_bw<TB, 3, FACTORED>(blocks, r, d, c1, c2, S, bs, ctas, tile, stages,
                                        smem_bytes, bulk, stream);
    case 4:
      return launch_bw<TB, 4, FACTORED>(blocks, r, d, c1, c2, S, bs, ctas, tile, stages,
                                        smem_bytes, bulk, stream);
    case 5:
      return launch_bw<TB, 5, FACTORED>(blocks, r, d, c1, c2, S, bs, ctas, tile, stages,
                                        smem_bytes, bulk, stream);
    case 7:
      return launch_bw<TB, 7, FACTORED>(blocks, r, d, c1, c2, S, bs, ctas, tile, stages,
                                        smem_bytes, bulk, stream);
    default:
      return (int)cudaErrorInvalidValue;  // no instantiation at this width
  }
}

}  // namespace

extern "C" {

// bw: the block width (2, 3, 4, 5 or 7); S: items per sample; ctas, tile,
// stages, smem_bytes and bulk: the launch geometry of
// ops/fused_smoother.point_block_geometry
int k2_point_block_apply_f32(const float* binv, const float* r, float* d, const float* c1,
                             const float* c2, int bw, int S, int bs, int ctas, int tile,
                             int stages, int smem_bytes, int bulk, void* stream) {
  return point_block_launch<float, false>(binv, r, d, c1, c2, bw, S, bs, ctas, tile, stages,
                                          smem_bytes, bulk, stream);
}

// bf16 B^-1, f32 vectors
int k2_point_block_apply_bf16(const __nv_bfloat16* binv, const float* r, float* d,
                              const float* c1, const float* c2, int bw, int S, int bs, int ctas,
                              int tile, int stages, int smem_bytes, int bulk, void* stream) {
  return point_block_launch<__nv_bfloat16, false>(binv, r, d, c1, c2, bw, S, bs, ctas, tile,
                                                  stages, smem_bytes, bulk, stream);
}

// bf16 upper-triangular W, f32 vectors
int k3_point_block_apply_bf16(const __nv_bfloat16* w, const float* r, float* d, const float* c1,
                              const float* c2, int bw, int S, int bs, int ctas, int tile,
                              int stages, int smem_bytes, int bulk, void* stream) {
  return point_block_launch<__nv_bfloat16, true>(w, r, d, c1, c2, bw, S, bs, ctas, tile, stages,
                                                 smem_bytes, bulk, stream);
}

const char* point_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
