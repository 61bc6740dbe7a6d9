// Time-line block-Jacobi applies with a Chebyshev epilogue, batched over
// (sample, spatial line):
//
//   K2  t = B^-1 r       B^-1 stored f32, or bf16 ('bf16' mode)
//   K3  t = W (W^T r)    W = L^-T stored bf16, B^-1 = W W^T
//                        ('bf16_factored' mode; L the Cholesky factor of B)
//
// Replace the block half of the TPU kernel
// mech_nn_discovery_pde_tpu/ops/fused_smoother.py `_fused_chebyshev_kernel`
// (launched by `_fused_single`): K2 its `_emit_block_apply` (:87-101), K3
// its `_emit_factored_block_apply` (:104-125).
//
// Operands:
//   binv / w (bs, S, bw, bw)   row-major block (inverse, or factor W),
//                              bw = nt * m, block row i = ti * m + mi;
//                              W must be upper-triangular (K3 reads only
//                              its upper triangle)
//   r    (bs, N, m)      f32   flat point-major vector, N = nt * S; line s,
//                              block row i lives at ((ti * S + s) * m + mi)
//   d    (bs, N, m)      f32   updated in place: d = c1[b] d + c2[b] t
//   c1, c2 (bs,)         f32   per-sample Chebyshev coefficients; c1 ==
//                              nullptr reads as 0 (d is then not read, so it
//                              may hold garbage), c2 == nullptr as 1
//
// Bound on an H100: bytes.  An item, one (sample, line), is a bw x bw block
// read once (12,544 B in f32 at the GL bw = 56, 6,272 B in bf16) and 2 bw
// floats of r and d, for 2 bw^2 flops (K3: 4 bw^2 on the dense count):
// 0.5 flop per byte in f32, against a ridge of 20 for the f32 units.  All
// that counts is keeping the memory busy, so the design has no tensor
// cores; it raises the bytes in flight and cuts the per-item overhead.
//
// Design.  Persistent CTAs: the grid is a few CTAs per SM (the launch
// geometry comes from ops/fused_smoother.line_block_geometry: 8 CTAs per SM
// with 2 stages each at the GL shapes), and CTA c walks the items c,
// c + grid, c + 2 grid, ...  Each CTA is one producer warp and
// ceil(bw / 32) consumer warps around a ring of `stages` stages in shared
// memory; a stage holds one block and its line of r.
//   - Producer (warp 0): waits for the stage to be released (its `empty`
//     mbarrier), gathers r's bw values through the line index map with
//     4-byte cp.async (tracked by the stage's `full` mbarrier through
//     cp.async.mbarrier.arrive.noinc), and has one lane start a 1-D bulk
//     copy (cp.async.bulk ... complete_tx) of the contiguous block that
//     completes on `full`.  It runs `stages` items ahead of the consumers,
//     so the next blocks load while one is computed on.  A block whose
//     bytes or address are not 16-byte aligned (bf16 at bw = 42: 3,528 B)
//     takes the in-kernel load path instead: the producer lanes copy it
//     with plain loads and each arrives on `full` after its stores.
//   - Consumers: one thread per block row (K2) or column/row (K3), sums in
//     f32 from shared memory, with no shuffles, 8 loads of each operand in
//     flight per step (`dot`).  Each thread prefetches its d entry and c1,
//     c2 before waiting on `full`, arrives on `empty` once it has read the
//     stage, and then writes its d entry; the thread that reads d(o) is the
//     one that writes it, so in-place d is race-free.
//   - K3 reads only W's upper triangle: pass 1 u_j = sum_{i<=j} W[i,j] r_i
//     (thread j, u kept in f32 as the TPU kernel's `us`, double-buffered
//     across items), one named barrier over the consumer warps (bar.sync 1,
//     never __syncthreads, so the producer keeps loading), pass 2
//     t_i = sum_{j>=i} W[i,j] u_j (thread i).  The stored W stays dense:
//     the copy still moves the zeros, so the bound is unchanged.
// A CTA computes one item at a time, and what limits it is its consumers'
// chain of shared-memory loads more than the bytes in flight: hence many
// small CTAs (8 per SM), two stages each, and the unrolled loads.
//
// Shared-memory banks.  A block row is bw words apart in f32; at bw = 56 that
// is 24 (mod 32), so a warp whose thread i reads column c of row i touches
// only 4 banks (8-way conflict).  K2's thread i instead starts at column i
// and wraps (c = (i + q) mod bw at step q): the word i*57 + q falls in bank
// 25 i + q (mod 32), distinct over a warp, and the threads whose column
// wrapped shift by 24 banks, so a step is at most 2-way (mean 1.55 for rows
// 0-31, 1.0 for rows 32-55; 1.74 / 1.0 at bw = 42).  In bf16 two entries
// share a word and the same skew gives 2-way.  K3's pass 1 reads a row of W
// across consecutive threads (conflict-free, r broadcast); pass 2's thread i
// reads W[i, i+q], which is skewed by construction (at most 2-way).  r and u
// are read at consecutive words.
//
// Row-tiled path (k2_line_block_apply_tiled, k3_factored_line_block_apply_tiled).
// A block larger than one CTA's shared memory (bw > 240 in f32, > 339 in
// bf16, > 337 for K3) streams through the same ring in panels of `rows`
// consecutive block rows (rows x bw entries; the last panel of a block may
// be shorter), with r's line resident in shared memory for the whole item
// (double-buffered by item, loaded with the item's first panel).  K2: the
// thread of panel row q computes block row p0 + q from each panel.  K3
// sweeps the panels twice: sweep 1 accumulates u = W^T r into a bw-float
// shared vector (thread q owns columns q, q + consumers, ...; a panel adds
// its rows i <= j to column j), one named barrier, then sweep 2 streams the
// panels again for t_i = sum_{j >= i} W[i, j] u_j (row p0 + q).  W is read
// twice there, each time only its upper triangle.  Producer and consumers
// walk the same sequence of panel loads, so the ring's stage and phase
// parity advance per panel across both sweeps; r's buffer for item k is
// rewritten only after the consumers released a panel of item k - 1, which
// the launch check guarantees (panel loads per item >= stages).  The
// geometry (rows, CTAs per SM, stages) comes from
// ops/fused_smoother.line_block_geometry; every block that fits one CTA
// takes the streamed path above, unchanged.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, CUDA 12.8 on the
// H100 machine; chip_smoke.py checks the stack and spills): 48 registers a
// thread for the three streamed kernels and 55-56 for the row-tiled ones, no
// spills, no static shared memory; the dynamic shared memory is the geometry's (GL
// shapes: 25,568 B for K2 f32, 13,024 B for K2 bf16, 13,472 B for K3 per
// CTA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- shared-memory layout (ops/fused_smoother.line_block_geometry mirrors it)
//   [full mbarriers: stages x 8 B][empty mbarriers: stages x 8 B]
//   [u: 2 bw f32, K3 only, padded to 16 B]
//   stages x [block: bw*bw entries, padded to 16 B][r: bw f32, padded to 16 B]
__host__ __device__ inline size_t pad16(size_t n) { return (n + 15) / 16 * 16; }

struct Layout {
  size_t block_bytes, block_pad, stage_bytes, u_off, stage_off, total;
};

__host__ __device__ inline Layout make_layout(int bw, int stages, int esize, bool factored) {
  Layout L;
  L.block_bytes = (size_t)bw * bw * esize;
  L.block_pad = pad16(L.block_bytes);
  L.stage_bytes = L.block_pad + pad16(sizeof(float) * (size_t)bw);
  L.u_off = 16 * (size_t)stages;
  L.stage_off = L.u_off + (factored ? pad16(2 * sizeof(float) * (size_t)bw) : 0);
  L.total = L.stage_off + (size_t)stages * L.stage_bytes;
  return L;
}

// ---- the row-tiled path's layout (line_block_smem_bytes with `rows` mirrors it)
//   [full mbarriers: stages x 8 B][empty mbarriers: stages x 8 B]
//   [u: 2 bw f32, K3 only, padded to 16 B][r: 2 bw f32, padded to 16 B]
//   stages x [panel: rows*bw entries, padded to 16 B]
struct TiledLayout {
  size_t stage_bytes, u_off, r_off, stage_off, total;
};

__host__ __device__ inline TiledLayout make_tiled_layout(int bw, int rows, int stages, int esize,
                                                         bool factored) {
  TiledLayout L;
  L.stage_bytes = pad16((size_t)rows * bw * esize);
  L.u_off = 16 * (size_t)stages;
  L.r_off = L.u_off + (factored ? pad16(2 * sizeof(float) * (size_t)bw) : 0);
  L.stage_off = L.r_off + pad16(2 * sizeof(float) * (size_t)bw);
  L.total = L.stage_off + (size_t)stages * L.stage_bytes;
  return L;
}

// ---- mbarrier, cp.async and bulk-copy primitives (sm_90)
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

// 4-byte asynchronous global -> shared copy; completion is tracked by
// cp_async_arrive_noinc on a stage's `full` barrier
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 8- and 16-byte asynchronous global -> shared copies (the row-tiled
// producer's in-kernel load path)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
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

// named barrier 1 over the consumer warps
__device__ __forceinline__ void consumers_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// the ring of either path: its barriers, its first stage and the layout
// (Layout or TiledLayout) that sizes a stage
template <typename LayoutT>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* stage0;
  LayoutT L;
  int stages;
};

// thread 0 initialises the barriers; every thread returns the ring
template <typename LayoutT>
__device__ __forceinline__ Ring<LayoutT> ring_setup(unsigned char* smem, const LayoutT& L,
                                                    int stages, int consumers, bool bulk) {
  Ring<LayoutT> g{reinterpret_cast<uint64_t*>(smem), reinterpret_cast<uint64_t*>(smem) + stages,
                  smem + L.stage_off, L, stages};
  if (threadIdx.x == 0) {
    // full: 32 cp.async arrivals for r (the row-tiled path's later panels:
    // 32 plain arrivals), plus the bulk copy's expect_tx arrival (one lane)
    // or every producer lane's arrival after its stores
    for (int k = 0; k < stages; ++k) {
      mbar_init(&g.full[k], 32 + (bulk ? 1 : 32));
      mbar_init(&g.empty[k], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  return g;
}

// warp 0: fill the ring with this CTA's items, `stages` ahead of the consumers
template <typename TB>
__device__ __forceinline__ void produce(const Ring<Layout>& g, const TB* __restrict__ blocks,
                                        const float* __restrict__ r, int m, int nt, int S,
                                        int items, bool bulk) {
  const int lane = threadIdx.x;
  const int bw = nt * m;
  const int nw = bw * bw;
  int stage = 0;
  uint32_t round = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    if (round > 0) mbar_wait(&g.empty[stage], (round - 1) & 1);
    unsigned char* st = g.stage0 + (size_t)stage * g.L.stage_bytes;
    TB* blk = reinterpret_cast<TB*>(st);
    float* rl = reinterpret_cast<float*>(st + g.L.block_pad);
    const int b = it / S;
    const int s = it - b * S;
    const float* rb = r + ((size_t)b * nt * S + s) * m;  // line s, block row 0
    for (int j = lane; j < bw; j += 32) cp_async4(rl + j, rb + (size_t)(j / m) * S * m + j % m);
    cp_async_arrive_noinc(&g.full[stage]);
    const TB* src = blocks + (size_t)it * nw;
    if (bulk) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&g.full[stage], (uint32_t)g.L.block_bytes);
        bulk_g2s(blk, src, (uint32_t)g.L.block_bytes, &g.full[stage]);
      }
    } else {
#pragma unroll 4
      for (int e = lane; e < nw; e += 32) blk[e] = src[e];
      mbar_arrive(&g.full[stage]);
    }
    if (++stage == g.stages) {
      stage = 0;
      ++round;
    }
  }
  // the warp leaves only once its own copies have landed
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The epilogue operands of one item, fetched by the thread of block row i
// before it waits for the item's stage.  `row_off` is block row i's offset
// within its line, (i / m) * S * m + i % m.
struct Epilogue {
  size_t o;
  float a1, a2, dold;
};

__device__ __forceinline__ Epilogue epilogue_fetch(const float* d, const float* c1,
                                                   const float* c2, int b, int s, int row_off,
                                                   int m, int nt, int S) {
  Epilogue e{((size_t)b * nt * S + s) * m + row_off, 0.f, 1.f, 0.f};
  if (c1) {
    e.a1 = c1[b];
    e.dold = d[e.o];
  }
  if (c2) e.a2 = c2[b];
  return e;
}

__device__ __forceinline__ void epilogue_store(float* d, const Epilogue& e, bool has_c1,
                                               float t) {
  float v = e.a2 * t;
  if (has_c1) v += e.a1 * e.dold;
  d[e.o] = v;
}

// sum over q < n of a[col(q) * stride] v[col(q)], with kUnroll loads of each
// operand in flight per step: a consumer thread's sum is a chain of shared-
// memory loads, and a few warps per SM cannot hide their latency otherwise
constexpr int kUnroll = 8;

template <typename TB, typename Col>
__device__ __forceinline__ float dot(const TB* a, int stride, const float* v, int n, Col col) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int q = 0;
  for (; q + kUnroll <= n; q += kUnroll) {
    float av[kUnroll], vv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int c = col(q + k);
      av[k] = widen(a[c * stride]);
      vv[k] = v[c];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc[k % 4] = fmaf(av[k], vv[k], acc[k % 4]);
  }
  for (; q < n; ++q) {
    const int c = col(q);
    acc[0] = fmaf(widen(a[c * stride]), v[c], acc[0]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <typename TB>
__global__ void k2_line_block_apply(const TB* __restrict__ binv, const float* __restrict__ r,
                                    float* d, const float* c1, const float* c2, int m, int nt,
                                    int S, int items, int stages, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bw = nt * m;
  const int consumers = blockDim.x - 32;
  const Ring<Layout> g = ring_setup(smem, make_layout(bw, stages, sizeof(TB), false), stages,
                                    consumers, bulk);
  if (threadIdx.x < 32) {
    produce<TB>(g, binv, r, m, nt, S, items, bulk);
    return;
  }
  const int i = threadIdx.x - 32;  // block row
  const int row_off = (i / m) * S * m + i % m;
  // thread i starts at column i and wraps (see the bank note)
  const auto skew = [i, bw](int q) {
    const int c = i + q;
    return c >= bw ? c - bw : c;
  };
  int stage = 0;
  uint32_t round = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / S;
    const int s = it - b * S;
    Epilogue e{};
    if (i < bw) e = epilogue_fetch(d, c1, c2, b, s, row_off, m, nt, S);
    mbar_wait(&g.full[stage], round & 1);
    const unsigned char* st = g.stage0 + (size_t)stage * g.L.stage_bytes;
    float t = 0.f;
    if (i < bw)
      t = dot(reinterpret_cast<const TB*>(st) + (size_t)i * bw, 1,
              reinterpret_cast<const float*>(st + g.L.block_pad), bw, skew);
    mbar_arrive(&g.empty[stage]);
    if (i < bw) epilogue_store(d, e, c1 != nullptr, t);
    if (++stage == stages) {
      stage = 0;
      ++round;
    }
  }
}

__global__ void k3_factored_line_block_apply(const __nv_bfloat16* __restrict__ w,
                                             const float* __restrict__ r, float* d,
                                             const float* c1, const float* c2, int m, int nt,
                                             int S, int items, int stages, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bw = nt * m;
  const int consumers = blockDim.x - 32;
  const Layout L = make_layout(bw, stages, sizeof(__nv_bfloat16), true);
  const Ring<Layout> g = ring_setup(smem, L, stages, consumers, bulk);
  if (threadIdx.x < 32) {
    produce<__nv_bfloat16>(g, w, r, m, nt, S, items, bulk);
    return;
  }
  float* u2 = reinterpret_cast<float*>(smem + L.u_off);
  const int i = threadIdx.x - 32;  // column j = i in pass 1, row i in pass 2
  const int row_off = (i / m) * S * m + i % m;
  const auto ident = [](int q) { return q; };
  int stage = 0;
  uint32_t round = 0;
  int k = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++k) {
    const int b = it / S;
    const int s = it - b * S;
    Epilogue e{};
    if (i < bw) e = epilogue_fetch(d, c1, c2, b, s, row_off, m, nt, S);
    mbar_wait(&g.full[stage], round & 1);
    const unsigned char* st = g.stage0 + (size_t)stage * g.L.stage_bytes;
    const __nv_bfloat16* W = reinterpret_cast<const __nv_bfloat16*>(st);
    const float* rl = reinterpret_cast<const float*>(st + g.L.block_pad);
    // u alternates between two buffers: the named barrier of item k + 1
    // orders every pass-2 read of item k before item k + 2's pass-1 writes
    float* u = u2 + (k & 1) * bw;
    // pass 1: u_i = sum_{q <= i} W[q, i] r_q (column i, down to the diagonal)
    if (i < bw) u[i] = dot(W + i, bw, rl, i + 1, ident);
    consumers_sync(consumers);
    // pass 2: t_i = sum_{j >= i} W[i, j] u_j (row i, from the diagonal)
    float t = 0.f;
    if (i < bw) t = dot(W + (size_t)i * bw + i, 1, u + i, bw - i, ident);
    mbar_arrive(&g.empty[stage]);
    if (i < bw) epilogue_store(d, e, c1 != nullptr, t);
    if (++stage == stages) {
      stage = 0;
      ++round;
    }
  }
}

// ---- the row-tiled path

// The row-tiled producer's in-kernel load path, for panels the bulk copy
// cannot take (a block whose bytes are not a multiple of 16, e.g. bf16 at
// bw 350: 245,000 B): each lane issues asynchronous copies in the widest
// unit (16, 8 or 4 bytes) that divides the panel's address and size, so a
// panel's bytes are in flight at once, and arrives on `full` when its own
// copies land; a panel aligned to 2 bytes only is copied with plain loads.
__device__ __forceinline__ void panel_load(void* dst, const void* src, size_t bytes, int lane,
                                           uint64_t* full) {
  char* d = reinterpret_cast<char*>(dst);
  const char* sp = reinterpret_cast<const char*>(src);
  const size_t a = reinterpret_cast<uintptr_t>(src) | bytes;
  if ((a & 15) == 0) {
    for (size_t o = 16 * (size_t)lane; o < bytes; o += 32 * 16) cp_async16(d + o, sp + o);
  } else if ((a & 7) == 0) {
    for (size_t o = 8 * (size_t)lane; o < bytes; o += 32 * 8) cp_async8(d + o, sp + o);
  } else if ((a & 3) == 0) {
    for (size_t o = 4 * (size_t)lane; o < bytes; o += 32 * 4)
      cp_async4(reinterpret_cast<float*>(d + o), reinterpret_cast<const float*>(sp + o));
  } else {
    const uint16_t* s2 = reinterpret_cast<const uint16_t*>(src);
    uint16_t* d2 = reinterpret_cast<uint16_t*>(dst);
#pragma unroll 4
    for (size_t e = lane; e < bytes / 2; e += 32) d2[e] = s2[e];
    mbar_arrive(full);
    return;
  }
  cp_async_arrive_noinc(full);
}

// warp 0: fill the ring with this CTA's items panel by panel, `sweeps`
// passes over each block; the item's first panel also gathers r's line into
// r2 + (k & 1) * bw (k counts the CTA's items)
template <typename TB>
__device__ __forceinline__ void produce_tiled(const Ring<TiledLayout>& g, const TB* __restrict__ blocks,
                                              const float* __restrict__ r, float* r2, int m,
                                              int nt, int S, int items, int rows, int sweeps,
                                              bool bulk) {
  const int lane = threadIdx.x;
  const int bw = nt * m;
  int stage = 0;
  uint32_t round = 0;
  int k = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++k) {
    const int b = it / S;
    const int s = it - b * S;
    const TB* src = blocks + (size_t)it * bw * bw;
    for (int sw = 0; sw < sweeps; ++sw) {
      for (int p0 = 0; p0 < bw; p0 += rows) {
        if (round > 0) mbar_wait(&g.empty[stage], (round - 1) & 1);
        if (sw == 0 && p0 == 0) {
          float* rl = r2 + (k & 1) * bw;
          const float* rb = r + ((size_t)b * nt * S + s) * m;  // line s, block row 0
          for (int j = lane; j < bw; j += 32)
            cp_async4(rl + j, rb + (size_t)(j / m) * S * m + j % m);
          cp_async_arrive_noinc(&g.full[stage]);
        } else {
          mbar_arrive(&g.full[stage]);  // stands in for r's 32 arrivals
        }
        TB* pan = reinterpret_cast<TB*>(g.stage0 + (size_t)stage * g.L.stage_bytes);
        const TB* ps = src + (size_t)p0 * bw;
        const int n = min(rows, bw - p0) * bw;
        if (bulk) {
          if (lane == 0) {
            const uint32_t bytes = (uint32_t)(n * sizeof(TB));
            mbar_arrive_expect_tx(&g.full[stage], bytes);
            bulk_g2s(pan, ps, bytes, &g.full[stage]);
          }
        } else {
          panel_load(pan, ps, n * sizeof(TB), lane, &g.full[stage]);
        }
        if (++stage == g.stages) {
          stage = 0;
          ++round;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <typename TB>
__global__ void k2_line_block_apply_tiled(const TB* __restrict__ binv,
                                          const float* __restrict__ r, float* d,
                                          const float* c1, const float* c2, int m, int nt,
                                          int S, int items, int rows, int stages, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bw = nt * m;
  const int consumers = blockDim.x - 32;
  const TiledLayout L = make_tiled_layout(bw, rows, stages, sizeof(TB), false);
  const Ring<TiledLayout> g = ring_setup(smem, L, stages, consumers, bulk);
  float* r2 = reinterpret_cast<float*>(smem + L.r_off);
  if (threadIdx.x < 32) {
    produce_tiled<TB>(g, binv, r, r2, m, nt, S, items, rows, 1, bulk);
    return;
  }
  const int q = threadIdx.x - 32;  // row within a panel
  // thread q starts at column q and wraps, as the streamed path's thread i
  const auto skew = [q, bw](int c) {
    const int j = q + c;
    return j >= bw ? j - bw : j;
  };
  int stage = 0;
  uint32_t round = 0;
  int k = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++k) {
    const int b = it / S;
    const int s = it - b * S;
    const float* rl = r2 + (k & 1) * bw;
    for (int p0 = 0; p0 < bw; p0 += rows) {
      const int i = p0 + q;  // block row
      const bool live = q < rows && i < bw;
      Epilogue e{};
      if (live) e = epilogue_fetch(d, c1, c2, b, s, (i / m) * S * m + i % m, m, nt, S);
      mbar_wait(&g.full[stage], round & 1);
      const TB* pan = reinterpret_cast<const TB*>(g.stage0 + (size_t)stage * g.L.stage_bytes);
      float t = 0.f;
      if (live) t = dot(pan + (size_t)q * bw, 1, rl, bw, skew);
      mbar_arrive(&g.empty[stage]);
      if (live) epilogue_store(d, e, c1 != nullptr, t);
      if (++stage == stages) {
        stage = 0;
        ++round;
      }
    }
  }
}

__global__ void k3_factored_line_block_apply_tiled(const __nv_bfloat16* __restrict__ w,
                                                   const float* __restrict__ r, float* d,
                                                   const float* c1, const float* c2, int m,
                                                   int nt, int S, int items, int rows,
                                                   int stages, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bw = nt * m;
  const int consumers = blockDim.x - 32;
  const TiledLayout L = make_tiled_layout(bw, rows, stages, sizeof(__nv_bfloat16), true);
  const Ring<TiledLayout> g = ring_setup(smem, L, stages, consumers, bulk);
  float* u2 = reinterpret_cast<float*>(smem + L.u_off);
  float* r2 = reinterpret_cast<float*>(smem + L.r_off);
  if (threadIdx.x < 32) {
    produce_tiled<__nv_bfloat16>(g, w, r, r2, m, nt, S, items, rows, 2, bulk);
    return;
  }
  const int q = threadIdx.x - 32;  // owns columns q + c * consumers in sweep 1, panel row q in sweep 2
  const auto ident = [](int c) { return c; };
  int stage = 0;
  uint32_t round = 0;
  int k = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++k) {
    const int b = it / S;
    const int s = it - b * S;
    const float* rl = r2 + (k & 1) * bw;
    // u alternates between two buffers, as in the streamed K3: the named
    // barrier of item k + 1 orders item k's sweep-2 reads before item k + 2's
    // sweep-1 writes
    float* u = u2 + (k & 1) * bw;
    // sweep 1: u_j = sum_{i <= j} W[i, j] r_i, panel by panel
    for (int p0 = 0; p0 < bw; p0 += rows) {
      const int n = min(rows, bw - p0);
      mbar_wait(&g.full[stage], round & 1);
      const __nv_bfloat16* pan =
          reinterpret_cast<const __nv_bfloat16*>(g.stage0 + (size_t)stage * g.L.stage_bytes);
      // a column j < p0 takes nothing from this panel (W[i, j] = 0 for i > j)
      for (int j = q; j < bw; j += consumers) {
        if (j < p0) continue;
        const float part = dot(pan + j, bw, rl + p0, min(n, j - p0 + 1), ident);
        u[j] = p0 == 0 ? part : u[j] + part;
      }
      mbar_arrive(&g.empty[stage]);
      if (++stage == stages) {
        stage = 0;
        ++round;
      }
    }
    consumers_sync(consumers);
    // sweep 2: t_i = sum_{j >= i} W[i, j] u_j (panel row q, from the diagonal)
    for (int p0 = 0; p0 < bw; p0 += rows) {
      const int i = p0 + q;
      const bool live = q < rows && i < bw;
      Epilogue e{};
      if (live) e = epilogue_fetch(d, c1, c2, b, s, (i / m) * S * m + i % m, m, nt, S);
      mbar_wait(&g.full[stage], round & 1);
      const __nv_bfloat16* pan =
          reinterpret_cast<const __nv_bfloat16*>(g.stage0 + (size_t)stage * g.L.stage_bytes);
      float t = 0.f;
      if (live) t = dot(pan + (size_t)q * bw + i, 1, u + i, bw - i, ident);
      mbar_arrive(&g.empty[stage]);
      if (live) epilogue_store(d, e, c1 != nullptr, t);
      if (++stage == stages) {
        stage = 0;
        ++round;
      }
    }
  }
}

// Check the launch geometry against the shapes and the layout of the path
// it takes (rows == nt * m: streamed; fewer: row-tiled); returns a CUDA
// error code (0 if the launch may go ahead)
int check_launch(const void* blocks, int m, int nt, int S, int bs, int ctas, int rows,
                 int stages, int smem_bytes, int bulk, int esize, bool factored) {
  if (m < 1 || nt < 1 || S < 1 || bs < 1 || ctas < 1 || stages < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)bs * S > 0x7fffffff || (long long)nt * S * m > 0x7fffffff)
    return (int)cudaErrorInvalidValue;  // item and row offsets are int
  const int bw = nt * m;
  if (rows > bw || 32 + (rows + 31) / 32 * 32 > 1024) return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(blocks) & 15) == 0;
  if (rows == bw) {
    const Layout L = make_layout(bw, stages, esize, factored);
    if ((size_t)smem_bytes != L.total) return (int)cudaErrorInvalidValue;
    if (bulk && (L.block_bytes % 16 != 0 || !aligned)) return (int)cudaErrorInvalidValue;
    return 0;
  }
  // r's buffer for item k is rewritten once a panel of item k - 1 is released
  if ((factored ? 2 : 1) * ((bw + rows - 1) / rows) < stages) return (int)cudaErrorInvalidValue;
  const TiledLayout L = make_tiled_layout(bw, rows, stages, esize, factored);
  if ((size_t)smem_bytes != L.total) return (int)cudaErrorInvalidValue;
  if (bulk && (((size_t)bw * bw * esize) % 16 != 0 || ((size_t)rows * bw * esize) % 16 != 0 ||
               !aligned))
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

// K2 (FACTORED false, B^-1 in TB) or K3 (true, W in bf16): the streamed
// kernel when a whole block is the ring's unit (rows == nt * m), else the
// row-tiled one
template <typename TB, bool FACTORED>
int line_block_launch(const TB* blocks, const float* r, float* d, const float* c1,
                      const float* c2, int m, int nt, int S, int bs, int ctas, int rows,
                      int stages, int smem_bytes, int bulk, void* stream) {
  static int allowed = 0, allowed_tiled = 0;
  int code = check_launch(blocks, m, nt, S, bs, ctas, rows, stages, smem_bytes, bulk,
                          sizeof(TB), FACTORED);
  if (code) return code;
  const int threads = 32 + (rows + 31) / 32 * 32;
  const int items = bs * S;
  if (rows != nt * m) {
    if constexpr (FACTORED)
      return launch(k3_factored_line_block_apply_tiled, &allowed_tiled, ctas, threads,
                    smem_bytes, stream, blocks, r, d, c1, c2, m, nt, S, items, rows, stages,
                    bulk);
    else
      return launch(k2_line_block_apply_tiled<TB>, &allowed_tiled, ctas, threads, smem_bytes,
                    stream, blocks, r, d, c1, c2, m, nt, S, items, rows, stages, bulk);
  }
  if constexpr (FACTORED)
    return launch(k3_factored_line_block_apply, &allowed, ctas, threads, smem_bytes, stream,
                  blocks, r, d, c1, c2, m, nt, S, items, stages, bulk);
  else
    return launch(k2_line_block_apply<TB>, &allowed, ctas, threads, smem_bytes, stream, blocks,
                  r, d, c1, c2, m, nt, S, items, stages, bulk);
}

}  // namespace

extern "C" {

// ctas, rows, stages, smem_bytes and bulk: the launch geometry of
// ops/fused_smoother.line_block_geometry; rows < nt * m takes the row-tiled
// path, rows == nt * m the streamed one
int k2_line_block_apply_f32(const float* binv, const float* r, float* d, const float* c1,
                            const float* c2, int m, int nt, int S, int bs, int ctas, int rows,
                            int stages, int smem_bytes, int bulk, void* stream) {
  return line_block_launch<float, false>(binv, r, d, c1, c2, m, nt, S, bs, ctas, rows, stages,
                                         smem_bytes, bulk, stream);
}

// bf16 B^-1, f32 vectors
int k2_line_block_apply_bf16(const __nv_bfloat16* binv, const float* r, float* d,
                             const float* c1, const float* c2, int m, int nt, int S, int bs,
                             int ctas, int rows, int stages, int smem_bytes, int bulk,
                             void* stream) {
  return line_block_launch<__nv_bfloat16, false>(binv, r, d, c1, c2, m, nt, S, bs, ctas, rows,
                                                  stages, smem_bytes, bulk, stream);
}

// bf16 upper-triangular W, f32 vectors
int k3_factored_line_block_apply_bf16(const __nv_bfloat16* w, const float* r, float* d,
                                      const float* c1, const float* c2, int m, int nt, int S,
                                      int bs, int ctas, int rows, int stages, int smem_bytes,
                                      int bulk, void* stream) {
  return line_block_launch<__nv_bfloat16, true>(w, r, d, c1, c2, m, nt, S, bs, ctas, rows,
                                                 stages, smem_bytes, bulk, stream);
}

const char* k2_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
