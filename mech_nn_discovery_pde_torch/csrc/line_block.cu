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
//                              its upper triangle); on K3's cluster route
//                              W is (bs, S, packed_off(bw, bw)), its packed
//                              upper triangle (see the row-tiled path)
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
// geometry comes from ops/fused_smoother.line_block_geometry: up to 8 CTAs
// per SM with 2 stages each, 8 at the GL shapes, or a CTA alone on its SM
// with up to 3), and CTA c walks the items c, c + grid, c + 2 grid, ...
// Each CTA is one producer warp and ceil(bw / 32) consumer warps around a
// ring of `stages` stages in shared memory; a stage holds one block and its
// line of r.
//   - Producer (warp 0): waits for the stage to be released (its `empty`
//     mbarrier), gathers r's bw values through the line index map with
//     4-byte cp.async (tracked by the stage's `full` mbarrier through
//     cp.async.mbarrier.arrive.noinc), and moves the contiguous block by a
//     1-D bulk copy (cp.async.bulk ... complete_tx) that completes on
//     `full`: where every block is 16-byte aligned (`whole`: its bytes a
//     multiple of 16 at an aligned pointer, as at the GL shapes), one lane
//     copies the whole block; else `panel_copy` puts the block at its
//     address mod 16 in the stage (16 more bytes a stage), one lane copies
//     its aligned interior and the lanes its head and tail, so a block of
//     any alignment (f32 at odd bw, bf16 at bw not a multiple of 4; 122,500
//     B at bw 175) is one bulk copy.  It runs `stages` items ahead of the
//     consumers, so the next blocks load while one is computed on.
//   - Consumers: one thread per block row (K2) or column/row (K3), sums in
//     f32 from shared memory, with no shuffles, 8 loads of each operand in
//     flight per step (`dot`), from the block's shifted base.  Each thread
//     prefetches its d entry and c1, c2 before waiting on `full`, arrives
//     on `empty` once it has read the stage, and then writes its d entry;
//     the thread that reads d(o) is the one that writes it, so in-place d is
//     race-free.
//   - K3 reads only W's upper triangle: pass 1 u_j = sum_{i<=j} W[i,j] r_i
//     (thread j, u kept in f32 as the TPU kernel's `us`, double-buffered
//     across items), one named barrier over the consumer warps (bar.sync 1,
//     never __syncthreads, so the producer keeps loading), pass 2
//     t_i = sum_{j>=i} W[i,j] u_j (thread i).  The stored W stays dense:
//     the copy still moves the zeros, so the bound is unchanged.
// A CTA computes one item at a time, and what limits it is its consumers'
// chain of shared-memory loads more than the bytes in flight: hence many
// small CTAs (8 per SM), two stages each, and the unrolled loads.  Wider
// blocks leave fewer CTAs an SM; the streamed kernels take a block only
// while their ring keeps enough of them in flight per SM, up to a measured
// crossover (ops/fused_smoother._STREAMED_MAX_BW, tools/line_block_sweep.py
// --mid on an H100): K2 f32 to bw 137 (2 CTAs of 2 stages, or one of 3),
// K2 bf16 to bw 240 (one CTA of 3 stages, then 2), K3 to bw 168 (2 CTAs of
// 2 stages); a wider block takes a row-tiled kernel below.
//
// Shared-memory banks.  A block row is bw words apart in f32; at bw = 56 that
// is 24 (mod 32), so a warp whose thread i reads column c of row i touches
// only 4 banks (8-way conflict).  K2's thread i instead starts at column
// a i mod bw and wraps (c = (a i + q) mod bw at step q), the skew a chosen
// per width (`flags`; ops/fused_smoother.line_block_walk, which counts each
// warp-wide load's banks over every step and block placement and takes
// the first walk at most 2-way).  a = 1 at bw = 56: the word i*57 + q falls
// in bank 25 i + q (mod 32), distinct over a warp, and the threads whose
// column wrapped shift by 24 banks (at most 2-way; mean 1.55 for rows 0-31,
// 1.0 for rows 32-55; 1.74 / 1.0 at bw = 42); a = 0 where a = 1 is more
// than 2-way and a = 0 is not (in f32 the widths bw = 3 (mod 4), whose
// rows are bw + 1 words apart from diagonal to diagonal, 16-way at bw =
// 175, while an odd bw puts B[i, q] in bank i bw + q, distinct; in bf16
// also some even ones); a = 3 where neither is (bf16 at bw 72, 80, 136,
// 144, 200, 208).  In bf16 two entries share a word, 2-way at most.  K3's
// pass 1 reads a row of W across consecutive threads (conflict-free, r
// broadcast); pass 2's thread i reads W[i, i+q], skewed by construction
// (rows bw + 1 entries apart, at most 2-way), except at bw = 7 (mod 8),
// where bw + 1 entries are a multiple of 4 bf16 words (88 at bw = 175:
// 8-way) and pass 2 walks down from the last column instead (W[i, bw-1-q]:
// the lanes read one column, bw entries apart, at most 2-way).  r and u
// are read at consecutive words or broadcast.
//
// Row-tiled path.  A block wider than the streamed kernels' crossover takes
// one of three kernels; which one follows from the launch's rows
// (`route_of`, mirrored by ops/fused_smoother.line_block_route), and the
// launch geometry (`rows`, CTAs, stages) comes from
// ops/fused_smoother.line_block_geometry.
//   - K2: k2_line_block_apply_panels.  The unit of work is an (item, row
//     panel) pair, not an item: the persistent CTAs walk the bs*S*panels
//     units (unit c, c + grid, ...), so 128 blocks of bw 280 are 1,152
//     units and every SM has work.  A stage holds one panel of `rows`
//     (<= 24) consecutive block rows and r's line, which each unit gathers
//     anew (4 / (rows * entry bytes) more bytes than the panel, read from
//     L2: 4 % at 24 rows in f32).  Each consumer warp takes 4 panel rows:
//     its 32 lanes split the columns (lane l reads columns l, l + 32, ...,
//     so a warp-wide load is 32 consecutive entries of one row, without
//     bank conflicts in f32 and bf16, and each r entry it loads serves the
//     4 rows), and a transposed shuffle reduction (`warp_row_sums`: 6
//     shuffles for 4 rows) leaves each row's sum on the lane that fetched
//     its epilogue operands.  6 consumer warps a CTA, 3 CTAs an SM of 2
//     stages each: 18 consumer warps an SM (tools/line_block_sweep.py
//     compares the other geometries).
//   - K3: k3_factored_line_block_apply_cluster.  W crosses device memory
//     once, and only its upper triangle: the solver stores W at these
//     widths packed (ops/fused_smoother.pack_upper): row i's entries from
//     the 8-entry boundary at or before its diagonal to the width rounded
//     up to 8, zero left of the diagonal and past bw, rows concatenated
//     (`packed_off`), 63,344 entries a block at bw 350 against 122,500
//     dense (3.1 % over the triangle's 61,425), every row 16-byte aligned,
//     so the consumers read 8 entries a load.  A thread-block cluster of
//     C <= 8 CTAs (the portable limit) holds one block, CTA c the rows
//     [cluster_row0(c), cluster_row0(c + 1)), one contiguous span and one
//     bulk copy, an equal share of the packed block as near as whole rows
//     allow (bw 350, C 2: rows 0-103 and 104-349, 31,616 and 31,728
//     entries; equal row counts gave CTA 0 1.5 times the mean share, 1.76 at
//     C 4); the launch's `rows` is ceil(bw / C), from which C follows.
//     The cluster walks the items (cluster k takes k, k + clusters, ...),
//     each CTA through its own ring.  An item's sweeps wait on the
//     cluster's slowest CTA, and what limits a CTA is its instructions and
//     chains of shared-memory loads an item, not bytes: no thread's chain
//     grows with the rows its CTA holds beyond one row's chunks.  Sweep 1:
//     each CTA forms its partial u_j = sum_{its rows i <= j} W[i, j] r_i for
//     the columns j from its first chunk on: warp v takes the rows v,
//     v + 8, ... of the CTA, lane l the l-th chunk of each pass of 32 (8
//     sums a lane, one 16-byte load a row, r broadcast; without branches, 4
//     rows' loads in flight); the warps' sums land in their rows of a
//     shared table that each column's thread adds up in warp order.  The
//     last C consumer threads then signal the other CTAs (a remote mbarrier
//     arrive, release at cluster scope), and each CTA, once the C - 1
//     signals of the item have come (acquire at cluster scope), sums for
//     each of its columns the partials of the CTAs whose chunks start at or
//     before it, reading the others' through distributed shared memory
//     (mapa + ld.shared::cluster, all in flight at once) in rank order, so
//     every CTA holds the same u.  Sweep 2: t_i = sum_{j >= i} W[i, j] u_j,
//     a thread a row, over its chunks (no reduction across lanes).  The
//     partials are double-buffered by item: CTA c rewrites item k's buffer
//     (at item k + 2) only after every other CTA's signal of item k + 1,
//     which each sends after its reads of item k.  A cluster barrier
//     follows the barriers' initialisation, and one precedes the CTAs'
//     exit (no CTA leaves while another may read its shared memory).  The
//     launcher caps the grid at the clusters that can be resident at once
//     (cudaOccupancyMaxActiveClusters), so no cluster waits for another to
//     end.  Cluster size, stages and CTAs an SM come from
//     ops/fused_smoother._cluster_geometry (tools/line_block_sweep.py
//     --k3): 2 CTAs an SM (__launch_bounds__(288, 2)), bw 350: clusters of
//     2 of one stage, bw 175: of 2 stages.  A block whose pointer is not
//     16-byte aligned is copied by the producer's lanes entry by entry.
//   - K3 at blocks too wide for 8 CTAs (bw > 916):
//     k3_factored_line_block_apply_tiled, which streams the block's panels
//     through one CTA twice.  Sweep 1 accumulates u = W^T r into a bw-float
//     shared vector (thread q owns columns q, q + consumers, ...; a panel
//     adds its rows i <= j to column j), one named barrier, then sweep 2
//     streams the panels again for t_i = sum_{j >= i} W[i, j] u_j (panel
//     row q).  W is read twice, each time only its upper triangle; r's line
//     stays resident for the item (double-buffered by item, loaded with its
//     first panel).  Producer and consumers walk the same sequence of panel
//     loads, so the ring's stage and phase parity advance per panel across
//     both sweeps; r's buffer for item k is rewritten only after the
//     consumers released a panel of item k - 1, which the launch check
//     guarantees (panel loads per item >= stages).
// The panel and cluster kernels move every panel with one 1-D bulk copy
// (`panel_copy`, as the streamed kernels' unaligned blocks): the panel
// lands at stage + (its address mod 16), so the copy takes its
// 16-byte-aligned interior and the lanes copy the head and tail (under 16
// bytes each) with 2-byte loads.  bf16 blocks of bw 350 (245,000 B, every
// other one 8-byte aligned) thus take the bulk copy too; the consumers' 4-
// and 2-byte loads need no alignment beyond the entry's.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, CUDA 12.8 on the
// H100 machine; chip_smoke.py checks the stack and spills): 48 registers a
// thread for the three streamed kernels (with the shifted copy and the
// walks), 56 for the panel one, 88 for the cluster one and 55 for the
// two-sweep one, no stack frame, no spills, no static shared memory; the
// dynamic shared memory is the geometry's (GL shapes: 25,568 B for K2 f32,
// 13,024 B for K2 bf16, 13,472 B for K3 per CTA, as before the shifted
// copy; bw 175: 35,072 B for K2 f32 on panels, 186,000 B for K2 bf16
// streamed in 3 stages, 43,024 B for K3 on a cluster of 2 in 2 stages;
// bw 350: 70,080 B for K2 f32 on panels, 36,480 B in bf16, 83,392 B for K3
// on a cluster of 2 in one stage).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- shared-memory layout (ops/fused_smoother.line_block_smem_bytes mirrors it)
//   [full mbarriers: stages x 8 B][empty mbarriers: stages x 8 B]
//   [u: 2 bw f32, K3 only, padded to 16 B]
//   stages x [block: bw*bw entries, padded to 16 B, + 16 B for its shift
//             unless every block is 16-byte aligned (`whole`)]
//            [r: bw f32, padded to 16 B]
__host__ __device__ inline size_t pad16(size_t n) { return (n + 15) / 16 * 16; }

struct Layout {
  size_t block_bytes, block_pad, stage_bytes, u_off, stage_off, total;
};

__host__ __device__ inline Layout make_layout(int bw, int stages, int esize, bool factored,
                                              bool whole) {
  Layout L;
  L.block_bytes = (size_t)bw * bw * esize;
  L.block_pad = pad16(L.block_bytes) + (whole ? 0 : 16);
  L.stage_bytes = L.block_pad + pad16(sizeof(float) * (size_t)bw);
  L.u_off = 16 * (size_t)stages;
  L.stage_off = L.u_off + (factored ? pad16(2 * sizeof(float) * (size_t)bw) : 0);
  L.total = L.stage_off + (size_t)stages * L.stage_bytes;
  return L;
}

// the streamed launch's `flags`: bit 0 `whole` (every block 16-byte aligned,
// moved by one bulk copy of the whole block; else `panel_copy`), bits 1-7
// the consumers' column walk (ops/fused_smoother.line_block_walk: K2's skew
// a, thread i starting at column a i mod bw; K3's pass 2, 0 from the
// diagonal up, 1 from the last column down)
constexpr int kWhole = 1;
__host__ __device__ inline int flags_walk(int flags) { return (flags >> 1) & 127; }

// ---- the two-sweep K3's layout (line_block_smem_bytes mirrors it)
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

// the row-tiled kernels' constants (ops/fused_smoother.py mirrors them)
constexpr int kRowsPerWarp = 4;    // block rows a consumer warp sums at once
constexpr int kPanelMaxRows = 24;  // panel kernel: 6 consumer warps at most
constexpr int kClusterWarps = 8;   // cluster kernel: consumer warps a CTA
constexpr int kMaxCluster = 8;     // CTAs a cluster: the portable limit

// ---- the panel kernel's layout (line_block_smem_bytes mirrors it)
//   [full mbarriers: stages x 8 B][empty mbarriers: stages x 8 B]
//   stages x [panel: rows*bw entries, padded to 16 B, + 16 B for its shift]
//            [r: bw f32, padded to 16 B]
struct PanelLayout {
  size_t stage_bytes, r_off, stage_off, total;
};

__host__ __device__ inline PanelLayout make_panel_layout(int bw, int rows, int stages, int esize) {
  PanelLayout L;
  L.r_off = pad16((size_t)rows * bw * esize) + 16;
  L.stage_bytes = L.r_off + pad16(sizeof(float) * (size_t)bw);
  L.stage_off = 16 * (size_t)stages;
  L.total = L.stage_off + (size_t)stages * L.stage_bytes;
  return L;
}

// ---- the cluster kernel's W: the rows of its upper triangle, concatenated,
// each from the 8-entry boundary at or before its diagonal to the width
// rounded up to 8 (ops/fused_smoother.pack_upper): row i holds W[i, a:bwp],
// a = 8 (i / 8), bwp = 8 ceil(bw / 8), zero left of the diagonal and past
// bw, from packed_off(bw, i), so every row starts and ends on 16 bytes.
// CTA c of a cluster of C holds the rows [cluster_row0(c),
// cluster_row0(c + 1)): the row boundary nearest c / C of the block's
// entries (the lower one on a tie), so each CTA holds an equal share as
// near as whole rows allow (ops/fused_smoother.cluster_rows mirrors it)
__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }

__host__ __device__ inline long long packed_off(int bw, int i) {
  const long long bwp = pad8(bw), g = i / 8, r = i % 8;
  return 8 * g * bwp - 32 * g * (g - 1) + r * (bwp - 8 * g);
}

__host__ __device__ inline int cluster_row0(int bw, int C, int c) {
  const long long t = (long long)c * packed_off(bw, bw);  // C times the share's start
  // the first row i with C packed_off(bw, i) >= t, by bisection
  int lo = 0, hi = bw;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (C * packed_off(bw, mid) >= t) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  if (lo > 0 && t - C * packed_off(bw, lo - 1) <= C * packed_off(bw, lo) - t) --lo;
  return lo;
}

// the most entries and the most rows any CTA of the split holds
struct ClusterSplit {
  int emax, nmax;
};

__host__ __device__ inline ClusterSplit cluster_split(int bw, int C) {
  ClusterSplit s{0, 0};
  int a = 0;
  for (int c = 0; c < C; ++c) {
    const int b = cluster_row0(bw, C, c + 1);
    s.emax = max(s.emax, (int)(packed_off(bw, b) - packed_off(bw, a)));
    s.nmax = max(s.nmax, b - a);
    a = b;
  }
  return s;
}

// ---- the cluster kernel's layout (line_block_smem_bytes mirrors it)
//   [full mbarriers: stages x 8 B][empty mbarriers: stages x 8 B][ready: 2 x 8 B]
//   [the split's first rows: kMaxCluster + 1 ints, padded to 16 B]
//   [this CTA's rows' offsets within their line: bw ints, padded to 16 B]
//   [partial u: 2 x bwp f32][u: bwp f32][old d: 2 x nmax f32, padded to 16 B]
//   [sweep 1's sums: kClusterWarps x bwp f32]
//   stages x [rows: emax bf16][r: nmax f32, padded to 16 B]
// (bwp = pad8(bw); every part starts on 16 bytes)
struct ClusterLayout {
  size_t stage_bytes, r_off, row0_off, loff_off, part_off, u_off, dold_off, sums_off, stage_off,
      total;
};

__host__ __device__ inline ClusterLayout make_cluster_layout(int bw, ClusterSplit sp,
                                                             int stages) {
  const size_t bwp = pad8(bw);
  ClusterLayout L;
  L.r_off = pad16((size_t)sp.emax * sizeof(__nv_bfloat16));
  L.stage_bytes = L.r_off + pad16(sizeof(float) * (size_t)sp.nmax);
  L.row0_off = 16 * (size_t)stages + 16;
  L.loff_off = L.row0_off + pad16(sizeof(int) * (kMaxCluster + 1));
  L.part_off = L.loff_off + pad16(sizeof(int) * (size_t)bw);
  L.u_off = L.part_off + 2 * sizeof(float) * bwp;
  L.dold_off = L.u_off + sizeof(float) * bwp;
  L.sums_off = L.dold_off + pad16(2 * sizeof(float) * (size_t)sp.nmax);
  L.stage_off = L.sums_off + sizeof(float) * kClusterWarps * bwp;
  L.total = L.stage_off + (size_t)stages * L.stage_bytes;
  return L;
}

// which kernel a launch takes, from its shape alone
enum Route { kStreamed, kPanels, kCluster, kTwoSweep };

__host__ inline Route route_of(int bw, int rows, bool factored) {
  if (rows >= bw) return kStreamed;
  if (!factored) return kPanels;
  return (bw + rows - 1) / rows <= kMaxCluster ? kCluster : kTwoSweep;
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

// ---- thread-block cluster primitives (sm_90)
struct ClusterPos {
  uint32_t rank, size, id, count;  // this CTA's rank and the CTAs in its cluster; the
                                   // cluster's index and the clusters in the grid (x)
};

__device__ __forceinline__ ClusterPos cluster_pos() {
  ClusterPos c;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(c.rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(c.size));
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(c.id));
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(c.count));
  return c;
}

// every thread of every CTA of the cluster (release, then acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;" ::: "memory");
}

// the shared::cluster address of `p` (this CTA's shared memory) in CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// arrive on the mbarrier at `bar`'s offset in CTA `rank`, releasing this
// thread's prior writes (and those ordered before them) at cluster scope
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
                   cluster_addr(bar, rank))
               : "memory");
}

// wait for a phase completed by other CTAs' arrivals, acquiring at cluster scope
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
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

// (the address of `p`) mod 16: where a panel copied from `p` starts in its
// stage (`panel_copy`)
__device__ __forceinline__ uint32_t panel_shift(const void* p) {
  return (uint32_t)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Producer warp: copy a panel of `bytes` (a multiple of 2) from global `src`
// into the stage at `dst`, starting at dst + panel_shift(src), so that its
// 16-byte-aligned interior lands 16-byte aligned: lane 0 expects and starts
// one 1-D bulk copy of the interior, completing on `full`; the lanes copy the
// head and the tail (under 16 bytes each) with 2-byte loads; every lane
// arrives on `full` after its stores (lane 0 with the bulk copy's
// expect_tx), 32 arrivals.
__device__ __forceinline__ void panel_copy(unsigned char* dst, const void* src, uint32_t bytes,
                                           int lane, uint64_t* full) {
  const uint32_t shift = panel_shift(src);
  const uint32_t head = min((16 - shift) & 15, bytes);
  const uint32_t body = (bytes - head) & ~15u;
  const uint16_t* s2 = reinterpret_cast<const uint16_t*>(src);
  uint16_t* d2 = reinterpret_cast<uint16_t*>(dst + shift);
  for (uint32_t e = lane; e < head / 2; e += 32) d2[e] = s2[e];
  for (uint32_t e = (head + body) / 2 + lane; e < bytes / 2; e += 32) d2[e] = s2[e];
  // a later bulk copy into this stage (async proxy) follows these stores
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (lane == 0 && body) {
    mbar_arrive_expect_tx(full, body);
    bulk_g2s(dst + shift + head, reinterpret_cast<const char*>(src) + head, body, full);
  } else {
    mbar_arrive(full);
  }
}

// warp 0: fill the ring with this CTA's items, `stages` ahead of the consumers:
// each stage gets r's line (4-byte cp.async, 32 arrivals) and the block, by
// one bulk copy where every block is 16-byte aligned (`whole`: lane 0's
// expect_tx arrival), else by `panel_copy` (32 arrivals)
template <typename TB>
__device__ __forceinline__ void produce(const Ring<Layout>& g, const TB* __restrict__ blocks,
                                        const float* __restrict__ r, int m, int nt, int S,
                                        int items, bool whole) {
  const int lane = threadIdx.x;
  const int bw = nt * m;
  const size_t nw = (size_t)bw * bw;
  int stage = 0;
  uint32_t round = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    if (round > 0) mbar_wait(&g.empty[stage], (round - 1) & 1);
    unsigned char* st = g.stage0 + (size_t)stage * g.L.stage_bytes;
    float* rl = reinterpret_cast<float*>(st + g.L.block_pad);
    const int b = it / S;
    const int s = it - b * S;
    const float* rb = r + ((size_t)b * nt * S + s) * m;  // line s, block row 0
    for (int j = lane; j < bw; j += 32) cp_async4(rl + j, rb + (size_t)(j / m) * S * m + j % m);
    cp_async_arrive_noinc(&g.full[stage]);
    const TB* src = blocks + (size_t)it * nw;
    if (whole) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&g.full[stage], (uint32_t)g.L.block_bytes);
        bulk_g2s(st, src, (uint32_t)g.L.block_bytes, &g.full[stage]);
      }
    } else {
      panel_copy(st, src, (uint32_t)g.L.block_bytes, lane, &g.full[stage]);
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
                                    int S, int items, int stages, int flags) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bw = nt * m;
  const int consumers = blockDim.x - 32;
  const bool whole = flags & kWhole;
  const Ring<Layout> g = ring_setup(smem, make_layout(bw, stages, sizeof(TB), false, whole),
                                    stages, consumers, whole);
  if (threadIdx.x < 32) {
    produce<TB>(g, binv, r, m, nt, S, items, whole);
    return;
  }
  const int i = threadIdx.x - 32;  // block row
  const int row_off = (i / m) * S * m + i % m;
  // thread i starts at column a i mod bw and wraps (see the bank note)
  const int start = (int)(((long long)flags_walk(flags) * i) % bw);
  const auto skew = [start, bw](int q) {
    const int c = start + q;
    return c >= bw ? c - bw : c;
  };
  const size_t nw = (size_t)bw * bw;
  int stage = 0;
  uint32_t round = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / S;
    const int s = it - b * S;
    Epilogue e{};
    if (i < bw) e = epilogue_fetch(d, c1, c2, b, s, row_off, m, nt, S);
    mbar_wait(&g.full[stage], round & 1);
    const unsigned char* st = g.stage0 + (size_t)stage * g.L.stage_bytes;
    // the block starts at its address mod 16 (0 where `whole`)
    const TB* blk = reinterpret_cast<const TB*>(st + panel_shift(binv + (size_t)it * nw));
    float t = 0.f;
    if (i < bw)
      t = dot(blk + (size_t)i * bw, 1, reinterpret_cast<const float*>(st + g.L.block_pad), bw,
              skew);
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
                                             int S, int items, int stages, int flags) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bw = nt * m;
  const int consumers = blockDim.x - 32;
  const bool whole = flags & kWhole;
  const Layout L = make_layout(bw, stages, sizeof(__nv_bfloat16), true, whole);
  const Ring<Layout> g = ring_setup(smem, L, stages, consumers, whole);
  if (threadIdx.x < 32) {
    produce<__nv_bfloat16>(g, w, r, m, nt, S, items, whole);
    return;
  }
  float* u2 = reinterpret_cast<float*>(smem + L.u_off);
  const int i = threadIdx.x - 32;  // column j = i in pass 1, row i in pass 2
  const int row_off = (i / m) * S * m + i % m;
  const auto ident = [](int q) { return q; };
  // pass 2 walks row i from the last column down (see the bank note)
  const bool down = flags_walk(flags) != 0;
  const auto from_last = [bw](int q) { return bw - 1 - q; };
  const size_t nw = (size_t)bw * bw;
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
    const __nv_bfloat16* W =
        reinterpret_cast<const __nv_bfloat16*>(st + panel_shift(w + (size_t)it * nw));
    const float* rl = reinterpret_cast<const float*>(st + g.L.block_pad);
    // u alternates between two buffers: the named barrier of item k + 1
    // orders every pass-2 read of item k before item k + 2's pass-1 writes
    float* u = u2 + (k & 1) * bw;
    // pass 1: u_i = sum_{q <= i} W[q, i] r_q (column i, down to the diagonal)
    if (i < bw) u[i] = dot(W + i, bw, rl, i + 1, ident);
    consumers_sync(consumers);
    // pass 2: t_i = sum_{j >= i} W[i, j] u_j (row i, from the diagonal up or
    // from the last column down)
    float t = 0.f;
    if (i < bw)
      t = down ? dot(W + (size_t)i * bw, 1, u, bw - i, from_last)
               : dot(W + (size_t)i * bw + i, 1, u + i, bw - i, ident);
    mbar_arrive(&g.empty[stage]);
    if (i < bw) epilogue_store(d, e, c1 != nullptr, t);
    if (++stage == stages) {
      stage = 0;
      ++round;
    }
  }
}

// ---- the two-sweep K3 (blocks too wide for a cluster)

// The two-sweep producer's in-kernel load path, for panels the bulk copy
// cannot take (a block whose bytes are not a multiple of 16): each lane
// issues asynchronous copies in the widest
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

// ---- the panel and cluster kernels

// The sums over a warp's 32 lanes of its 4 row sums a0..a3: returns, at
// lane l, the total of row (l >> 3) & 3.  A transposed reduction: the lane
// pairs 16 apart swap two rows each, the pairs 8 apart one, then the eight
// lanes of an octet hold one row and finish it in 3 steps (6 shuffles in
// all, against 20 for four separate reductions).
__device__ __forceinline__ float warp_row_sums(float a0, float a1, float a2, float a3, int lane) {
  const bool h16 = lane & 16;
  float k0 = h16 ? a2 : a0;
  float k1 = h16 ? a3 : a1;
  k0 += __shfl_xor_sync(0xffffffffu, h16 ? a0 : a2, 16);
  k1 += __shfl_xor_sync(0xffffffffu, h16 ? a1 : a3, 16);
  const bool h8 = lane & 8;
  float v = h8 ? k1 : k0;
  v += __shfl_xor_sync(0xffffffffu, h8 ? k0 : k1, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// One consumer warp's 4 rows of a panel against a vector: lane l sums
// columns c0 + l, c0 + l + 32, ... below bw of rows w0..w3 (row pointers
// into shared memory) times v, then `warp_row_sums`
template <typename TB>
__device__ __forceinline__ float warp_rows_dot(const TB* w0, const TB* w1, const TB* w2,
                                               const TB* w3, const float* v, int c0, int bw,
                                               int lane) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int c = c0 + lane; c < bw; c += 32) {
    const float x = v[c];
    a0 = fmaf(widen(w0[c]), x, a0);
    a1 = fmaf(widen(w1[c]), x, a1);
    a2 = fmaf(widen(w2[c]), x, a2);
    a3 = fmaf(widen(w3[c]), x, a3);
  }
  return warp_row_sums(a0, a1, a2, a3, lane);
}

// block row i's offset within its line of the (bs, N, m) vectors
__device__ __forceinline__ int line_row_off(int i, int m, int S) { return (i / m) * S * m + i % m; }

// warp 0 of the panel kernel: fill the ring with this CTA's units (item,
// panel): each stage gets r's line (4-byte cp.async, 32 arrivals) and the
// panel (`panel_copy`, 32 arrivals)
template <typename TB>
__device__ __forceinline__ void produce_panels(const Ring<PanelLayout>& g,
                                               const TB* __restrict__ blocks,
                                               const float* __restrict__ r, int m, int nt, int S,
                                               int units, int rows, int panels) {
  const int lane = threadIdx.x;
  const int bw = nt * m;
  int stage = 0;
  uint32_t round = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    if (round > 0) mbar_wait(&g.empty[stage], (round - 1) & 1);
    const int it = u / panels;
    const int p0 = (u - it * panels) * rows;
    const int b = it / S;
    const int s = it - b * S;
    unsigned char* st = g.stage0 + (size_t)stage * g.L.stage_bytes;
    float* rl = reinterpret_cast<float*>(st + g.L.r_off);
    const float* rb = r + ((size_t)b * nt * S + s) * m;  // line s, block row 0
    for (int j = lane; j < bw; j += 32) cp_async4(rl + j, rb + line_row_off(j, m, S));
    cp_async_arrive_noinc(&g.full[stage]);
    const int n = min(rows, bw - p0);
    panel_copy(st, blocks + ((size_t)it * bw + p0) * bw, (uint32_t)((size_t)n * bw * sizeof(TB)),
               lane, &g.full[stage]);
    if (++stage == g.stages) {
      stage = 0;
      ++round;
    }
  }
  // the warp leaves only once its own copies have landed
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <typename TB>
__global__ void __launch_bounds__(32 + 32 * kPanelMaxRows / kRowsPerWarp, 3)
    k2_line_block_apply_panels(const TB* __restrict__ binv, const float* __restrict__ r, float* d,
                               const float* c1, const float* c2, int m, int nt, int S, int units,
                               int rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bw = nt * m;
  const int consumers = blockDim.x - 32;
  const PanelLayout L = make_panel_layout(bw, rows, stages, sizeof(TB));
  // full: 32 arrivals for r, 32 for the panel (bulk = false sets 32 + 32)
  const Ring<PanelLayout> g = ring_setup(smem, L, stages, consumers, false);
  const int panels = (bw + rows - 1) / rows;
  if (threadIdx.x < 32) {
    produce_panels<TB>(g, binv, r, m, nt, S, units, rows, panels);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int q0 = ((threadIdx.x >> 5) - 1) * kRowsPerWarp;  // the warp's first panel row
  const int q = q0 + (lane >> 3);                         // the row this lane ends with
  const bool owner = (lane & 7) == 0;
  int stage = 0;
  uint32_t round = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int it = u / panels;
    const int p0 = (u - it * panels) * rows;
    const int b = it / S;
    const int s = it - b * S;
    const int n = min(rows, bw - p0);
    const bool live = owner && q < n;
    Epilogue e{};
    if (live) e = epilogue_fetch(d, c1, c2, b, s, line_row_off(p0 + q, m, S), m, nt, S);
    mbar_wait(&g.full[stage], round & 1);
    const unsigned char* st = g.stage0 + (size_t)stage * L.stage_bytes;
    const TB* pan =
        reinterpret_cast<const TB*>(st + panel_shift(binv + ((size_t)it * bw + p0) * bw));
    // a row past the panel's last is read (within the stage) and dropped
    const auto row = [&](int k) { return pan + (size_t)min(q0 + k, n - 1) * bw; };
    const float t = warp_rows_dot(row(0), row(1), row(2), row(3),
                                  reinterpret_cast<const float*>(st + L.r_off), 0, bw, lane);
    mbar_arrive(&g.empty[stage]);
    if (live) epilogue_store(d, e, c1 != nullptr, t);
    if (++stage == stages) {
      stage = 0;
      ++round;
    }
  }
}

// warp 0 of a cluster CTA: fill the ring with its packed rows [i0, i0 + n)
// of the cluster's items (one contiguous span of `entries`, a multiple of
// 8), and their entries of r (4-byte cp.async, 32 arrivals).  The span goes
// to the stage's start by one bulk copy where it is 16-byte aligned (every
// span is, on a 16-byte-aligned W); else the lanes copy it entry by entry
// (32 arrivals either way)
__device__ __forceinline__ void produce_cluster(const Ring<ClusterLayout>& g,
                                                const __nv_bfloat16* __restrict__ w,
                                                const float* __restrict__ r, const int* loff,
                                                int m, int nt, int S, int items, int i0, int n,
                                                int entries, ClusterPos cp) {
  const int lane = threadIdx.x;
  const int bw = nt * m;
  const size_t per_block = (size_t)packed_off(bw, bw);
  const size_t first = (size_t)packed_off(bw, i0);
  const uint32_t bytes = (uint32_t)entries * sizeof(__nv_bfloat16);
  int stage = 0;
  uint32_t round = 0;
  for (int it = cp.id; it < items; it += cp.count) {
    if (round > 0) mbar_wait(&g.empty[stage], (round - 1) & 1);
    const int b = it / S;
    const int s = it - b * S;
    unsigned char* st = g.stage0 + (size_t)stage * g.L.stage_bytes;
    float* rl = reinterpret_cast<float*>(st + g.L.r_off);
    const float* rb = r + ((size_t)b * nt * S + s) * m;
    for (int j = lane; j < n; j += 32) cp_async4(rl + j, rb + loff[j]);
    cp_async_arrive_noinc(&g.full[stage]);
    const __nv_bfloat16* src = w + (size_t)it * per_block + first;
    if (panel_shift(src) == 0) {
      if (lane == 0 && bytes) {
        mbar_arrive_expect_tx(&g.full[stage], bytes);
        bulk_g2s(st, src, bytes, &g.full[stage]);
      } else {
        mbar_arrive(&g.full[stage]);
      }
    } else {
      const uint16_t* s2 = reinterpret_cast<const uint16_t*>(src);
      uint16_t* d2 = reinterpret_cast<uint16_t*>(st);
      for (int e = lane; e < entries; e += 32) d2[e] = s2[e];
      // a later bulk copy into this stage (async proxy) follows these stores
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&g.full[stage]);
    }
    if (++stage == g.stages) {
      stage = 0;
      ++round;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// a += the 4 bf16 entries of x, y (two words of a packed row) times v
__device__ __forceinline__ float dot4(uint32_t x, uint32_t y, float4 v, float a) {
  a = fmaf(__uint_as_float(x << 16), v.x, a);
  a = fmaf(__uint_as_float(x & 0xffff0000u), v.y, a);
  a = fmaf(__uint_as_float(y << 16), v.z, a);
  return fmaf(__uint_as_float(y & 0xffff0000u), v.w, a);
}

// acc[0..7] += the 8 bf16 entries of e times x
__device__ __forceinline__ void axpy8(uint4 e, float x, float* acc) {
  acc[0] = fmaf(__uint_as_float(e.x << 16), x, acc[0]);
  acc[1] = fmaf(__uint_as_float(e.x & 0xffff0000u), x, acc[1]);
  acc[2] = fmaf(__uint_as_float(e.y << 16), x, acc[2]);
  acc[3] = fmaf(__uint_as_float(e.y & 0xffff0000u), x, acc[3]);
  acc[4] = fmaf(__uint_as_float(e.z << 16), x, acc[4]);
  acc[5] = fmaf(__uint_as_float(e.z & 0xffff0000u), x, acc[5]);
  acc[6] = fmaf(__uint_as_float(e.w << 16), x, acc[6]);
  acc[7] = fmaf(__uint_as_float(e.w & 0xffff0000u), x, acc[7]);
}

__global__ void __launch_bounds__(32 + 32 * kClusterWarps, 2)
    k3_factored_line_block_apply_cluster(const __nv_bfloat16* __restrict__ w,
                                         const float* __restrict__ r, float* d, const float* c1,
                                         const float* c2, int m, int nt, int S, int items,
                                         int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bw = nt * m;
  const int chunks = pad8(bw) / 8;  // a row's 8-entry chunks, its first at (its row) / 8
  const int consumers = blockDim.x - 32;
  const ClusterPos cp = cluster_pos();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ready = bars + 2 * stages;  // the other CTAs' signals, by item parity
  // CTA c's first row (row0[C] = bw), and the offsets of this CTA's rows
  // within their line: where they lie does not depend on the split
  const ClusterLayout L0 = make_cluster_layout(bw, ClusterSplit{0, 0}, stages);
  int* row0 = reinterpret_cast<int*>(smem + L0.row0_off);
  int* loff = reinterpret_cast<int*>(smem + L0.loff_off);
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(&bars[k], 64);  // full: 32 arrivals for r, 32 for the rows
      mbar_init(&bars[stages + k], consumers);
    }
    mbar_init(&ready[0], cp.size - 1);
    mbar_init(&ready[1], cp.size - 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  if (threadIdx.x <= cp.size) row0[threadIdx.x] = cluster_row0(bw, cp.size, threadIdx.x);
  {
    const int a = cluster_row0(bw, cp.size, cp.rank), z = cluster_row0(bw, cp.size, cp.rank + 1);
    for (int t = threadIdx.x; t < z - a; t += blockDim.x) loff[t] = line_row_off(a + t, m, S);
  }
  // every CTA's barriers are initialised before any remote arrive (and the
  // split and the offsets are in place)
  cluster_sync();
  ClusterSplit sp{0, 0};  // `cluster_split`, from the table
  for (uint32_t c = 0; c < cp.size; ++c) {
    sp.emax = max(sp.emax, (int)(packed_off(bw, row0[c + 1]) - packed_off(bw, row0[c])));
    sp.nmax = max(sp.nmax, row0[c + 1] - row0[c]);
  }
  const ClusterLayout L = make_cluster_layout(bw, sp, stages);
  const Ring<ClusterLayout> g{bars, bars + stages, smem + L.stage_off, L, stages};
  const int i0 = row0[cp.rank];         // this CTA's first block row
  const int n = row0[cp.rank + 1] - i0;  // and its rows
  const int base = (int)packed_off(bw, i0);
  if (threadIdx.x < 32) {
    produce_cluster(g, w, r, loff, m, nt, S, items, i0, n, (int)packed_off(bw, i0 + n) - base,
                    cp);
  } else {
    float* part = reinterpret_cast<float*>(smem + L.part_off);
    float* u = reinterpret_cast<float*>(smem + L.u_off);
    float* dold = reinterpret_cast<float*>(smem + L.dold_off);
    float* sums = reinterpret_cast<float*>(smem + L.sums_off);
    const int q = threadIdx.x - 32;
    const int lane = threadIdx.x & 31;
    const int warp = q >> 5;
    const int bwp = 8 * chunks;
    const int j0 = 8 * (i0 / 8);  // the first column of this CTA's chunks
    // where row i's chunk i / 8 starts in the CTA's span (packed_off, in int)
    const auto row_at = [&](int i) {
      const int gi = i >> 3, ri = i & 7;
      return 8 * gi * bwp - 32 * gi * (gi - 1) + ri * (bwp - 8 * gi) - base;
    };
    int stage = 0;
    uint32_t round = 0;
    int k = 0;
    for (int it = cp.id; it < items; it += cp.count, ++k) {
      const int b = it / S;
      const int s = it - b * S;
      const size_t line = ((size_t)b * nt * S + s) * m;
      // d's old entries of this CTA's rows, and the coefficients, before the
      // wait; dold and part alternate by item (the barriers of item k + 1
      // order item k's reads before item k + 2's writes)
      float* dk = dold + (k & 1) * sp.nmax;
      float* pk = part + (k & 1) * bwp;
      const float a1 = c1 ? c1[b] : 0.f;
      const float a2 = c2 ? c2[b] : 1.f;
      if (c1)
        for (int t = q; t < n; t += consumers) dk[t] = d[line + loff[t]];
      mbar_wait(&g.full[stage], round & 1);
      const unsigned char* st = g.stage0 + (size_t)stage * L.stage_bytes;
      // chunk ch (columns 8 ch to 8 ch + 7) of row i >= i0 at
      // Wc[row_at(i) / 8 + ch - i / 8], 16-byte aligned
      const uint4* Wc = reinterpret_cast<const uint4*>(st);
      const float* rl = reinterpret_cast<const float*>(st + L.r_off);
      // sweep 1: this CTA's part of u_j = sum_{i <= j} W[i, j] r_i for the
      // columns j >= j0.  Warp v takes the rows i0 + v, i0 + v + 8, ..., lane
      // l the chunk c0 + l of each pass of 32 chunks from j0 / 8 (8 sums a
      // lane, one 16-byte load a row); the warps' sums go to their rows of
      // `sums`, then each column's thread adds them in warp order
      for (int c0 = j0 / 8; c0 < chunks; c0 += 32) {
        const int ch = c0 + lane;
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const int end = min(i0 + n, 8 * (c0 + 32));  // later rows start past the pass
        // without branches, so that the loads of several rows are in flight:
        // a lane off its row's chunks reads the span's first and adds 0 times
        // it.  Row i's chunk ch at Wc[at + ch], at = row_at(i) / 8 - i / 8,
        // which grows by bwp - i - 1 from row i to row i + 8
        static_assert(kClusterWarps == 8, "a warp's rows step by 8, one group of 8 rows");
        int i = i0 + warp;
        int at = (row_at(i) >> 3) - (i >> 3);
#pragma unroll 4
        for (; i < end; i += kClusterWarps) {
          const bool on = ch >= (i >> 3) && ch < chunks;
          const uint4 e = Wc[(at + ch) * on];
          axpy8(e, on ? rl[i - i0] : 0.f, acc);
          at += bwp - i - 1;
        }
        if (ch < chunks) {
          float4* o = reinterpret_cast<float4*>(sums + warp * bwp + 8 * ch);
          o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
          o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
        }
      }
      consumers_sync(consumers);
      for (int j = j0 + 4 * q; j < bwp; j += 4 * consumers) {
        float4 v = reinterpret_cast<const float4*>(sums + j)[0];
#pragma unroll
        for (int v_ = 1; v_ < kClusterWarps; ++v_) {
          const float4 x = reinterpret_cast<const float4*>(sums + v_ * bwp + j)[0];
          v.x += x.x;
          v.y += x.y;
          v.z += x.z;
          v.w += x.w;
        }
        reinterpret_cast<float4*>(pk + j)[0] = v;
      }
      consumers_sync(consumers);
      // each other CTA's signal from a thread of its own, the last ones (a
      // cluster-scope release waits for the thread's own stores, and the
      // last threads hold no row of sweep 2 where the CTA's rows are fewer)
      const int to = consumers - 1 - q;
      if (to < (int)cp.size && to != (int)cp.rank) mbar_arrive_remote(&ready[k & 1], to);
      mbar_wait_cluster(&ready[k & 1], (k >> 1) & 1);
      // u_j: the partials of the CTAs whose chunks start at or before j, in
      // rank order (every CTA sums them alike; a CTA's partial is 0 left of
      // its first row), the loads in flight together
      for (int j = j0 + q; j < bwp; j += consumers) {
        float x[kMaxCluster];
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c)
          x[c] = c >= (int)cp.size || 8 * (row0[c] / 8) > j ? 0.f
                 : c == (int)cp.rank                       ? pk[j]
                                                           : ld_cluster(cluster_addr(pk + j, c));
        float v = x[0];
#pragma unroll
        for (int c = 1; c < kMaxCluster; ++c) v += x[c];
        u[j] = v;
      }
      consumers_sync(consumers);
      // sweep 2: t_i = sum_{j >= i} W[i, j] u_j, a thread a row (no
      // reduction across lanes), over its chunks from i / 8 on (what limits
      // it is the instructions a chunk, not the banks: the 8 rows of a group
      // read one u chunk, a broadcast, and their W chunks a row apart)
      const float4* u4 = reinterpret_cast<const float4*>(u);
      for (int li = q; li < n; li += consumers) {
        const int i = i0 + li, f = i >> 3;
        const uint4* wr = Wc + ((row_at(i) >> 3) - f);  // chunk ch at wr[ch]
        float s0 = 0.f, s1 = 0.f;
#pragma unroll 2
        for (int ch = f; ch < chunks; ++ch) {
          const uint4 e = wr[ch];
          const float4 v0 = u4[2 * ch], v1 = u4[2 * ch + 1];
          s0 = dot4(e.x, e.y, v0, s0);
          s1 = dot4(e.z, e.w, v1, s1);
        }
        const Epilogue e{line + loff[li], a1, a2, c1 ? dk[li] : 0.f};
        epilogue_store(d, e, c1 != nullptr, s0 + s1);
      }
      mbar_arrive(&g.empty[stage]);
      if (++stage == stages) {
        stage = 0;
        ++round;
      }
    }
  }
  // no CTA leaves while another may still read its partials
  cluster_sync();
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

// Check the launch geometry against the shapes and the layout of the kernel
// it takes (`route_of`); returns a CUDA error code (0 if the launch may go
// ahead)
int check_launch(const void* blocks, int m, int nt, int S, int bs, int ctas, int rows,
                 int stages, int smem_bytes, int flags, int esize, bool factored) {
  if (m < 1 || nt < 1 || S < 1 || bs < 1 || ctas < 1 || stages < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)bs * S > 0x7fffffff || (long long)nt * S * m > 0x7fffffff)
    return (int)cudaErrorInvalidValue;  // item and row offsets are int
  const int bw = nt * m;
  if (rows > bw) return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(blocks) & 15) == 0;
  const int panels = (bw + rows - 1) / rows;
  switch (route_of(bw, rows, factored)) {
    case kStreamed: {
      // `whole` only where every block is 16-byte aligned; the walk in range
      const bool whole = flags & kWhole;
      const Layout L = make_layout(bw, stages, esize, factored, whole);
      if (32 + (rows + 31) / 32 * 32 > 1024 || (size_t)smem_bytes != L.total)
        return (int)cudaErrorInvalidValue;
      if (whole && (L.block_bytes % 16 != 0 || !aligned)) return (int)cudaErrorInvalidValue;
      if ((reinterpret_cast<uintptr_t>(blocks) & (esize - 1)) != 0 ||
          flags_walk(flags) > (factored ? 1 : 64))
        return (int)cudaErrorInvalidValue;
      return 0;
    }
    case kPanels:
      // units (item, panel) are int; the panel's entries are 2-byte aligned
      if (rows > kPanelMaxRows || (long long)bs * S * panels > 0x7fffffff ||
          (reinterpret_cast<uintptr_t>(blocks) & 1) != 0 ||
          (size_t)smem_bytes != make_panel_layout(bw, rows, stages, esize).total)
        return (int)cudaErrorInvalidValue;
      return 0;
    case kCluster:
      // whole clusters of C = panels CTAs, each CTA's share of the packed
      // triangle (`cluster_row0`) in the layout
      if (ctas % panels != 0 || (reinterpret_cast<uintptr_t>(blocks) & 1) != 0 ||
          (size_t)smem_bytes != make_cluster_layout(bw, cluster_split(bw, panels), stages).total)
        return (int)cudaErrorInvalidValue;
      return 0;
    case kTwoSweep:
      break;
  }
  // r's buffer for item k is rewritten once a panel of item k - 1 is released
  if (32 + (rows + 31) / 32 * 32 > 1024 || 2 * panels < stages) return (int)cudaErrorInvalidValue;
  const TiledLayout L = make_tiled_layout(bw, rows, stages, esize, factored);
  if ((size_t)smem_bytes != L.total) return (int)cudaErrorInvalidValue;
  if ((flags & kWhole) &&
      (((size_t)bw * bw * esize) % 16 != 0 || ((size_t)rows * bw * esize) % 16 != 0 || !aligned))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// raise a kernel's dynamic shared-memory limit when the launch needs more
// than the default 48 KiB (once per size and kernel)
template <typename K>
cudaError_t allow_smem(K kernel, int* allowed, int smem_bytes) {
  if (smem_bytes > 48 * 1024 && smem_bytes > *allowed) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
    *allowed = smem_bytes;
  }
  return cudaSuccess;
}

// raise the kernel's shared-memory limit if needed, then launch it
template <typename K, typename... Args>
int launch(K kernel, int* allowed, int ctas, int threads, int smem_bytes, void* stream,
           Args... args) {
  cudaError_t e = allow_smem(kernel, allowed, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<ctas, threads, smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// the cluster kernel's launch configuration for `clusters` clusters of
// `csize` CTAs (attr: the one attribute it needs, the cluster's shape)
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int clusters, int csize,
                                         int smem_bytes, void* stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * clusters);
  cfg.blockDim = dim3(32 + 32 * kClusterWarps);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of `csize` CTAs of `smem_bytes` that the card holds at once
// (cudaOccupancyMaxActiveClusters, asked once per cluster size and
// shared-memory size); none is an error
int active_clusters(int csize, int smem_bytes, int* n) {
  static int allowed = 0, active[kMaxCluster + 1] = {}, active_smem[kMaxCluster + 1] = {};
  if (csize < 2 || csize > kMaxCluster) return (int)cudaErrorInvalidValue;
  if (active_smem[csize] != smem_bytes) {
    cudaError_t e = allow_smem(k3_factored_line_block_apply_cluster, &allowed, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(attr, 1, csize, smem_bytes, nullptr);
    e = cudaOccupancyMaxActiveClusters(&active[csize], k3_factored_line_block_apply_cluster,
                                       &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active[csize] < 1) return (int)cudaErrorInvalidConfiguration;
    active_smem[csize] = smem_bytes;
  }
  *n = active[csize];
  return 0;
}

// launch the cluster kernel in clusters of `csize` CTAs: at most `clusters`,
// and no more than the card holds at once, so that no cluster of the
// persistent grid waits for another to end
template <typename... Args>
int launch_cluster(int clusters, int csize, int smem_bytes, void* stream, Args... args) {
  int active = 0;
  const int code = active_clusters(csize, smem_bytes, &active);
  if (code) return code;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(attr, min(clusters, active), csize, smem_bytes, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k3_factored_line_block_apply_cluster, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K2 (FACTORED false, B^-1 in TB) or K3 (true, W in bf16): the kernel of
// `route_of` for the shape
template <typename TB, bool FACTORED>
int line_block_launch(const TB* blocks, const float* r, float* d, const float* c1,
                      const float* c2, int m, int nt, int S, int bs, int ctas, int rows,
                      int stages, int smem_bytes, int flags, void* stream) {
  static int allowed = 0, allowed_tiled = 0;
  int code = check_launch(blocks, m, nt, S, bs, ctas, rows, stages, smem_bytes, flags,
                          sizeof(TB), FACTORED);
  if (code) return code;
  const int bw = nt * m;
  const int items = bs * S;
  const int panels = (bw + rows - 1) / rows;
  const Route route = route_of(bw, rows, FACTORED);
  if constexpr (FACTORED) {
    if (route == kCluster)
      return launch_cluster(ctas / panels, panels, smem_bytes, stream, blocks, r, d, c1, c2, m,
                            nt, S, items, stages);
    if (route == kTwoSweep)
      return launch(k3_factored_line_block_apply_tiled, &allowed_tiled, ctas,
                    32 + (rows + 31) / 32 * 32, smem_bytes, stream, blocks, r, d, c1, c2, m, nt,
                    S, items, rows, stages, flags & kWhole);
    return launch(k3_factored_line_block_apply, &allowed, ctas, 32 + (rows + 31) / 32 * 32,
                  smem_bytes, stream, blocks, r, d, c1, c2, m, nt, S, items, stages, flags);
  } else {
    if (route == kPanels)
      return launch(k2_line_block_apply_panels<TB>, &allowed_tiled, ctas,
                    32 + 32 * ((rows + kRowsPerWarp - 1) / kRowsPerWarp), smem_bytes, stream,
                    blocks, r, d, c1, c2, m, nt, S, items * panels, rows, stages);
    return launch(k2_line_block_apply<TB>, &allowed, ctas, 32 + (rows + 31) / 32 * 32,
                  smem_bytes, stream, blocks, r, d, c1, c2, m, nt, S, items, stages, flags);
  }
}

}  // namespace

extern "C" {

// ctas, rows, stages, smem_bytes and flags: the launch geometry of
// ops/fused_smoother.line_block_geometry (flags: bit 0 `whole`, every block
// 16-byte aligned; the streamed kernels' column walk above it); the kernel
// follows from the launch's rows (`route_of`): rows == nt * m the streamed
// one, else a row-tiled one
int k2_line_block_apply_f32(const float* binv, const float* r, float* d, const float* c1,
                            const float* c2, int m, int nt, int S, int bs, int ctas, int rows,
                            int stages, int smem_bytes, int flags, void* stream) {
  return line_block_launch<float, false>(binv, r, d, c1, c2, m, nt, S, bs, ctas, rows, stages,
                                         smem_bytes, flags, stream);
}

// bf16 B^-1, f32 vectors
int k2_line_block_apply_bf16(const __nv_bfloat16* binv, const float* r, float* d,
                             const float* c1, const float* c2, int m, int nt, int S, int bs,
                             int ctas, int rows, int stages, int smem_bytes, int flags,
                             void* stream) {
  return line_block_launch<__nv_bfloat16, false>(binv, r, d, c1, c2, m, nt, S, bs, ctas, rows,
                                                  stages, smem_bytes, flags, stream);
}

// bf16 upper-triangular W (packed on the cluster route), f32 vectors
int k3_factored_line_block_apply_bf16(const __nv_bfloat16* w, const float* r, float* d,
                                      const float* c1, const float* c2, int m, int nt, int S,
                                      int bs, int ctas, int rows, int stages, int smem_bytes,
                                      int flags, void* stream) {
  return line_block_launch<__nv_bfloat16, true>(w, r, d, c1, c2, m, nt, S, bs, ctas, rows,
                                                 stages, smem_bytes, flags, stream);
}

// the clusters of `csize` CTAs with `smem_bytes` of shared memory each that
// the card holds at once (the cluster kernel's grid is capped at it); a
// negative CUDA error code if the query fails
int k3_cluster_occupancy(int csize, int smem_bytes) {
  int n = 0;
  const int code = active_clusters(csize, smem_bytes, &n);
  return code ? -code : n;
}

const char* k2_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
