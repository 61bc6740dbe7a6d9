// K1: block-stencil normal-operator apply y = (A^T A) x, batched over samples.
//
// Replaces the TPU kernel of mech_nn_discovery_pde_tpu/ops/normal_stencil.py,
// `_stencil_kernel_body` (:404-419) launched by `_pallas_single` (:422-444),
// and its sample-batched form `pallas_apply_batched` in
// benchmarks/pallas_grid_batched.py (:35-80).  The TPU kernel holds a whole
// sample in VMEM and scatters each band both ways; here every thread gathers
// the outputs of its own points, so no two threads write one value.
//
// Operands (one sample b of bs):
//   coef  (bs, NC, N)   channel-major assembled stencil: channels 0..M*M-1
//                       hold the dense offset-0 block (row-major), then per
//                       axis c and offset d = 1..4 the band channels
//                       vv, vd_k, dv_k (k over the axis's derivative indices)
//   x     (bs, N, M)    flat point-major solver vector (index p*M + i)
//
// For a band of flat stride s = d * stride_c with channel ci at p and cj at
// p + s (vv: 0, 0; vd_k: 0, mik; dv_k: mik, 0) the thread of point p adds
//   y[ci] += g(p)   x[p+s, cj]   (p + s < N)
//   y[cj] += g(p-s) x[p-s, ci]   (p >= s)
// The assembled band fields are zero wherever p + s crosses an axis edge,
// which makes this exact on the C-order flat grid.
//
// Epilogue (one launch per Chebyshev step's stencil half):
//   out = rin - y   if rin != nullptr, else out = y
//   xout = xin + x  if xout != nullptr (xin == nullptr reads as zero)
// out may alias rin and xout may alias xin: each thread reads its run of
// rin and xin before it writes the same run of out and xout, and touches no
// other run of them.  Neither may alias x, which is read at neighbours.
//
// Stored types (the JAX package's mg_precond_dtype): coef f32 or f64 with
// vectors of the same type, or bf16 with f32 vectors ('bf16' mode).  A bf16
// coefficient is widened to f32 in registers as it is loaded, and every sum
// is taken in the vector type.
//
// What bounds it on an H100: bytes.  Each point has its own M x M block and
// its own band coefficients, NC values read once, at about two flops per
// value: 0.5 flop per byte in f32, against the card's 20.  The least time is
// (NC*sizeof(coef) + 2*M*sizeof(x)) * N * bs bytes over the memory rate.
// The design keeps the memory system busy and re-reads nothing from DRAM:
//
// - Compile-time layout.  The kernel is a template on (NCOORD, ORDER), so
//   M = 1 + NCOORD*ORDER and every channel index is a constant: band
//   (c, d, vv | vd_k | dv_k) lives at channel
//   M*M + (4c + d - 1)(1 + 2 ORDER) + (0 | 1 + 2k | 2 + 2k), the layout
//   `make_desc` builds, which the wrapper checks once per descriptor
//   (ops/normal_stencil.k1_layout_args).  The axis, offset and derivative
//   loops unroll fully, every per-thread array is indexed by constants and
//   stays in registers, and there is no band table, shared memory or
//   barrier.  The last axis has flat stride 1, so its offsets are constants
//   too; the other axes' strides are arguments.
// - Wide loads.  A thread takes P consecutive points (ops/normal_stencil.
//   stencil_geometry picks P and the grid): each coefficient read is one
//   P-value load along a channel's row (16 bytes in f32 and f64, 8 in bf16,
//   coalesced across the warp), its own P*M values of x are 16-byte loads,
//   and neighbour runs at p +- s are 16-byte loads where s is a multiple of
//   P, one value per load otherwise.  Along the last axis the P + 8 points
//   p0 - 4 .. p0 + P + 3 are read once for all four offsets, and the
//   backward coefficients at p - d come from the aligned P-value load just
//   below p0 beside the forward one at p0.  With P = 1 the thread reads only
//   the 1 + ORDER channels it uses at each neighbour.
// - A grid that fills the card.  128 threads a CTA; P > 1 only where the
//   rows allow it (N % P == 0, 16-byte aligned operands) and the grid then
//   still gives every SM two CTAs, else P = 1 (GL level 1: 512 CTAs).
// x is not staged in shared memory: the neighbour reads at p +- s hit L1
// for the short strides and L2 for the time axis.
//
// `nvcc -Xptxas -v` (CUDA 12.8, sm_90a): all 36 instantiations (3 stored
// types x 6 layouts x 2 point widths) use a 0-byte stack frame and spill
// nothing.  Registers at GL's layout (3, 2): f32 177 (P 4) and 72 (P 1),
// bf16 fields 164 and 72, f64 178 (P 2) and 96; 46-146 at the others.
// chip_smoke.py checks the stack and spills at every build.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per CTA (ops/normal_stencil.K1_THREADS)
constexpr int kMaxDelta = 4;   // largest axis offset of a band

// ---- loads ------------------------------------------------------------------

template <int n>
struct Int {};

// n consecutive coefficients at p (aligned to n values), widened into d
__device__ __forceinline__ void ld_coef(const float* p, float* d, Int<1>) { d[0] = __ldg(p); }
__device__ __forceinline__ void ld_coef(const float* p, float* d, Int<4>) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
}
__device__ __forceinline__ void ld_coef(const double* p, double* d, Int<1>) { d[0] = __ldg(p); }
__device__ __forceinline__ void ld_coef(const double* p, double* d, Int<2>) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  d[0] = v.x, d[1] = v.y;
}
__device__ __forceinline__ void ld_coef(const __nv_bfloat16* p, float* d, Int<1>) {
  d[0] = __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void ld_coef(const __nv_bfloat16* p, float* d, Int<4>) {
  // four bf16 in one 8-byte load; a bf16 is the high half of its f32
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  d[0] = __uint_as_float(v.x << 16), d[1] = __uint_as_float(v.x & 0xffff0000u);
  d[2] = __uint_as_float(v.y << 16), d[3] = __uint_as_float(v.y & 0xffff0000u);
}

// 16-byte vector of a vector type
template <typename T>
struct V16;
template <>
struct V16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const float4& v, float* d) { d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w; }
  __device__ static float4 pack(const float* s) { return make_float4(s[0], s[1], s[2], s[3]); }
};
template <>
struct V16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void unpack(const double2& v, double* d) { d[0] = v.x, d[1] = v.y; }
  __device__ static double2 pack(const double* s) { return make_double2(s[0], s[1]); }
};

// A run of R values of x at p: 16-byte loads when VEC (p 16-byte aligned and
// R a multiple of the vector), else one value per load.  RO: through the
// read-only path (x is never written by the launch).
template <bool VEC, bool RO, int R, typename T>
__device__ __forceinline__ void ld_run(const T* p, T* d) {
  if constexpr (VEC) {
    using V = V16<T>;
#pragma unroll
    for (int i = 0; i < R; i += V::n) {
      const typename V::type* q = reinterpret_cast<const typename V::type*>(p + i);
      V::unpack(RO ? __ldg(q) : *q, d + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) d[i] = RO ? __ldg(p + i) : p[i];
  }
}

template <bool VEC, int R, typename T>
__device__ __forceinline__ void st_run(T* p, const T* s) {
  if constexpr (VEC) {
    using V = V16<T>;
#pragma unroll
    for (int i = 0; i < R; i += V::n) *reinterpret_cast<typename V::type*>(p + i) = V::pack(s + i);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = s[i];
  }
}

// ---- the kernel -------------------------------------------------------------

template <int NCOORD, int ORDER>
struct Layout {
  static constexpr int M = 1 + NCOORD * ORDER;  // unknowns per point
  static constexpr int NB = 1 + 2 * ORDER;      // band channels per (axis, offset)
  static constexpr int NC = M * M + NCOORD * kMaxDelta * NB;
  static constexpr int NV = 1 + ORDER;          // x channels a band reads: 0, mik
  // first channel of axis c's bands at offset d
  __host__ __device__ static constexpr int band(int c, int d) { return M * M + (c * kMaxDelta + d - 1) * NB; }
  // mi index of axis c's k-th derivative (central_mi_indices(c)[k])
  __host__ __device__ static constexpr int mi(int c, int k) { return 1 + c + k * NCOORD; }
};

// y at point q += the forward terms of axis C's bands at one offset:
// g[n] the NB coefficients at q, v[0 | 1 + k] = x[q + s, 0 | mik]
template <int NCOORD, int ORDER, int C, typename T>
__device__ __forceinline__ void add_forward(T* yq, const T* g, const T* v) {
  using L = Layout<NCOORD, ORDER>;
  T acc = g[0] * v[0];  // vv
#pragma unroll
  for (int k = 0; k < ORDER; ++k) {
    acc += g[1 + 2 * k] * v[1 + k];                 // vd_k: y[0]   += g x[q+s, mik]
    yq[L::mi(C, k)] += g[2 + 2 * k] * v[0];         // dv_k: y[mik] += g x[q+s, 0]
  }
  yq[0] += acc;
}

// y at point q += the backward terms: h[n] the NB coefficients at q - s,
// v[0 | 1 + k] = x[q - s, 0 | mik]
template <int NCOORD, int ORDER, int C, typename T>
__device__ __forceinline__ void add_backward(T* yq, const T* h, const T* v) {
  using L = Layout<NCOORD, ORDER>;
  T acc = h[0] * v[0];  // vv
#pragma unroll
  for (int k = 0; k < ORDER; ++k) {
    acc += h[2 + 2 * k] * v[1 + k];                 // dv_k: y[0]   += h x[q-s, mik]
    yq[L::mi(C, k)] += h[1 + 2 * k] * v[0];         // vd_k: y[mik] += h x[q-s, 0]
  }
  yq[0] += acc;
}

// v = x[pt, 0 | mik(C, k)], zero where !ok
template <int NCOORD, int ORDER, int C, typename T>
__device__ __forceinline__ void ld_picks(const T* xb, int pt, bool ok, T* v) {
  using L = Layout<NCOORD, ORDER>;
  const T* q = xb + (size_t)pt * L::M;
  v[0] = ok ? __ldg(q) : T(0);
#pragma unroll
  for (int k = 0; k < ORDER; ++k) v[1 + k] = ok ? __ldg(q + L::mi(C, k)) : T(0);
}

// v[q] = x[a + q, 0 | mik(C, k)] for the P points of the aligned run at a
// (one 16-byte load after another over its P*M values), zero where !ok
template <int NCOORD, int ORDER, int C, int P, typename T>
__device__ __forceinline__ void ld_run_picks(const T* xb, int a, bool ok, T (*v)[Layout<NCOORD, ORDER>::NV]) {
  using L = Layout<NCOORD, ORDER>;
  T run[P * L::M];
  if (ok) {
    ld_run<true, true, P * L::M>(xb + (size_t)a * L::M, run);
  } else {
#pragma unroll
    for (int i = 0; i < P * L::M; ++i) run[i] = T(0);
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    v[q][0] = run[q * L::M];
#pragma unroll
    for (int k = 0; k < ORDER; ++k) v[q][1 + k] = run[q * L::M + L::mi(C, k)];
  }
}

// Axis C < NCOORD-1, flat stride sc (an argument): offsets d = 1..4
template <typename TC, typename T, int NCOORD, int ORDER, int P, int C>
__device__ __forceinline__ void axis_strided(const TC* cb, const T* xb, int N, int p0, int sc,
                                             T* y) {
  using L = Layout<NCOORD, ORDER>;
  constexpr int M = L::M, NB = L::NB, NV = L::NV;
  const bool aligned = P == 1 || sc % P == 0;  // so is every d * sc
#pragma unroll
  for (int d = 1; d <= kMaxDelta; ++d) {
    const int s = d * sc;
    const TC* gb = cb + (size_t)L::band(C, d) * N;
    // forward: coefficients at p0 .. p0+P-1, neighbours at + s
    T g[NB][P];
#pragma unroll
    for (int n = 0; n < NB; ++n) ld_coef(gb + (size_t)n * N + p0, g[n], Int<P>());
    T h[NB][P];  // backward coefficients at p0 - s + q
    T vf[P][NV], vb[P][NV];
    if (aligned) {
      // the runs at p0 + s and p0 - s lie wholly inside or outside the grid
      const bool fok = p0 + s < N, bok = p0 >= s;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (bok) {
          ld_coef(gb + (size_t)n * N + (p0 - s), h[n], Int<P>());
        } else {
#pragma unroll
          for (int q = 0; q < P; ++q) h[n][q] = T(0);
        }
      }
      if constexpr (P == 1) {
        ld_picks<NCOORD, ORDER, C>(xb, p0 + s, fok, vf[0]);
        ld_picks<NCOORD, ORDER, C>(xb, p0 - s, bok, vb[0]);
      } else {
        ld_run_picks<NCOORD, ORDER, C, P>(xb, p0 + s, fok, vf);
        ld_run_picks<NCOORD, ORDER, C, P>(xb, p0 - s, bok, vb);
      }
    } else {
      // s is not a multiple of P: one value per load, each point masked
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int pf = p0 + q + s, pb = p0 + q - s;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (pb >= 0) ld_coef(gb + (size_t)n * N + pb, &h[n][q], Int<1>());
          else h[n][q] = T(0);
        }
        ld_picks<NCOORD, ORDER, C>(xb, pf, pf < N, vf[q]);
        ld_picks<NCOORD, ORDER, C>(xb, pb, pb >= 0, vb[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      T gq[NB], hq[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) gq[n] = g[n][q], hq[n] = h[n][q];
      add_forward<NCOORD, ORDER, C>(y + q * M, gq, vf[q]);
      add_backward<NCOORD, ORDER, C>(y + q * M, hq, vb[q]);
    }
  }
}

// The last axis, flat stride 1: offsets are constants.  The thread reads
// x at p0 - 4 .. p0 + P + 3 once (its own P points from xr), and the
// coefficients at p - d from the aligned runs of P values below p0.
template <typename TC, typename T, int NCOORD, int ORDER, int P>
__device__ __forceinline__ void axis_last(const TC* cb, const T* xb, int N, int p0, const T* xr,
                                          T* y) {
  using L = Layout<NCOORD, ORDER>;
  constexpr int C = NCOORD - 1;
  constexpr int M = L::M, NB = L::NB, NV = L::NV;
  constexpr int W = kMaxDelta / P;  // aligned runs of P points on each side (P | 4)
  // w[4 + o] = x[p0 + o, 0 | mik] for o in -4 .. P+3
  T w[P + 2 * kMaxDelta][NV];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    w[kMaxDelta + q][0] = xr[q * M];
#pragma unroll
    for (int k = 0; k < ORDER; ++k) w[kMaxDelta + q][1 + k] = xr[q * M + L::mi(C, k)];
  }
#pragma unroll
  for (int r = 1; r <= W; ++r) {
    const int lo = p0 - r * P, hi = p0 + r * P;  // run starts
    if constexpr (P == 1) {
      ld_picks<NCOORD, ORDER, C>(xb, lo, lo >= 0, w[kMaxDelta - r]);
      ld_picks<NCOORD, ORDER, C>(xb, hi, hi < N, w[kMaxDelta + r]);
    } else {
      ld_run_picks<NCOORD, ORDER, C, P>(xb, lo, lo >= 0, w + kMaxDelta - r * P);
      ld_run_picks<NCOORD, ORDER, C, P>(xb, hi, hi < N, w + kMaxDelta + r * P);
    }
  }
#pragma unroll
  for (int d = 1; d <= kMaxDelta; ++d) {
    const TC* gb = cb + (size_t)L::band(C, d) * N;
    // c[n][0] = coefficient n at p0 .. p0+P-1 (forward), c[n][r] at the
    // aligned run p0 - r*P (backward; the runs an offset does not use are
    // dead loads and go)
    T c[NB][W + 1][P];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      ld_coef(gb + (size_t)n * N + p0, c[n][0], Int<P>());
#pragma unroll
      for (int r = 1; r <= W; ++r) {
        if (p0 >= r * P) {
          ld_coef(gb + (size_t)n * N + (p0 - r * P), c[n][r], Int<P>());
        } else {
#pragma unroll
          for (int q = 0; q < P; ++q) c[n][r][q] = T(0);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      // the backward coefficient at p0 + o, o = q - d: run r = ceil(-o / P)
      const int o = q - d;
      const int r = o >= 0 ? 0 : (-o + P - 1) / P;
      T gq[NB], hq[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) gq[n] = c[n][0][q], hq[n] = c[n][r][o + r * P];
      add_forward<NCOORD, ORDER, C>(y + q * M, gq, w[kMaxDelta + q + d]);
      add_backward<NCOORD, ORDER, C>(y + q * M, hq, w[kMaxDelta + q - d]);
    }
  }
}

// TC: stored coefficient type; T: vector and sum type.  A thread computes
// the P points p0 .. p0+P-1 of sample blockIdx.y.  P > 1 requires
// N % P == 0 and 16-byte aligned operands (the wrapper's geometry).
template <typename TC, typename T, int NCOORD, int ORDER, int P>
__global__ void __launch_bounds__(kThreads)
    k1_stencil_apply(const TC* __restrict__ coef, const T* __restrict__ x, int s0, int s1, int N,
                     const T* rin, T* out, const T* xin, T* xout) {
  using L = Layout<NCOORD, ORDER>;
  constexpr int M = L::M, R = P * M;
  constexpr bool VEC = P > 1;
  const int p0 = (blockIdx.x * kThreads + threadIdx.x) * P;
  if (p0 >= N) return;
  const size_t b = blockIdx.y;
  const TC* cb = coef + b * (size_t)L::NC * N;
  const T* xb = x + b * (size_t)N * M;
  const size_t o = (b * (size_t)N + p0) * M;  // the thread's run in x, out, ...

  T xr[R], y[R];
  ld_run<VEC, true, R>(x + o, xr);

  // dense offset-0 block: y[q, i] = sum_j D[i, j](p0 + q) x[p0 + q, j]
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T d[P];
      ld_coef(cb + (size_t)(i * M + j) * N + p0, d, Int<P>());
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (j == 0) y[q * M + i] = d[q] * xr[q * M];
        else y[q * M + i] += d[q] * xr[q * M + j];
      }
    }
  }

  // bands, axis by axis
  if constexpr (NCOORD >= 2) axis_strided<TC, T, NCOORD, ORDER, P, 0>(cb, xb, N, p0, s0, y);
  if constexpr (NCOORD >= 3) axis_strided<TC, T, NCOORD, ORDER, P, 1>(cb, xb, N, p0, s1, y);
  axis_last<TC, T, NCOORD, ORDER, P>(cb, xb, N, p0, xr, y);

  // epilogue, in 16-byte chunks (VEC) or value by value: each chunk of rin
  // and xin is read before the same chunk of out and xout is written
  constexpr int CH = VEC ? V16<T>::n : 1;
#pragma unroll
  for (int i = 0; i < R; i += CH) {
    T v[CH];
    if (rin) {
      ld_run<VEC, false, CH>(rin + o + i, v);
#pragma unroll
      for (int j = 0; j < CH; ++j) v[j] -= y[i + j];
    } else {
#pragma unroll
      for (int j = 0; j < CH; ++j) v[j] = y[i + j];
    }
    if (xout) {
      T u[CH];
      if (xin) {
        ld_run<VEC, false, CH>(xin + o + i, u);
#pragma unroll
        for (int j = 0; j < CH; ++j) u[j] += xr[i + j];
      } else {
#pragma unroll
        for (int j = 0; j < CH; ++j) u[j] = xr[i + j];
      }
      st_run<VEC, CH>(xout + o + i, u);
    }
    st_run<VEC, CH>(out + o + i, v);
  }
}

template <typename TC, typename T, int NCOORD, int ORDER>
int launch_layout(const TC* coef, const T* x, int s0, int s1, int N, int bs, int P, int grid_x,
                  const T* rin, T* out, const T* xin, T* xout, cudaStream_t stream) {
  constexpr int PV = 16 / (int)sizeof(T);  // the vector width: 4 in f32, 2 in f64
  const dim3 grid(grid_x, bs);
  if (P == 1) {
    k1_stencil_apply<TC, T, NCOORD, ORDER, 1>
        <<<grid, kThreads, 0, stream>>>(coef, x, s0, s1, N, rin, out, xin, xout);
  } else if (P == PV && N % PV == 0) {
    k1_stencil_apply<TC, T, NCOORD, ORDER, PV>
        <<<grid, kThreads, 0, stream>>>(coef, x, s0, s1, N, rin, out, xin, xout);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TC, typename T>
int launch(const TC* coef, const T* x, int n_coord, int order, int s0, int s1, int N, int bs,
           int P, int threads, int grid_x, const T* rin, T* out, const T* xin, T* xout,
           void* stream) {
  if (N < 1 || bs < 1 || grid_x < 1 || threads != kThreads ||
      (long long)grid_x * kThreads * P < N)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define K1_LAYOUT(NCOORD, ORDER)                                                            \
  if (n_coord == NCOORD && order == ORDER)                                                  \
    return launch_layout<TC, T, NCOORD, ORDER>(coef, x, s0, s1, N, bs, P, grid_x, rin, out, \
                                               xin, xout, st);
  K1_LAYOUT(1, 1)
  K1_LAYOUT(1, 2)
  K1_LAYOUT(2, 1)
  K1_LAYOUT(2, 2)
  K1_LAYOUT(3, 1)
  K1_LAYOUT(3, 2)
#undef K1_LAYOUT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// coef, x; the layout (n_coord, order) and the strides of axes 0 and 1 when
// they are not the last; N, bs; the geometry (P, threads, grid_x); the
// epilogue operands; the stream
int k1_stencil_apply_f32(const float* coef, const float* x, int n_coord, int order, int s0,
                         int s1, int N, int bs, int P, int threads, int grid_x, const float* rin,
                         float* out, const float* xin, float* xout, void* stream) {
  return launch<float, float>(coef, x, n_coord, order, s0, s1, N, bs, P, threads, grid_x, rin,
                              out, xin, xout, stream);
}

int k1_stencil_apply_f64(const double* coef, const double* x, int n_coord, int order, int s0,
                         int s1, int N, int bs, int P, int threads, int grid_x, const double* rin,
                         double* out, const double* xin, double* xout, void* stream) {
  return launch<double, double>(coef, x, n_coord, order, s0, s1, N, bs, P, threads, grid_x, rin,
                                out, xin, xout, stream);
}

// bf16 coefficients, f32 vectors
int k1_stencil_apply_bf16(const __nv_bfloat16* coef, const float* x, int n_coord, int order,
                          int s0, int s1, int N, int bs, int P, int threads, int grid_x,
                          const float* rin, float* out, const float* xin, float* xout,
                          void* stream) {
  return launch<__nv_bfloat16, float>(coef, x, n_coord, order, s0, s1, N, bs, P, threads, grid_x,
                                      rin, out, xin, xout, stream);
}

const char* k1_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
