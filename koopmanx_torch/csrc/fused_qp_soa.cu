// Fused condensed-QP build and solve for Hopper (sm_90a), scenario-in-lanes
// (SoA) layout: lane l of every warp of a block works on scenario
// 32 * blockIdx + l.
//
// Replaces the TPU kernel koopmanx/ops/qp_pallas_soa.py::fused_qp_solve_soa
// (body _kernel). It computes the same function as csrc/fused_qp.cu (the
// AoS kernel; koopmanx_torch/ops/fused_qp.py states it and holds the plain
// version of both): clipped Markov blocks and F1 z0 rows, P = 2(F2' Qbar F2
// + Rbar) (not symmetrized) and q, rho from trace(P) and K, schulz_iters
// Newton-Schulz steps X <- X (2I - K X) from X = K / (|K|_1 |K|_inf), box
// ADMM from a zero dual. Clamps and maxima propagate NaN.
//
// What bounds it: the work. Per scenario at the flagship's shapes (nz = 8,
// m = 1, py = 2, N = 20, nx = N m = 20, 16 Newton-Schulz steps, 60 ADMM
// iterations) about 610 kFLOP, 518 kFLOP of it the Newton-Schulz products,
// against 704 bytes in and out in float32. At B = 8192: 4.9 GFLOP, 0.0746 ms
// at the card's 67 TFLOP/s float32 peak outside the tensor cores, against
// 1.7 us of bytes at 3.35 TB/s (chip_smoke.py::fused_qp_bound_ms).
//
// What held the first design (one thread per scenario) at 1 % of that
// bound, and what this one does about each:
// 1. The card was nearly empty: 64 threads a block, one scenario each, gave
//    128 blocks of 2 warps at B = 8192, each thread a dependent chain of
//    2 x 16 x 20^3 FMAs. Here a block holds S scenarios (S = 32 in float32,
//    16 in float64), lane l of each group of S threads working on scenario
//    S * blockIdx + l, and its W = NXP / R row groups (R = 2 rows a thread)
//    share the rows of every product. At the flagship's shapes in float32:
//    256 blocks of 10 warps, 96 registers a thread, two blocks (20 warps)
//    resident on each SM, one wave (chip_smoke.py phase 2 prints these for
//    every case it checks). chip_smoke.py measured 0.3525 ms of device
//    time there on an NVIDIA H100 80GB HBM3 (700 W), 21 % of the bound;
//    the first design took 7.478 ms on the same card model.
// 2. The working set (~1,800 values a scenario) sat in a global
//    (element, B) scratch of 59 MB at B = 8192, more than the L2, and every
//    Newton-Schulz FMA loaded two operands from it. Here it lives in shared
//    memory and registers. Each thread keeps its R rows of K in registers
//    (R x NXP values, indices fixed at compile time: the kernel is
//    templated on NXP, nx rounded up to 4); X and T = 2I - K X sit in shared
//    memory laid out [element][S lanes], so a warp's load of one element of
//    its scenarios touches consecutive banks. T's rows come from K's rows in
//    registers and all of X (one shared load feeds R FMAs); X T from the
//    thread's own rows of X, read into registers, and all of T (again one
//    load per R FMAs), written back over X's own rows, which no other
//    thread reads in that phase. Two __syncthreads per step. The order of
//    the products and of every sum is the first design's: T = 2I - K X,
//    then X T, each dot product summed in k order.
//    The ADMM keeps the thread's rows of the final X in registers, shares
//    rhs through two shared buffers taken in turn (one __syncthreads an
//    iteration) and keeps x, z, y of its rows in registers.
//    The small stages (Markov recursion, weighted error, H and q from the
//    blocks, trace, norms, seed; ~40 kFLOP of the 610) split their output
//    elements over the W row groups, with the prologue's arrays in T's
//    space.
//    Why R = 2: R = 4 halves the shared loads per FMA but needs ~190
//    registers a thread (K's and X's rows, 2 R NXP values), which leaves one
//    block of 5 warps on an SM, or spills at the 168 that two such blocks
//    allow (ptxas's report); R = 2 fits two blocks of 10 warps in 96
//    registers. In float64 the R = 2 rows take ~190 registers; a block of
//    32 scenarios (10 warps) would be held to 168 and spill, so it holds 16
//    (5 warps).
// 3. The wrapper transposed six inputs in, allocated the scratch and
//    transposed u back: 8 launches and ~12 MB of copies around the kernel.
//    Here the kernel reads the (B, ...) inputs as they are (a block stages
//    its scenarios into the [element][lane] layout: conflict-free shared
//    stores, global reads served by L1 across the block's rows) and writes
//    u (B, N m); the wrapper launches one kernel and copies nothing.
//
// Padding: rows and columns of K, X and T from nx to NXP are zero and are
// never written, so the padded terms add +0 to each sum. Lanes past the
// batch compute on zero inputs (a finite QP) and skip only their store:
// every thread reaches every __syncthreads.
//
// Instances (the wrapper picks one from the shapes alone, before the
// launch; koopmanx_torch/ops/fused_qp.py::soa_instance mirrors the rule):
// - fused_qp_soa_smem<T, NXP, R, S>: nx <= 24 in float32, nx <= 20 in
//   float64, and the block's shared memory (SmemLayout below;
//   ops/fused_qp.py::soa_shared_bytes) within 227 KB. At the flagship's
//   shapes: 112,800 bytes in float32, 112,960 in float64.
// - fused_qp_soa_global<T>: every other shape (nx = 40 at m = 2, larger
//   nz): the first design, one thread per scenario with its working set in
//   a global (element, B) scratch that the wrapper allocates (rows from
//   ops/fused_qp.py::soa_scratch_rows), reading the (B, ...) inputs
//   directly. Its per-channel vectors need N (py + 2 m) values within
//   48 KB of shared memory.
// At most 16 entries in each per-channel weight and bound array (they
// travel by value in the kernel's parameters).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see koopmanx_torch/ops/build.py)

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kGlobalThreads = 64;
constexpr int kMaxChannels = 16;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// scenarios a block holds, rows a thread owns, and the widest NXP, of the
// shared instance
template <typename T>
constexpr int kLanesOf = sizeof(T) == 4 ? 32 : 16;
constexpr int kRows = 2;
template <typename T>
constexpr int kMaxNxp = sizeof(T) == 4 ? 24 : 20;

struct Channels {
  double q[kMaxChannels], r[kMaxChannels], lo[kMaxChannels], hi[kMaxChannels];
  int nq, nr, nlo, nhi;
};

template <typename T>
struct Params {
  const T* a;     // (B, nz, nz)
  const T* b;     // (B, nz, m)
  const T* cyc;   // (B, py, nz)
  const T* z0;    // (B, nz)
  const T* yr;    // (B, N py)
  const T* warm;  // (B, N m)
  T* u;           // (B, N m) out
  T* scratch;     // (rows, B), the global instance only
  int batch, nz, m, py, horizon, iters, schulz_iters;
  T rho_scale, sigma, alpha, one_minus_alpha, f_clamp;
  Channels ch;
};

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  // NaN-propagating, as torch.clamp and jnp.clip: a NaN compares false
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  // NaN-propagating max, as torch.amax and jnp.max (fmax drops a NaN)
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float abs_val(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_val(double v) { return fabs(v); }

// ---------------------------------------------------------------------------
// The shared instance.

// A block's shared memory, in elements of S values each (element e of an
// array at offset o, lane l, is value (o + e) * S + l), then Qbar
// (N py values, one for all lanes). The prologue's arrays share T's space.
struct SmemLayout {
  int x, t, q, rhs, red, lanes_total;
  int a, b, cyc, g, gn, s, sn, mk, err;
};

__host__ __device__ inline SmemLayout smem_layout(int nz, int m, int py,
                                                  int horizon, int nxp,
                                                  int warps) {
  SmemLayout L;
  int o = 0;
  L.x = o;   o += nxp * nxp;
  L.t = o;
  int p = o;
  L.a = p;   p += nz * nz;
  L.b = p;   p += nz * m;
  L.cyc = p; p += py * nz;
  L.g = p;   p += py * nz;
  L.gn = p;  p += py * nz;
  L.s = p;   p += nz;
  L.sn = p;  p += nz;
  L.mk = p;  p += horizon * py * m;
  L.err = p; p += horizon * py;
  o += (p - o > nxp * nxp) ? p - o : nxp * nxp;
  L.q = o;   o += nxp;
  L.rhs = o; o += 2 * nxp;
  L.red = o; o += 2 * warps;
  L.lanes_total = o;
  return L;
}

template <typename T>
size_t smem_bytes(int nz, int m, int py, int horizon, int nxp, int warps) {
  const SmemLayout L = smem_layout(nz, m, py, horizon, nxp, warps);
  return (static_cast<size_t>(L.lanes_total) * kLanesOf<T> +
          static_cast<size_t>(horizon) * py) * sizeof(T);
}

template <typename T, int NXP, int R, int S>
__global__ void __launch_bounds__(NXP / R * S, (sizeof(T) == 4 && NXP <= 20) ? 2 : 1)
    fused_qp_soa_smem(const Params<T> p) {
  constexpr int kLanes = S;   // scenarios of the block, one per lane
  constexpr int W = NXP / R;  // row groups of the block; row r = w + W i
  static_assert(NXP % R == 0 && W * S % 32 == 0, "whole warps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x % kLanes;
  const int w = threadIdx.x / kLanes;
  const long long b0 = static_cast<long long>(blockIdx.x) * kLanes;
  const long long bi = b0 + lane;
  const bool live = bi < p.batch;
  const int nz = p.nz, m = p.m, py = p.py, horizon = p.horizon;
  const int nx = horizon * m, nrow = horizon * py;
  const Channels& ch = p.ch;
  const SmemLayout L = smem_layout(nz, m, py, horizon, NXP, W);
  T* const lanes = sm + lane;  // element e of the array at o: lanes[(o + e) * kLanes]
  auto at = [&](int o, int e) -> T& { return lanes[(o + e) * kLanes]; };
  T* const qbar = sm + L.lanes_total * kLanes;
  T* const sx = lanes + L.x * kLanes;
  T* const st = lanes + L.t * kLanes;

  // ---- inputs: the block's 32 scenarios into the [element][lane] layout;
  // lanes past the batch get zeros ----
  auto stage = [&](const T* src, int n, int o) {
    for (int idx = threadIdx.x; idx < n * kLanes; idx += blockDim.x) {
      const int e = idx / kLanes;  // idx % kLanes == lane
      sm[(o + e) * kLanes + lane] = live ? src[bi * n + e] : T(0);
    }
  };
  stage(p.a, nz * nz, L.a);
  stage(p.b, nz * m, L.b);
  stage(p.cyc, py * nz, L.cyc);
  stage(p.cyc, py * nz, L.g);
  stage(p.z0, nz, L.s);
  for (int r = threadIdx.x; r < nrow; r += blockDim.x)
    qbar[r] = T(ch.q[r % ch.nq]);
  for (int e = w; e < 2 * NXP; e += W) at(L.rhs, e) = T(0);
  __syncthreads();

  // ---- Markov blocks M_j = clip(G B) and F1 z0 rows, G = CyC A^j ----
  int g = L.g, gn = L.gn, s = L.s, sn = L.sn;
  const int n_mk = py * m, n_g = py * nz;
  for (int j = 0; j < horizon; ++j) {
    for (int e = w; e < n_mk + n_g + nz; e += W) {
      T acc = T(0);
      if (e < n_mk) {
        const int r = e / m, c = e - r * m;
        for (int k = 0; k < nz; ++k) acc += at(g, r * nz + k) * at(L.b, k * m + c);
        at(L.mk, j * n_mk + e) = clip(acc, -p.f_clamp, p.f_clamp);
      } else if (e < n_mk + n_g) {
        const int e2 = e - n_mk, r = e2 / nz, c = e2 - r * nz;
        for (int k = 0; k < nz; ++k) acc += at(g, r * nz + k) * at(L.a, k * nz + c);
        at(gn, e2) = acc;
      } else {
        const int i = e - n_mk - n_g;
        for (int k = 0; k < nz; ++k) acc += at(L.a, i * nz + k) * at(s, k);
        at(sn, i) = acc;
      }
    }
    __syncthreads();
    int t = g; g = gn; gn = t;
    t = s; s = sn; sn = t;  // s = A^(j+1) z0
    // the next step writes gn and sn, which nothing below reads
    for (int r = w; r < py; r += W) {
      T acc = T(0);
      for (int k = 0; k < nz; ++k) acc += at(L.cyc, r * nz + k) * at(s, k);
      at(L.err, j * py + r) = clip(acc, -p.f_clamp, p.f_clamp);
    }
  }
  __syncthreads();

  // ---- weighted tracking error Qbar (F1 z0 - yr) ----
  for (int r = w; r < nrow; r += W)
    at(L.err, r) = (at(L.err, r) - (live ? p.yr[bi * nrow + r] : T(0))) * qbar[r];
  __syncthreads();

  // ---- P = 2 (F2' Qbar F2 + Rbar) into X's space, zero past nx, and
  // q = 2 F2' err, from the blocks ----
  for (int e = w; e < NXP * NXP; e += W) {
    const int r = e / NXP, c = e - r * NXP;
    T v = T(0);
    if (r < nx && c < nx) {
      const int jr = r / m, br = r - jr * m;
      const int jc = c / m, bc = c - jc * m;
      T acc = T(0);
      for (int i = (jr > jc ? jr : jc); i < horizon; ++i)
        for (int a = 0; a < py; ++a)
          acc += at(L.mk, ((i - jr) * py + a) * m + br) *
                 (at(L.mk, ((i - jc) * py + a) * m + bc) * qbar[i * py + a]);
      if (r == c) acc += T(ch.r[r % ch.nr]);
      v = T(2) * acc;
    }
    sx[e * kLanes] = v;
  }
  for (int r = w; r < NXP; r += W) {
    T acc = T(0);
    if (r < nx) {
      const int jr = r / m, br = r - jr * m;
      for (int i = jr; i < horizon; ++i)
        for (int a = 0; a < py; ++a)
          acc += at(L.mk, ((i - jr) * py + a) * m + br) * at(L.err, i * py + a);
    }
    at(L.q, r) = T(2) * acc;
  }
  __syncthreads();

  // ---- rho from trace(P); K = P + (sigma + rho) I ----
  T trace = T(0);
  for (int i = 0; i < nx; ++i) trace += sx[(i * NXP + i) * kLanes];
  const T rho = p.rho_scale * nan_max(trace / T(nx), T(1e-6));
  __syncthreads();  // every thread has read the diagonal before it changes
  const T shift = p.sigma + rho;
  for (int i = w; i < nx; i += W) sx[(i * NXP + i) * kLanes] += shift;
  __syncthreads();

  // ---- Newton-Schulz seed X = K / (|K|_1 |K|_inf) ----
  T norm1 = T(0), norminf = T(0);
  for (int c = w; c < nx; c += W) {
    T col = T(0), row = T(0);
    for (int r = 0; r < nx; ++r) {
      col += abs_val(sx[(r * NXP + c) * kLanes]);
      row += abs_val(sx[(c * NXP + r) * kLanes]);
    }
    norm1 = nan_max(norm1, col);
    norminf = nan_max(norminf, row);
  }
  at(L.red, w) = norm1;
  at(L.red, W + w) = norminf;
  __syncthreads();
  norm1 = norminf = T(0);
  for (int v = 0; v < W; ++v) {
    norm1 = nan_max(norm1, at(L.red, v));
    norminf = nan_max(norminf, at(L.red, W + v));
  }
  const T scale = norm1 * norminf;

  // this thread's rows of K into registers (zero past nx), then its rows of
  // X over them; T's space is free again: zero its padding
  T kr[R][NXP];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < NXP; ++k) kr[i][k] = sx[((w + W * i) * NXP + k) * kLanes];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = w + W * i;
#pragma unroll
    for (int c = 0; c < NXP; ++c)
      if (r < nx && c < nx) sx[(r * NXP + c) * kLanes] = kr[i][c] / scale;
  }
  for (int e = w; e < NXP * NXP; e += W) {
    const int r = e / NXP, c = e - r * NXP;
    if (r >= nx || c >= nx) st[e * kLanes] = T(0);
  }
  __syncthreads();

  // ---- Newton-Schulz: X <- X (2I - K X) ----
  for (int it = 0; it < p.schulz_iters; ++it) {
    // T = 2I - K X: this thread's rows, from its rows of K and all of X
#pragma unroll 1
    for (int c = 0; c < nx; ++c) {
      T acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = T(0);
#pragma unroll
      for (int k = 0; k < NXP; ++k) {
        const T xv = sx[(k * NXP + c) * kLanes];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] += kr[i][k] * xv;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = w + W * i;
        if (r < nx) st[(r * NXP + c) * kLanes] = (r == c ? T(2) : T(0)) - acc[i];
      }
    }
    __syncthreads();
    // X T: this thread's rows, from its rows of X (into registers first)
    // and all of T, written back over those rows, which no other thread
    // reads in this phase
    T xr[R][NXP];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < NXP; ++k) xr[i][k] = sx[((w + W * i) * NXP + k) * kLanes];
#pragma unroll 1
    for (int c = 0; c < nx; ++c) {
      T acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = T(0);
#pragma unroll
      for (int k = 0; k < NXP; ++k) {
        const T tv = st[(k * NXP + c) * kLanes];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] += xr[i][k] * tv;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = w + W * i;
        if (r < nx) sx[(r * NXP + c) * kLanes] = acc[i];
      }
    }
    __syncthreads();
  }

  // ---- box ADMM from x = warm, z = clip(warm), y = 0; X's rows in kr ----
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < NXP; ++k) kr[i][k] = sx[((w + W * i) * NXP + k) * kLanes];
  T x[R], z[R], y[R], qv[R], lov[R], hiv[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = w + W * i;
    if (r < nx) {
      lov[i] = T(ch.lo[r % ch.nlo]);
      hiv[i] = T(ch.hi[r % ch.nhi]);
      qv[i] = at(L.q, r);
      x[i] = live ? p.warm[bi * nx + r] : T(0);
      y[i] = T(0);
      z[i] = clip(x[i], lov[i], hiv[i]);
    } else {
      qv[i] = lov[i] = hiv[i] = x[i] = y[i] = z[i] = T(0);
    }
  }
  const T sigma = p.sigma, alpha = p.alpha, beta = p.one_minus_alpha;
  // rhs buffers in turn (zero past nx): a thread writes a buffer again only
  // after the __syncthreads of the other, which every thread reaches after
  // its reads of this one
  for (int it = 0; it < p.iters; ++it) {
    T* const rb = lanes + (L.rhs + (it & 1) * NXP) * kLanes;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = w + W * i;
      if (r < nx) rb[r * kLanes] = sigma * x[i] - qv[i] + rho * z[i] - y[i];
    }
    __syncthreads();
    T acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = T(0);
#pragma unroll
    for (int k = 0; k < NXP; ++k) {
      const T rv = rb[k * kLanes];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += kr[i][k] * rv;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (w + W * i < nx) {
        const T xm = alpha * acc[i] + beta * z[i];
        const T zn = clip(xm + y[i] / rho, lov[i], hiv[i]);
        y[i] = y[i] + rho * (xm - zn);
        z[i] = zn;
        x[i] = acc[i];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = w + W * i;
      if (r < nx) p.u[bi * nx + r] = z[i];
    }
  }
}

// ---------------------------------------------------------------------------
// The global instance: one thread per scenario, the working set in a global
// (rows, B) scratch (rows from global_layout(...).total).

struct GlobalLayout {
  int g, gn, s, sn, mk, err, q, rhs, x, z, y, k, xi, t, xn, total;
};

__host__ __device__ inline GlobalLayout global_layout(int nz, int m, int py,
                                                      int horizon) {
  const int nx = horizon * m, nrow = horizon * py;
  GlobalLayout L;
  int o = 0;
  L.g = o;   o += py * nz;
  L.gn = o;  o += py * nz;
  L.s = o;   o += nz;
  L.sn = o;  o += nz;
  L.mk = o;  o += horizon * py * m;
  L.err = o; o += nrow;
  L.q = o;   o += nx;
  L.rhs = o; o += nx;
  L.x = o;   o += nx;
  L.z = o;   o += nx;
  L.y = o;   o += nx;
  L.k = o;   o += nx * nx;
  L.xi = o;  o += nx * nx;
  L.t = o;   o += nx * nx;
  L.xn = o;  o += nx * nx;
  L.total = o;
  return L;
}

// One scenario's column of an array: element e at p[e * stride].
template <typename P>
struct Col {
  P* p;
  long long stride;
  __device__ __forceinline__ P& operator[](int e) const {
    return p[static_cast<long long>(e) * stride];
  }
};

template <typename T>
__global__ void fused_qp_soa_global(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = p.nz, m = p.m, py = p.py, horizon = p.horizon;
  const int nx = horizon * m, nrow = horizon * py;
  const Channels& ch = p.ch;
  // per-channel vectors shared by every scenario: Qbar (N py), lo, hi (N m)
  T* qbar = reinterpret_cast<T*>(smem_raw);
  T* lo = qbar + nrow;
  T* hi = lo + nx;
  for (int r = threadIdx.x; r < nrow; r += blockDim.x)
    qbar[r] = T(ch.q[r % ch.nq]);
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    lo[i] = T(ch.lo[i % ch.nlo]);
    hi[i] = T(ch.hi[i % ch.nhi]);
  }
  __syncthreads();
  const long long bi = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (bi >= p.batch) return;  // no barrier below

  const long long n = p.batch;
  const GlobalLayout L = global_layout(nz, m, py, horizon);
  auto in = [&](const T* base, int size) { return Col<const T>{base + bi * size, 1}; };
  auto sc = [&](int row) { return Col<T>{p.scratch + row * n + bi, n}; };
  const Col<const T> A = in(p.a, nz * nz), Bm = in(p.b, nz * m);
  const Col<const T> C = in(p.cyc, py * nz), z0 = in(p.z0, nz);
  const Col<const T> yr = in(p.yr, nrow), warm = in(p.warm, nx);
  Col<T> G = sc(L.g), Gn = sc(L.gn), S = sc(L.s), Sn = sc(L.sn);
  const Col<T> Mk = sc(L.mk), Err = sc(L.err), Q = sc(L.q), Rhs = sc(L.rhs);
  const Col<T> X = sc(L.x), Z = sc(L.z), Y = sc(L.y), K = sc(L.k);
  Col<T> Xi = sc(L.xi), Xn = sc(L.xn);
  const Col<T> Tm = sc(L.t);
  const T f_clamp = p.f_clamp;

  // ---- Markov blocks M_j = clip(G B) and F1 z0 rows, G = CyC A^j ----
  for (int e = 0; e < py * nz; ++e) G[e] = C[e];
  for (int i = 0; i < nz; ++i) S[i] = z0[i];
  for (int j = 0; j < horizon; ++j) {
    for (int r = 0; r < py; ++r)
      for (int c = 0; c < m; ++c) {
        T acc = T(0);
        for (int k = 0; k < nz; ++k) acc += G[r * nz + k] * Bm[k * m + c];
        Mk[(j * py + r) * m + c] = clip(acc, -f_clamp, f_clamp);
      }
    for (int r = 0; r < py; ++r)
      for (int c = 0; c < nz; ++c) {
        T acc = T(0);
        for (int k = 0; k < nz; ++k) acc += G[r * nz + k] * A[k * nz + c];
        Gn[r * nz + c] = acc;
      }
    for (int i = 0; i < nz; ++i) {
      T acc = T(0);
      for (int k = 0; k < nz; ++k) acc += A[i * nz + k] * S[k];
      Sn[i] = acc;
    }
    Col<T> t = G; G = Gn; Gn = t;
    t = S; S = Sn; Sn = t;  // S = A^(j+1) z0
    for (int r = 0; r < py; ++r) {
      T acc = T(0);
      for (int k = 0; k < nz; ++k) acc += C[r * nz + k] * S[k];
      Err[j * py + r] = clip(acc, -f_clamp, f_clamp);
    }
  }

  // ---- weighted tracking error Qbar (F1 z0 - yr) ----
  for (int r = 0; r < nrow; ++r) Err[r] = (Err[r] - yr[r]) * qbar[r];

  // ---- P = 2 (F2' Qbar F2 + Rbar) and q = 2 F2' err, from the blocks ----
  for (int r = 0; r < nx; ++r) {
    const int jr = r / m, br = r - jr * m;
    for (int c = 0; c < nx; ++c) {
      const int jc = c / m, bc = c - jc * m;
      T acc = T(0);
      for (int i = (jr > jc ? jr : jc); i < horizon; ++i)
        for (int a = 0; a < py; ++a)
          acc += Mk[((i - jr) * py + a) * m + br] *
                 (Mk[((i - jc) * py + a) * m + bc] * qbar[i * py + a]);
      if (r == c) acc += T(ch.r[r % ch.nr]);
      K[r * nx + c] = T(2) * acc;
    }
    T acc = T(0);
    for (int i = jr; i < horizon; ++i)
      for (int a = 0; a < py; ++a)
        acc += Mk[((i - jr) * py + a) * m + br] * Err[i * py + a];
    Q[r] = T(2) * acc;
  }

  // ---- rho from trace(P); K = P + (sigma + rho) I ----
  T trace = T(0);
  for (int i = 0; i < nx; ++i) trace += K[i * nx + i];
  const T rho = p.rho_scale * nan_max(trace / T(nx), T(1e-6));
  const T shift = p.sigma + rho;
  for (int i = 0; i < nx; ++i) K[i * nx + i] += shift;

  // ---- Newton-Schulz seed X = K / (|K|_1 |K|_inf) ----
  T norm1 = T(0), norminf = T(0);
  for (int c = 0; c < nx; ++c) {
    T col = T(0), row = T(0);
    for (int r = 0; r < nx; ++r) {
      col += abs_val(K[r * nx + c]);
      row += abs_val(K[c * nx + r]);
    }
    norm1 = nan_max(norm1, col);
    norminf = nan_max(norminf, row);
  }
  const T scale = norm1 * norminf;
  for (int e = 0; e < nx * nx; ++e) Xi[e] = K[e] / scale;

  // ---- Newton-Schulz: X <- X (2I - K X) ----
  for (int it = 0; it < p.schulz_iters; ++it) {
    for (int r = 0; r < nx; ++r)
      for (int c = 0; c < nx; ++c) {
        T acc = T(0);
        for (int k = 0; k < nx; ++k) acc += K[r * nx + k] * Xi[k * nx + c];
        Tm[r * nx + c] = (r == c ? T(2) : T(0)) - acc;
      }
    for (int r = 0; r < nx; ++r)
      for (int c = 0; c < nx; ++c) {
        T acc = T(0);
        for (int k = 0; k < nx; ++k) acc += Xi[r * nx + k] * Tm[k * nx + c];
        Xn[r * nx + c] = acc;
      }
    Col<T> t = Xi; Xi = Xn; Xn = t;
  }

  // ---- box ADMM from x = warm, z = clip(warm), y = 0 ----
  for (int i = 0; i < nx; ++i) {
    X[i] = warm[i];
    Y[i] = T(0);
    Z[i] = clip(X[i], lo[i], hi[i]);
  }
  for (int it = 0; it < p.iters; ++it) {
    for (int i = 0; i < nx; ++i)
      Rhs[i] = p.sigma * X[i] - Q[i] + rho * Z[i] - Y[i];
    for (int i = 0; i < nx; ++i) {
      T acc = T(0);
      for (int j = 0; j < nx; ++j) acc += Xi[i * nx + j] * Rhs[j];
      const T xm = p.alpha * acc + p.one_minus_alpha * Z[i];
      const T zn = clip(xm + Y[i] / rho, lo[i], hi[i]);
      Y[i] = Y[i] + rho * (xm - zn);
      Z[i] = zn;
      X[i] = acc;
    }
  }
  for (int i = 0; i < nx; ++i) p.u[bi * nx + i] = Z[i];
}

// ---------------------------------------------------------------------------
// Instances, shapes and launches.

template <int NXP>
struct Smem {};
struct Global {};

// The instance for nx: the global one when the wrapper gave a scratch,
// else the shared one at NXP = nx rounded up to 4.
template <typename T, typename F>
cudaError_t dispatch(int nx, bool global, F&& f) {
  if (global) return f(Global{});
  switch ((nx + 3) / 4 * 4) {
    case 4: return f(Smem<4>{});
    case 8: return f(Smem<8>{});
    case 12: return f(Smem<12>{});
    case 16: return f(Smem<16>{});
    case 20: return f(Smem<20>{});
    case 24:
      if constexpr (kMaxNxp<T> >= 24) return f(Smem<24>{});
      break;
  }
  return cudaErrorInvalidValue;  // the wrapper picks the global instance
}

// How one instance is launched.
struct Shape {
  int threads = 0;     // per block
  int per_block = 0;   // scenarios per block
  size_t smem = 0;     // dynamic shared memory per block, bytes
  long long blocks(int batch) const {
    return (batch + per_block - 1) / per_block;
  }
};

template <typename T, int NXP>
Shape shape(Smem<NXP>, int nz, int m, int py, int horizon) {
  constexpr int W = NXP / kRows, S = kLanesOf<T>;
  return Shape{W * S, S, smem_bytes<T>(nz, m, py, horizon, NXP, W)};
}

template <typename T>
Shape shape(Global, int, int m, int py, int horizon) {
  return Shape{kGlobalThreads, kGlobalThreads,
               static_cast<size_t>(horizon) * (py + 2 * m) * sizeof(T)};
}

template <typename T, int NXP>
const void* kernel_of(Smem<NXP>) {
  return reinterpret_cast<const void*>(
      fused_qp_soa_smem<T, NXP, kRows, kLanesOf<T>>);
}
template <typename T>
const void* kernel_of(Global) {
  return reinterpret_cast<const void*>(fused_qp_soa_global<T>);
}

// shared memory a block of the instance may have
template <int NXP>
constexpr size_t smem_limit(Smem<NXP>) { return kMaxSmem; }
constexpr size_t smem_limit(Global) { return kDefaultSmem; }

// The launch shape, with the opt-in above 48 KB of shared memory.
template <typename T, typename Inst>
cudaError_t prepare(Inst inst, const Params<T>& p, Shape* s) {
  *s = shape<T>(inst, p.nz, p.m, p.py, p.horizon);
  if (s->smem > smem_limit(inst)) return cudaErrorInvalidValue;
  if (s->smem > kDefaultSmem)
    return cudaFuncSetAttribute(kernel_of<T>(inst),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(s->smem));
  return cudaSuccess;
}

bool fill(double* dst, int* n_dst, const double* src, int n) {
  if (src == nullptr || n < 1 || n > kMaxChannels) return false;
  for (int i = 0; i < n; ++i) dst[i] = src[i];
  *n_dst = n;
  return true;
}

template <typename T>
cudaError_t make_params(Params<T>* p, int batch, int nz, int m, int py,
                        int horizon, int iters, int schulz_iters, double rho,
                        double sigma, double alpha, double f_clamp,
                        const double* qdiag, int nq, const double* rdiag,
                        int nr, const double* u_lo, int nlo,
                        const double* u_hi, int nhi) {
  if (batch <= 0 || nz <= 0 || m <= 0 || py <= 0 || horizon <= 0 ||
      iters < 0 || schulz_iters < 0)
    return cudaErrorInvalidValue;
  Channels& ch = p->ch;
  if (!fill(ch.q, &ch.nq, qdiag, nq) || !fill(ch.r, &ch.nr, rdiag, nr) ||
      !fill(ch.lo, &ch.nlo, u_lo, nlo) || !fill(ch.hi, &ch.nhi, u_hi, nhi))
    return cudaErrorInvalidValue;
  p->batch = batch;
  p->nz = nz;
  p->m = m;
  p->py = py;
  p->horizon = horizon;
  p->iters = iters;
  p->schulz_iters = schulz_iters;
  p->rho_scale = T(rho);
  p->sigma = T(sigma);
  p->alpha = T(alpha);
  p->one_minus_alpha = T(1.0 - alpha);
  p->f_clamp = T(f_clamp);
  return cudaSuccess;
}

template <typename T>
int launch(const T* a, const T* b, const T* cyc, const T* z0, const T* yr,
           const T* warm, T* u, T* scratch, int batch, int nz, int m, int py,
           int horizon, int iters, int schulz_iters, double rho, double sigma,
           double alpha, double f_clamp, const double* qdiag, int nq,
           const double* rdiag, int nr, const double* u_lo, int nlo,
           const double* u_hi, int nhi, void* stream) {
  Params<T> p;
  cudaError_t err = make_params(&p, batch, nz, m, py, horizon, iters,
                                schulz_iters, rho, sigma, alpha, f_clamp,
                                qdiag, nq, rdiag, nr, u_lo, nlo, u_hi, nhi);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.a = a, p.b = b, p.cyc = cyc, p.z0 = z0, p.yr = yr, p.warm = warm;
  p.u = u, p.scratch = scratch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<T>(
      horizon * m, scratch != nullptr, [&](auto inst) {
        Shape sh;
        cudaError_t e = prepare<T>(inst, p, &sh);
        if (e != cudaSuccess) return e;
        void* args[] = {&p};
        e = cudaLaunchKernel(kernel_of<T>(inst),
                             dim3(static_cast<unsigned>(sh.blocks(batch))),
                             dim3(sh.threads), args, sh.smem, s);
        if (e != cudaSuccess) return e;
        return cudaGetLastError();
      }));
}

// out = {registers per thread, shared bytes per block, warps per block,
// resident warps per SM, waves over the batch, NXP (0: global instance)}.
template <typename T>
int launch_shape(int global, int batch, int nz, int m, int py, int horizon,
                 int* out) {
  if (batch <= 0 || nz <= 0 || m <= 0 || py <= 0 || horizon <= 0)
    return cudaErrorInvalidValue;
  Params<T> p{};
  p.nz = nz, p.m = m, p.py = py, p.horizon = horizon;
  return static_cast<int>(dispatch<T>(
      horizon * m, global != 0, [&](auto inst) {
        Shape sh;
        cudaError_t e = prepare<T>(inst, p, &sh);
        if (e != cudaSuccess) return e;
        const void* kern = kernel_of<T>(inst);
        cudaFuncAttributes attr;
        e = cudaFuncGetAttributes(&attr, kern);
        if (e != cudaSuccess) return e;
        int per_sm = 0, dev = 0, sms = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          sh.threads, sh.smem);
        if (e != cudaSuccess) return e;
        if (per_sm == 0) return cudaErrorInvalidConfiguration;
        e = cudaGetDevice(&dev);
        if (e != cudaSuccess) return e;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
        const long long per_wave = static_cast<long long>(per_sm) * sms;
        out[0] = attr.numRegs;
        out[1] = static_cast<int>(sh.smem);
        out[2] = sh.threads / 32;
        out[3] = per_sm * sh.threads / 32;
        out[4] = static_cast<int>((sh.blocks(batch) + per_wave - 1) / per_wave);
        out[5] = global ? 0 : (horizon * m + 3) / 4 * 4;
        return cudaSuccess;
      }));
}

}  // namespace

extern "C" {

// Every tensor pointer is a contiguous device array: a (B, nz, nz),
// b (B, nz, m), cyc (B, py, nz), z0 (B, nz), yr (B, N py), warm and
// u (B, N m). scratch is null for the shared instance, else a
// (rows, B) array for the global one. qdiag, rdiag, u_lo and u_hi are host
// arrays of 1..16 doubles. Returns a cudaError_t (0 = success).
int fused_qp_soa_f32(const float* a, const float* b, const float* cyc,
                     const float* z0, const float* yr, const float* warm,
                     float* u, float* scratch, int batch, int nz, int m,
                     int py, int horizon, int iters, int schulz_iters,
                     double rho, double sigma, double alpha, double f_clamp,
                     const double* qdiag, int nq, const double* rdiag, int nr,
                     const double* u_lo, int nlo, const double* u_hi, int nhi,
                     void* stream) {
  return launch<float>(a, b, cyc, z0, yr, warm, u, scratch, batch, nz, m, py,
                       horizon, iters, schulz_iters, rho, sigma, alpha,
                       f_clamp, qdiag, nq, rdiag, nr, u_lo, nlo, u_hi, nhi,
                       stream);
}

int fused_qp_soa_f64(const double* a, const double* b, const double* cyc,
                     const double* z0, const double* yr, const double* warm,
                     double* u, double* scratch, int batch, int nz, int m,
                     int py, int horizon, int iters, int schulz_iters,
                     double rho, double sigma, double alpha, double f_clamp,
                     const double* qdiag, int nq, const double* rdiag, int nr,
                     const double* u_lo, int nlo, const double* u_hi, int nhi,
                     void* stream) {
  return launch<double>(a, b, cyc, z0, yr, warm, u, scratch, batch, nz, m,
                        py, horizon, iters, schulz_iters, rho, sigma, alpha,
                        f_clamp, qdiag, nq, rdiag, nr, u_lo, nlo, u_hi, nhi,
                        stream);
}

// Fills out[6] (see launch_shape) for float64 if f64 != 0, else float32,
// for the global instance if global != 0, else the shared one.
int fused_qp_soa_launch_shape(int f64, int global, int batch, int nz, int m,
                              int py, int horizon, int* out) {
  return f64 ? launch_shape<double>(global, batch, nz, m, py, horizon, out)
             : launch_shape<float>(global, batch, nz, m, py, horizon, out);
}

const char* fused_qp_soa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
