// Fused condensed-QP build and solve for Hopper (sm_90a), AoS layout:
// one warp per scenario.
//
// Replaces the TPU kernel koopmanx/ops/qp_pallas.py::fused_qp_solve (body
// _kernel). Same function, per scenario (koopmanx_torch/ops/fused_qp.py
// states it and holds its plain version): the clipped Markov blocks
// M_j = clip(CyC A^j B) and F1 z0 rows clip(CyC A^(j+1) z0); P =
// 2(F2' Qbar F2 + Rbar) (not symmetrized) and q = 2 F2' Qbar (F1 z0 - yr);
// rho = rho_cfg max(trace(P)/nx, 1e-6) and K = P + (sigma + rho) I;
// schulz_iters Newton-Schulz steps X <- X (2I - K X) from
// X = K / (|K|_1 |K|_inf); then `iters` box-ADMM iterations (B1's, with X
// in place of Minv) from x = warm, z = clip(warm), y = 0. Writes z.
//
// What bounds it: the work. Per scenario at the flagship's shapes (nz = 8,
// m = 1, py = 2, N = 20, nx = N m = 20, 16 Newton-Schulz steps, 60 ADMM
// iterations) about 610 kFLOP, 518 kFLOP of it the Newton-Schulz products
// and 62 kFLOP the ADMM, against 704 bytes in and out in float32. At
// B = 8192: 0.0746 ms at the card's 67 TFLOP/s float32 peak outside the
// tensor cores, against 1.7 us of bytes at 3.35 TB/s
// (chip_smoke.py::fused_qp_bound_ms).
//
// What held the first design (fused_qp_generic below) at 8 % of that
// bound: shared-memory loads. Its whole working set sat in the warp's
// slice of shared memory, and each product gave lane e the output elements
// e, e + 32, ..., so every FMA loaded both operands from shared memory
// (K[r][k] and X[k][c]; in the ADMM X'[j][i] and rhs[j]): about 16,000
// warp-wide loads a scenario, at about one a clock an SM. It took 0.915 ms
// at B = 8192, 0.60 ms of it in the Newton-Schulz products
// (tools/check_fused_qp.py's breakdown; PERF.md).
//
// The register instance (fused_qp_regs<T, NXP>, nx <= 32, NXP = nx rounded
// up to 4) keeps one warp per scenario and the function's arithmetic:
// 1. Newton-Schulz products as register tiles. Lane l owns the 4 x 4
//    output tiles l, l + 32, ... of an NXP x NXP product (25 tiles on 25
//    lanes at nx = 20) and keeps their 16 accumulators in registers. For
//    each k it loads four consecutive values of the left factor's column k
//    and of the right factor's row k (a float4, or two double2), which
//    feed 16 FMAs. The left factor's columns are rows of its transpose, so
//    shared memory holds K' (K itself is never stored: it is not bitwise
//    symmetric, since H[r][c] and H[c][r] round differently) beside X, X'
//    and T: T = 2I - K X reads K' and X, X T reads X' and T. T is written
//    as it is computed (nothing reads T in that product); the new X stays
//    in registers until a __syncwarp shows every lane has read X', then is
//    written in both layouts. Lanes without a tile meet every __syncwarp.
// 2. The ADMM with row i of the final X in registers (lane i, indices fixed
//    at compile time, zero past nx), rhs shared through two NXP-wide
//    buffers taken in turn and read back by every lane with 16-byte
//    broadcast loads, as B1's register instance does (csrc/box_admm.cu):
//    NXP / 4 (float32) or NXP / 2 (float64) loads per NXP FMAs, and one
//    __syncwarp an iteration. (Shuffles would take one instruction per
//    element.)
// 3. A smaller slice of shared memory: the prologue's arrays (A, B, CyC,
//    the CyC A^j and A^j z0 recursions, the Markov blocks, the error) live
//    in the space of X, X' and T until the seed overwrites it: 6,800 bytes
//    a warp at the flagship's shapes in float32 (7,584 in the first
//    design). The launcher asks the occupancy API about 1, 2, 4 and 8 warps
//    a block and takes the fewest waves over the batch, then the most
//    resident warps; float32 instances with one tile a lane are held to 64
//    registers, so that 32 warps fit on an SM: 2 waves at B = 8192, not 3.
// Every dot product is still one FMA chain per output element in ascending
// k (the first design's order), so the result is the first design's bit
// for bit. Rows and columns from nx to NXP are zero in K', X, X' and T and
// are never written, so the padded terms add +0 (0 x 0, whatever rho or K
// hold). Offsets of K', X, X', T and rhs are 16-byte aligned
// (regs_layout; ops/fused_qp.py::aos_shared_bytes mirrors it).
//
// What bounds it now: shared-memory bandwidth in the Newton-Schulz
// products. Each step issues 80 16-byte tile loads a warp beside its 640
// FMAs, and a 16-byte load costs the SM's shared-memory pipe as much per
// value as a 4-byte one whether or not lanes share its address, so the
// loads, not the FMAs, set the pace. Larger tiles would leave lanes idle
// and need more loads a product; tensor cores were kept out (TF32 keeps
// about three digits, and the 16-step inverse is unconverged on some
// models). The rest is the prologue, whose dependent passes run several
// times the instructions of their arithmetic, and the ADMM.
// chip_smoke.py measured 0.350-0.353 ms of device time at the flagship's
// shapes, B = 8192, float32 on an NVIDIA H100 80GB HBM3 (700 W), 21 % of
// the bound, against the first design's 0.916-0.922 ms in the same call
// (PERF.md).
//
// The generic instance (fused_qp_generic<T, ROWS>, 32 < nx <= 128, or a
// register layout past 227 KB) is the first design: the working set in the
// warp's slice of shared memory (Layout below), products split element by
// element over the lanes, X' in shared memory for the ADMM, ceil(nx / 32)
// ADMM rows a lane. The launcher picks the instance from the shapes alone
// (ops/fused_qp.py::aos_instance mirrors the rule).
//
// Both share the prologue (build_qp): the Markov recursion in one pass a
// step (M_j, the next CyC A^j and A^j z0, and the F1 z0 row of the step
// before); F2 never exists: it is block-Toeplitz, so
//     H[(j,b),(l,c)] = sum_{i >= max(j,l)} sum_a M_{i-j}[a,b] qbar_(i,a) M_{i-l}[a,c]
// and q likewise, are summed straight from the Markov blocks in one
// strided loop an element, skipping the structural zeros that the plain
// version multiplies. Warps never meet at a block barrier, and the grid's
// bounds check covers any B.
//
// Limits (the wrapper enforces them first): nx = N m <= 128; one warp's
// working set in the first design's layout within the 227 KB of shared
// memory a block may use; at most 16 entries in each per-channel weight
// and bound array (they travel by value in the kernel's parameters).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see koopmanx_torch/ops/build.py)

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxChannels = 16;
constexpr int kMaxRegsNx = 32;  // widest nx the register instance takes
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
// block sizes (warps) the register instance chooses from
constexpr int kBlockWarps[] = {1, 2, 4, 8};

// Per-channel stage weights and input bounds; entry i of a horizon-stacked
// vector takes vals[i % n].
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
  int batch, nz, m, py, horizon, iters, schulz_iters;
  T rho_scale, sigma, alpha, one_minus_alpha, f_clamp;
  Channels ch;
};

// The prologue's arrays, back to back from offset 0, in elements.
struct Prologue {
  int a, b, cyc, g, gn, s, sn, mk, err, total;
};

__host__ __device__ inline Prologue prologue_layout(int nz, int m, int py,
                                                    int horizon) {
  Prologue P;
  int o = 0;
  P.a = o;    o += nz * nz;
  P.b = o;    o += nz * m;
  P.cyc = o;  o += py * nz;
  P.g = o;    o += py * nz;
  P.gn = o;   o += py * nz;
  P.s = o;    o += nz;
  P.sn = o;   o += nz;
  P.mk = o;   o += horizon * py * m;
  P.err = o;  o += horizon * py;
  P.total = o;
  return P;
}

// One warp's slice of shared memory in the first design, in elements: the
// prologue, then Qbar, q, rhs and K, X, T and the next X, nx x nx each
// (mirrored by koopmanx_torch/ops/fused_qp.py::aos_shared_bytes).
struct Layout {
  int qbar, q, rhs, k, x, t, xn, total;
};

__host__ __device__ inline Layout make_layout(int nz, int m, int py,
                                              int horizon) {
  const int nx = horizon * m, nrow = horizon * py;
  Layout L;
  int o = prologue_layout(nz, m, py, horizon).total;
  L.qbar = o; o += nrow;
  L.q = o;    o += nx;
  L.rhs = o;  o += nx;
  L.k = o;    o += nx * nx;
  L.x = o;    o += nx * nx;
  L.t = o;    o += nx * nx;
  L.xn = o;   o += nx * nx;
  L.total = o;
  return L;
}

// One warp's slice in the register instance, in elements, every offset and
// the total a multiple of 16 bytes: K' (NXP^2); X, X' and T (NXP^2 each;
// the prologue's arrays share their space, which is at least the
// prologue's size); two rhs buffers (NXP each); q (NXP); Qbar (N py).
struct RegsLayout {
  int kt, x, xt, t, rhs, q, qbar, total;
};

__host__ __device__ inline int align16(int n, int item) {
  const int per = 16 / item;  // elements in 16 bytes
  return (n + per - 1) / per * per;
}

__host__ __device__ inline RegsLayout regs_layout(int nz, int m, int py,
                                                  int horizon, int nxp,
                                                  int item) {
  const int sq = nxp * nxp;
  const int pro = prologue_layout(nz, m, py, horizon).total;
  RegsLayout L;
  int o = 0;
  L.kt = o;   o += sq;
  L.x = o;
  L.xt = o + sq;
  L.t = o + 2 * sq;
  o += align16(3 * sq > pro ? 3 * sq : pro, item);
  L.rhs = o;  o += 2 * nxp;
  L.q = o;    o += nxp;
  L.qbar = o; o += horizon * py;
  L.total = align16(o, item);
  return L;
}

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

template <typename T>
__device__ __forceinline__ void swap_ptr(T*& p, T*& q) {
  T* t = p;
  p = q;
  q = t;
}

// Four consecutive values from or to 16-byte-aligned shared memory.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 t0 = *reinterpret_cast<const double2*>(p);
  const double2 t1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = t0.x, v[1] = t0.y, v[2] = t1.x, v[3] = t1.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// Steps 1-2 for one warp: the inputs into shared memory, the Markov blocks
// and F1 z0 rows, the weighted error, q, and P into sK with leading
// dimension ld (K[r][c] at sK[r ld + c], or at sK[c ld + r] if
// `transposed`; zero past nx). Ends with a __syncwarp.
template <typename T>
__device__ __forceinline__ void build_qp(const Params<T>& p, long long bi,
                                         int lane, T* pro, T* sQbar, T* sQ,
                                         T* sK, int ld, bool transposed) {
  const int nz = p.nz, m = p.m, py = p.py, horizon = p.horizon;
  const int nx = horizon * m, nrow = horizon * py;
  const Channels& ch = p.ch;
  const T f_clamp = p.f_clamp;
  const Prologue P = prologue_layout(nz, m, py, horizon);
  T* sA = pro + P.a;
  T* sB = pro + P.b;
  T* sC = pro + P.cyc;
  T* sG = pro + P.g;
  T* sGn = pro + P.gn;
  T* sS = pro + P.s;
  T* sSn = pro + P.sn;
  T* sMk = pro + P.mk;
  T* sErr = pro + P.err;

  // ---- inputs, each read once and coalesced ----
  for (int e = lane; e < nz * nz; e += kWarp) sA[e] = p.a[bi * nz * nz + e];
  for (int e = lane; e < nz * m; e += kWarp) sB[e] = p.b[bi * nz * m + e];
  for (int e = lane; e < py * nz; e += kWarp) {
    const T v = p.cyc[bi * py * nz + e];
    sC[e] = v;
    sG[e] = v;
  }
  for (int e = lane; e < nz; e += kWarp) sS[e] = p.z0[bi * nz + e];
  for (int r = lane; r < nrow; r += kWarp) sQbar[r] = T(ch.q[r % ch.nq]);
  __syncwarp();

  // ---- Markov blocks M_j = clip(G B) and F1 z0 rows, G = CyC A^j: one
  // pass a step over the step's dot products, each element one lane's FMA
  // chain over k: M_j = G B, the next G = G A, the next s = A s (s =
  // A^j z0), and the F1 z0 row of the step before, clip(CyC s) ----
  const int n_mk = py * m, n_g = py * nz, n_s = nz;
  for (int j = 0; j <= horizon; ++j) {
    const bool step = j < horizon, row = j > 0;
    const int lo = step ? 0 : n_mk + n_g + n_s;
    const int hi = n_mk + n_g + n_s + (row ? py : 0);
    for (int e = lo + lane; e < hi; e += kWarp) {
      const T* x;  // x[k] * y[k ys], k < nz
      const T* y;
      int ys = 1;
      if (e < n_mk) {
        const int r = e / m, c = e - r * m;
        x = sG + r * nz, y = sB + c, ys = m;
      } else if (e < n_mk + n_g) {
        const int r = (e - n_mk) / nz, c = e - n_mk - r * nz;
        x = sG + r * nz, y = sA + c, ys = nz;
      } else if (e < n_mk + n_g + n_s) {
        x = sA + (e - n_mk - n_g) * nz, y = sS;
      } else {
        x = sC + (e - n_mk - n_g - n_s) * nz, y = sS;
      }
      T acc = T(0);
      for (int k = 0; k < nz; ++k) acc += x[k] * y[k * ys];
      if (e < n_mk)
        sMk[j * n_mk + e] = clip(acc, -f_clamp, f_clamp);
      else if (e < n_mk + n_g)
        sGn[e - n_mk] = acc;
      else if (e < n_mk + n_g + n_s)
        sSn[e - n_mk - n_g] = acc;
      else
        sErr[(j - 1) * py + e - n_mk - n_g - n_s] = clip(acc, -f_clamp, f_clamp);
    }
    __syncwarp();  // the pass read G and s; the next reads what it wrote
    swap_ptr(sG, sGn);
    swap_ptr(sS, sSn);  // sS = A^(j+1) z0
  }

  // ---- weighted tracking error Qbar (F1 z0 - yr) ----
  for (int r = lane; r < nrow; r += kWarp)
    sErr[r] = (sErr[r] - p.yr[bi * nrow + r]) * sQbar[r];
  __syncwarp();

  // ---- P = 2 (F2' Qbar F2 + Rbar) and q = 2 F2' err, from the blocks.
  // Element (r, c) of P sums M_{i-jr}[a][br] (M_{i-jc}[a][bc] qbar_(i,a))
  // over i from max(jr, jc) up and a < py, in that order: term t of the
  // flattened (i, a) sequence lies t m past the first in the blocks and t
  // past it in Qbar. Elements go to lanes shell by shell (shell d: the
  // 2d + 1 elements with max(r, c) = d, column d then row d), so the lanes
  // of a pass sum about as many terms ----
  for (int e = lane; e < ld * ld; e += kWarp) {
    int d = static_cast<int>(sqrtf(static_cast<float>(e)));
    while (d * d > e) --d;
    while ((d + 1) * (d + 1) <= e) ++d;
    const int o = e - d * d;
    const int r = o < d ? o : d, c = o < d ? d : o - d;
    T v = T(0);
    if (r < nx && c < nx) {
      const int jr = r / m, br = r - jr * m;
      const int jc = c / m, bc = c - jc * m;
      const int i0 = jr > jc ? jr : jc;
      const T* m1 = sMk + (i0 - jr) * py * m + br;
      const T* m2 = sMk + (i0 - jc) * py * m + bc;
      const T* qb = sQbar + i0 * py;
      const int terms = (horizon - i0) * py;
      T acc = T(0);
      for (int t = 0; t < terms; ++t) acc += m1[t * m] * (m2[t * m] * qb[t]);
      if (r == c) acc += T(ch.r[r % ch.nr]);
      v = T(2) * acc;
    }
    sK[transposed ? c * ld + r : r * ld + c] = v;
  }
  for (int r = lane; r < nx; r += kWarp) {  // the same flattening
    const int j = r / m, br = r - j * m;
    const T* mk = sMk + br;
    const T* er = sErr + j * py;
    const int terms = (horizon - j) * py;
    T acc = T(0);
    for (int t = 0; t < terms; ++t) acc += mk[t * m] * er[t];
    sQ[r] = T(2) * acc;
  }
  __syncwarp();
}

// Step 3 and the seed's scale: rho from trace(P), K = P + (sigma + rho) I
// in place, and |K|_1 |K|_inf (every lane gets both). sK as build_qp left
// it; only the diagonal changes.
template <typename T>
__device__ __forceinline__ void kkt_and_scale(const Params<T>& p, int lane,
                                              T* sK, int ld, bool transposed,
                                              T* rho_out, T* scale_out) {
  const int nx = p.horizon * p.m;
  T trace = T(0);
  for (int i = 0; i < nx; ++i) trace += sK[i * ld + i];  // every lane alike
  const T rho = p.rho_scale * nan_max(trace / T(nx), T(1e-6));
  __syncwarp();  // every lane has read the diagonal before it changes
  const T shift = p.sigma + rho;
  for (int i = lane; i < nx; i += kWarp) sK[i * ld + i] += shift;
  __syncwarp();

  // ---- |K|_1 (column sums) and |K|_inf (row sums) ----
  auto kat = [&](int r, int c) -> T {
    return transposed ? sK[c * ld + r] : sK[r * ld + c];
  };
  T norm1 = T(0), norminf = T(0);
  for (int c = lane; c < nx; c += kWarp) {
    T col = T(0), row = T(0);
    for (int r = 0; r < nx; ++r) {
      col += abs_val(kat(r, c));
      row += abs_val(kat(c, r));
    }
    norm1 = nan_max(norm1, col);
    norminf = nan_max(norminf, row);
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    norm1 = nan_max(norm1, __shfl_xor_sync(0xffffffffu, norm1, off));
    norminf = nan_max(norminf, __shfl_xor_sync(0xffffffffu, norminf, off));
  }
  *rho_out = rho;
  *scale_out = norm1 * norminf;
}

// ---------------------------------------------------------------------------
// The first design, for the shapes the register instance does not take.

template <typename T, int ROWS>
__global__ void fused_qp_generic(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = p.nz, m = p.m, py = p.py, horizon = p.horizon;
  const Layout L = make_layout(nz, m, py, horizon);
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long bi = static_cast<long long>(blockIdx.x) * warps + warp;
  if (bi >= p.batch) return;  // whole warp exits together: no sync hazard

  const int nx = horizon * m;
  const Channels& ch = p.ch;
  T* sm = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * L.total;
  T* sQ = sm + L.q;
  T* sRhs = sm + L.rhs;
  T* sK = sm + L.k;
  T* sX = sm + L.x;
  T* sT = sm + L.t;
  T* sXn = sm + L.xn;

  build_qp(p, bi, lane, sm, sm + L.qbar, sQ, sK, nx, false);
  T rho, scale;
  kkt_and_scale(p, lane, sK, nx, false, &rho, &scale);

  // ---- Newton-Schulz seed X = K / (|K|_1 |K|_inf) ----
  for (int e = lane; e < nx * nx; e += kWarp) sX[e] = sK[e] / scale;
  __syncwarp();

  // ---- Newton-Schulz: X <- X (2I - K X) ----
  for (int it = 0; it < p.schulz_iters; ++it) {
    for (int e = lane; e < nx * nx; e += kWarp) {
      const int r = e / nx, c = e - r * nx;
      T acc = T(0);
      for (int k = 0; k < nx; ++k) acc += sK[r * nx + k] * sX[k * nx + c];
      sT[e] = (r == c ? T(2) : T(0)) - acc;
    }
    __syncwarp();
    for (int e = lane; e < nx * nx; e += kWarp) {
      const int r = e / nx, c = e - r * nx;
      T acc = T(0);
      for (int k = 0; k < nx; ++k) acc += sX[r * nx + k] * sT[k * nx + c];
      sXn[e] = acc;
    }
    __syncwarp();
    swap_ptr(sX, sXn);
  }

  // ---- X transposed into T: lane i reads row i at consecutive banks ----
  for (int e = lane; e < nx * nx; e += kWarp) {
    const int r = e / nx, c = e - r * nx;
    sT[c * nx + r] = sX[e];
  }

  // ---- box ADMM from x = warm, z = clip(warm), y = 0 ----
  const T sigma = p.sigma, alpha = p.alpha, one_minus_alpha = p.one_minus_alpha;
  T x[ROWS], z[ROWS], y[ROWS], qv[ROWS], lov[ROWS], hiv[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = lane + k * kWarp;
    if (i < nx) {
      lov[k] = T(ch.lo[i % ch.nlo]);
      hiv[k] = T(ch.hi[i % ch.nhi]);
      qv[k] = sQ[i];
      x[k] = p.warm[bi * nx + i];
      y[k] = T(0);
      z[k] = clip(x[k], lov[k], hiv[k]);
    } else {
      qv[k] = lov[k] = hiv[k] = x[k] = y[k] = z[k] = T(0);
    }
  }
  __syncwarp();

  for (int it = 0; it < p.iters; ++it) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int i = lane + k * kWarp;
      if (i < nx) sRhs[i] = sigma * x[k] - qv[k] + rho * z[k] - y[k];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int i = lane + k * kWarp;
      if (i < nx) {
        T acc = T(0);
        for (int j = 0; j < nx; ++j) acc += sT[j * nx + i] * sRhs[j];
        const T xm = alpha * acc + one_minus_alpha * z[k];
        const T zn = clip(xm + y[k] / rho, lov[k], hiv[k]);
        y[k] = y[k] + rho * (xm - zn);
        z[k] = zn;
        x[k] = acc;
      }
    }
    __syncwarp();  // every lane has read sRhs before the next write
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = lane + k * kWarp;
    if (i < nx) p.u[bi * nx + i] = z[k];
  }
}

// ---------------------------------------------------------------------------
// The register instance (see the note at the top).

// acc[i][j] = sum_k A'[k][i] B[k][j], k = 0 .. NXP - 1 ascending, one FMA
// chain per element: `at` points at column i0 of row 0 of A' (the left
// factor transposed), `b` at column j0 of row 0 of B; rows NXP apart.
template <typename T, int NXP>
__device__ __forceinline__ void tile_product(const T* at, const T* b,
                                             T (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
#pragma unroll
  for (int k = 0; k < NXP; ++k) {
    T av[4], bv[4];
    load4(at + k * NXP, av);
    load4(b + k * NXP, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// v[i][j] into buf[(r0 + i) NXP + c0 + j], or, if `transposed`, into
// buf[(c0 + j) NXP + r0 + i]; nothing at or past nx.
template <typename T, int NXP>
__device__ __forceinline__ void store_tile(T* buf, int r0, int c0, int nx,
                                           const T (&v)[4][4],
                                           bool transposed) {
  if (r0 + 4 <= nx && c0 + 4 <= nx) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      T w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = transposed ? v[j][i] : v[i][j];
      store4(buf + ((transposed ? c0 : r0) + i) * NXP +
                 (transposed ? r0 : c0), w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + i, c = c0 + j;
        if (r < nx && c < nx) buf[transposed ? c * NXP + r : r * NXP + c] = v[i][j];
      }
  }
}

// Float instances with one tile a lane are held to 64 registers, so that
// 32 warps fit on an SM (2 waves at B = 8192 instead of 3).
template <typename T, int NXP>
__global__ void __launch_bounds__(8 * kWarp, sizeof(T) == 4 && NXP <= 20 ? 4 : 1)
    fused_qp_regs(const Params<T> p) {
  static_assert(NXP % 4 == 0 && NXP <= kMaxRegsNx, "NXP is nx rounded up to 4");
  constexpr int kTileCols = NXP / 4;
  constexpr int kTiles = kTileCols * kTileCols;
  constexpr int kTilesPerLane = (kTiles + kWarp - 1) / kWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nz = p.nz, m = p.m, py = p.py, horizon = p.horizon;
  const RegsLayout L = regs_layout(nz, m, py, horizon, NXP, sizeof(T));
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long bi = static_cast<long long>(blockIdx.x) * warps + warp;
  if (bi >= p.batch) return;  // whole warp exits together: no sync hazard

  const int nx = horizon * m;
  const Channels& ch = p.ch;
  T* sm = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * L.total;
  T* const kt = sm + L.kt;
  T* const sx = sm + L.x;
  T* const sxt = sm + L.xt;
  T* const st = sm + L.t;

  // K' into kt (zero past nx); the prologue's arrays in X's space onwards
  build_qp(p, bi, lane, sx, sm + L.qbar, sm + L.q, kt, NXP, true);
  T rho, scale;
  kkt_and_scale(p, lane, kt, NXP, true, &rho, &scale);

  // ---- seed X = K / (|K|_1 |K|_inf) in both layouts over the prologue's
  // arrays (dead now); zero past nx in X, X' and T ----
  for (int e = lane; e < NXP * NXP; e += kWarp) {
    const int i0 = e / NXP, i1 = e - i0 * NXP;
    const bool in = i0 < nx && i1 < nx;
    const T v = in ? kt[e] / scale : T(0);  // K[i1][i0] / s
    sxt[e] = v;                             // X'[i0][i1]
    sx[i1 * NXP + i0] = v;                  // X[i1][i0]
    if (!in) st[e] = T(0);
  }
  __syncwarp();

  // ---- Newton-Schulz: X <- X (2I - K X), 4 x 4 tiles in registers ----
  for (int it = 0; it < p.schulz_iters; ++it) {
    // T = 2I - K X from K' and X; nothing reads T here, so each tile is
    // stored as soon as it is summed
#pragma unroll
    for (int s = 0; s < kTilesPerLane; ++s) {
      const int tile = lane + s * kWarp;
      if (tile < kTiles) {
        const int r0 = tile / kTileCols * 4, c0 = tile % kTileCols * 4;
        T acc[4][4];
        tile_product<T, NXP>(kt + r0, sx + c0, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = (r0 + i == c0 + j ? T(2) : T(0)) - acc[i][j];
        store_tile<T, NXP>(st, r0, c0, nx, acc, false);
      }
    }
    __syncwarp();
    // X T from X' and T; the tiles wait in registers until every lane has
    // read X', then go to X and X'
    T acc[kTilesPerLane][4][4];
#pragma unroll
    for (int s = 0; s < kTilesPerLane; ++s) {
      const int tile = lane + s * kWarp;
      if (tile < kTiles) {
        const int r0 = tile / kTileCols * 4, c0 = tile % kTileCols * 4;
        tile_product<T, NXP>(sxt + r0, st + c0, acc[s]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kTilesPerLane; ++s) {
      const int tile = lane + s * kWarp;
      if (tile < kTiles) {
        const int r0 = tile / kTileCols * 4, c0 = tile % kTileCols * 4;
        store_tile<T, NXP>(sx, r0, c0, nx, acc[s], false);
        store_tile<T, NXP>(sxt, r0, c0, nx, acc[s], true);
      }
    }
    __syncwarp();
  }

  // ---- box ADMM from x = warm, z = clip(warm), y = 0; lane i keeps row i
  // of X in registers (zero past nx) ----
  const bool own = lane < nx;
  T row[NXP];
#pragma unroll
  for (int c = 0; c < NXP; c += 4) {
    T v[4] = {T(0), T(0), T(0), T(0)};
    if (own) load4(sx + lane * NXP + c, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) row[c + k] = v[k];
  }
  const T sigma = p.sigma, alpha = p.alpha, one_minus_alpha = p.one_minus_alpha;
  T qv = T(0), lov = T(0), hiv = T(0), x = T(0), y = T(0), z = T(0);
  if (own) {
    lov = T(ch.lo[lane % ch.nlo]);
    hiv = T(ch.hi[lane % ch.nhi]);
    qv = sm[L.q + lane];
    x = p.warm[bi * nx + lane];
    z = clip(x, lov, hiv);
  }
  auto step = [&](T* buf) {
    const T rhs = sigma * x - qv + rho * z - y;
    if (lane < NXP) buf[lane] = own ? rhs : T(0);
    __syncwarp();
    T acc = T(0);
#pragma unroll
    for (int c = 0; c < NXP; c += 4) {
      T r[4];
      load4(buf + c, r);  // one address in every lane: a broadcast
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += row[c + k] * r[k];
    }
    if (own) {
      const T xm = alpha * acc + one_minus_alpha * z;
      const T zn = clip(xm + y / rho, lov, hiv);
      y = y + rho * (xm - zn);
      z = zn;
      x = acc;
    }
  };
  // buffers in turn: a lane writes the first again only after the
  // __syncwarp of the second, which every lane reaches after its reads of
  // the first
  T* const buf0 = sm + L.rhs;
  T* const buf1 = buf0 + NXP;
  int it = 0;
  for (; it + 2 <= p.iters; it += 2) {
    step(buf0);
    step(buf1);
  }
  if (it < p.iters) step(buf0);

  if (own) p.u[bi * nx + lane] = z;
}

// ---------------------------------------------------------------------------
// Instances, shapes and launches.

template <int NXP>
struct Regs {};
template <int ROWS>
struct Generic {};

// The instance for a shape: the register one where nx <= 32 and its slice
// fits 227 KB, else the first design (ops/fused_qp.py::aos_instance).
template <typename T, typename F>
cudaError_t dispatch(int nz, int m, int py, int horizon, F&& f) {
  const int nx = horizon * m, nxp = (nx + 3) / 4 * 4;
  const size_t regs_bytes =
      static_cast<size_t>(regs_layout(nz, m, py, horizon, nxp, sizeof(T)).total) *
      sizeof(T);
  if (nx <= kMaxRegsNx && regs_bytes <= kMaxSmem) {
    switch (nxp) {
      case 4: return f(Regs<4>{});
      case 8: return f(Regs<8>{});
      case 12: return f(Regs<12>{});
      case 16: return f(Regs<16>{});
      case 20: return f(Regs<20>{});
      case 24: return f(Regs<24>{});
      case 28: return f(Regs<28>{});
      case 32: return f(Regs<32>{});
    }
  }
  const int rows = (nx + kWarp - 1) / kWarp;
  if (rows == 1) return f(Generic<1>{});
  if (rows == 2) return f(Generic<2>{});
  if (rows <= 4) return f(Generic<4>{});
  return cudaErrorInvalidValue;  // N m > 128: the wrapper refuses first
}

template <typename T, int NXP>
const void* kernel_of(Regs<NXP>) {
  return reinterpret_cast<const void*>(fused_qp_regs<T, NXP>);
}
template <typename T, int ROWS>
const void* kernel_of(Generic<ROWS>) {
  return reinterpret_cast<const void*>(fused_qp_generic<T, ROWS>);
}

template <typename T, int NXP>
size_t warp_bytes(Regs<NXP>, const Params<T>& p) {
  return static_cast<size_t>(
             regs_layout(p.nz, p.m, p.py, p.horizon, NXP, sizeof(T)).total) *
         sizeof(T);
}
template <typename T, int ROWS>
size_t warp_bytes(Generic<ROWS>, const Params<T>& p) {
  return static_cast<size_t>(make_layout(p.nz, p.m, p.py, p.horizon).total) *
         sizeof(T);
}

// How one instance is launched, and how it fills the card.
struct Shape {
  int warps = 0;          // warps (scenarios) per block
  size_t smem = 0;        // dynamic shared memory per block, bytes
  int blocks_per_sm = 0;  // resident blocks per SM
  int sms = 0;

  long long blocks(int batch) const { return (batch + warps - 1) / warps; }
  long long waves(int batch) const {
    const long long per_wave = static_cast<long long>(blocks_per_sm) * sms;
    return (blocks(batch) + per_wave - 1) / per_wave;
  }
  int resident_warps() const { return blocks_per_sm * warps; }
};

// Resident blocks of `warps` warps with `smem` bytes each, with the opt-in
// above 48 KB of shared memory.
cudaError_t resident_blocks(const void* kern, int warps, size_t smem, int* n) {
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kern, warps * kWarp,
                                                       smem);
}

// Register instance: the block size with the fewest waves over the batch,
// then the most resident warps.
template <typename T, int NXP>
cudaError_t shape(Regs<NXP> inst, const Params<T>& p, Shape* best) {
  const void* kern = kernel_of<T>(inst);
  const size_t per_warp = warp_bytes<T>(inst, p);
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *best = Shape{};
  for (int warps : kBlockWarps) {
    Shape s;
    s.warps = warps;
    s.smem = per_warp * warps;
    s.sms = sms;
    if (s.smem > kMaxSmem) break;
    err = resident_blocks(kern, warps, s.smem, &s.blocks_per_sm);
    if (err != cudaSuccess) return err;
    if (s.blocks_per_sm == 0) continue;
    if (best->warps == 0 || s.waves(p.batch) < best->waves(p.batch) ||
        (s.waves(p.batch) == best->waves(p.batch) &&
         s.resident_warps() > best->resident_warps()))
      *best = s;
  }
  if (best->warps == 0) return cudaErrorInvalidConfiguration;
  // the launch needs the chosen size's opt-in (the search left the last)
  return resident_blocks(kern, best->warps, best->smem, &best->blocks_per_sm);
}

// First design: up to 4 warps per block within 227 KB of shared memory.
template <typename T, int ROWS>
cudaError_t shape(Generic<ROWS> inst, const Params<T>& p, Shape* s) {
  const size_t per_warp = warp_bytes<T>(inst, p);
  if (per_warp > kMaxSmem) return cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&s->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  s->warps = 4;
  while (s->warps > 1 && per_warp * s->warps > kMaxSmem) --s->warps;
  s->smem = per_warp * s->warps;
  return resident_blocks(kernel_of<T>(inst), s->warps, s->smem,
                       &s->blocks_per_sm);
}

bool fill(double* dst, int* n_dst, const double* src, int n) {
  if (src == nullptr || n < 1 || n > kMaxChannels) return false;
  for (int i = 0; i < n; ++i) dst[i] = src[i];
  *n_dst = n;
  return true;
}

template <typename T>
int launch(const T* a, const T* b, const T* cyc, const T* z0, const T* yr,
           const T* warm, T* u, int batch, int nz, int m, int py, int horizon,
           int iters, int schulz_iters, double rho, double sigma, double alpha,
           double f_clamp, const double* qdiag, int nq, const double* rdiag,
           int nr, const double* u_lo, int nlo, const double* u_hi, int nhi,
           void* stream) {
  if (batch <= 0 || nz <= 0 || m <= 0 || py <= 0 || horizon <= 0 ||
      iters < 0 || schulz_iters < 0)
    return cudaErrorInvalidValue;
  Params<T> p{a, b, cyc, z0, yr, warm, u, batch, nz, m, py, horizon, iters,
              schulz_iters, T(rho), T(sigma), T(alpha), T(1.0 - alpha),
              T(f_clamp), {}};
  Channels& ch = p.ch;
  if (!fill(ch.q, &ch.nq, qdiag, nq) || !fill(ch.r, &ch.nr, rdiag, nr) ||
      !fill(ch.lo, &ch.nlo, u_lo, nlo) || !fill(ch.hi, &ch.nhi, u_hi, nhi))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<T>(nz, m, py, horizon, [&](auto inst) {
    Shape sh;
    cudaError_t err = shape<T>(inst, p, &sh);
    if (err != cudaSuccess) return err;
    void* args[] = {&p};
    err = cudaLaunchKernel(kernel_of<T>(inst),
                           dim3(static_cast<unsigned>(sh.blocks(batch))),
                           dim3(sh.warps * kWarp), args, sh.smem, s);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }));
}

template <int NXP>
constexpr int nxp_of(Regs<NXP>) { return NXP; }
template <int ROWS>
constexpr int nxp_of(Generic<ROWS>) { return 0; }

// out = {registers per thread, shared bytes per block, warps per block,
// resident warps per SM, waves over the batch, NXP (0: generic instance)}.
template <typename T>
int launch_shape(int batch, int nz, int m, int py, int horizon, int* out) {
  if (batch <= 0 || nz <= 0 || m <= 0 || py <= 0 || horizon <= 0)
    return cudaErrorInvalidValue;
  Params<T> p{};
  p.batch = batch, p.nz = nz, p.m = m, p.py = py, p.horizon = horizon;
  return static_cast<int>(dispatch<T>(nz, m, py, horizon, [&](auto inst) {
    Shape sh;
    cudaError_t err = shape<T>(inst, p, &sh);
    if (err != cudaSuccess) return err;
    if (sh.blocks_per_sm == 0) return cudaErrorInvalidConfiguration;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel_of<T>(inst));
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(sh.smem);
    out[2] = sh.warps;
    out[3] = sh.resident_warps();
    out[4] = static_cast<int>(sh.waves(batch));
    out[5] = nxp_of(inst);
    return cudaSuccess;
  }));
}

}  // namespace

extern "C" {

// Every tensor pointer is a contiguous device array: a (B, nz, nz),
// b (B, nz, m), cyc (B, py, nz), z0 (B, nz), yr (B, N py), warm and
// u (B, N m). qdiag, rdiag, u_lo and u_hi are host arrays of 1..16
// doubles. Returns a cudaError_t (0 = success).
int fused_qp_f32(const float* a, const float* b, const float* cyc,
                 const float* z0, const float* yr, const float* warm,
                 float* u, int batch, int nz, int m, int py, int horizon,
                 int iters, int schulz_iters, double rho, double sigma,
                 double alpha, double f_clamp, const double* qdiag, int nq,
                 const double* rdiag, int nr, const double* u_lo, int nlo,
                 const double* u_hi, int nhi, void* stream) {
  return launch<float>(a, b, cyc, z0, yr, warm, u, batch, nz, m, py, horizon,
                       iters, schulz_iters, rho, sigma, alpha, f_clamp, qdiag,
                       nq, rdiag, nr, u_lo, nlo, u_hi, nhi, stream);
}

int fused_qp_f64(const double* a, const double* b, const double* cyc,
                 const double* z0, const double* yr, const double* warm,
                 double* u, int batch, int nz, int m, int py, int horizon,
                 int iters, int schulz_iters, double rho, double sigma,
                 double alpha, double f_clamp, const double* qdiag, int nq,
                 const double* rdiag, int nr, const double* u_lo, int nlo,
                 const double* u_hi, int nhi, void* stream) {
  return launch<double>(a, b, cyc, z0, yr, warm, u, batch, nz, m, py,
                        horizon, iters, schulz_iters, rho, sigma, alpha,
                        f_clamp, qdiag, nq, rdiag, nr, u_lo, nlo, u_hi, nhi,
                        stream);
}

// Fills out[6] (see launch_shape) for float64 if f64 != 0, else float32.
int fused_qp_launch_shape(int f64, int batch, int nz, int m, int py,
                          int horizon, int* out) {
  return f64 ? launch_shape<double>(batch, nz, m, py, horizon, out)
             : launch_shape<float>(batch, nz, m, py, horizon, out);
}

const char* fused_qp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
