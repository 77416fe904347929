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
// What bounds it: per scenario at the flagship's shapes (nz = 8, m = 1,
// py = 2, N = 20, nx = N m = 20, 16 Newton-Schulz steps, 60 ADMM
// iterations) about 0.6 MFLOP, of which 16 x 2 x 2 nx^3 = 512 kFLOP is the
// Newton-Schulz inverse and 60 x (2 nx^2 + 12 nx) = 62 kFLOP the ADMM,
// against 704 bytes in and out in float32 (A, B, CyC, z0, yr, warm in; u
// out). At B = 8192: 4.9 GFLOP, 73 us at the card's 67 TFLOP/s float32
// peak outside the tensor cores, against 5.8 MB, 1.7 us at 3.35 TB/s: the
// work bounds it. The work is a dependent chain of small products per
// scenario (20 Markov steps, 2 x 16 Newton-Schulz products, 60 ADMM
// matvecs), so in practice a warp waits on its own shared-memory latency
// and the card needs many scenarios in flight.
//
// What the design does about it: the inputs are read from device memory
// once, coalesced, and the whole working set stays in the warp's slice of
// shared memory (the TPU kernel kept it in VMEM): A, B, CyC, the CyC A^j and
// A^j z0 recursions, the N Markov blocks, the weighted tracking error, q,
// and four nx x nx buffers K, X, T = 2I - KX and the next X (about 1,900
// values at the flagship's shapes: 7.5 KB in float32, 15 KB in float64).
// F2 never exists: it is block-Toeplitz, so
//     H[(j,b),(l,c)] = sum_{i >= max(j,l)} sum_a M_{i-j}[a,b] qbar_(i,a) M_{i-l}[a,c]
// and q likewise, are summed straight from the Markov blocks, skipping the
// structural zeros that the plain version multiplies. Reading F2
// transposed is the same math as the TPU kernel's reshape (m = 1 or
// py = 1) or its dual recursion (otherwise), with other rounding. Every
// matrix product splits its output elements over the 32 lanes (lane e
// computes element e, e + 32, ...; neighbouring lanes read neighbouring
// columns of the right factor), with a __syncwarp between dependent
// products. Before the ADMM, X is stored transposed so that lane i reading
// row i hits consecutive banks; the ADMM state lives in registers,
// ceil(nx / 32) rows per lane. Warps never meet at a block barrier, and
// the grid's bounds check covers any B.
//
// Limits (the wrapper enforces them first): nx = N m <= 128 (at most four
// ADMM rows per lane, as in B1); one warp's working set (Layout below)
// within the 227 KB of shared memory a block may use, which bounds nz,
// N py and N m together; at most 16 entries in each per-channel weight and
// bound array (they travel by value in the kernel's parameters).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see koopmanx_torch/ops/build.py)

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxChannels = 16;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// Per-channel stage weights and input bounds; entry i of a horizon-stacked
// vector takes vals[i % n].
struct Channels {
  double q[kMaxChannels], r[kMaxChannels], lo[kMaxChannels], hi[kMaxChannels];
  int nq, nr, nlo, nhi;
};

// One warp's slice of shared memory, in elements (mirrored by
// koopmanx_torch/ops/fused_qp.py::aos_shared_bytes).
struct Layout {
  int a, b, cyc, g, gn, s, sn, mk, err, qbar, q, rhs, k, x, t, xn, total;
};

__host__ __device__ inline Layout make_layout(int nz, int m, int py,
                                              int horizon) {
  const int nx = horizon * m, nrow = horizon * py;
  Layout L;
  int o = 0;
  L.a = o;    o += nz * nz;
  L.b = o;    o += nz * m;
  L.cyc = o;  o += py * nz;
  L.g = o;    o += py * nz;
  L.gn = o;   o += py * nz;
  L.s = o;    o += nz;
  L.sn = o;   o += nz;
  L.mk = o;   o += horizon * py * m;
  L.err = o;  o += nrow;
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

template <typename T, int ROWS>
__global__ void fused_qp_kernel(const T* __restrict__ a_in,
                                const T* __restrict__ b_in,
                                const T* __restrict__ cyc_in,
                                const T* __restrict__ z0_in,
                                const T* __restrict__ yr_in,
                                const T* __restrict__ warm_in,
                                T* __restrict__ u_out, int batch, int nz,
                                int m, int py, int horizon, int iters,
                                int schulz_iters, T rho_scale, T sigma,
                                T alpha, T one_minus_alpha, T f_clamp,
                                Channels ch) {
  extern __shared__ unsigned char smem_raw[];
  const Layout L = make_layout(nz, m, py, horizon);
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long bi = static_cast<long long>(blockIdx.x) * warps + warp;
  if (bi >= batch) return;  // whole warp exits together: no sync hazard

  const int nx = horizon * m, nrow = horizon * py;
  T* sm = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * L.total;
  T* sA = sm + L.a;
  T* sB = sm + L.b;
  T* sC = sm + L.cyc;
  T* sG = sm + L.g;
  T* sGn = sm + L.gn;
  T* sS = sm + L.s;
  T* sSn = sm + L.sn;
  T* sMk = sm + L.mk;
  T* sErr = sm + L.err;
  T* sQbar = sm + L.qbar;
  T* sQ = sm + L.q;
  T* sRhs = sm + L.rhs;
  T* sK = sm + L.k;
  T* sX = sm + L.x;
  T* sT = sm + L.t;
  T* sXn = sm + L.xn;

  // ---- inputs, each read once and coalesced ----
  for (int e = lane; e < nz * nz; e += kWarp) sA[e] = a_in[bi * nz * nz + e];
  for (int e = lane; e < nz * m; e += kWarp) sB[e] = b_in[bi * nz * m + e];
  for (int e = lane; e < py * nz; e += kWarp) {
    const T v = cyc_in[bi * py * nz + e];
    sC[e] = v;
    sG[e] = v;
  }
  for (int e = lane; e < nz; e += kWarp) sS[e] = z0_in[bi * nz + e];
  for (int r = lane; r < nrow; r += kWarp) sQbar[r] = T(ch.q[r % ch.nq]);
  __syncwarp();

  // ---- Markov blocks M_j = clip(G B) and F1 z0 rows, G = CyC A^j ----
  for (int j = 0; j < horizon; ++j) {
    T* mk = sMk + j * py * m;
    for (int e = lane; e < py * m; e += kWarp) {
      const int r = e / m, c = e - r * m;
      T acc = T(0);
      for (int k = 0; k < nz; ++k) acc += sG[r * nz + k] * sB[k * m + c];
      mk[e] = clip(acc, -f_clamp, f_clamp);
    }
    for (int e = lane; e < py * nz; e += kWarp) {
      const int r = e / nz, c = e - r * nz;
      T acc = T(0);
      for (int k = 0; k < nz; ++k) acc += sG[r * nz + k] * sA[k * nz + c];
      sGn[e] = acc;
    }
    for (int i = lane; i < nz; i += kWarp) {
      T acc = T(0);
      for (int k = 0; k < nz; ++k) acc += sA[i * nz + k] * sS[k];
      sSn[i] = acc;
    }
    __syncwarp();
    swap_ptr(sG, sGn);
    swap_ptr(sS, sSn);  // sS = A^(j+1) z0
    for (int r = lane; r < py; r += kWarp) {
      T acc = T(0);
      for (int k = 0; k < nz; ++k) acc += sC[r * nz + k] * sS[k];
      sErr[j * py + r] = clip(acc, -f_clamp, f_clamp);
    }
    __syncwarp();
  }

  // ---- weighted tracking error Qbar (F1 z0 - yr) ----
  for (int r = lane; r < nrow; r += kWarp)
    sErr[r] = (sErr[r] - yr_in[bi * nrow + r]) * sQbar[r];
  __syncwarp();

  // ---- P = 2 (F2' Qbar F2 + Rbar) and q = 2 F2' err, from the blocks ----
  for (int e = lane; e < nx * nx; e += kWarp) {
    const int r = e / nx, c = e - r * nx;
    const int jr = r / m, br = r - jr * m;
    const int jc = c / m, bc = c - jc * m;
    T acc = T(0);
    for (int i = (jr > jc ? jr : jc); i < horizon; ++i) {
      const T* m1 = sMk + (i - jr) * py * m;
      const T* m2 = sMk + (i - jc) * py * m;
      for (int a = 0; a < py; ++a)
        acc += m1[a * m + br] * (m2[a * m + bc] * sQbar[i * py + a]);
    }
    if (r == c) acc += T(ch.r[r % ch.nr]);
    sK[e] = T(2) * acc;
  }
  for (int r = lane; r < nx; r += kWarp) {
    const int j = r / m, br = r - j * m;
    T acc = T(0);
    for (int i = j; i < horizon; ++i) {
      const T* mk = sMk + (i - j) * py * m;
      for (int a = 0; a < py; ++a) acc += mk[a * m + br] * sErr[i * py + a];
    }
    sQ[r] = T(2) * acc;
  }
  __syncwarp();

  // ---- rho from trace(P); K = P + (sigma + rho) I ----
  T trace = T(0);
  for (int i = 0; i < nx; ++i) trace += sK[i * nx + i];  // every lane alike
  const T rho = rho_scale * nan_max(trace / T(nx), T(1e-6));
  __syncwarp();  // every lane has read the diagonal before it changes
  const T shift = sigma + rho;
  for (int i = lane; i < nx; i += kWarp) sK[i * nx + i] += shift;
  __syncwarp();

  // ---- Newton-Schulz seed X = K / (|K|_1 |K|_inf) ----
  T norm1 = T(0), norminf = T(0);
  for (int c = lane; c < nx; c += kWarp) {
    T col = T(0), row = T(0);
    for (int r = 0; r < nx; ++r) {
      col += abs_val(sK[r * nx + c]);
      row += abs_val(sK[c * nx + r]);
    }
    norm1 = nan_max(norm1, col);
    norminf = nan_max(norminf, row);
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    norm1 = nan_max(norm1, __shfl_xor_sync(0xffffffffu, norm1, off));
    norminf = nan_max(norminf, __shfl_xor_sync(0xffffffffu, norminf, off));
  }
  const T scale = norm1 * norminf;
  for (int e = lane; e < nx * nx; e += kWarp) sX[e] = sK[e] / scale;
  __syncwarp();

  // ---- Newton-Schulz: X <- X (2I - K X) ----
  for (int it = 0; it < schulz_iters; ++it) {
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
  T x[ROWS], z[ROWS], y[ROWS], qv[ROWS], lov[ROWS], hiv[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = lane + k * kWarp;
    if (i < nx) {
      lov[k] = T(ch.lo[i % ch.nlo]);
      hiv[k] = T(ch.hi[i % ch.nhi]);
      qv[k] = sQ[i];
      x[k] = warm_in[bi * nx + i];
      y[k] = T(0);
      z[k] = clip(x[k], lov[k], hiv[k]);
    } else {
      qv[k] = lov[k] = hiv[k] = x[k] = y[k] = z[k] = T(0);
    }
  }
  __syncwarp();

  for (int it = 0; it < iters; ++it) {
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
    if (i < nx) u_out[bi * nx + i] = z[k];
  }
}

template <typename T, int ROWS>
cudaError_t launch_rows(const T* a, const T* b, const T* cyc, const T* z0,
                        const T* yr, const T* warm, T* u, int batch, int nz,
                        int m, int py, int horizon, int iters,
                        int schulz_iters, double rho, double sigma,
                        double alpha, double f_clamp, const Channels& ch,
                        cudaStream_t stream) {
  const size_t per_warp =
      static_cast<size_t>(make_layout(nz, m, py, horizon).total) * sizeof(T);
  if (per_warp > kMaxSmem) return cudaErrorInvalidValue;
  int warps = 4;
  while (warps > 1 && per_warp * warps > kMaxSmem) --warps;
  const size_t smem = per_warp * warps;
  auto kern = fused_qp_kernel<T, ROWS>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (batch + warps - 1) / warps;
  kern<<<blocks, warps * kWarp, smem, stream>>>(
      a, b, cyc, z0, yr, warm, u, batch, nz, m, py, horizon, iters,
      schulz_iters, T(rho), T(sigma), T(alpha), T(1.0 - alpha), T(f_clamp),
      ch);
  return cudaGetLastError();
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
  Channels ch;
  if (!fill(ch.q, &ch.nq, qdiag, nq) || !fill(ch.r, &ch.nr, rdiag, nr) ||
      !fill(ch.lo, &ch.nlo, u_lo, nlo) || !fill(ch.hi, &ch.nhi, u_hi, nhi))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = (horizon * m + kWarp - 1) / kWarp;
  cudaError_t err;
  if (rows == 1)
    err = launch_rows<T, 1>(a, b, cyc, z0, yr, warm, u, batch, nz, m, py,
                            horizon, iters, schulz_iters, rho, sigma, alpha,
                            f_clamp, ch, s);
  else if (rows == 2)
    err = launch_rows<T, 2>(a, b, cyc, z0, yr, warm, u, batch, nz, m, py,
                            horizon, iters, schulz_iters, rho, sigma, alpha,
                            f_clamp, ch, s);
  else if (rows <= 4)
    err = launch_rows<T, 4>(a, b, cyc, z0, yr, warm, u, batch, nz, m, py,
                            horizon, iters, schulz_iters, rho, sigma, alpha,
                            f_clamp, ch, s);
  else
    err = cudaErrorInvalidValue;  // N m > 128: the wrapper refuses first
  return static_cast<int>(err);
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

const char* fused_qp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
