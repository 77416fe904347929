// Fused condensed-QP build and solve for Hopper (sm_90a), scenario-in-lanes
// (SoA) layout: one thread per scenario.
//
// Replaces the TPU kernel koopmanx/ops/qp_pallas_soa.py::fused_qp_solve_soa
// (body _kernel). It computes the same function as csrc/fused_qp.cu (the
// AoS kernel; koopmanx_torch/ops/fused_qp.py states it and holds the plain
// version of both): clipped Markov blocks and F1 z0 rows, P = 2(F2' Qbar F2
// + Rbar) and q, rho and K, a Newton-Schulz inverse, box ADMM from a zero
// dual.
//
// The TPU kernel made every per-scenario matrix entry a lane vector over
// the scenario tile, (rows, cols, T), and every product an unrolled
// multiply-accumulate over lanes. Carried over to Hopper: scenario b is
// thread b, and every array is laid out (element, B), so the 32 threads of
// a warp always touch 32 neighbouring addresses of one element. The
// wrapper lays the inputs out so (koopmanx_torch/ops/fused_qp_soa.py); the
// kernel reads A, B and CyC transposed from those same arrays.
//
// What bounds it: the work, as for the AoS kernel: about 0.6 MFLOP per
// scenario at the flagship's shapes (nz = 8, m = 1, py = 2, N = 20,
// 16 Newton-Schulz steps, 60 ADMM iterations), 4.9 GFLOP at B = 8192, 73 us
// at 67 TFLOP/s float32, against 704 bytes per scenario in and out (1.7 us
// at 3.35 TB/s).
//
// The working set (about 1,800 values a scenario: 7 KB in float32) cannot
// sit in registers. It lives in a global scratch laid out (element, B)
// that the wrapper allocates (rows from fused_qp_soa_scratch_rows), rather
// than in per-thread local memory: any size works without a compile-time
// bound, and the layout coalesces by construction. Only the per-channel
// weight and bound vectors, shared by all scenarios, go to shared memory,
// once per block. Each thread's products are sequential loops over its own
// column, so the kernel leans on the L1 and L2 caches; one thread per
// scenario also leaves the card short of warps at B = 8192 (256 warps on
// 132 SMs). Both are the design carried over as it is; making it fast is
// later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see koopmanx_torch/ops/build.py)

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxChannels = 16;

struct Channels {
  double q[kMaxChannels], r[kMaxChannels], lo[kMaxChannels], hi[kMaxChannels];
  int nq, nr, nlo, nhi;
};

// Rows of the (rows, B) scratch, in elements per scenario.
struct Layout {
  int g, gn, s, sn, mk, err, q, rhs, x, z, y, k, xi, t, xn, total;
};

__host__ __device__ inline Layout make_layout(int nz, int m, int py,
                                              int horizon) {
  const int nx = horizon * m, nrow = horizon * py;
  Layout L;
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

// One scenario's column of a (rows, B) array.
template <typename P>
struct Col {
  P* p;
  long long stride;
  __device__ __forceinline__ P& operator[](int e) const {
    return p[static_cast<long long>(e) * stride];
  }
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

template <typename T>
__global__ void fused_qp_soa_kernel(const T* __restrict__ a_in,
                                    const T* __restrict__ b_in,
                                    const T* __restrict__ cyc_in,
                                    const T* __restrict__ z0_in,
                                    const T* __restrict__ yr_in,
                                    const T* __restrict__ warm_in,
                                    T* __restrict__ u_out,
                                    T* __restrict__ scratch, int batch,
                                    int nz, int m, int py, int horizon,
                                    int iters, int schulz_iters, T rho_scale,
                                    T sigma, T alpha, T one_minus_alpha,
                                    T f_clamp, Channels ch) {
  extern __shared__ unsigned char smem_raw[];
  const int nx = horizon * m, nrow = horizon * py;
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
  if (bi >= batch) return;

  const long long n = batch;
  const Layout L = make_layout(nz, m, py, horizon);
  auto in = [&](const T* base) { return Col<const T>{base + bi, n}; };
  auto sc = [&](int row) { return Col<T>{scratch + row * n + bi, n}; };
  const Col<const T> A = in(a_in), Bm = in(b_in), C = in(cyc_in);
  const Col<const T> z0 = in(z0_in), yr = in(yr_in), warm = in(warm_in);
  Col<T> G = sc(L.g), Gn = sc(L.gn), S = sc(L.s), Sn = sc(L.sn);
  const Col<T> Mk = sc(L.mk), Err = sc(L.err), Q = sc(L.q), Rhs = sc(L.rhs);
  const Col<T> X = sc(L.x), Z = sc(L.z), Y = sc(L.y), K = sc(L.k);
  Col<T> Xi = sc(L.xi), Xn = sc(L.xn);
  const Col<T> Tm = sc(L.t);

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
  const T rho = rho_scale * nan_max(trace / T(nx), T(1e-6));
  const T shift = sigma + rho;
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
  for (int it = 0; it < schulz_iters; ++it) {
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
  for (int it = 0; it < iters; ++it) {
    for (int i = 0; i < nx; ++i)
      Rhs[i] = sigma * X[i] - Q[i] + rho * Z[i] - Y[i];
    for (int i = 0; i < nx; ++i) {
      T acc = T(0);
      for (int j = 0; j < nx; ++j) acc += Xi[i * nx + j] * Rhs[j];
      const T xm = alpha * acc + one_minus_alpha * Z[i];
      const T zn = clip(xm + Y[i] / rho, lo[i], hi[i]);
      Y[i] = Y[i] + rho * (xm - zn);
      Z[i] = zn;
      X[i] = acc;
    }
  }
  const Col<T> u{u_out + bi, n};
  for (int i = 0; i < nx; ++i) u[i] = Z[i];
}

bool fill(double* dst, int* n_dst, const double* src, int n) {
  if (src == nullptr || n < 1 || n > kMaxChannels) return false;
  for (int i = 0; i < n; ++i) dst[i] = src[i];
  *n_dst = n;
  return true;
}

template <typename T>
int launch(const T* a, const T* b, const T* cyc, const T* z0, const T* yr,
           const T* warm, T* u, T* scratch, int batch, int nz, int m, int py,
           int horizon, int iters, int schulz_iters, double rho, double sigma,
           double alpha, double f_clamp, const double* qdiag, int nq,
           const double* rdiag, int nr, const double* u_lo, int nlo,
           const double* u_hi, int nhi, void* stream) {
  if (batch <= 0 || nz <= 0 || m <= 0 || py <= 0 || horizon <= 0 ||
      iters < 0 || schulz_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Channels ch;
  if (!fill(ch.q, &ch.nq, qdiag, nq) || !fill(ch.r, &ch.nr, rdiag, nr) ||
      !fill(ch.lo, &ch.nlo, u_lo, nlo) || !fill(ch.hi, &ch.nhi, u_hi, nhi))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(horizon) * (py + 2 * m) * sizeof(T);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + kThreads - 1) / kThreads;
  fused_qp_soa_kernel<T><<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      a, b, cyc, z0, yr, warm, u, scratch, batch, nz, m, py, horizon, iters,
      schulz_iters, T(rho), T(sigma), T(alpha), T(1.0 - alpha), T(f_clamp),
      ch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of the (rows, B) scratch the kernel needs.
int fused_qp_soa_scratch_rows(int nz, int m, int py, int horizon) {
  return make_layout(nz, m, py, horizon).total;
}

// Every tensor pointer is a contiguous device array laid out scenario-minor:
// a (nz*nz, B), b (nz*m, B), cyc (py*nz, B), z0 (nz, B), yr (N*py, B),
// warm and u (N*m, B), scratch (rows, B). qdiag, rdiag, u_lo and u_hi are
// host arrays of 1..16 doubles. Returns a cudaError_t (0 = success).
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

const char* fused_qp_soa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
