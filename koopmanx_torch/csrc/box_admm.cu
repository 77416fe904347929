// Batched box-QP ADMM for Hopper (sm_90a): one warp per scenario.
//
// Replaces the TPU kernel koopmanx/ops/qp_pallas_box.py::box_admm_pallas
// (body _admm_kernel). Same function: given each scenario's KKT inverse
// Minv = (P + (sigma + rho) I)^-1, run `iters` fixed OSQP box-ADMM
// iterations
//     rhs = sigma x - q + rho z - y
//     xt  = Minv rhs
//     xm  = alpha xt + (1 - alpha) z
//     z   = clip(xm + y / rho, lo, hi)
//     y   = y + rho (xm - z)          (x <- xt)
// from x = x0, y = y0, z = clip(x0, lo, hi), and return (xt, z, y).
//
// What bounds it: per scenario per launch about iters * (2 nx^2 + 12 nx)
// floating-point operations (62 kFLOP at nx = 20, iters = 60) against
// about 4 (nx^2 + 9 nx + 1) bytes moved in float32 (Minv, six input and
// three output vectors, rho: 2.3 KB). At B = 8192 that is 0.51 GFLOP and
// 19 MB: 7.6 us at the card's 67 TFLOP/s float32 (non-tensor) peak
// against 5.7 us at 3.35 TB/s, so the work, not the bytes, bounds it.
// The 60 iterations are a dependent chain, so in practice the launch is
// latency-bound per warp and needs many scenarios in flight.
//
// What the design does about it: Minv is read from device memory once and
// kept in shared memory for all iterations (the TPU kernel kept it in
// VMEM for the same reason), stored column-major so that lane i reading
// element (i, j) hits consecutive banks. Each lane owns rows
// i = lane, lane + 32, ... of x, z, y, q, lo, hi in registers, so any nx
// works; per iteration the warp writes rhs to shared memory, syncs, and
// every lane does its own row dot products. No block-level barrier: warps
// are independent, and a block of a few warps fills the SMs at any B.
// The grid covers B with a bounds check, so no padding is needed.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see koopmanx_torch/ops/build.py)

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  // NaN-propagating, as jnp.clip and torch.clamp: a NaN compares false
  return v < lo ? lo : (v > hi ? hi : v);
}

// ROWS = rows per lane = ceil(nx / 32), a compile-time bound so that the
// per-lane state lives in registers.
template <typename T, int ROWS>
__global__ void box_admm_kernel(const T* __restrict__ minv,
                                const T* __restrict__ q,
                                const T* __restrict__ lo,
                                const T* __restrict__ hi,
                                const T* __restrict__ x0,
                                const T* __restrict__ y0,
                                const T* __restrict__ rho_in,
                                T* __restrict__ xt_out,
                                T* __restrict__ z_out,
                                T* __restrict__ y_out,
                                int batch, int nx, int iters,
                                T sigma, T alpha, T one_minus_alpha) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= batch) return;  // whole warp exits together: no sync hazard

  T* s_minv_t = smem + static_cast<size_t>(warp) * (nx * nx + nx);
  T* s_rhs = s_minv_t + nx * nx;

  // Minv once: coalesced read, transposed store (s_minv_t[j*nx+i] = M[i][j])
  const T* m_b = minv + b * nx * nx;
  for (int e = lane; e < nx * nx; e += kWarp) {
    const int i = e / nx, j = e - i * nx;
    s_minv_t[j * nx + i] = m_b[e];
  }

  const long long off = b * nx;
  const T rho = rho_in[b];
  T x[ROWS], z[ROWS], y[ROWS], qv[ROWS], lov[ROWS], hiv[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = lane + k * kWarp;
    if (i < nx) {
      qv[k] = q[off + i];
      lov[k] = lo[off + i];
      hiv[k] = hi[off + i];
      x[k] = x0[off + i];
      y[k] = y0[off + i];
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
      if (i < nx) s_rhs[i] = sigma * x[k] - qv[k] + rho * z[k] - y[k];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int i = lane + k * kWarp;
      if (i < nx) {
        T acc = T(0);
        for (int j = 0; j < nx; ++j) acc += s_minv_t[j * nx + i] * s_rhs[j];
        const T xm = alpha * acc + one_minus_alpha * z[k];
        const T zn = clip(xm + y[k] / rho, lov[k], hiv[k]);
        y[k] = y[k] + rho * (xm - zn);
        z[k] = zn;
        x[k] = acc;
      }
    }
    __syncwarp();  // every lane has read s_rhs before the next write
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = lane + k * kWarp;
    if (i < nx) {
      xt_out[off + i] = x[k];
      z_out[off + i] = z[k];
      y_out[off + i] = y[k];
    }
  }
}

template <typename T, int ROWS>
cudaError_t launch_rows(const T* minv, const T* q, const T* lo, const T* hi,
                        const T* x0, const T* y0, const T* rho, T* xt, T* z,
                        T* y, int batch, int nx, int iters, double sigma,
                        double alpha, cudaStream_t stream) {
  const size_t per_warp = static_cast<size_t>(nx) * (nx + 1) * sizeof(T);
  constexpr size_t kDefaultSmem = 48 * 1024;
  constexpr size_t kMaxSmem = 227 * 1024;
  if (per_warp > kMaxSmem) return cudaErrorInvalidValue;
  int warps = 4;
  while (warps > 1 && per_warp * warps > kDefaultSmem) --warps;
  const size_t smem = per_warp * warps;
  auto kern = box_admm_kernel<T, ROWS>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (batch + warps - 1) / warps;
  kern<<<blocks, warps * kWarp, smem, stream>>>(
      minv, q, lo, hi, x0, y0, rho, xt, z, y, batch, nx, iters, T(sigma),
      T(alpha), T(1.0 - alpha));
  return cudaGetLastError();
}

template <typename T>
int launch(const T* minv, const T* q, const T* lo, const T* hi, const T* x0,
           const T* y0, const T* rho, T* xt, T* z, T* y, int batch, int nx,
           int iters, double sigma, double alpha, void* stream) {
  if (batch <= 0 || nx <= 0 || iters < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = (nx + kWarp - 1) / kWarp;
  cudaError_t err;
  if (rows == 1)
    err = launch_rows<T, 1>(minv, q, lo, hi, x0, y0, rho, xt, z, y, batch,
                            nx, iters, sigma, alpha, s);
  else if (rows == 2)
    err = launch_rows<T, 2>(minv, q, lo, hi, x0, y0, rho, xt, z, y, batch,
                            nx, iters, sigma, alpha, s);
  else if (rows <= 4)
    err = launch_rows<T, 4>(minv, q, lo, hi, x0, y0, rho, xt, z, y, batch,
                            nx, iters, sigma, alpha, s);
  else
    err = cudaErrorInvalidValue;  // nx > 128: the wrapper refuses first
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Every pointer is a contiguous device array: minv (B, nx, nx); q, lo, hi,
// x0, y0, xt, z, y (B, nx); rho (B,). Returns a cudaError_t (0 = success).
int box_admm_f32(const float* minv, const float* q, const float* lo,
                 const float* hi, const float* x0, const float* y0,
                 const float* rho, float* xt, float* z, float* y, int batch,
                 int nx, int iters, double sigma, double alpha,
                 void* stream) {
  return launch<float>(minv, q, lo, hi, x0, y0, rho, xt, z, y, batch, nx,
                       iters, sigma, alpha, stream);
}

int box_admm_f64(const double* minv, const double* q, const double* lo,
                 const double* hi, const double* x0, const double* y0,
                 const double* rho, double* xt, double* z, double* y,
                 int batch, int nx, int iters, double sigma, double alpha,
                 void* stream) {
  return launch<double>(minv, q, lo, hi, x0, y0, rho, xt, z, y, batch, nx,
                        iters, sigma, alpha, stream);
}

const char* box_admm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
