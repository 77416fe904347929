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
// 19 MB: 7.63 us (0.00763 ms) at the card's 67 TFLOP/s float32
// (non-tensor) peak against 5.7 us at 3.35 TB/s, so the operations, not
// the bytes, bound it. With one scenario per warp and lane i owning row i,
// nx = 20 keeps 20 of 32 lanes busy: at most ~62 % of that bound.
//
// Why the first design (Minv in shared memory) ran at 6 % of the bound:
// each iteration wrote rhs to shared memory and then every lane ran a
// 20-term dot product whose every term loaded two values from shared
// memory, Minv^T[j][i] and rhs[j] (nx was a runtime value, so the rhs
// broadcast could not be vectorised): 40 loads and 1 store per 20 FMAs.
// A warp-wide shared load is one wavefront, and an SM serves about one
// per clock; at B = 8192 about 62 warps run on each SM, so about
// 62 x 41 = 2,500 wavefronts per iteration per SM, ~150 k clocks over 60
// iterations, ~80 us of the measured 127 us. It was bound by shared-memory
// loads, not FMAs. The transposed store of Minv (a 20-word stride, 8-way
// bank conflict) and an IEEE division y / rho in every iteration added
// to it.
//
// The design for nx <= 32 (box_admm_regs), step by step:
// 1. Minv's row in registers. Lane i reads row i of its scenario's Minv
//    from device memory once, with 16-byte loads where the rows are
//    16-byte aligned (nx a multiple of 4 in float32, of 2 in float64),
//    into a register array of NXP = nx rounded up to 8 entries, zero past
//    nx, so the inner loop needs no predicate. The warp's rows together
//    cover the scenario's contiguous Minv. No shared copy, no transposed
//    store, no bank conflict.
// 2. rhs by broadcast. Each iteration lane i < nx writes rhs[i] into a
//    per-warp 16-byte-aligned buffer of NXP entries (zero past nx) and
//    the warp syncs; then every lane reads the whole buffer with NXP / 4
//    (float32) or NXP / 2 (float64) 16-byte loads of one address, which
//    are broadcasts. Two buffers in turn make one __syncwarp per
//    iteration enough. At nx = 20: 6 loads and 1 store per 24 FMAs,
//    against 40 and 1 per 20 before.
// 3. A shorter dependent chain: the dot product runs in 4 independent
//    accumulators summed at the end. The plain version sums in cuBLAS's
//    order, so this reassociation is one more order of the same sum; it
//    stays inside the float32 tolerance the kernel is held to (1e-5 x
//    scale in chip_smoke.py; a CPU emulation of this order reads
//    1.1e-6 at nx = 32).
// 4. One reciprocal per scenario: inv_rho = 1 / rho once, then y * inv_rho,
//    as the TPU kernel does (qp_pallas_box.py:73, :103). The plain version
//    keeps y / rho; the one-ulp difference sits inside the tolerance.
// 5. Occupancy: the launcher asks the occupancy API
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) about 1, 2, 4 and 8
//    warps per block and takes the size that covers the batch in the
//    fewest waves, then the one with the most resident warps. ptxas gives
//    the float32 NXP = 24 instance (nx = 20) 62 registers a thread, no
//    spills; on an H100 80GB HBM3 (700 W) that leaves 32 resident warps
//    per SM (at 1 or 2 warps per block; the launcher takes 1), so
//    B = 8192 runs in 2 waves. One wave would need 63 resident warps per
//    SM, i.e. 32 registers or fewer, which the 24-entry row and the state
//    of the iteration do not fit in. The search earns its place at the
//    narrow instances: at NXP = 8 (32 registers in float32) one warp per
//    block stops at 32 resident warps, the card's 32 blocks per SM, where
//    two warps per block reach 64. (chip_smoke.py phase 2 prints these
//    numbers for every instance it launches.) chip_smoke.py measured
//    0.0367 ms of device time per launch at B = 8192, nx = 20, 60
//    iterations, 21 % of the bound; the first design took 0.127-0.129 ms
//    back to back on the same card.
//
// For 32 < nx <= 128 (box_admm_smem) the rows do not fit in registers:
// that instance keeps Minv transposed in shared memory, each lane owns
// rows lane, lane + 32, ... (ROWS = 2 or 4), and the warp shares rhs
// through shared memory, as the first design did (with step 4).
//
// No block-level barrier in either: warps are independent. The grid
// covers B with a bounds check, so no padding is needed.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see koopmanx_torch/ops/build.py)

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRegsNx = 32;  // widest nx the register instance takes
// block sizes (warps) the register instance chooses from
constexpr int kBlockWarps[] = {1, 2, 4, 8};
constexpr int kBlockChoices = sizeof(kBlockWarps) / sizeof(kBlockWarps[0]);

template <typename T>
struct Args {
  const T* minv;  // (B, nx, nx)
  const T* q;     // (B, nx), as lo, hi, x0, y0
  const T* lo;
  const T* hi;
  const T* x0;
  const T* y0;
  const T* rho;  // (B,)
  T* xt;         // (B, nx) out, as z, y
  T* z;
  T* y;
  int batch, nx, iters;
  T sigma, alpha, one_minus_alpha;
};

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  // NaN-propagating, as jnp.clip and torch.clamp: a NaN compares false
  return v < lo ? lo : (v > hi ? hi : v);
}

// One 16-byte load of V consecutive values.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
};
template <>
struct Vec16<double> {
  static constexpr int V = 2;
  __device__ __forceinline__ static void load(const double* p, double* v) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
};

// nx <= NXP <= 32: lane i holds row i of Minv in registers (see the note).
// Dynamic shared memory: two rhs buffers of NXP entries per warp.
template <typename T, int NXP>
__global__ void box_admm_regs(const Args<T> a) {
  constexpr int V = Vec16<T>::V;
  static_assert(NXP % 8 == 0 && NXP <= kWarp, "NXP is nx rounded up to 8");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= a.batch) return;  // whole warp exits together: no sync hazard
  T* const buf0 = reinterpret_cast<T*>(smem_raw) + warp * 2 * NXP;
  T* const buf1 = buf0 + NXP;

  const int nx = a.nx;
  const bool own = lane < nx;  // lanes past nx compute on zeros, store 0
  const long long off = b * nx + (own ? lane : 0);

  T row[NXP];
  const T* m_row = a.minv + off * nx;
  const bool vec = nx % V == 0 &&
                   reinterpret_cast<std::uintptr_t>(a.minv) % 16 == 0;
  if (vec) {
#pragma unroll
    for (int c = 0; c < NXP; c += V) {
      T v[V] = {};
      if (own && c < nx) Vec16<T>::load(m_row + c, v);
#pragma unroll
      for (int k = 0; k < V; ++k) row[c + k] = v[k];
    }
  } else {
#pragma unroll
    for (int j = 0; j < NXP; ++j) row[j] = own && j < nx ? m_row[j] : T(0);
  }

  T qv = 0, lov = 0, hiv = 0, x = 0, y = 0;
  if (own) {
    qv = a.q[off];
    lov = a.lo[off];
    hiv = a.hi[off];
    x = a.x0[off];
    y = a.y0[off];
  }
  T z = clip(x, lov, hiv);
  const T rho = a.rho[b];
  const T inv_rho = T(1) / rho;
  const T sigma = a.sigma, alpha = a.alpha, beta = a.one_minus_alpha;

  auto step = [&](T* buf) {
    const T rhs = sigma * x - qv + rho * z - y;
    if (lane < NXP) buf[lane] = own ? rhs : T(0);
    __syncwarp();
    T acc[4] = {};
#pragma unroll
    for (int c = 0; c < NXP; c += V) {
      T r[V];
      Vec16<T>::load(buf + c, r);  // one address in every lane: a broadcast
#pragma unroll
      for (int k = 0; k < V; ++k) acc[(c + k) % 4] += row[c + k] * r[k];
    }
    const T xt = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    const T xm = alpha * xt + beta * z;
    const T zn = clip(xm + y * inv_rho, lov, hiv);
    y = y + rho * (xm - zn);
    z = zn;
    x = xt;
  };
  // buffers in turn: a lane writes buf0 again only after the __syncwarp of
  // the buf1 step, which every lane reaches after its reads of buf0
  int it = 0;
  for (; it + 2 <= a.iters; it += 2) {
    step(buf0);
    step(buf1);
  }
  if (it < a.iters) step(buf0);

  if (own) {
    a.xt[off] = x;
    a.z[off] = z;
    a.y[off] = y;
  }
}

// 32 < nx <= 32 ROWS: Minv transposed in shared memory, ROWS rows per lane
// in registers. Dynamic shared memory: nx (nx + 1) values per warp.
template <typename T, int ROWS>
__global__ void box_admm_smem(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= a.batch) return;  // whole warp exits together: no sync hazard

  const int nx = a.nx;
  T* s_minv_t = reinterpret_cast<T*>(smem_raw) +
                static_cast<size_t>(warp) * (nx * nx + nx);
  T* s_rhs = s_minv_t + nx * nx;

  // Minv once: coalesced read, transposed store (s_minv_t[j*nx+i] = M[i][j])
  const T* m_b = a.minv + b * nx * nx;
  for (int e = lane; e < nx * nx; e += kWarp) {
    const int i = e / nx, j = e - i * nx;
    s_minv_t[j * nx + i] = m_b[e];
  }

  const long long off = b * nx;
  const T rho = a.rho[b];
  const T inv_rho = T(1) / rho;
  T x[ROWS], z[ROWS], y[ROWS], qv[ROWS], lov[ROWS], hiv[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = lane + k * kWarp;
    if (i < nx) {
      qv[k] = a.q[off + i];
      lov[k] = a.lo[off + i];
      hiv[k] = a.hi[off + i];
      x[k] = a.x0[off + i];
      y[k] = a.y0[off + i];
      z[k] = clip(x[k], lov[k], hiv[k]);
    } else {
      qv[k] = lov[k] = hiv[k] = x[k] = y[k] = z[k] = T(0);
    }
  }
  __syncwarp();

  for (int it = 0; it < a.iters; ++it) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int i = lane + k * kWarp;
      if (i < nx) s_rhs[i] = a.sigma * x[k] - qv[k] + rho * z[k] - y[k];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int i = lane + k * kWarp;
      if (i < nx) {
        T acc = T(0);
        for (int j = 0; j < nx; ++j) acc += s_minv_t[j * nx + i] * s_rhs[j];
        const T xm = a.alpha * acc + a.one_minus_alpha * z[k];
        const T zn = clip(xm + y[k] * inv_rho, lov[k], hiv[k]);
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
      a.xt[off + i] = x[k];
      a.z[off + i] = z[k];
      a.y[off + i] = y[k];
    }
  }
}

// Tags naming one compiled instance: the register one at NXP, or the
// shared-memory one at ROWS.
template <int N>
struct Regs {};
template <int N>
struct Rows {};

template <typename F>
cudaError_t dispatch(int nx, F&& f) {
  if (nx <= 8) return f(Regs<8>{});
  if (nx <= 16) return f(Regs<16>{});
  if (nx <= 24) return f(Regs<24>{});
  if (nx <= kMaxRegsNx) return f(Regs<32>{});
  if (nx <= 2 * kWarp) return f(Rows<2>{});
  if (nx <= 4 * kWarp) return f(Rows<4>{});
  return cudaErrorInvalidValue;  // nx > 128: the wrapper refuses first
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

cudaError_t sm_count(int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Register instance: the block size with the fewest waves, then the most
// resident warps. Blocks per SM for each size are asked once per instance.
template <typename T, int NXP>
cudaError_t shape(Regs<NXP>, int batch, int nx, Shape* best) {
  static std::atomic<int> per_sm_cache[kBlockChoices];  // 0: not asked yet
  Shape s;
  cudaError_t err = sm_count(&s.sms);
  if (err != cudaSuccess) return err;
  *best = Shape{};
  for (int c = 0; c < kBlockChoices; ++c) {
    s.warps = kBlockWarps[c];
    s.smem = static_cast<size_t>(s.warps) * 2 * NXP * sizeof(T);
    int per_sm = per_sm_cache[c].load(std::memory_order_relaxed);
    if (per_sm == 0) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, box_admm_regs<T, NXP>, s.warps * kWarp, s.smem);
      if (err != cudaSuccess) return err;
      if (per_sm == 0) per_sm = -1;  // this block size does not fit
      per_sm_cache[c].store(per_sm, std::memory_order_relaxed);
    }
    if (per_sm < 0) continue;
    s.blocks_per_sm = per_sm;
    if (best->warps == 0 || s.waves(batch) < best->waves(batch) ||
        (s.waves(batch) == best->waves(batch) &&
         s.resident_warps() > best->resident_warps()))
      *best = s;
  }
  return best->warps ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Shared-memory instance: up to 4 warps per block within the default 48 KB
// of shared memory, one warp with the opt-in above it.
template <typename T, int ROWS>
cudaError_t shape(Rows<ROWS>, int batch, int nx, Shape* s) {
  constexpr size_t kDefaultSmem = 48 * 1024;
  constexpr size_t kMaxSmem = 227 * 1024;
  const size_t per_warp = static_cast<size_t>(nx) * (nx + 1) * sizeof(T);
  if (per_warp > kMaxSmem) return cudaErrorInvalidValue;
  s->warps = 4;
  while (s->warps > 1 && per_warp * s->warps > kDefaultSmem) --s->warps;
  s->smem = per_warp * s->warps;
  s->blocks_per_sm = 0;  // asked only by box_admm_launch_shape
  return sm_count(&s->sms);
}

template <typename T, int NXP>
void* kernel_of(Regs<NXP>) {
  return reinterpret_cast<void*>(box_admm_regs<T, NXP>);
}
template <typename T, int ROWS>
void* kernel_of(Rows<ROWS>) {
  return reinterpret_cast<void*>(box_admm_smem<T, ROWS>);
}

template <typename T, typename Inst>
cudaError_t launch_instance(Inst inst, const Args<T>& a, cudaStream_t stream) {
  Shape s;
  cudaError_t err = shape<T>(inst, a.batch, a.nx, &s);
  if (err != cudaSuccess) return err;
  const void* kern = kernel_of<T>(inst);
  if (s.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s.smem));
    if (err != cudaSuccess) return err;
  }
  void* params[] = {const_cast<Args<T>*>(&a)};
  err = cudaLaunchKernel(kern, dim3(static_cast<unsigned>(s.blocks(a.batch))),
                         dim3(s.warps * kWarp), params, s.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch(const T* minv, const T* q, const T* lo, const T* hi, const T* x0,
           const T* y0, const T* rho, T* xt, T* z, T* y, int batch, int nx,
           int iters, double sigma, double alpha, void* stream) {
  if (batch <= 0 || nx <= 0 || iters < 0) return cudaErrorInvalidValue;
  const Args<T> a{minv, q, lo, hi, x0, y0, rho, xt, z, y, batch, nx, iters,
                  T(sigma), T(alpha), T(1.0 - alpha)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(
      nx, [&](auto inst) { return launch_instance<T>(inst, a, s); }));
}

// out = {registers per thread, warps per block, resident warps per SM,
// waves over the batch} of the instance that `batch` x `nx` launches.
template <typename T>
int launch_shape(int batch, int nx, int* out) {
  if (batch <= 0 || nx <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(dispatch(nx, [&](auto inst) {
    Shape s;
    cudaError_t err = shape<T>(inst, batch, nx, &s);
    if (err != cudaSuccess) return err;
    const void* kern = kernel_of<T>(inst);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return err;
    if (s.smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(s.smem));
      if (err != cudaSuccess) return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &s.blocks_per_sm, kern, s.warps * kWarp, s.smem);
    if (err != cudaSuccess) return err;
    if (s.blocks_per_sm == 0) return cudaErrorInvalidConfiguration;
    out[0] = attr.numRegs;
    out[1] = s.warps;
    out[2] = s.resident_warps();
    out[3] = static_cast<int>(s.waves(batch));
    return cudaSuccess;
  }));
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

// Fills out[4] (see launch_shape) for float64 if f64 != 0, else float32.
// Returns a cudaError_t (0 = success).
int box_admm_launch_shape(int f64, int batch, int nx, int* out) {
  return f64 ? launch_shape<double>(batch, nx, out)
             : launch_shape<float>(batch, nx, out);
}

const char* box_admm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
