// The per-step terminal synthesis for Hopper (sm_90a): the DARE by
// doubling, its gain and trace P for a batch of models, in one launch.
//
// It replaces no Pallas kernel: the JAX package leaves the synthesis
// (koopmanx/control/terminal.py::synthesize_terminal over
// koopmanx/control/dare.py::solve_dare_doubling) to XLA. The port ran it
// as eager PyTorch, about 198 launches a doubling step (two pivoted
// Gauss-Jordan inverses of ~92 operations each, and the products), ~6,000
// a control step; this kernel computes, per scenario (nz states, m
// inputs),
//     G = B R^-1 B',  (A_k, G_k, H_k) from (A, G, Q), for iters steps:
//       W = (I + G H)^-1 A,  A <- A W,
//       G <- G + A G (I + H G)^-1 A',  H <- H + W' H A,
//     P = H,  K = (R + B'PB)^-1 B'PA,  gamma = trace P,
// reading A, B, Q and R once and writing P, K and gamma once.
//
// The arithmetic is the plain version's (the plain route of
// control/terminal.py::synthesize_terminal, i.e. control/dare.py and
// ops/linalg.py), in its order where the order is fixed there:
// - both (I + .)^-1 are Gauss-Jordan with partial pivoting as
//   ops/linalg.py::gj_inverse: the pivot of column j is the largest
//   |entry| at or below the diagonal, the first on ties, a NaN counted as
//   the largest; piv = row_p / d by IEEE division; one rank-1 update
//   aug - factor * piv, with factor[j] = d - 1, that both eliminates and
//   normalizes, as a product and a difference each rounded (no FMA);
// - R^-1 and (R + B'PB)^-1 are ops/linalg.py::spd_inverse (block 1):
//   pivot-free Gauss-Jordan with the same update, then 0.5 (X + X');
// - eye + X, G + ., H + . and R + . are single rounded sums.
// The matrix products accumulate with FMAs in index order; cuBLAS and the
// CPU sum in their own orders, so float32 results differ from the plain
// version's by its round-off, amplified by the DARE (PERF.md, section 2).
//
// What bounds it: benchmark/roofline.py::terminal_work counts 30 x (22
// nz^3 + 4 nz^2) FLOP and the gain, 0.67 MFLOP a scenario at nz = 10,
// m = 1, against ~900 bytes read and written: 44 GFLOP at B = 65,536,
// 0.66 ms at the card's 67 TFLOP/s float32 (non-tensor) peak against
// 0.018 ms of memory. Nothing but the operations bounds it, and at
// nz = 10 those are 10 x 10 products and pivoted eliminations whose steps
// depend on each other: what a warp can issue, not the FMA units, is
// the limit.
//
// Design, and why:
// 1. A lane owns one row of one scenario; floor(32 / nz) scenarios share
//    a warp (3 at nz = 10, 4 at nz = 8), each in a segment of nz lanes, so
//    30 or 32 of 32 lanes work where a warp a scenario would keep 10.
//    Lanes past the last segment run along on the last segment's data and
//    store nothing. Every exchange is inside a warp (__syncwarp, shuffles):
//    no block barrier, no atomics.
// 2. A_k, G_k, H_k, W and the inverse live in the scenario's shared
//    memory, rows padded to 16 bytes (the gain reads the model's A again
//    from device memory, where a sixth shared matrix would cost resident
//    warps). A product
//    X Y runs on the lane's row of X in registers and reads Y by 16-byte
//    row loads that the scenario's lanes share (one address each: a
//    broadcast): nz^2 FMAs and nz^2 / 4 loads a lane at nz = 10.
// 3. Gauss-Jordan in registers: the lane's row of [M | I] (2 nz values).
//    The pivot search is a max over a 64-bit key (|entry|'s bits, a NaN as
//    the largest, then the first logical row, then the lane) by
//    ceil(log2 nz) shuffles over the segment, each lane combining with
//    the lane s rows ahead (cyclically), which works for any segment
//    width. Rows are not moved: each lane keeps the logical index of its
//    row, which the swap exchanges, so the swap is two integer selects
//    and no data moves; the update of every row is the same in either
//    labelling. The pivot lane stores its row once; lane r divides
//    columns r and nz + r by d (two IEEE divisions a lane, not 2 nz), and
//    every lane reads the quotients back to update the live columns
//    (those right of j: the columns left of it are never read again, so
//    their values, which the plain version also computes, are not).
// 4. The width nz is a template parameter, so every row index above is a
//    register and every loop unrolls; ops/dare_terminal.py builds one
//    library a width (-DKX_DARE_NZ=nz, nz <= 32) at its first use. m <= 4
//    is a runtime value inside unrolled loops of 4.
// 5. Occupancy: a float32 instance of nz <= 10 is compiled for 24
//    resident warps per SM (__launch_bounds__: at most 85 registers). The
//    shared state is 8.7 KB a warp at nz = 10, so 24 warps fit in the
//    SM's 228 KB. On an H100 80GB HBM3 (700 W) at B = 65,536, nz = 10,
//    m = 1: ptxas's 118 registers gave 16 resident warps and 4.94 ms a
//    launch, 96 registers 20 warps and 4.59 ms, 80 registers (52 bytes of
//    spill stores) 24 warps, 7 waves and 4.32 ms: each step is a chain of
//    shuffles, shared loads and divisions, and more warps hide more of it.
//    The launcher asks the occupancy API about 1, 2 and 4 warps a block
//    and takes the fewest waves, then the most resident warps (as
//    box_admm.cu); ops/dare_terminal.py::launch_shape reports registers,
//    warps a block, resident warps per SM and waves.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#ifndef KX_DARE_NZ
#error "build with -DKX_DARE_NZ=<nz>, one library a width (ops/build.py)"
#endif
static_assert(KX_DARE_NZ >= 1 && KX_DARE_NZ <= 32, "a segment is one warp at most");

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxM = 4;
constexpr int kBlockWarps[] = {1, 2, 4};
constexpr int kBlockChoices = 3;
constexpr int kMaxBlockThreads = 4 * 32;
constexpr size_t kMaxSmem = 227 * 1024;

// rounded operations, never contracted into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Shapes of one instance: nz = NZ states; a scenario's shared region.
template <typename T, int NZ>
struct Layout {
  static constexpr int kVec = Vec<T>::n;
  static constexpr int kPerWarp = kWarp / NZ;      // scenarios a warp
  static constexpr int kLd = round_up(NZ, kVec);   // padded row
  static constexpr int kAug = round_up(2 * NZ, kVec);
  static constexpr int kMat = NZ * kLd;
  // A_k, G_k, H_k, W, the inverse (then X = inv2 A')
  static constexpr int kA = 0, kG = kMat, kH = 2 * kMat, kW = 3 * kMat,
                       kT = 4 * kMat;
  static constexpr int kB = 5 * kMat;                // B, NZ x kMaxM
  static constexpr int kRow = kB + round_up(NZ * kMaxM, kVec);  // pivot row
  static constexpr int kPiv = kRow + kAug;           // its quotients
  static constexpr int kS = kPiv + kAug;             // m x kLd scratch
  static constexpr int kScenario = kS + kMaxM * kLd;
  static constexpr size_t warp_bytes() {
    return static_cast<size_t>(kPerWarp) * kScenario * sizeof(T);
  }
};

template <typename T>
struct Args {
  const T* a;
  const T* b;
  const T* q;
  const T* r;
  T* p;
  T* k;
  T* gamma;
  // element strides: batch and row of A, B, Q, R (columns are unit-stride)
  long long a_bs, a_rs, b_bs, b_rs, q_bs, q_rs, r_bs, r_rs;
  int batch, m, iters;
};

// N values from 16-byte aligned shared memory into registers.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* src, T (&dst)[N]) {
  using V = typename Vec<T>::type;
  constexpr int kv = Vec<T>::n;
  static_assert(N % kv == 0, "rows are padded to 16 bytes");
#pragma unroll
  for (int c = 0; c < N; c += kv) {
    const V v = *reinterpret_cast<const V*>(src + c);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int t = 0; t < kv; ++t) dst[c + t] = e[t];
  }
}

// The first NZ values of a row into shared memory, zero-padded to LD.
template <typename T, int NZ, int LD>
__device__ __forceinline__ void store_row(T* dst, const T (&src)[NZ]) {
  using V = typename Vec<T>::type;
  constexpr int kv = Vec<T>::n;
#pragma unroll
  for (int c = 0; c < LD; c += kv) {
    V v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int t = 0; t < kv; ++t) e[t] = c + t < NZ ? src[c + t] : T(0);
    *reinterpret_cast<V*>(dst + c) = v;
  }
}

// out = x Y: x a row in registers, Y (NZ x NZ, row stride LD) shared.
template <typename T, int NZ, int LD>
__device__ __forceinline__ void row_times(const T (&x)[NZ], const T* y,
                                          T (&out)[NZ]) {
#pragma unroll
  for (int k = 0; k < NZ; ++k) out[k] = T(0);
#pragma unroll
  for (int l = 0; l < NZ; ++l) {
    T yr[LD];
    load_row<T, LD>(y + l * LD, yr);
#pragma unroll
    for (int k = 0; k < NZ; ++k) out[k] = fma_rn(x[l], yr[k], out[k]);
  }
}

// out = x Y': out[k] = sum_l x[l] Y[k][l].
template <typename T, int NZ, int LD>
__device__ __forceinline__ void row_times_t(const T (&x)[NZ], const T* y,
                                            T (&out)[NZ]) {
#pragma unroll
  for (int k = 0; k < NZ; ++k) {
    T yr[LD];
    load_row<T, LD>(y + k * LD, yr);
    T acc = T(0);
#pragma unroll
    for (int l = 0; l < NZ; ++l) acc = fma_rn(x[l], yr[l], acc);
    out[k] = acc;
  }
}

template <typename T, int NZ, int LD>
__device__ __forceinline__ void own_row(const T* mat, int row, T (&out)[NZ]) {
  T full[LD];
  load_row<T, LD>(mat + row * LD, full);
#pragma unroll
  for (int k = 0; k < NZ; ++k) out[k] = full[k];
}

// |v|'s bits, ordered as |v| is, a NaN above every number (as argmax).
__device__ __forceinline__ unsigned long long magnitude(float v) {
  return isnan(v) ? 0x7fffffffull : __float_as_uint(fabsf(v));
}
__device__ __forceinline__ unsigned long long magnitude(double v) {
  return isnan(v) ? 0x7fffffffffffffffull
                  : static_cast<unsigned long long>(
                        __double_as_longlong(fabs(v)));
}

// Tie-break bits: the first logical row wins, and the key names the lane.
__device__ __forceinline__ unsigned tie_bits(int lrow, int row) {
  return (static_cast<unsigned>(0xffff - lrow) << 16) | static_cast<unsigned>(row);
}

// The segment's pivot of a column: (lane in the segment, logical row) of
// the largest magnitude among the lanes that are candidates (the first
// logical row on ties). Every lane of the segment gets the same answer.
template <typename T, int NZ>
__device__ __forceinline__ void pivot_of(T v, bool candidate, int lrow,
                                         int row, const int (&src)[5],
                                         int* p_row, int* p_lrow) {
  unsigned long long mag = candidate ? magnitude(v) : 0ull;
  unsigned tie = candidate ? tie_bits(lrow, row) : 0u;
  if constexpr (sizeof(T) == 4) {
    unsigned long long key = (mag << 32) | tie;
#pragma unroll
    for (int r = 0; (1 << r) < NZ; ++r) {
      const unsigned long long other = __shfl_sync(kFull, key, src[r]);
      key = other > key ? other : key;
    }
    tie = static_cast<unsigned>(key);
  } else {
#pragma unroll
    for (int r = 0; (1 << r) < NZ; ++r) {
      const unsigned long long om = __shfl_sync(kFull, mag, src[r]);
      const unsigned ot = __shfl_sync(kFull, tie, src[r]);
      if (om > mag || (om == mag && ot > tie)) {
        mag = om;
        tie = ot;
      }
    }
  }
  *p_row = static_cast<int>(tie & 0xffffu);
  *p_lrow = 0xffff - static_cast<int>(tie >> 16);
}

// Gauss-Jordan with partial pivoting on the segment's [M | I], the lane
// holding row `row` of M in aug[0, NZ) (aug[NZ, 2 NZ) is set here).
// Writes row i of M^-1 to inv[i * LD, ...) (stores only if `store`).
template <typename T, int NZ, int LD, int AUG>
__device__ __forceinline__ void gj_inverse(T (&aug)[AUG], int row, int base,
                                           bool store, const int (&src)[5],
                                           T* rowbuf, T* pivbuf, T* inv) {
  constexpr int kv = Vec<T>::n;
#pragma unroll
  for (int c = NZ; c < AUG; ++c) aug[c] = c - NZ == row ? T(1) : T(0);
  int lrow = row;
#pragma unroll
  for (int j = 0; j < NZ; ++j) {
    int p_row, q;
    pivot_of<T, NZ>(aug[j], lrow >= j, lrow, row, src, &p_row, &q);
    const T d = __shfl_sync(kFull, aug[j], base + p_row);
    const bool is_pivot = row == p_row;
    // the live columns j + 1 .. 2 NZ - 1, in whole 16-byte chunks
    const int c0 = (j + 1) / kv * kv;  // a constant once unrolled
    if (store && is_pivot) {
      using V = typename Vec<T>::type;
#pragma unroll
      for (int c = c0; c < AUG; c += kv) {
        V v;
        T* e = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int t = 0; t < kv; ++t) e[t] = aug[c + t];
        *reinterpret_cast<V*>(rowbuf + c) = v;
      }
    }
    __syncwarp();
    if (store) {
      if (row > j) pivbuf[row] = div_rn(rowbuf[row], d);
      pivbuf[NZ + row] = div_rn(rowbuf[NZ + row], d);
    }
    __syncwarp();
    const T factor = is_pivot ? sub_rn(d, T(1)) : aug[j];
    T piv[AUG];
#pragma unroll
    for (int c = c0; c < AUG; c += kv) {
      using V = typename Vec<T>::type;
      const V v = *reinterpret_cast<const V*>(pivbuf + c);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int t = 0; t < kv; ++t) piv[c + t] = e[t];
    }
#pragma unroll
    for (int c = j + 1; c < 2 * NZ; ++c)
      aug[c] = sub_rn(aug[c], mul_rn(factor, piv[c]));
    // rows j and q trade places (the pivot row becomes logical row j)
    lrow = lrow == q ? j : (lrow == j ? q : lrow);
  }
  if (store) {
    T right[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) right[k] = aug[NZ + k];
    store_row<T, NZ, LD>(inv + lrow * LD, right);
  }
}

// ops/linalg.py::spd_inverse (block 1) of an m x m matrix, m <= kMaxM,
// entries past m unused.
template <typename T>
__device__ __forceinline__ void spd_inverse(const T (&k)[kMaxM][kMaxM], int m,
                                            T (&out)[kMaxM][kMaxM]) {
  T aug[kMaxM][2 * kMaxM];
#pragma unroll
  for (int i = 0; i < kMaxM; ++i)
#pragma unroll
    for (int c = 0; c < kMaxM; ++c) {
      aug[i][c] = k[i][c];
      aug[i][kMaxM + c] = i == c ? T(1) : T(0);
    }
#pragma unroll
  for (int j = 0; j < kMaxM; ++j) {
    if (j >= m) break;
    const T d = aug[j][j];
    T piv[2 * kMaxM];
#pragma unroll
    for (int c = 0; c < 2 * kMaxM; ++c) piv[c] = div_rn(aug[j][c], d);
#pragma unroll
    for (int i = 0; i < kMaxM; ++i) {
      const T factor = i == j ? sub_rn(d, T(1)) : aug[i][j];
#pragma unroll
      for (int c = 0; c < 2 * kMaxM; ++c)
        aug[i][c] = sub_rn(aug[i][c], mul_rn(factor, piv[c]));
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxM; ++i)
#pragma unroll
    for (int c = 0; c < kMaxM; ++c)
      out[i][c] = mul_rn(T(0.5), add_rn(aug[i][kMaxM + c], aug[c][kMaxM + i]));
}

// Resident warps a float32 instance of nz <= 10 asks ptxas to leave room
// for: its registers capped at 65,536 / (32 x 24) = 85 (note, item 5);
// wider and float64 instances take what they need.
constexpr int kTargetWarps = 24;

template <typename T, int NZ>
__global__ void __launch_bounds__(
    kMaxBlockThreads,
    sizeof(T) == 4 && NZ <= 10 ? kTargetWarps * kWarp / kMaxBlockThreads : 1)
dare_terminal_kernel(const Args<T> a) {
  using L = Layout<T, NZ>;
  constexpr int LD = L::kLd, SPW = L::kPerWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* warp_smem = reinterpret_cast<T*>(smem_raw) +
                 static_cast<size_t>(threadIdx.x / kWarp) * SPW * L::kScenario;
  const int lane = threadIdx.x % kWarp;
  const int seg = lane / NZ, row = lane % NZ;
  const bool in_seg = seg < SPW;
  const int seg_c = in_seg ? seg : SPW - 1;
  const long long warp_id =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long idx = warp_id * SPW + seg_c;
  const bool mine = in_seg && idx < a.batch;  // writes P, K, gamma
  const long long ld_idx = idx < a.batch ? idx : a.batch - 1;
  const int base = seg * NZ, m = a.m;
  int src[5];
#pragma unroll
  for (int r = 0; r < 5; ++r) src[r] = base + (row + (1 << r)) % NZ;
  T* s = warp_smem + seg_c * L::kScenario;
  T *sA = s + L::kA, *sG = s + L::kG, *sH = s + L::kH, *sW = s + L::kW,
    *sT = s + L::kT, *sB = s + L::kB,
    *rowbuf = s + L::kRow, *pivbuf = s + L::kPiv, *sS = s + L::kS;

  for (int e = lane; e < SPW * L::kScenario; e += kWarp) warp_smem[e] = T(0);
  __syncwarp();
  // A, Q and B, column `row` of each (coalesced over the segment)
  if (in_seg) {
    const T* ga = a.a + ld_idx * a.a_bs;
    const T* gq = a.q + ld_idx * a.q_bs;
#pragma unroll
    for (int t = 0; t < NZ; ++t) {
      const T v = ga[t * a.a_rs + row];
      sA[t * LD + row] = v;
      sH[t * LD + row] = gq[t * a.q_rs + row];
    }
    const T* gb = a.b + ld_idx * a.b_bs + row * a.b_rs;
#pragma unroll
    for (int c = 0; c < kMaxM; ++c)
      if (c < m) sB[row * kMaxM + c] = gb[c];
  }
  T rr[kMaxM][kMaxM];
  {
    const T* gr = a.r + ld_idx * a.r_bs;
#pragma unroll
    for (int i = 0; i < kMaxM; ++i)
#pragma unroll
      for (int c = 0; c < kMaxM; ++c)
        rr[i][c] = i < m && c < m ? gr[i * a.r_rs + c] : T(0);
  }
  __syncwarp();

  // G = B (R^-1 B'): column `row` of R^-1 B', then row `row` of G
  {
    T rinv[kMaxM][kMaxM];
    spd_inverse(rr, m, rinv);
    if (in_seg) {
#pragma unroll
      for (int i = 0; i < kMaxM; ++i) {
        if (i >= m) break;
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < kMaxM; ++c)
          if (c < m) acc = fma_rn(rinv[i][c], sB[row * kMaxM + c], acc);
        sS[i * LD + row] = acc;
      }
    }
    __syncwarp();
    T g[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < kMaxM; ++c)
        if (c < m) acc = fma_rn(sB[row * kMaxM + c], sS[c * LD + k], acc);
      g[k] = acc;
    }
    if (in_seg) store_row<T, NZ, LD>(sG + row * LD, g);
    __syncwarp();
  }

#pragma unroll 1
  for (int it = 0; it < a.iters; ++it) {
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      // M = I + G H (half 0) or I + H G (half 1), inverted into sT
      T x[NZ], prod[NZ], aug[L::kAug];
      own_row<T, NZ, LD>(half ? sH : sG, row, x);
      row_times<T, NZ, LD>(x, half ? sG : sH, prod);
#pragma unroll
      for (int k = 0; k < NZ; ++k)
        aug[k] = add_rn(k == row ? T(1) : T(0), prod[k]);
      gj_inverse<T, NZ, LD, L::kAug>(aug, row, base, in_seg, src, rowbuf,
                                     pivbuf, sT);
      __syncwarp();
      own_row<T, NZ, LD>(sT, row, x);
      if (half == 0) {
        row_times<T, NZ, LD>(x, sA, prod);  // W = (I + G H)^-1 A
        if (in_seg) store_row<T, NZ, LD>(sW + row * LD, prod);
      } else {
        row_times_t<T, NZ, LD>(x, sA, prod);  // X = (I + H G)^-1 A'
        if (in_seg) store_row<T, NZ, LD>(sT + row * LD, prod);
      }
      __syncwarp();
    }
    // each product's result is stored once no lane reads the old matrix
    T x[NZ], y[NZ], out[NZ];
    // G + (A G) X
    own_row<T, NZ, LD>(sA, row, x);
    row_times<T, NZ, LD>(x, sG, y);
    row_times<T, NZ, LD>(y, sT, out);
    own_row<T, NZ, LD>(sG, row, x);
#pragma unroll
    for (int k = 0; k < NZ; ++k) out[k] = add_rn(x[k], out[k]);
    __syncwarp();
    if (in_seg) store_row<T, NZ, LD>(sG + row * LD, out);
    // H + (W' H) A
#pragma unroll
    for (int l = 0; l < NZ; ++l) x[l] = sW[l * LD + row];
    row_times<T, NZ, LD>(x, sH, y);
    row_times<T, NZ, LD>(y, sA, out);
    own_row<T, NZ, LD>(sH, row, x);
#pragma unroll
    for (int k = 0; k < NZ; ++k) out[k] = add_rn(x[k], out[k]);
    __syncwarp();
    if (in_seg) store_row<T, NZ, LD>(sH + row * LD, out);
    // A W
    own_row<T, NZ, LD>(sA, row, x);
    row_times<T, NZ, LD>(x, sW, out);
    __syncwarp();
    if (in_seg) store_row<T, NZ, LD>(sA + row * LD, out);
    __syncwarp();
  }

  // K = (R + B'PB)^-1 (B'P A) with P = H: column `row` of B'P first
  if (in_seg) {
#pragma unroll
    for (int i = 0; i < kMaxM; ++i) {
      if (i >= m) break;
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < NZ; ++l)
        acc = fma_rn(sB[l * kMaxM + i], sH[l * LD + row], acc);
      sS[i * LD + row] = acc;
    }
  }
  __syncwarp();
  T sm[kMaxM][kMaxM], sinv[kMaxM][kMaxM], btpa[kMaxM];
#pragma unroll
  for (int i = 0; i < kMaxM; ++i) {
#pragma unroll
    for (int c = 0; c < kMaxM; ++c) {
      T acc = T(0);
      if (i < m && c < m) {
#pragma unroll
        for (int l = 0; l < NZ; ++l)
          acc = fma_rn(sS[i * LD + l], sB[l * kMaxM + c], acc);
      }
      sm[i][c] = add_rn(rr[i][c], acc);
    }
    T acc = T(0);
    if (i < m) {
#pragma unroll
      for (int l = 0; l < NZ; ++l)
        acc = fma_rn(sS[i * LD + l], a.a[ld_idx * a.a_bs + l * a.a_rs + row],
                     acc);
    }
    btpa[i] = acc;
  }
  spd_inverse(sm, m, sinv);
  if (mine) {
    T* gk = a.k + idx * m * NZ;
#pragma unroll
    for (int i = 0; i < kMaxM; ++i) {
      if (i >= m) break;
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < kMaxM; ++c)
        if (c < m) acc = fma_rn(sinv[i][c], btpa[c], acc);
      gk[i * NZ + row] = acc;
    }
    T* gp = a.p + idx * NZ * NZ;
#pragma unroll
    for (int t = 0; t < NZ; ++t) gp[t * NZ + row] = sH[t * LD + row];
    if (row == 0) {
      T tr = sH[0];
#pragma unroll
      for (int i = 1; i < NZ; ++i) tr = add_rn(tr, sH[i * LD + i]);
      a.gamma[idx] = tr;
    }
  }
}

struct Shape {
  int warps = 0;          // a block
  size_t smem = 0;        // a block
  int blocks_per_sm = 0;
  int sms = 0;
  long long blocks(long long warps_needed) const {
    return (warps_needed + warps - 1) / warps;
  }
  long long waves(long long warps_needed) const {
    const long long per_wave = static_cast<long long>(blocks_per_sm) * sms;
    return (blocks(warps_needed) + per_wave - 1) / per_wave;
  }
  int resident_warps() const { return blocks_per_sm * warps; }
};

template <typename T>
cudaError_t shape(int batch, Shape* best) {
  using L = Layout<T, KX_DARE_NZ>;
  static std::atomic<int> per_sm_cache[kBlockChoices];  // 0: not asked yet
  const void* kern = reinterpret_cast<const void*>(
      dare_terminal_kernel<T, KX_DARE_NZ>);
  const long long warps_needed = (batch + L::kPerWarp - 1) / L::kPerWarp;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Shape s;
  err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *best = Shape{};
  for (int c = 0; c < kBlockChoices; ++c) {
    s.warps = kBlockWarps[c];
    s.smem = s.warps * L::warp_bytes();
    if (s.smem > kMaxSmem) continue;
    int per_sm = per_sm_cache[c].load(std::memory_order_relaxed);
    if (per_sm == 0) {
      if (s.smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kern,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(s.smem));
        if (err != cudaSuccess) return err;
      }
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, s.warps * kWarp, s.smem);
      if (err != cudaSuccess) return err;
      if (per_sm == 0) per_sm = -1;  // this block size does not fit
      per_sm_cache[c].store(per_sm, std::memory_order_relaxed);
    }
    if (per_sm < 0) continue;
    s.blocks_per_sm = per_sm;
    if (best->warps == 0 || s.waves(warps_needed) < best->waves(warps_needed) ||
        (s.waves(warps_needed) == best->waves(warps_needed) &&
         s.resident_warps() > best->resident_warps()))
      *best = s;
  }
  return best->warps ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T>
int launch(const T* a_, const T* b_, const T* q_, const T* r_, T* p, T* k,
           T* gamma, const long long* strides, int batch, int nz, int m,
           int iters, void* stream) {
  if (batch <= 0 || nz != KX_DARE_NZ || m <= 0 || m > kMaxM || iters < 0)
    return cudaErrorInvalidValue;
  const Args<T> a{a_, b_, q_, r_, p, k, gamma,
                  strides[0], strides[1], strides[2], strides[3],
                  strides[4], strides[5], strides[6], strides[7],
                  batch, m, iters};
  Shape s;
  cudaError_t err = shape<T>(batch, &s);
  if (err != cudaSuccess) return err;
  const void* kern = reinterpret_cast<const void*>(
      dare_terminal_kernel<T, KX_DARE_NZ>);
  if (s.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s.smem));
    if (err != cudaSuccess) return err;
  }
  using L = Layout<T, KX_DARE_NZ>;
  const long long warps_needed = (batch + L::kPerWarp - 1) / L::kPerWarp;
  void* params[] = {const_cast<Args<T>*>(&a)};
  err = cudaLaunchKernel(kern, dim3(static_cast<unsigned>(s.blocks(warps_needed))),
                         dim3(s.warps * kWarp), params, s.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch_shape(int batch, int* out) {
  if (batch <= 0) return cudaErrorInvalidValue;
  Shape s;
  cudaError_t err = shape<T>(batch, &s);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(dare_terminal_kernel<T, KX_DARE_NZ>));
  if (err != cudaSuccess) return err;
  using L = Layout<T, KX_DARE_NZ>;
  const long long warps_needed = (batch + L::kPerWarp - 1) / L::kPerWarp;
  out[0] = attr.numRegs;
  out[1] = s.warps;
  out[2] = s.resident_warps();
  out[3] = static_cast<int>(s.waves(warps_needed));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The width this library was built for (-DKX_DARE_NZ).
int dare_terminal_width(void) { return KX_DARE_NZ; }

// a (B, nz, nz), b (B, nz, m), q (B, nz, nz), r (B, m, m) with the element
// strides {a batch, a row, b batch, b row, q batch, q row, r batch, r row}
// (a batch stride may be 0; columns are unit-stride); p (B, nz, nz),
// k (B, m, nz), gamma (B,) contiguous. nz must be the library's width,
// 1 <= m <= 4. Returns a cudaError_t (0 = success).
int dare_terminal_f32(const float* a, const float* b, const float* q,
                      const float* r, float* p, float* k, float* gamma,
                      const long long* strides, int batch, int nz, int m,
                      int iters, void* stream) {
  return launch<float>(a, b, q, r, p, k, gamma, strides, batch, nz, m, iters,
                       stream);
}

int dare_terminal_f64(const double* a, const double* b, const double* q,
                      const double* r, double* p, double* k, double* gamma,
                      const long long* strides, int batch, int nz, int m,
                      int iters, void* stream) {
  return launch<double>(a, b, q, r, p, k, gamma, strides, batch, nz, m, iters,
                        stream);
}

// out = {registers per thread, warps per block, resident warps per SM,
// waves over the batch} for float64 if f64 != 0, else float32.
int dare_terminal_launch_shape(int f64, int batch, int* out) {
  return f64 ? launch_shape<double>(batch, out)
             : launch_shape<float>(batch, out);
}

const char* dare_terminal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
