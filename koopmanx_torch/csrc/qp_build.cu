// The condensed box-QP build for Hopper (sm_90a): for a batch of models,
// each scenario's P and q of the MPC QP in one launch.
//
// It replaces no Pallas kernel: the JAX package leaves the build to XLA
// (koopmanx/control/condensed.py). The port ran it as eager PyTorch, about
// 45-50 launches a control step of batched 8 x 8 and 2 x 8 products,
// stacks, gathers and masks on tiny matrices; this kernel computes, per
// scenario (nz states, m inputs, py tracked outputs, horizon N,
// nx = N m decisions),
//     the ladder A^(2^r), the rows g_0 = CyC, g_j = g_(j - 2^r) A^(2^r)
//     (2^r the largest power <= j), the Markov blocks g_j B,
//     F1 = [g_1; ...; g_N], F2 = the block-Toeplitz of g_(i-j) B,
//     under f_clamp > 0 each entry of F1 and F2 as nan_to_num(nan = 0,
//     +-inf = +-fc) then clamp(-fc, fc),
//     Qbar = kron(I_N, Q) with its last block the scenario's terminal
//     block where one is given, Rbar = kron(I_N, R),
//     H = (F2' Qbar) F2 + Rbar,  P = 2 (0.5 (H + H')),
//     q = 2 F2' (Qbar (F1 z - yr)),
// reading A, B, CyC, z, yr, Q, R and the terminal block once and writing
// P and q once: F1, F2, Qbar and H never reach device memory.
//
// The arithmetic is the plain version's (ops/qp_build.py::plain: the
// engine's weight_bar, prediction_matrices(..., 'dag'), f_clamp and
// condensed_qp), in its order where the order is fixed there: the ladder
// and the rows in the 'dag' order, err = (F1 z) - yr, H + Rbar, the
// symmetrization and both factors of 2 each a rounded operation. Each
// matrix product entry is one FMA chain in ascending index order; cuBLAS
// and the CPU sum in their own orders, so float32 results differ from the
// plain version's by its round-off.
//
// Zeros. F2's structural zeros are the plain version's values
// (markov_0 * 0, clamped): NaN where markov_0 is not finite. Qbar's
// off-block zeros (0 * Q) are skipped: F2' Qbar and Qbar err sum each
// block's own py terms, and an entry is made NaN exactly where a skipped
// term would have been NaN (a non-finite F2 entry or err entry in another
// block, or a non-finite Q entry in its column or row, with N >= 2).
// Where F2, Q and F2' Qbar are finite, the terms of F2's structural zeros
// in H and q are +-0 at the head of each chain and are skipped too. A
// skipped finite term is +-0, which changes no value, so every finite
// entry is the dense sum's and the non-finite pattern is the plain
// version's. Rbar is added entry by entry, R or R * 0.
//
// What bounds it: at the flagship's shapes (nz 8, py 2, m 1, N 10) a
// scenario reads 96 floats (A, B, CyC, z; Q, R and yr shared) and writes
// 110 (P, q), about 0.8 KB, against ~11.6 kFLOP counted dense
// (tools/check_qp_build.py::work): at B = 262,144, 216 MB (0.065 ms at
// 3.35 TB/s) against 3.0 GFLOP (0.045 ms at 67 TFLOP/s float32 without
// tensor cores). Memory bounds it on paper; a scenario's stages depend on
// each other, so what a warp dispatches between its shared-memory round
// trips is the practical limit.
//
// Design, and why:
// 1. A segment of lanes a scenario: 16 lanes, two scenarios a warp, where
//    H's rows and q fit (nx + 1 <= 16), else the whole warp. Every stage
//    hands its entries out over the segment's lanes, each entry one FMA
//    chain; most stages have 16-32 entries at the flagship's shapes, so a
//    warp a scenario left half of it idle. Stages are separated by
//    __syncwarp and the segment's flags are ballots: no block barrier,
//    no atomics. A segment past the batch runs along on the last
//    scenario and stores nothing.
// 2. A scenario's working set lives in shared memory: the ladder and the
//    rows g_0..g_N on lines padded to 16 bytes, the Markov blocks, err,
//    Qbar err and H (and F2' Qbar where it is not formed in registers);
//    3.4 KB in float32 at the flagship's shapes. A ladder or row product
//    computes four entries of a line a lane (two in float64), reading
//    the right factor by one vector load. The ladder's next step and the
//    rows that read the same power share one pass.
// 3. H's rows (and q, as one more row) come from registers where a row of
//    F2' Qbar and F2's N py m distinct entries fit (N py <= 32,
//    N py m <= 32): with the column and the row index unrolled, F2[l][col]
//    is a register, and on finite data each row forms its own F2' Qbar
//    row there too. Wider shapes read both from shared memory.
// 4. nz, m, py and N are template parameters, so every index split is by
//    a constant and every chain unrolls; ops/qp_build.py builds one
//    library a shape (-DKX_QPB_NZ, _M, _PY, _N) at its first use. The
//    caps (nz <= 32, N m <= 32, py <= 32, N py <= 128) keep a float64
//    warp's working set (both of its scenarios) under 205 KB, inside the
//    227 KB a block may use.
// 5. On an H100 80GB HBM3 (700 W) at B = 262,144 and the flagship's
//    shapes: a warp a scenario with every operand from shared memory
//    took 0.733 ms a launch (~550 shared loads a warp, the load pipe the
//    limit); H's rows in registers 0.567; vector loads in the products
//    0.535; F2' Qbar in the rows and the structural zeros skipped 0.501;
//    two scenarios a warp 0.342 (72 registers, 28 resident warps per
//    SM); as built now 0.327 (64 registers, 32 resident warps, 2 warps a
//    block). Capping registers for more resident warps (64 for 32, 48
//    with spills for 40) moved it by 1-3 %.
// 6. The launcher asks the occupancy API about 1, 2, 4 and 8 warps a
//    block and takes the fewest waves, then the most resident warps (as
//    dare_terminal.cu); ops/qp_build.py::launch_shape reports registers,
//    warps a block, resident warps per SM, waves, shared bytes and
//    scenarios a warp.
#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <cstdint>

#if !defined(KX_QPB_NZ) || !defined(KX_QPB_M) || !defined(KX_QPB_PY) || \
    !defined(KX_QPB_N)
#error "build with -DKX_QPB_NZ, -DKX_QPB_M, -DKX_QPB_PY and -DKX_QPB_N (ops/build.py)"
#endif
static_assert(KX_QPB_NZ >= 1 && KX_QPB_NZ <= 32, "nz <= 32");
static_assert(KX_QPB_M >= 1 && KX_QPB_N >= 1 && KX_QPB_N * KX_QPB_M <= 32,
              "N m <= 32");
static_assert(KX_QPB_PY >= 1 && KX_QPB_PY <= 32 && KX_QPB_N * KX_QPB_PY <= 128,
              "py <= 32, N py <= 128");

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockWarps[] = {1, 2, 4, 8};
constexpr int kBlockChoices = 4;
constexpr int kMaxBlockThreads = 8 * 32;
constexpr size_t kMaxSmem = 227 * 1024;

// rounded operations, never contracted
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= FLT_MAX; }
__device__ __forceinline__ bool finite(double v) { return fabs(v) <= DBL_MAX; }
template <typename T> __device__ __forceinline__ T nan_value();
template <> __device__ __forceinline__ float nan_value<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double nan_value<double>() {
  return __longlong_as_double(0x7ff8000000000000ll);
}

constexpr int bit_length(int n) { return n == 0 ? 0 : 1 + bit_length(n >> 1); }

// bits [lo, hi) of a 32-bit word, clipped to it
__device__ __forceinline__ unsigned span_mask(int lo, int hi) {
  lo = lo < 0 ? 0 : lo;
  hi = hi > 32 ? 32 : hi;
  if (hi <= lo) return 0u;
  const unsigned ones = hi - lo == 32 ? 0xffffffffu : (1u << (hi - lo)) - 1u;
  return ones << lo;
}

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Shapes of one instance and a scenario's shared region (in elements of
// T); the ladder's and the rows' lines are padded to 16 bytes.
template <typename T, int NZ, int M, int PY, int N>
struct Layout {
  static constexpr int kVec = Vec<T>::n;
  static constexpr int kLd = round_up(NZ, kVec);   // a padded line
  static constexpr int kGroups = kLd / kVec;       // 16-byte groups a line
  static constexpr int kNx = N * M;          // decisions
  static constexpr int kNp = N * PY;         // stacked outputs
  static constexpr int kLevels = bit_length(N);  // A, A^2, ..., A^(2^(L-1))
  static constexpr int kLadder = 0;                          // L x NZ x Ld
  static constexpr int kG = kLadder + kLevels * NZ * kLd;    // (N+1) x PY x Ld
  static constexpr int kB = kG + (N + 1) * PY * kLd;         // NZ x M
  static constexpr int kMk = kB + NZ * M;                    // N x PY x M
  static constexpr int kZero = kMk + N * PY * M;             // PY x M
  static constexpr int kZ = kZero + PY * M;                  // NZ
  static constexpr int kErr = kZ + NZ;                       // Np
  static constexpr int kW = kErr + kNp;                      // Np
  static constexpr int kQ = kW + kNp;                        // PY x PY
  static constexpr int kTerm = kQ + PY * PY;                 // PY x PY
  static constexpr int kR = kTerm + PY * PY;                 // M x M
  static constexpr int kLdT = kNp | 1;  // odd: a row a lane, no bank conflict
  static constexpr int kT = kR + M * M;                      // Nx x LdT
  static constexpr int kH = kT + kNx * kLdT;                 // Nx x Nx
  static constexpr int kBad = kH + kNx * kNx;                // Nx
  static constexpr int kScenario = round_up(kBad + kNx, kVec);
  // H's rows from registers where a row and F2's distinct entries fit
  static constexpr bool kRegisterRows = kNp <= 32 && N * PY * M <= 32;
  // a segment of lanes a scenario: two scenarios a warp where H's rows
  // and q fit 16 lanes
  static constexpr int kSeg = kNx + 1 <= 16 ? 16 : kWarp;
  static constexpr int kPerWarp = kWarp / kSeg;
  static constexpr int kChunks = (kNp + kSeg - 1) / kSeg;  // of err's bits
};

template <typename T>
struct Args {
  const T* a;
  const T* b;
  const T* c;  // CyC
  const T* z;
  const T* yr;
  const T* q;
  const T* r;
  const T* term;  // null: no terminal block
  T* p;
  T* qv;
  // element strides: batch, row and column of A, B, CyC, yr, Q, R and the
  // terminal block; batch and entry of z
  long long a_bs, a_rs, a_cs, b_bs, b_rs, b_cs, c_bs, c_rs, c_cs, y_bs, y_rs,
      y_cs, q_bs, q_rs, q_cs, r_bs, r_rs, r_cs, t_bs, t_rs, t_cs, z_bs, z_es;
  T fc;  // f_clamp; <= 0: none
  int batch;
};

template <typename T, int NZ, int M, int PY, int N>
__global__ void __launch_bounds__(kMaxBlockThreads)
qp_build_kernel(const Args<T> a) {
  using L = Layout<T, NZ, M, PY, N>;
  using V = typename Vec<T>::type;
  constexpr int NX = L::kNx, NP = L::kNp, LD = L::kLd, VW = L::kVec;
  constexpr int SEG = L::kSeg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % SEG,
            seg = threadIdx.x % kWarp / SEG;
  const long long first =
      (static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp) *
      L::kPerWarp;
  if (first >= a.batch) return;  // the whole warp
  // a segment past the batch runs along on the last scenario, storing
  // nothing, so that every lane takes part in the warp's exchanges
  const bool real = first + seg < a.batch;
  const long long s = real ? first + seg : a.batch - 1;
  T* sm = reinterpret_cast<T*>(smem_raw) +
          (warp * L::kPerWarp + seg) * L::kScenario;
  const unsigned seg_bits =
      SEG == kWarp ? kFull : ((1u << SEG) - 1u) << (seg * SEG);
  // whether pred holds on every lane of the segment
  auto seg_all = [&](bool pred) {
    return (__ballot_sync(kFull, pred) & seg_bits) == seg_bits;
  };
  T* sLad = sm + L::kLadder;
  T* sB = sm + L::kB;
  T* sG = sm + L::kG;
  T* sMk = sm + L::kMk;
  T* sZero = sm + L::kZero;
  T* sZ = sm + L::kZ;
  T* sErr = sm + L::kErr;
  T* sW = sm + L::kW;
  T* sQ = sm + L::kQ;
  T* sTerm = sm + L::kTerm;
  T* sR = sm + L::kR;
  T* sT = sm + L::kT;
  T* sH = sm + L::kH;
  T* sBad = sm + L::kBad;
  const bool has_term = a.term != nullptr;
  const T fc = a.fc;
  // nan_to_num(nan = 0, +-inf = +-fc), then clamp(-fc, fc)
  auto clampf = [fc](T v) -> T {
    if (!(fc > T(0))) return v;
    return isnan(v) ? T(0) : vmin(vmax(v, -fc), fc);
  };

  // the inputs
  for (int o = lane; o < NZ * NZ; o += SEG)
    sLad[(o / NZ) * LD + o % NZ] =
        a.a[s * a.a_bs + (o / NZ) * a.a_rs + (o % NZ) * a.a_cs];
  for (int o = lane; o < NZ * M; o += SEG)
    sB[o] = a.b[s * a.b_bs + (o / M) * a.b_rs + (o % M) * a.b_cs];
  for (int o = lane; o < PY * NZ; o += SEG)
    sG[(o / NZ) * LD + o % NZ] =
        a.c[s * a.c_bs + (o / NZ) * a.c_rs + (o % NZ) * a.c_cs];
  for (int o = lane; o < NZ; o += SEG) sZ[o] = a.z[s * a.z_bs + o * a.z_es];
  for (int o = lane; o < PY * PY; o += SEG) {
    const int i = o / PY, c = o % PY;
    sQ[o] = a.q[s * a.q_bs + i * a.q_rs + c * a.q_cs];
    if (has_term) sTerm[o] = a.term[s * a.t_bs + i * a.t_rs + c * a.t_cs];
  }
  for (int o = lane; o < M * M; o += SEG)
    sR[o] = a.r[s * a.r_bs + (o / M) * a.r_rs + (o % M) * a.r_cs];
  __syncwarp();

  // out[i][g] = x[i] Y over a 16-byte group g of the line: one FMA chain
  // in k for each entry, Y's group read by one vector load
  auto group_times = [&](const T* x, const T* y, int g, T* out) {
    T acc[VW];
#pragma unroll
    for (int t = 0; t < VW; ++t) acc[t] = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      const V v = *reinterpret_cast<const V*>(y + k * LD + g * VW);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int t = 0; t < VW; ++t) acc[t] = fma_rn(x[k], e[t], acc[t]);
    }
    V v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int t = 0; t < VW; ++t) e[t] = acc[t];
    *reinterpret_cast<V*>(out + g * VW) = v;
  };

  // by levels r, each one pass over the lines that read A^(2^r): the
  // ladder's next A^(2^(r+1)) = A^(2^r) A^(2^r), and the rows
  // g_j = g_(j - 2^r) A^(2^r) for 2^r <= j < 2^(r+1)
#pragma unroll 1
  for (int r = 0; r < L::kLevels; ++r) {
    const T* y = sLad + r * NZ * LD;
    const int lo = 1 << r;
    const int hi = (2 * lo - 1) < N ? (2 * lo - 1) : N;
    const int ladder = r + 1 < L::kLevels ? NZ * L::kGroups : 0;
    const int count = ladder + (hi - lo + 1) * PY * L::kGroups;
    for (int o = lane; o < count; o += SEG) {
      const bool step = o < ladder;
      const int e = step ? o : o - ladder;
      const int line = e / L::kGroups, g = e % L::kGroups;
      // a ladder line i, or a row line jj PY + p of g_(j - 2^r), j = lo + jj
      const T* x = step ? y + line * LD : sG + line * LD;
      T* out = step ? sLad + (r + 1) * NZ * LD + line * LD
                    : sG + (lo * PY + line) * LD;
      group_times(x, y, g, out);
    }
    __syncwarp();
  }

  // the Markov blocks g_j B (j < N), clamped; F2's structural zero
  for (int o = lane; o < N * PY * M; o += SEG) {
    const int j = o / (PY * M), p = (o / M) % PY, c = o % M;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k)
      acc = fma_rn(sG[(j * PY + p) * LD + k], sB[k * M + c], acc);
    if (j == 0) sZero[p * M + c] = clampf(mul_rn(acc, T(0)));
    sMk[o] = clampf(acc);
  }
  __syncwarp();

  // F2[(i, p), (j, c)]
  auto f2 = [&](int i, int p, int j, int c) -> T {
    return i >= j ? sMk[((i - j) * PY + p) * M + c] : sZero[p * M + c];
  };
  // whether every entry of F2 and of Q is finite, so that no skipped
  // off-block term of F2' Qbar can be NaN
  bool fin = true;
  for (int o = lane; o < N * PY * M; o += SEG) fin &= finite(sMk[o]);
  for (int o = lane; o < PY * M; o += SEG) fin &= finite(sZero[o]);
  for (int o = lane; o < PY * PY; o += SEG) fin &= finite(sQ[o]);
  const bool clean = seg_all(fin);

  // err = F1 z - yr, F1's rows g_1..g_N clamped; unless clean, for each
  // column of F2 the number of its blocks of rows with a non-finite entry
  for (int o = lane; o < NP; o += SEG) {
    const int i = o / PY, p = o % PY;
    const T* g = sG + ((i + 1) * PY + p) * LD;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) acc = fma_rn(clampf(g[k]), sZ[k], acc);
    sErr[o] = sub_rn(acc, a.yr[s * a.y_bs + i * a.y_rs + p * a.y_cs]);
  }
  if (!clean) {
    for (int col = lane; col < NX; col += SEG) {
      const int j = col / M, c = col % M;
      int bad = 0;
#pragma unroll 1
      for (int i = 0; i < N; ++i) {
        bool any = false;
#pragma unroll
        for (int p = 0; p < PY; ++p) any |= !finite(f2(i, p, j, c));
        bad += any;
      }
      sBad[col] = T(bad);
    }
  }
  __syncwarp();
  // the non-finite entries of err, a bit each
  unsigned err_bad[L::kChunks];
#pragma unroll
  for (int t = 0; t < L::kChunks; ++t) {
    const int o = t * SEG + lane;
    err_bad[t] = (__ballot_sync(kFull, o < NP && !finite(sErr[o])) &
                  seg_bits) >> (seg * SEG);
  }

  // F2' Qbar over each block's own terms (unless clean rows of H make
  // their own below); Qbar err likewise
  const bool own_rows = L::kRegisterRows && clean;
  for (int o = lane; o < (own_rows ? 0 : NX * NP); o += SEG) {
    const int col = o / NP, l = o % NP, i = l / PY, pp = l % PY;
    const int j = col / M, c = col % M;
    const T* qb = has_term && i == N - 1 ? sTerm : sQ;
    T acc = T(0);
    bool own_bad = false, q_bad = false;
#pragma unroll
    for (int p = 0; p < PY; ++p) {
      const T f = f2(i, p, j, c);
      if (!clean) {
        own_bad |= !finite(f);
        q_bad |= !finite(sQ[p * PY + pp]);
      }
      acc = fma_rn(f, qb[p * PY + pp], acc);
    }
    const bool poison =
        !clean && ((N >= 2 && q_bad) || sBad[col] > T(own_bad ? 1 : 0));
    sT[col * L::kLdT + l] = poison ? nan_value<T>() : acc;
  }
  for (int o = lane; o < NP; o += SEG) {
    const int i = o / PY, p = o % PY;
    const T* qb = has_term && i == N - 1 ? sTerm : sQ;
    T acc = T(0);
    bool q_bad = false;
#pragma unroll
    for (int pp = 0; pp < PY; ++pp) {
      if (!clean) q_bad |= !finite(sQ[p * PY + pp]);
      acc = fma_rn(qb[p * PY + pp], sErr[i * PY + pp], acc);
    }
    bool other_bad = false;
#pragma unroll
    for (int t = 0; t < L::kChunks; ++t)
      other_bad |= (err_bad[t] & ~span_mask(i * PY - t * SEG,
                                            (i + 1) * PY - t * SEG)) != 0u;
    sW[o] = (N >= 2 && q_bad) || other_bad ? nan_value<T>() : acc;
  }
  __syncwarp();

  // H = (F2' Qbar) F2 + Rbar, a row each, and q = 2 F2' (Qbar err) as
  // one more row (fma(w, F2, .) is fma(F2, w, .))
  if constexpr (L::kRegisterRows) {
    // the row and every distinct entry of F2 in registers: with the
    // column and the row index unrolled, F2[l][col] is a register
    T mk[N * PY * M], zr[PY * M];
#pragma unroll
    for (int t = 0; t < N * PY * M; ++t) mk[t] = sMk[t];
#pragma unroll
    for (int t = 0; t < PY * M; ++t) zr[t] = sZero[t];
    for (int base = 0; base <= NX; base += SEG) {
      const int row = base + lane;
      const bool live = row <= NX;
      T x[NP];
      if (own_rows && row < NX) {
        // F2' Qbar's row `row` from F2's column, block by block, the
        // chains of the stage above
        const int ja = row / M, ca = row % M;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const T* qb = has_term && i == N - 1 ? sTerm : sQ;
          T f[PY];
#pragma unroll
          for (int p = 0; p < PY; ++p)
            f[p] = i >= ja ? sMk[((i - ja) * PY + p) * M + ca] : zr[p * M + ca];
#pragma unroll
          for (int pp = 0; pp < PY; ++pp) {
            T acc = T(0);
#pragma unroll
            for (int p = 0; p < PY; ++p) acc = fma_rn(f[p], qb[p * PY + pp], acc);
            x[i * PY + pp] = acc;
          }
        }
      } else {
        const T* src = row < NX ? sT + row * L::kLdT : sW;
#pragma unroll
        for (int l = 0; l < NP; ++l) x[l] = live ? src[l] : T(0);
      }
      // where F2 and every row are finite, the terms of F2's structural
      // zeros are +-0 at the head of each chain: skipped
      bool fin = true;
#pragma unroll
      for (int l = 0; l < NP; ++l) fin &= finite(x[l]);
      const bool skip = seg_all(fin) && clean;
#pragma unroll
      for (int col = 0; col < NX; ++col) {
        const int j = col / M, c = col % M;
        T acc = T(0);
        if (skip) {
#pragma unroll
          for (int l = j * PY; l < NP; ++l)
            acc = fma_rn(x[l], mk[((l / PY - j) * PY + l % PY) * M + c], acc);
        } else {
#pragma unroll
          for (int l = 0; l < NP; ++l) {
            const int i = l / PY, p = l % PY;
            acc = fma_rn(x[l], i >= j ? mk[((i - j) * PY + p) * M + c]
                                      : zr[p * M + c], acc);
          }
        }
        if (row < NX) {
          const T rv = sR[(row % M) * M + c];
          sH[row * NX + col] = add_rn(acc, row / M == j ? rv : mul_rn(rv, T(0)));
        } else if (row == NX && real) {
          a.qv[s * NX + col] = mul_rn(T(2), acc);
        }
      }
    }
  } else {
    for (int o = lane; o < NX * NX; o += SEG) {
      const int row = o / NX, col = o % NX;
      const int j = col / M, c = col % M;
      const T* t = sT + row * L::kLdT;
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < NP; ++l)
        acc = fma_rn(t[l], f2(l / PY, l % PY, j, c), acc);
      const T rv = sR[(row % M) * M + c];
      sH[o] = add_rn(acc, row / M == j ? rv : mul_rn(rv, T(0)));
    }
    for (int col = lane; col < NX; col += SEG) {
      const int j = col / M, c = col % M;
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < NP; ++l)
        acc = fma_rn(f2(l / PY, l % PY, j, c), sW[l], acc);
      if (real) a.qv[s * NX + col] = mul_rn(T(2), acc);
    }
  }
  __syncwarp();

  // P = 2 (0.5 (H + H'))
  for (int o = lane; o < (real ? NX * NX : 0); o += SEG) {
    const int row = o / NX, col = o % NX;
    a.p[s * NX * NX + o] =
        mul_rn(T(2), mul_rn(T(0.5), add_rn(sH[o], sH[col * NX + row])));
  }
}

using Shaped = Layout<float, KX_QPB_NZ, KX_QPB_M, KX_QPB_PY, KX_QPB_N>;

struct Shape {
  int warps = 0;  // a block
  size_t smem = 0;  // a block
  int blocks_per_sm = 0;
  int sms = 0;
  // warps that cover the batch, blocks that cover those, rounds of those
  static long long warps_for(long long batch) {
    return (batch + Shaped::kPerWarp - 1) / Shaped::kPerWarp;
  }
  long long blocks(long long batch) const {
    return (warps_for(batch) + warps - 1) / warps;
  }
  long long waves(long long batch) const {
    const long long per_wave = static_cast<long long>(blocks_per_sm) * sms;
    return (blocks(batch) + per_wave - 1) / per_wave;
  }
  int resident_warps() const { return blocks_per_sm * warps; }
};

template <typename T>
const void* kernel_of() {
  return reinterpret_cast<const void*>(
      qp_build_kernel<T, KX_QPB_NZ, KX_QPB_M, KX_QPB_PY, KX_QPB_N>);
}

template <typename T>
size_t warp_bytes() {
  using L = Layout<T, KX_QPB_NZ, KX_QPB_M, KX_QPB_PY, KX_QPB_N>;
  return static_cast<size_t>(L::kPerWarp) * L::kScenario * sizeof(T);
}

template <typename T>
cudaError_t shape(int batch, Shape* best) {
  static std::atomic<int> per_sm_cache[kBlockChoices];  // 0: not asked yet
  const void* kern = kernel_of<T>();
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Shape s;
  err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *best = Shape{};
  for (int c = 0; c < kBlockChoices; ++c) {
    s.warps = kBlockWarps[c];
    s.smem = s.warps * warp_bytes<T>();
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
    if (best->warps == 0 || s.waves(batch) < best->waves(batch) ||
        (s.waves(batch) == best->waves(batch) &&
         s.resident_warps() > best->resident_warps()))
      *best = s;
  }
  return best->warps ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T>
int launch(const T* a_, const T* b_, const T* c_, const T* z_, const T* yr_,
           const T* q_, const T* r_, const T* term_, T* p, T* qv,
           const long long* st, double fc, int batch, int nz, int m, int py,
           int horizon, void* stream) {
  if (batch <= 0 || nz != KX_QPB_NZ || m != KX_QPB_M || py != KX_QPB_PY ||
      horizon != KX_QPB_N)
    return cudaErrorInvalidValue;
  const Args<T> a{a_, b_, c_, z_, yr_, q_, r_, term_, p, qv,
                  st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                  st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15],
                  st[16], st[17], st[18], st[19], st[20], st[21], st[22],
                  static_cast<T>(fc), batch};
  Shape s;
  cudaError_t err = shape<T>(batch, &s);
  if (err != cudaSuccess) return err;
  const void* kern = kernel_of<T>();
  if (s.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s.smem));
    if (err != cudaSuccess) return err;
  }
  void* params[] = {const_cast<Args<T>*>(&a)};
  err = cudaLaunchKernel(kern, dim3(static_cast<unsigned>(s.blocks(batch))),
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
  err = cudaFuncGetAttributes(&attr, kernel_of<T>());
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = s.warps;
  out[2] = s.resident_warps();
  out[3] = static_cast<int>(s.waves(batch));
  out[4] = static_cast<int>(warp_bytes<T>());
  out[5] = Shaped::kPerWarp;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The shape this library was built for: {nz, m, py, horizon}.
void qp_build_shape(int* out) {
  out[0] = KX_QPB_NZ;
  out[1] = KX_QPB_M;
  out[2] = KX_QPB_PY;
  out[3] = KX_QPB_N;
}

// a (B, nz, nz), b (B, nz, m), c = CyC (B, py, nz), z (B, nz),
// yr (B, N, py), q and term (B, py, py), r (B, m, m) with the element
// strides {batch, row, column} of a, b, c, yr, q, r and term, then
// {batch, entry} of z (a batch stride may be 0); term may be null (no
// terminal block); p (B, N m, N m) and qv (B, N m) contiguous; fc the
// f_clamp (<= 0: none). The shape must be the library's. Returns a
// cudaError_t (0 = success).
int qp_build_f32(const float* a, const float* b, const float* c,
                 const float* z, const float* yr, const float* q,
                 const float* r, const float* term, float* p, float* qv,
                 const long long* strides, double fc, int batch, int nz, int m,
                 int py, int horizon, void* stream) {
  return launch<float>(a, b, c, z, yr, q, r, term, p, qv, strides, fc, batch,
                       nz, m, py, horizon, stream);
}

int qp_build_f64(const double* a, const double* b, const double* c,
                 const double* z, const double* yr, const double* q,
                 const double* r, const double* term, double* p, double* qv,
                 const long long* strides, double fc, int batch, int nz, int m,
                 int py, int horizon, void* stream) {
  return launch<double>(a, b, c, z, yr, q, r, term, p, qv, strides, fc, batch,
                        nz, m, py, horizon, stream);
}

// out = {registers per thread, warps per block, resident warps per SM,
// waves over the batch, shared bytes a warp, scenarios a warp} for
// float64 if f64 != 0, else float32.
int qp_build_launch_shape(int f64, int batch, int* out) {
  return f64 ? launch_shape<double>(batch, out)
             : launch_shape<float>(batch, out);
}

const char* qp_build_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
