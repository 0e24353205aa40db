// Batched truncated-DARE LQR gains.
//
// Replaces the TPU kernel centroidal_mpc_tpu/ops/pallas_lqr.py
// (lqr_gain_batched, _dare_kernel).  For S independent (A_s, B_s) pairs
// sharing Q (nx x nx) and R (nu x nu), with H = R + B'PB = L L':
//   P <- Q;  repeat n_iter:  P <- Q + A'PA - Y'Y,  Y = L^{-1} B'PA
//   K = -L^{-T} Y   (L and Y of the n_iter-step P)
// which is the Pallas kernel's P <- Q + A'PA - A'PB H^{-1} B'PA and
// K = -H^{-1} B'PA without forming H^{-1}: H^{-1} is only ever applied to
// B'PA, so a forward substitution (and, for K, a back substitution) takes
// the place of L^{-1} and L^{-T} L^{-1}.  Arrays are row-major and
// contiguous: A (S, nx, nx), B (S, nx, nu), K (S, nu, nx).
//
// What bounds it on an H100: at S = 6,400 (solo12, B=128, N=50; nx 9,
// nu 12) two steps are 191 MFLOP against 7.6 MB moved, so operations bound
// it (2.86 us at the f32 rate, ops/lqr_kernel.lqr_cost).  Each problem is a
// chain of small dependent steps (products 9-12 wide, a 12-pivot Cholesky,
// two substitutions), so the card is busy only if many problems run at
// once and each step issues few instructions: no explicit inverse, no
// index arithmetic, operands in registers.  No tensor cores: the products
// are 9-12 wide, and the port keeps f32 exact (TF32 off,
// solver/scp.set_fp32_exact) against a 1e-4 kernel-vs-plain bar.
//
// Design: a group of 16 lanes per problem, two problems per warp, one warp
// per block, so S = 6,400 is 3,200 one-warp blocks, one wave of 25 on each
// of the 132 SMs when the (9, 12) f32 kernel keeps to 80 registers (its
// launch bounds ask for that).
//   - Lane r of a group owns row r of the nu-row results (B'P, H and its
//     factor L, B'PA, Y, K); lane i < nx owns row i of the nx-row ones
//     (A'P, P).  Column r of A and of B, which those rows need every step,
//     stay in the lane's registers from the load.
//   - What every lane of a group reads (the rows of P, A, B and Y) sits in
//     the group's shared memory, rows padded to 16 bytes and read as
//     broadcast 16-byte vectors.  Q and R are read once per block into
//     shared memory.  Only __syncwarp orders the shared rows.
//   - The Cholesky of H runs in registers, right-looking, pivots and column
//     entries passed by __shfl_sync within the group; the forward
//     substitution for Y rides along, row c of Y passed by shuffle once
//     pivot c is known.  One IEEE 1/sqrt a pivot (rsqrt is approximate).
//   - K = -L^{-T} Y by back substitution: L's rows go through shared
//     memory so that each lane has its column, rows of the result pass by
//     shuffle.
//   - (nx, nu) = (9, 12) (solo12, talos) and (9, 6) (bolt) are compiled
//     with the dimensions known; every other nx, nu <= 16 runs one generic
//     width of 16, padded as the Pallas wrapper pads (zeros in A, B and Q,
//     ones on R's padded diagonal), so its loops need no bounds checks.
//     A group past the last problem (odd S) recomputes the last one and
//     stores nothing: every lane takes part in every shuffle.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 16;  // nx, nu bound: the generic width
constexpr int kGroup = 16;   // lanes per problem
constexpr unsigned kFull = 0xffffffffu;

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

__device__ __forceinline__ void unpack(const float4& v, float* r) {
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* r) {
  r[0] = v.x;
  r[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float* r) {
  return make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ double2 pack(const double* r) {
  return make_double2(r[0], r[1]);
}

// W elements of a 16-byte aligned shared row into registers, 16 bytes a
// load (W a multiple of 16 / sizeof(T)), and back.
template <typename T, int W>
__device__ __forceinline__ void load_row(T (&r)[W], const T* p) {
  using V = typename Vec<T>::type;
#pragma unroll
  for (int k = 0; k < W; k += 16 / sizeof(T))
    unpack(*reinterpret_cast<const V*>(p + k), r + k);
}
template <typename T, int W>
__device__ __forceinline__ void store_row(T* p, const T (&r)[W]) {
  using V = typename Vec<T>::type;
#pragma unroll
  for (int k = 0; k < W; k += 16 / sizeof(T))
    *reinterpret_cast<V*>(p + k) = pack(r + k);
}

// Shared-memory layout, in elements of T, every row 16-byte aligned: per
// block Q (NX x XP) and R (NU x UP), then per problem A and P (NX x XP), B
// (NX x UP) and one NU x WP buffer for Y, then L, then K.
template <typename T, int NX, int NU>
struct Shape {
  static constexpr int kPer = 16 / sizeof(T);
  static constexpr int XP = round_up(NX, kPer);
  static constexpr int UP = round_up(NU, kPer);
  static constexpr int WP = XP > UP ? XP : UP;
  static constexpr int kProblem = 2 * NX * XP + NX * UP + NU * WP;
  static constexpr int kBlock = NX * XP + NU * UP + 2 * kProblem;
  static constexpr bool kGeneric = NX == kMaxDim && NU == kMaxDim;
  // one wave at the main path's S = 6,400 on 132 SMs (<= 80 registers)
  static constexpr int kMinBlocks =
      sizeof(T) == 4 && NX == 9 && NU == 12 ? 25 : 1;
};

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(32, (Shape<T, NX, NU>::kMinBlocks))
    dare_lqr_kernel(const T* __restrict__ Q, const T* __restrict__ R,
                    const T* __restrict__ A, const T* __restrict__ Bm,
                    T* __restrict__ K, int S, int nx_arg, int nu_arg,
                    int n_iter) {
  using Sh = Shape<T, NX, NU>;
  constexpr int XP = Sh::XP, UP = Sh::UP, WP = Sh::WP;
  const int nx = Sh::kGeneric ? nx_arg : NX;
  const int nu = Sh::kGeneric ? nu_arg : NU;
  extern __shared__ __align__(16) unsigned char dare_smem[];
  T* sQ = reinterpret_cast<T*>(dare_smem);
  T* sR = sQ + NX * XP;
  const int lane = threadIdx.x;
  const int grp = lane / kGroup, g = lane % kGroup;
  T* sA = sR + NU * UP + grp * Sh::kProblem;
  T* sP = sA + NX * XP;
  T* sB = sP + NX * XP;
  T* sY = sB + NX * UP;

  // Q and R once per block: zeros past nx, nu, ones on R's pad diagonal
#pragma unroll
  for (int i = 0; i < NX; ++i)
    if (lane < XP)
      sQ[i * XP + lane] = i < nx && lane < nx ? Q[i * nx + lane] : T(0);
#pragma unroll
  for (int i = 0; i < NU; ++i)
    if (lane < UP)
      sR[i * UP + lane] = i < nu && lane < nu ? R[i * nu + lane]
                          : i == lane         ? T(1)
                                              : T(0);

  // The group's A, B and P = Q, a row a step, coalesced; lane g keeps
  // column g of A and of B.
  const long long s_lane = 2ll * blockIdx.x + grp;
  const bool live = s_lane < S;
  const long long s = live ? s_lane : S - 1;
  const T* As = A + s * nx * nx;
  const T* Bs = Bm + s * nx * nu;
  T acol[NX], bcol[NX];
#pragma unroll
  for (int l = 0; l < NX; ++l) {
    acol[l] = l < nx && g < nx ? As[l * nx + g] : T(0);
    bcol[l] = l < nx && g < nu ? Bs[l * nu + g] : T(0);
    if (g < XP) {
      sA[l * XP + g] = acol[l];
      sP[l * XP + g] = l < nx && g < nx ? Q[l * nx + g] : T(0);
    }
    if (g < UP) sB[l * UP + g] = bcol[l];
  }
  __syncwarp();

  // the rows this lane owns; pad lanes repeat the last and store nothing
  const int ru = g < NU ? g : NU - 1;
  const int rx = g < NX ? g : NX - 1;
  T h[UP];        // row ru of H, then of L (zero right of the diagonal)
  T m[XP];        // row ru of B'PA, then of Y, then of K
  T dinv = T(1);  // 1 / L[ru][ru]
  for (int it = 0;; ++it) {
    // row ru of B'P = sum_l B[l][ru] P[l][:]
    T bp[XP];
#pragma unroll
    for (int j = 0; j < XP; ++j) bp[j] = T(0);
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      T p[XP];
      load_row(p, sP + l * XP);
#pragma unroll
      for (int j = 0; j < NX; ++j) bp[j] += bcol[l] * p[j];
    }
    // row ru of H = R + (B'P) B and of B'PA = (B'P) A
    load_row(h, sR + ru * UP);
#pragma unroll
    for (int j = 0; j < XP; ++j) m[j] = T(0);
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      T b[UP], a[XP];
      load_row(b, sB + l * UP);
      load_row(a, sA + l * XP);
#pragma unroll
      for (int c = 0; c < NU; ++c) h[c] += bp[l] * b[c];
#pragma unroll
      for (int j = 0; j < NX; ++j) m[j] += bp[l] * a[j];
    }

    // Cholesky of H in registers with Y = L^{-1} B'PA alongside: pivot c
    // from lane c; rows below lose L[i][c] L[j][c] (L[j][c] from lane j)
    // and L[i][c] Y[c] (Y[c] = m / L[c][c] from lane c).
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      const T isq = T(1) / sqrt(__shfl_sync(kFull, h[c], c, kGroup));
      if (g == c) dinv = isq;
      const T lc = g >= c ? h[c] * isq : T(0);
      h[c] = lc;
#pragma unroll
      for (int j = c + 1; j < NU; ++j)
        h[j] -= lc * __shfl_sync(kFull, lc, j, kGroup);
      if (c == NU - 1) {  // no row below: lane c finishes its own
#pragma unroll
        for (int j = 0; j < NX; ++j) m[j] = g == c ? m[j] * isq : m[j];
      } else {
        const T le = g > c ? lc : T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const T y = __shfl_sync(kFull, m[j], c, kGroup) * isq;
          m[j] = g == c ? y : m[j] - le * y;
        }
      }
    }
    if (it == n_iter) break;  // K uses L and Y of the n_iter-step P

    // P <- Q + (A'P) A - Y'Y, row rx; Y published for the column sums
    if (g < NU) store_row(sY + g * WP, m);
    __syncwarp();
    T ap[XP];
#pragma unroll
    for (int j = 0; j < XP; ++j) ap[j] = T(0);
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      T p[XP];
      load_row(p, sP + l * XP);
#pragma unroll
      for (int j = 0; j < NX; ++j) ap[j] += acol[l] * p[j];
    }
    T pn[XP];
    load_row(pn, sQ + rx * XP);
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      T a[XP];
      load_row(a, sA + l * XP);
#pragma unroll
      for (int j = 0; j < NX; ++j) pn[j] += ap[l] * a[j];
    }
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      T y[XP];
      load_row(y, sY + r * WP);
      const T yr = sY[r * WP + rx];
#pragma unroll
      for (int j = 0; j < NX; ++j) pn[j] -= yr * y[j];
    }
    __syncwarp();  // every read of P before it is overwritten
    if (g < NX) store_row(sP + g * XP, pn);
    __syncwarp();
  }

  // K = -L^{-T} Y by back substitution: lane g needs column g of L
  if (g < NU) store_row(sY + g * WP, h);
  __syncwarp();
  T lcol[NU];
#pragma unroll
  for (int c = 0; c < NU; ++c) lcol[c] = sY[c * WP + ru];
  __syncwarp();  // L read before K is staged over it
#pragma unroll
  for (int c = NU - 1; c >= 0; --c) {
    if (c == 0) {  // no row above: lane 0 finishes its own
#pragma unroll
      for (int j = 0; j < NX; ++j) m[j] = g == 0 ? m[j] * dinv : m[j];
    } else {
      const T d = __shfl_sync(kFull, dinv, c, kGroup);
      const T le = g < c ? lcol[c] : T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        const T x = __shfl_sync(kFull, m[j], c, kGroup) * d;
        m[j] = g == c ? x : m[j] - le * x;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < XP; ++j) m[j] = -m[j];
  if (g < NU) store_row(sY + g * WP, m);
  __syncwarp();
  if (live) {  // K rows out, coalesced
    T* Ks = K + s * nu * nx;
#pragma unroll
    for (int r = 0; r < NU; ++r)
      if (r < nu && g < nx) Ks[r * nx + g] = sY[r * WP + g];
  }
}

template <typename T, int NX, int NU>
cudaError_t launch(const T* Q, const T* R, const T* A, const T* Bm, T* K,
                   int S, int nx, int nu, int n_iter, cudaStream_t stream) {
  const size_t bytes = sizeof(T) * Shape<T, NX, NU>::kBlock;  // < 48 KB
  dare_lqr_kernel<T, NX, NU><<<(S + 1) / 2, 32, bytes, stream>>>(
      Q, R, A, Bm, K, S, nx, nu, n_iter);
  return cudaGetLastError();
}

template <typename T>
int dare(const T* Q, const T* R, const T* A, const T* Bm, T* K, int S,
         int nx, int nu, int n_iter, void* stream) {
  if (S <= 0 || nx <= 0 || nu <= 0 || nx > kMaxDim || nu > kMaxDim ||
      n_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nx == 9 && nu == 12)  // solo12, talos
    err = launch<T, 9, 12>(Q, R, A, Bm, K, S, nx, nu, n_iter, st);
  else if (nx == 9 && nu == 6)  // bolt
    err = launch<T, 9, 6>(Q, R, A, Bm, K, S, nx, nu, n_iter, st);
  else
    err = launch<T, kMaxDim, kMaxDim>(Q, R, A, Bm, K, S, nx, nu, n_iter, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int cmpc_dare_lqr_f32(const float* Q, const float* R, const float* A,
                      const float* Bm, float* K, int S, int nx, int nu,
                      int n_iter, void* stream) {
  return dare<float>(Q, R, A, Bm, K, S, nx, nu, n_iter, stream);
}

int cmpc_dare_lqr_f64(const double* Q, const double* R, const double* A,
                      const double* Bm, double* K, int S, int nx, int nu,
                      int n_iter, void* stream) {
  return dare<double>(Q, R, A, Bm, K, S, nx, nu, n_iter, stream);
}

}  // extern "C"
