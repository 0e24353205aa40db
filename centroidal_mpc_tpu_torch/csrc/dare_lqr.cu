// Batched truncated-DARE LQR gains.
//
// Replaces the TPU kernel centroidal_mpc_tpu/ops/pallas_lqr.py
// (lqr_gain_batched, _dare_kernel).  For S independent (A_s, B_s) pairs
// sharing Q (nx x nx) and R (nu x nu):
//   P <- Q;  repeat n_iter:  P <- Q + A'PA - A'PB H^{-1} B'PA,  H = R + B'PB
//   K = -H^{-1} B'PA   (H, B'PA of the final P)
// with H^{-1} = L^{-T} L^{-1} from a Cholesky factor H = L L'.  Arrays are
// row-major and contiguous: A (S, nx, nx), B (S, nx, nu), K (S, nu, nx).
//
// What bounds it on an H100: S = 6400 problems of 9 x 12 matrices (solo12
// at B=128, N=50) is ~10 small dense products per step, a few MFLOP in
// all and ~6 MB of A, B and K: far below either roofline, so the chain of
// dependent small steps (products, a 12 x 12 Cholesky, its inverse) sets
// the time.  Design: one warp per problem, four problems per block, every
// matrix of the chain in shared memory; a product spreads its output
// elements over the warp's lanes, the Cholesky runs column by column and
// the triangular inverse one column per lane.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 16;
constexpr int kWarpsPerBlock = 4;
constexpr int kMats = 10;  // shared-memory matrices per warp

// C = op(A) op(B): op(A) is m x kd, op(B) is kd x n; all with pitch ld.
template <typename T>
__device__ void warp_matmul(T* C, const T* A, bool ta, const T* Bm, bool tb,
                            int m, int n, int kd, int ld, int lane) {
  for (int e = lane; e < m * n; e += 32) {
    const int i = e / n, j = e - i * n;
    T acc = T(0);
    for (int l = 0; l < kd; ++l) {
      const T a = ta ? A[l * ld + i] : A[i * ld + l];
      const T b = tb ? Bm[j * ld + l] : Bm[l * ld + j];
      acc += a * b;
    }
    C[i * ld + j] = acc;
  }
  __syncwarp();
}

// Hinv = (R + BtP B)^{-1} through its Cholesky factor; H is overwritten.
template <typename T>
__device__ void warp_spd_inverse(T* H, T* L, T* Li, T* Hinv, int n, int ld,
                                 int lane) {
  for (int c = 0; c < n; ++c) {
    const T isq = T(1) / sqrt(H[c * ld + c]);
    if (lane < n) L[lane * ld + c] = (lane >= c) ? H[lane * ld + c] * isq : T(0);
    __syncwarp();
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e - i * n;
      if (j > c && i >= j) H[i * ld + j] -= L[i * ld + c] * L[j * ld + c];
    }
    __syncwarp();
  }
  if (lane < n) {
    const int j = lane;
    for (int i = 0; i < n; ++i) {
      if (i < j) {
        Li[i * ld + j] = T(0);
        continue;
      }
      T acc = (i == j) ? T(1) : T(0);
      for (int l = j; l < i; ++l) acc -= L[i * ld + l] * Li[l * ld + j];
      Li[i * ld + j] = acc / L[i * ld + i];
    }
  }
  __syncwarp();
  warp_matmul(Hinv, Li, true, Li, false, n, n, n, ld, lane);  // L^-T L^-1
}

template <typename T>
__global__ void dare_lqr_kernel(const T* __restrict__ Q,
                                const T* __restrict__ R,
                                const T* __restrict__ A,
                                const T* __restrict__ Bm,
                                T* __restrict__ K, int S, int nx, int nu,
                                int n_iter) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarpsPerBlock + warp;
  if (s >= S) return;  // whole warps exit together
  const int d = nx > nu ? nx : nu;
  const int ld = d + 1;
  const int mat = d * ld;
  T* base = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kMats * mat;
  T* sA = base;              // nx x nx
  T* sB = sA + mat;          // nx x nu
  T* P = sB + mat;           // nx x nx
  T* BtP = P + mat;          // nu x nx
  T* H = BtP + mat;          // nu x nu, then its Cholesky workspace
  T* L = H + mat;            // nu x nu
  T* Li = L + mat;           // nu x nu
  T* Hinv = Li + mat;        // nu x nu
  T* BtPA = Hinv + mat;      // nu x nx
  T* AtP = BtPA + mat;       // nx x nx; reused as (A'PB) H^{-1}, nx x nu

  const T* As = A + (size_t)s * nx * nx;
  const T* Bs = Bm + (size_t)s * nx * nu;
  for (int e = lane; e < nx * nx; e += 32) {
    const int i = e / nx, j = e - i * nx;
    sA[i * ld + j] = As[e];
    P[i * ld + j] = Q[e];
  }
  for (int e = lane; e < nx * nu; e += 32) {
    const int i = e / nu, j = e - i * nu;
    sB[i * ld + j] = Bs[e];
  }
  __syncwarp();

  for (int it = 0; it <= n_iter; ++it) {
    warp_matmul(BtP, sB, true, P, false, nu, nx, nx, ld, lane);   // B'P
    warp_matmul(H, BtP, false, sB, false, nu, nu, nx, ld, lane);  // B'PB
    for (int e = lane; e < nu * nu; e += 32) {
      const int i = e / nu, j = e - i * nu;
      H[i * ld + j] = R[e] + H[i * ld + j];
    }
    __syncwarp();
    warp_spd_inverse(H, L, Li, Hinv, nu, ld, lane);
    warp_matmul(BtPA, BtP, false, sA, false, nu, nx, nx, ld, lane);  // B'PA
    if (it == n_iter) break;  // K uses H and B'PA of the n_iter-step P
    warp_matmul(AtP, sA, true, P, false, nx, nx, nx, ld, lane);  // A'P
    // P <- Q + (A'P) A - ((B'PA)' H^{-1}) (B'PA)
    for (int e = lane; e < nx * nx; e += 32) {
      const int i = e / nx, j = e - i * nx;
      T acc = T(0);
      for (int l = 0; l < nx; ++l) acc += AtP[i * ld + l] * sA[l * ld + j];
      P[i * ld + j] = Q[e] + acc;
    }
    __syncwarp();
    warp_matmul(AtP, BtPA, true, Hinv, false, nx, nu, nu, ld, lane);
    for (int e = lane; e < nx * nx; e += 32) {
      const int i = e / nx, j = e - i * nx;
      T acc = T(0);
      for (int l = 0; l < nu; ++l) acc += AtP[i * ld + l] * BtPA[l * ld + j];
      P[i * ld + j] -= acc;
    }
    __syncwarp();
  }
  T* Ks = K + (size_t)s * nu * nx;
  for (int e = lane; e < nu * nx; e += 32) {
    const int i = e / nx, j = e - i * nx;
    T acc = T(0);
    for (int l = 0; l < nu; ++l) acc += Hinv[i * ld + l] * BtPA[l * ld + j];
    Ks[e] = -acc;
  }
}

template <typename T>
int dare(const T* Q, const T* R, const T* A, const T* Bm, T* K, int S,
         int nx, int nu, int n_iter, void* stream) {
  if (S <= 0 || nx <= 0 || nu <= 0 || nx > kMaxDim || nu > kMaxDim ||
      n_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = nx > nu ? nx : nu;
  const size_t bytes = sizeof(T) * kWarpsPerBlock * kMats * d * (d + 1);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dare_lqr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dare_lqr_kernel<T><<<blocks, 32 * kWarpsPerBlock, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      Q, R, A, Bm, K, S, nx, nu, n_iter);
  return static_cast<int>(cudaGetLastError());
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
