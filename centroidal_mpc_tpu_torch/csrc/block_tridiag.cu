// Block-tridiagonal Cholesky factor and solve sweeps for the block ADMM.
//
// Replaces the TPU kernels of centroidal_mpc_tpu/ops/pallas_blockqp.py:
//   tridiag_factor  <- factor_batched (_factor_kernel, _chol_inv)
//   tridiag_fwd     <- solve_batched, forward pallas_call (_fwd_kernel)
//   tridiag_bwd     <- solve_batched, backward pallas_call (_bwd_kernel)
//
// M = P + sigma I + A' diag(rho) A is block-tridiagonal over the N+1 knots,
// with V x V blocks (V = nx + nu + 1 = 22 for solo12).  Per scenario:
//   C_0 = chol(D_0);  W_k = O_{k-1} C_{k-1}^{-T};  C_k = chol(D_k - W_k W_k')
// stored pre-inverted so that the solve is matrix-vector work only:
//   Cinv[k]   = C_k^{-1}                       (B, N+1, V, V)
//   Pfwd[k-1] = C_k^{-1} W_k                   (B, N,   V, V)
//   Pbwd[k-1] = C_{k-1}^{-T} W_k'              (B, N,   V, V)
// and M w = b is solved by
//   forward:  v_0 = Cinv_0 b_0,  v_k = Cinv_k b_k - Pfwd[k-1] v_{k-1}
//   backward: w_N = Cinv_N' v_N, w_k = Cinv_k' v_k - Pbwd[k] w_{k+1}
// C^{-T} is not stored: the backward sweep reads Cinv transposed from
// shared memory.  All arrays are batch-major, row-major and contiguous;
// the plain PyTorch versions in ops/block_tridiag.py use the same layout.
//
// What bounds these kernels on an H100: each is a dependency chain over
// the knots per scenario, on blocks far too small for tensor cores.  The
// factor runs ~4 small dense steps per knot (two V^3 products, a Cholesky,
// a triangular inverse, two more products); the sweeps read 2 V x V
// matrices per knot (about 25 MB per sweep at B=128, N=50, V=22 in f32)
// and are bound by memory latency along the chain.  Design: one thread
// block per scenario for the factor (the V x V work of a knot spread over
// the block, the carried C_{k-1}^{-1} in shared memory), and one warp per
// scenario for each sweep (lane i owns row i, V <= 32; the knot's two
// matrices are staged through shared memory with coalesced loads).  The
// batch is not padded.  Square roots and divisions are IEEE-rounded (no
// rsqrt approximation).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxV = 32;
constexpr int kFactorThreads = 256;

template <typename T>
__global__ void tridiag_factor_kernel(const T* __restrict__ diag,
                                      const T* __restrict__ off,
                                      T* __restrict__ cinv,
                                      T* __restrict__ pfwd,
                                      T* __restrict__ pbwd, int n1, int V) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ld = V + 1;  // odd row pitch: conflict-free column access
  const int mat = V * ld;
  T* S = sm;             // D_k - W W' (lower triangle updated in place)
  T* L = S + mat;        // Cholesky factor C_k
  T* X = L + mat;        // C_k^{-1}
  T* Xp = X + mat;       // C_{k-1}^{-1}
  T* W = Xp + mat;       // W_k
  T* O = W + mat;        // O_{k-1}
  const int tid = threadIdx.x, nt = blockDim.x;
  const int VV = V * V;
  const size_t b = blockIdx.x;
  const T* D = diag + b * n1 * VV;
  const T* Of = off + b * (n1 - 1) * VV;
  T* Ci = cinv + b * n1 * VV;
  T* Pf = pfwd + b * (n1 - 1) * VV;
  T* Pb = pbwd + b * (n1 - 1) * VV;

  for (int k = 0; k < n1; ++k) {
    for (int e = tid; e < VV; e += nt) {
      const int i = e / V, j = e - i * V;
      S[i * ld + j] = D[(size_t)k * VV + e];
      if (k > 0) O[i * ld + j] = Of[(size_t)(k - 1) * VV + e];
    }
    __syncthreads();
    if (k > 0) {
      // W[i][j] = sum_l O[i][l] Xp[j][l]      (W = O C_{k-1}^{-T})
      for (int e = tid; e < VV; e += nt) {
        const int i = e / V, j = e - i * V;
        T acc = T(0);
        for (int l = 0; l < V; ++l) acc += O[i * ld + l] * Xp[j * ld + l];
        W[i * ld + j] = acc;
      }
      __syncthreads();
      // S -= W W'
      for (int e = tid; e < VV; e += nt) {
        const int i = e / V, j = e - i * V;
        T acc = T(0);
        for (int l = 0; l < V; ++l) acc += W[i * ld + l] * W[j * ld + l];
        S[i * ld + j] -= acc;
      }
      __syncthreads();
    }
    // Cholesky, column by column: L[:, c] = S[:, c] / sqrt(S[c][c]), then
    // the trailing lower triangle loses L[:, c] L[:, c]'.
    for (int c = 0; c < V; ++c) {
      const T isq = T(1) / sqrt(S[c * ld + c]);
      for (int i = tid; i < V; i += nt)
        L[i * ld + c] = (i >= c) ? S[i * ld + c] * isq : T(0);
      __syncthreads();
      for (int e = tid; e < VV; e += nt) {
        const int i = e / V, j = e - i * V;
        if (j > c && i >= j) S[i * ld + j] -= L[i * ld + c] * L[j * ld + c];
      }
      __syncthreads();
    }
    // X = L^{-1} by forward substitution, one column per thread:
    // X[i][j] = (delta_ij - sum_{l<i} L[i][l] X[l][j]) / L[i][i]
    for (int j = tid; j < V; j += nt) {
      for (int i = 0; i < V; ++i) {
        if (i < j) {
          X[i * ld + j] = T(0);
          continue;
        }
        T acc = (i == j) ? T(1) : T(0);
        for (int l = j; l < i; ++l) acc -= L[i * ld + l] * X[l * ld + j];
        X[i * ld + j] = acc / L[i * ld + i];
      }
    }
    __syncthreads();
    for (int e = tid; e < VV; e += nt) {
      const int i = e / V, j = e - i * V;
      Ci[(size_t)k * VV + e] = X[i * ld + j];
      if (k > 0) {
        T pf = T(0), pb = T(0);
        for (int l = 0; l < V; ++l) {
          pf += X[i * ld + l] * W[l * ld + j];   // (C_k^{-1} W)[i][j]
          pb += W[j * ld + l] * Xp[l * ld + i];  // (W C_{k-1}^{-1})[j][i]
        }
        Pf[(size_t)(k - 1) * VV + e] = pf;
        Pb[(size_t)(k - 1) * VV + e] = pb;
      }
    }
    __syncthreads();
    for (int e = tid; e < VV; e += nt) {
      const int i = e / V, j = e - i * V;
      Xp[i * ld + j] = X[i * ld + j];
    }
    __syncthreads();
  }
}

// One sweep, one warp per scenario.  REVERSE=false is the forward sweep
// (Cinv applied as is, coupling P[k-1] on the previous knot); REVERSE=true
// the backward sweep (Cinv applied transposed, coupling P[k] on the next).
template <typename T, bool REVERSE>
__global__ void tridiag_sweep_kernel(const T* __restrict__ cinv,
                                     const T* __restrict__ coup,
                                     const T* __restrict__ rhs,
                                     T* __restrict__ out, int n1, int V) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ld = V + 1;
  T* M = sm;              // Cinv_k
  T* P = M + V * ld;      // coupling block
  T* r = P + V * ld;      // rhs_k
  T* prev = r + V;        // carried solution of the neighbour knot
  const int lane = threadIdx.x;
  const int VV = V * V;
  const size_t b = blockIdx.x;
  const T* Cb = cinv + b * n1 * VV;
  const T* Pb = coup + b * (n1 - 1) * VV;
  const T* rb = rhs + b * n1 * V;
  T* ob = out + b * n1 * V;

  for (int s = 0; s < n1; ++s) {
    const int k = REVERSE ? n1 - 1 - s : s;
    const int pk = REVERSE ? k : k - 1;   // coupling slot, valid if s > 0
    for (int e = lane; e < VV; e += 32) {
      const int i = e / V, j = e - i * V;
      M[i * ld + j] = Cb[(size_t)k * VV + e];
      if (s > 0) P[i * ld + j] = Pb[(size_t)pk * VV + e];
    }
    if (lane < V) r[lane] = rb[(size_t)k * V + lane];
    __syncwarp();
    T y = T(0);
    if (lane < V) {
      T c = T(0);
      for (int l = 0; l < V; ++l)
        c += (REVERSE ? M[l * ld + lane] : M[lane * ld + l]) * r[l];
      T q = T(0);
      if (s > 0)
        for (int l = 0; l < V; ++l) q += P[lane * ld + l] * prev[l];
      y = c - q;
    }
    __syncwarp();
    if (lane < V) {
      prev[lane] = y;
      ob[(size_t)k * V + lane] = y;
    }
    __syncwarp();
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int factor(const T* diag, const T* off, T* cinv, T* pfwd, T* pbwd, int B,
           int n1, int V, void* stream) {
  if (B <= 0 || n1 <= 0 || V <= 0 || V > kMaxV)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = 6 * sizeof(T) * V * (V + 1);
  cudaError_t err = allow_smem(tridiag_factor_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tridiag_factor_kernel<T><<<B, kFactorThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      diag, off, cinv, pfwd, pbwd, n1, V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool REVERSE>
int sweep(const T* cinv, const T* coup, const T* rhs, T* out, int B, int n1,
          int V, void* stream) {
  if (B <= 0 || n1 <= 0 || V <= 0 || V > kMaxV)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(T) * (2 * V * (V + 1) + 2 * V);
  tridiag_sweep_kernel<T, REVERSE><<<B, 32, bytes,
                                     static_cast<cudaStream_t>(stream)>>>(
      cinv, coup, rhs, out, n1, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cmpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int cmpc_tridiag_factor_f32(const float* diag, const float* off, float* cinv,
                            float* pfwd, float* pbwd, int B, int n1, int V,
                            void* stream) {
  return factor<float>(diag, off, cinv, pfwd, pbwd, B, n1, V, stream);
}

int cmpc_tridiag_factor_f64(const double* diag, const double* off,
                            double* cinv, double* pfwd, double* pbwd, int B,
                            int n1, int V, void* stream) {
  return factor<double>(diag, off, cinv, pfwd, pbwd, B, n1, V, stream);
}

int cmpc_tridiag_fwd_f32(const float* cinv, const float* pfwd,
                         const float* b, float* out, int B, int n1, int V,
                         void* stream) {
  return sweep<float, false>(cinv, pfwd, b, out, B, n1, V, stream);
}

int cmpc_tridiag_fwd_f64(const double* cinv, const double* pfwd,
                         const double* b, double* out, int B, int n1, int V,
                         void* stream) {
  return sweep<double, false>(cinv, pfwd, b, out, B, n1, V, stream);
}

int cmpc_tridiag_bwd_f32(const float* cinv, const float* pbwd,
                         const float* v, float* out, int B, int n1, int V,
                         void* stream) {
  return sweep<float, true>(cinv, pbwd, v, out, B, n1, V, stream);
}

int cmpc_tridiag_bwd_f64(const double* cinv, const double* pbwd,
                         const double* v, double* out, int B, int n1, int V,
                         void* stream) {
  return sweep<double, true>(cinv, pbwd, v, out, B, n1, V, stream);
}

}  // extern "C"
