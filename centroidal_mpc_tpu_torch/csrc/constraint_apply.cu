// The block ADMM's constraint operator A and its transpose A', one launch
// for each product.
//
// Replaces no TPU kernel.  The JAX package applies A and A' as batched
// einsums that XLA fuses on the TPU (centroidal_mpc_tpu/ops/blockqp.py,
// _apply_A and _apply_AT).  In the port those einsums became cuBLAS
// batched gemv over tens of thousands of 9x9, 9x12, 5x3 and 8x3 matrices,
// each a problem too small for the library, plus 15-25 elementwise,
// slice-add and zero-fill launches a product; at B=1024 they held about 70%
// of the device's busy time.  These two kernels were added to compute each
// product whole, reading every coefficient once.
//
// Per scenario, with w = (x, u, t) and z grouped as ops/blockqp.ZGroups
// (init, dyn, final, cop, fric, trust, slack):
//   A w:   init   = d0 * x_0                 final  = dN * x_N
//          dyn_k  = Ah_k x_k + Bh_k u_k - Ih_k * x_{k+1}           (k < N)
//          cop_kc = coph_kc * u_kc[0:2]      fric_kc = Gh_kc u_kc   (k < N)
//          trust_k = Th_k x_k[6:9] - wh_k t_k,  slack_k = -sh_k t_k (k <= N)
//   A' z:  x_k = [k=0] d0 init + [k<N] Ah_k' dyn_k - [k>0] Ih_{k-1} dyn_{k-1}
//                + [k=N] dN final + (entries 6:9) Th_k' trust_k
//          u_kc = Bh_k' dyn_k (its columns of c) + Gh_kc' fric_kc
//                 + (entries 0:2) coph_kc cop_kc
//          t_k = -wh_k . trust_k - sh_k slack_k
// in the order the plain versions (ops/blockqp._apply_A_plain,
// _apply_AT_plain) add their terms.
//
// What bounds them: bytes.  A product reads every coefficient block once
// (Ah, Bh, Ih, Gh, coph a knot k < N; Th, wh, sh a knot k <= N; d0, dN a
// scenario) and the vectors once: 248 MB at B=1024, N=165 for solo12 in
// f32, 74 us at 3.35 TB/s, against 2 flops a coefficient, about 0.4 flop a
// byte (ops/constraint_apply.constraint_apply_cost).  No tensor cores: the
// work has nothing for them to do.  At B=128 the coefficient blocks (26
// MB) fit in the 50 MB L2, so the products of one segment read them from
// there.
//
// Design.  The (scenario, knot) pairs are flattened into S = B (N+1) rows;
// a block takes R consecutive rows (R = 32 in f32, 16 in f64).  Those rows
// are one contiguous run of each coefficient tensor: a row of knot N has no
// Ah, Bh, Ih, Gh or coph, so the runs of those skip it, and row r's entry
// is r - r / (N+1).  The block copies each run into shared memory with
// 16-byte cp.async copies (element copies at the run's ragged ends), and
// the rows' vectors element by element: w = (x, u, t) as strided views of
// the solve's packed W (A' also zeroes its dummy control slot of knot N),
// z a (B, m) buffer of the groups above (`ZOffsets`) with a lane stride.
// The one neighbour a row needs across the tile's edge (x_{k+1} for A;
// dyn_{k-1} and Ih_{k-1} for A') is copied from device memory with the
// tile.  After one wait, the threads compute each output group in a loop
// over (row, entry): one thread an output, written once, by its owner, in
// entry order, so a warp's stores are coalesced.  No atomics.  Every sum is
// an fp32 (fp64 for fp64) fused multiply-add chain in a fixed order over
// its index.  A block uses under 48 KB of shared memory, so four or five
// share an SM and one's copies overlap another's arithmetic.  The block
// sizes are template parameters: nx = 9 and the contact layout (C
// contacts, nuc entries each): solo12 (4, 3), bolt (2, 3) and the talos
// wrench6 feet (2, 6).  The point-foot robots' cop rows are inert zeros,
// computed as the plain version computes them, so that the group layout
// does not depend on the robot.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kNX = 9;     // state entries
constexpr int kTrust = 8;  // trust rows a knot (sign enumeration of 3)
constexpr int kAng = 6;    // first angular-momentum entry of x

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" :::
                   "memory");
}

// Copy src[0, n) into the 16-B aligned shared region `region` (n elements
// and 16 bytes long) and return where src[0] landed: the region mirrors
// device memory's 16-byte alignment, so the aligned interior goes in
// 16-byte copies and only the ends element by element.
template <typename T>
__device__ __forceinline__ T* stage(char* region, const T* src, int n) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t g1 = g0 + static_cast<uintptr_t>(n) * sizeof(T);
  const uintptr_t base = g0 & ~static_cast<uintptr_t>(15);
  T* dst = reinterpret_cast<T*>(region + (g0 - base));
  const uintptr_t a = (g0 + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t e = g1 & ~static_cast<uintptr_t>(15);
  if (a < e) {
    const int n16 = static_cast<int>((e - a) / 16);
    char* d16 = region + (a - base);
    const char* s16 = reinterpret_cast<const char*>(a);
    for (int q = threadIdx.x; q < n16; q += blockDim.x)
      cp_async16(d16 + 16 * q, s16 + 16 * q);
    const int head = static_cast<int>((a - g0) / sizeof(T));
    const int tail0 = static_cast<int>((e - g0) / sizeof(T));
    for (int q = threadIdx.x; q < head + n - tail0; q += blockDim.x) {
      const int i = q < head ? q : tail0 + q - head;
      cp_async_elem(dst + i, src + i);
    }
  } else {
    for (int q = threadIdx.x; q < n; q += blockDim.x)
      cp_async_elem(dst + q, src + q);
  }
  return dst;
}

// Bytes of a shared region that takes n elements of T at any 16-byte
// phase.
template <typename T>
__host__ __device__ constexpr int region(int n) {
  return (n * static_cast<int>(sizeof(T)) + 15) / 16 * 16 + 16;
}

// The block sizes of one contact layout, and each kernel's shared memory.
template <typename T, int C, int NUC>
struct Shape {
  static constexpr int R = sizeof(T) == 4 ? 32 : 16;  // rows a block
  static constexpr int NU = C * NUC;
  static constexpr int COP = 2 * C;  // cop rows a knot
  static constexpr int FR = 5 * C;   // friction rows a knot
  // coefficient runs, common to both kernels but Ih
  static constexpr int kCoef =
      region<T>(R * kNX * kNX) + region<T>(R * kNX * NU) +
      region<T>(R * FR * NUC) + region<T>(R * COP) +
      region<T>(R * kTrust * 3) + region<T>(R * kTrust) + region<T>(R);
  // A: Ih over the tile; x with the row after the tile, u, t
  static constexpr int kApply = kCoef + region<T>(R * kNX) +
                                region<T>((R + 1) * kNX) +
                                region<T>(R * NU) + region<T>(R);
  // A': Ih and dyn with the entry before the tile; cop, fric, trust, slack
  static constexpr int kApplyT =
      kCoef + 2 * region<T>((R + 1) * kNX) + region<T>(R * COP) +
      region<T>(R * FR) + region<T>(R * kTrust) + region<T>(R);
};

template <typename T>
struct Coef {
  const T *d0, *Ah, *Bh, *Ih, *dN, *Gh, *coph, *Th, *wh, *sh;
};

// Where each group starts in a lane's row of z (ops/blockqp._zshapes):
// init at 0, then dyn, final, cop, fric, trust, slack.
template <int C>
struct ZOffsets {
  long long dyn = kNX, fin, cop, fric, trust, slack;
  __device__ explicit ZOffsets(long long N)
      : fin(kNX + N * kNX), cop(fin + kNX), fric(cop + N * 2 * C),
        trust(fric + N * 5 * C), slack(trust + (N + 1) * kTrust) {}
};

struct Strides {  // of x, u (lane, knot, entry), t (lane, knot), z (lane)
  long long xb, xk, xi, ub, uk, ui, tb, tk, zb;
};

// Copy entries [0, width) of group `off` of n rows of z into dst: row j is
// row rows[j] of the tile's table (j itself without `rows`).
template <typename T>
__device__ __forceinline__ void stage_z(T* dst, const T* z, long long zb,
                                        long long off, int width, int n,
                                        const int* rows, const int* rb,
                                        const int* rk) {
  for (int e = threadIdx.x; e < n * width; e += blockDim.x) {
    const int lr = rows ? rows[e / width] : e / width;
    cp_async_elem(dst + e, z + rb[lr] * zb + off + rk[lr] * width + e % width);
  }
}

// The rows of one block: row lr = 0..nr-1 is (scenario rb[lr], knot
// rk[lr]); entry j = 0..nc-1 of the coefficient runs is row jrow[j].  Row
// nr, the one after the tile, is in the table too.
struct Tile {
  long long r0, ia;  // first row, its coefficient entry
  int nr, nc, b0;
};

__device__ __forceinline__ Tile tile_rows(int R, int B, int N, int* rk,
                                          int* rb, int* jrow) {
  const int n1 = N + 1;
  const long long S = static_cast<long long>(B) * n1;
  Tile t;
  t.r0 = static_cast<long long>(blockIdx.x) * R;
  t.nr = static_cast<int>(S - t.r0 < R ? S - t.r0 : R);
  t.b0 = static_cast<int>(t.r0 / n1);
  t.ia = t.r0 - t.b0;
  const long long re = t.r0 + t.nr;
  t.nc = static_cast<int>(re - re / n1 - t.ia);
  for (int lr = threadIdx.x; lr <= t.nr; lr += blockDim.x) {
    const long long r = t.r0 + lr;
    const int b = static_cast<int>(r / n1);
    const int k = static_cast<int>(r - static_cast<long long>(b) * n1);
    rk[lr] = k;
    rb[lr] = b;
    if (lr < t.nr && k < N) jrow[lr - (b - t.b0)] = lr;
  }
  return t;
}

template <typename T, int C, int NUC>
__global__ void __launch_bounds__(kThreads, 4)
    constraint_apply_kernel(Coef<T> cf, const T* __restrict__ x,
                            const T* __restrict__ u,
                            const T* __restrict__ t, T* __restrict__ z,
                            Strides sd, int B, int N) {
  using S = Shape<T, C, NUC>;
  constexpr int R = S::R, NU = S::NU, COP = S::COP, FR = S::FR;
  const ZOffsets<C> zo(N);
  __shared__ __align__(16) char smem[S::kApply];
  __shared__ int rk[R + 1], rb[R + 1], jrow[R];
  const Tile tl = tile_rows(R, B, N, rk, rb, jrow);
  __syncthreads();
  // entry q of row lr's group at `off`, `width` entries a knot
  auto zat = [&](long long off, int width, int lr, int q) -> T& {
    return z[rb[lr] * sd.zb + off + rk[lr] * width + q];
  };
  const long long S1 = static_cast<long long>(B) * (N + 1);
  const long long ia = tl.ia, r0 = tl.r0;
  const int nr = tl.nr, nc = tl.nc;

  char* p = smem;
  const T* sAh = stage(p, cf.Ah + ia * kNX * kNX, nc * kNX * kNX);
  p += region<T>(R * kNX * kNX);
  const T* sBh = stage(p, cf.Bh + ia * kNX * NU, nc * kNX * NU);
  p += region<T>(R * kNX * NU);
  const T* sGh = stage(p, cf.Gh + ia * FR * NUC, nc * FR * NUC);
  p += region<T>(R * FR * NUC);
  const T* scoph = stage(p, cf.coph + ia * COP, nc * COP);
  p += region<T>(R * COP);
  const T* sTh = stage(p, cf.Th + r0 * kTrust * 3, nr * kTrust * 3);
  p += region<T>(R * kTrust * 3);
  const T* swh = stage(p, cf.wh + r0 * kTrust, nr * kTrust);
  p += region<T>(R * kTrust);
  const T* ssh = stage(p, cf.sh + r0, nr);
  p += region<T>(R);
  const T* sIh = stage(p, cf.Ih + ia * kNX, nc * kNX);
  p += region<T>(R * kNX);
  // the vectors, dense in shared memory: x over the rows and the row after
  T* sx = reinterpret_cast<T*>(p);
  p += region<T>((R + 1) * kNX);
  T* su = reinterpret_cast<T*>(p);
  p += region<T>(R * NU);
  T* st = reinterpret_cast<T*>(p);
  for (int e = threadIdx.x; e < (nr + 1) * kNX; e += blockDim.x) {
    const int lr = e / kNX, i = e - lr * kNX;
    if (r0 + lr < S1)
      cp_async_elem(sx + e, x + rb[lr] * sd.xb + rk[lr] * sd.xk + i * sd.xi);
  }
  for (int e = threadIdx.x; e < nc * NU; e += blockDim.x) {
    const int j = e / NU, q = e - j * NU, lr = jrow[j];
    cp_async_elem(su + e, u + rb[lr] * sd.ub + rk[lr] * sd.uk + q * sd.ui);
  }
  for (int lr = threadIdx.x; lr < nr; lr += blockDim.x)
    cp_async_elem(st + lr, t + rb[lr] * sd.tb + rk[lr] * sd.tk);
  cp_async_wait_all();
  __syncthreads();

  // dyn = (Ah x_k + Bh u_k) - Ih * x_{k+1}
  for (int o = threadIdx.x; o < nc * kNX; o += blockDim.x) {
    const int j = o / kNX, i = o - j * kNX, lr = jrow[j];
    const T* a = sAh + (j * kNX + i) * kNX;
    const T* xv = sx + lr * kNX;
    T acc = T(0);
#pragma unroll
    for (int m = 0; m < kNX; ++m) acc = fma(a[m], xv[m], acc);
    const T* bm = sBh + (j * kNX + i) * NU;
    const T* uv = su + j * NU;
    T accu = T(0);
#pragma unroll
    for (int m = 0; m < NU; ++m) accu = fma(bm[m], uv[m], accu);
    zat(zo.dyn, kNX, lr, i) = (acc + accu) - sIh[o] * xv[kNX + i];
  }
  // cop = coph * u_c[0:2]
  for (int o = threadIdx.x; o < nc * COP; o += blockDim.x) {
    const int j = o / COP, q = o - j * COP, lr = jrow[j];
    zat(zo.cop, COP, lr, q) =
        scoph[o] * su[j * NU + (q >> 1) * NUC + (q & 1)];
  }
  // fric = Gh u_c
  for (int o = threadIdx.x; o < nc * FR; o += blockDim.x) {
    const int j = o / FR, q = o - j * FR, lr = jrow[j];
    const T* g = sGh + o * NUC;
    const T* uv = su + j * NU + (q / 5) * NUC;
    T acc = T(0);
#pragma unroll
    for (int m = 0; m < NUC; ++m) acc = fma(g[m], uv[m], acc);
    zat(zo.fric, FR, lr, q) = acc;
  }
  // trust = Th x[6:9] - wh * t
  for (int o = threadIdx.x; o < nr * kTrust; o += blockDim.x) {
    const int lr = o / kTrust, q = o - lr * kTrust;
    const T* th = sTh + o * 3;
    const T* xv = sx + lr * kNX + kAng;
    T acc = T(0);
#pragma unroll
    for (int m = 0; m < 3; ++m) acc = fma(th[m], xv[m], acc);
    zat(zo.trust, kTrust, lr, q) = acc - swh[o] * st[lr];
  }
  // slack = -sh * t
  for (int lr = threadIdx.x; lr < nr; lr += blockDim.x)
    zat(zo.slack, 1, lr, 0) = -ssh[lr] * st[lr];
  // init = d0 * x_0, final = dN * x_N
  for (int o = threadIdx.x; o < nr * kNX; o += blockDim.x) {
    const int lr = o / kNX, i = o - lr * kNX, k = rk[lr];
    const long long bi = static_cast<long long>(rb[lr]) * kNX + i;
    T* zl = z + rb[lr] * sd.zb + i;
    if (k == 0) zl[0] = cf.d0[bi] * sx[o];
    if (k == N) zl[zo.fin] = cf.dN[bi] * sx[o];
  }
}

template <typename T, int C, int NUC>
__global__ void __launch_bounds__(kThreads, 4)
    constraint_apply_T_kernel(Coef<T> cf, const T* __restrict__ z,
                              T* __restrict__ x, T* __restrict__ u,
                              T* __restrict__ t, Strides sd, int B, int N) {
  using S = Shape<T, C, NUC>;
  constexpr int R = S::R, NU = S::NU, COP = S::COP, FR = S::FR;
  const ZOffsets<C> zo(N);
  __shared__ __align__(16) char smem[S::kApplyT];
  __shared__ int rk[R + 1], rb[R + 1], jrow[R];
  const Tile tl = tile_rows(R, B, N, rk, rb, jrow);
  __syncthreads();  // z's copies below read the row tables
  const long long ia = tl.ia, r0 = tl.r0;
  const int nr = tl.nr, nc = tl.nc;
  // Ih and dyn from the entry before the tile's first (knot k-1 of x_k)
  const long long im = ia > 0 ? ia - 1 : 0;
  const int nm = static_cast<int>(ia + nc - im);
  const int jm = static_cast<int>(ia - im);

  char* p = smem;
  const T* sAh = stage(p, cf.Ah + ia * kNX * kNX, nc * kNX * kNX);
  p += region<T>(R * kNX * kNX);
  const T* sBh = stage(p, cf.Bh + ia * kNX * NU, nc * kNX * NU);
  p += region<T>(R * kNX * NU);
  const T* sGh = stage(p, cf.Gh + ia * FR * NUC, nc * FR * NUC);
  p += region<T>(R * FR * NUC);
  const T* scoph = stage(p, cf.coph + ia * COP, nc * COP);
  p += region<T>(R * COP);
  const T* sTh = stage(p, cf.Th + r0 * kTrust * 3, nr * kTrust * 3);
  p += region<T>(R * kTrust * 3);
  const T* swh = stage(p, cf.wh + r0 * kTrust, nr * kTrust);
  p += region<T>(R * kTrust);
  const T* ssh = stage(p, cf.sh + r0, nr);
  p += region<T>(R);
  const T* sIh = stage(p, cf.Ih + im * kNX, nm * kNX);
  p += region<T>((R + 1) * kNX);
  // z's groups, element by element: the tile's rows may span lanes; dyn
  // over the coefficient entries im .. ia+nc-1 (entry g: lane g / N)
  T* sdyn = reinterpret_cast<T*>(p);
  for (int e = threadIdx.x; e < nm * kNX; e += blockDim.x) {
    const long long g = im + e / kNX, b = g / N;
    cp_async_elem(sdyn + e,
                  z + b * sd.zb + zo.dyn + (g - b * N) * kNX + e % kNX);
  }
  p += region<T>((R + 1) * kNX);
  T* scop = reinterpret_cast<T*>(p);
  stage_z(scop, z, sd.zb, zo.cop, COP, nc, jrow, rb, rk);
  p += region<T>(R * COP);
  T* sfric = reinterpret_cast<T*>(p);
  stage_z(sfric, z, sd.zb, zo.fric, FR, nc, jrow, rb, rk);
  p += region<T>(R * FR);
  T* strust = reinterpret_cast<T*>(p);
  stage_z(strust, z, sd.zb, zo.trust, kTrust, nr, nullptr, rb, rk);
  p += region<T>(R * kTrust);
  T* sslack = reinterpret_cast<T*>(p);
  stage_z(sslack, z, sd.zb, zo.slack, 1, nr, nullptr, rb, rk);
  cp_async_wait_all();
  __syncthreads();

  // x = [k=0] d0 init + [k<N] Ah' dyn_k - [k>0] Ih_{k-1} dyn_{k-1}
  //     + [k=N] dN final + (entries 6:9) Th' trust
  for (int o = threadIdx.x; o < nr * kNX; o += blockDim.x) {
    const int lr = o / kNX, i = o - lr * kNX, k = rk[lr];
    const long long bi = static_cast<long long>(rb[lr]) * kNX + i;
    const int j = lr - (rb[lr] - tl.b0);  // this row's coefficient entry
    const T* zl = z + rb[lr] * sd.zb + i;
    T acc = T(0);
    if (k == 0) acc = cf.d0[bi] * zl[0];
    if (k < N) {
      const T* a = sAh + j * kNX * kNX + i;
      const T* dv = sdyn + (j + jm) * kNX;
      T s = T(0);
#pragma unroll
      for (int m = 0; m < kNX; ++m) s = fma(a[m * kNX], dv[m], s);
      acc = acc + s;
    }
    if (k > 0) {
      const int jp = (j + jm - 1) * kNX + i;
      acc = acc + (-sIh[jp]) * sdyn[jp];
    }
    if (k == N) acc = acc + cf.dN[bi] * zl[zo.fin];
    if (i >= kAng && i < kAng + 3) {
      const T* th = sTh + lr * kTrust * 3 + (i - kAng);
      const T* tv = strust + lr * kTrust;
      T s = T(0);
#pragma unroll
      for (int q = 0; q < kTrust; ++q) s = fma(th[q * 3], tv[q], s);
      acc = acc + s;
    }
    x[rb[lr] * sd.xb + rk[lr] * sd.xk + i * sd.xi] = acc;
  }
  // u = Bh' dyn + (Gh' fric, + coph cop on entries 0:2) per contact
  for (int o = threadIdx.x; o < nc * NU; o += blockDim.x) {
    const int j = o / NU, q = o - j * NU, c = q / NUC, m = q - c * NUC;
    const int lr = jrow[j];
    const T* bm = sBh + j * kNX * NU + q;
    const T* dv = sdyn + (j + jm) * kNX;
    T s = T(0);
#pragma unroll
    for (int i = 0; i < kNX; ++i) s = fma(bm[i * NU], dv[i], s);
    const T* g = sGh + (j * FR + c * 5) * NUC + m;
    const T* fv = sfric + j * FR + c * 5;
    T uc = T(0);
#pragma unroll
    for (int r = 0; r < 5; ++r) uc = fma(g[r * NUC], fv[r], uc);
    if (m < 2) {
      const int cq = j * COP + 2 * c + m;
      uc = uc + scoph[cq] * scop[cq];
    }
    u[rb[lr] * sd.ub + rk[lr] * sd.uk + q * sd.ui] = s + uc;
  }
  // W's dummy control slot of knot N
  for (int o = threadIdx.x; o < nr * NU; o += blockDim.x) {
    const int lr = o / NU;
    if (rk[lr] == N)
      u[rb[lr] * sd.ub + N * sd.uk + (o - lr * NU) * sd.ui] = T(0);
  }
  // t = -(wh . trust) - sh * slack
  for (int lr = threadIdx.x; lr < nr; lr += blockDim.x) {
    const T* wv = swh + lr * kTrust;
    const T* tv = strust + lr * kTrust;
    T s = T(0);
#pragma unroll
    for (int q = 0; q < kTrust; ++q) s = fma(wv[q], tv[q], s);
    t[rb[lr] * sd.tb + rk[lr] * sd.tk] = -s - ssh[lr] * sslack[lr];
  }
}

template <typename T>
Coef<T> coef(const T* d0, const T* Ah, const T* Bh, const T* Ih, const T* dN,
             const T* Gh, const T* coph, const T* Th, const T* wh,
             const T* sh) {
  return Coef<T>{d0, Ah, Bh, Ih, dN, Gh, coph, Th, wh, sh};
}

template <typename T, int C, int NUC>
unsigned grid_of(int B, int N) {
  const long long rows = static_cast<long long>(B) * (N + 1);
  const int R = Shape<T, C, NUC>::R;
  return static_cast<unsigned>((rows + R - 1) / R);
}

template <typename T, int C, int NUC>
int launch_apply(Coef<T> cf, const T* x, const T* u, const T* t, T* z,
                 int B, int N, Strides sd, void* stream) {
  constraint_apply_kernel<T, C, NUC>
      <<<grid_of<T, C, NUC>(B, N), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(cf, x, u, t, z, sd, B, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C, int NUC>
int launch_apply_T(Coef<T> cf, const T* z, T* x, T* u, T* t, int B, int N,
                   Strides sd, void* stream) {
  constraint_apply_T_kernel<T, C, NUC>
      <<<grid_of<T, C, NUC>(B, N), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(cf, z, x, u, t, sd, B, N);
  return static_cast<int>(cudaGetLastError());
}

// Shapes with an instantiation: nx = 9 and (C, nuc) of solo12, bolt and
// the talos wrench6 feet.  Others give cudaErrorInvalidValue (the wrapper
// raises before that).
constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <typename T>
int apply(Coef<T> cf, const T* x, const T* u, const T* t, T* z, int B,
          int N, int nx, int C, int nuc, Strides sd, void* stream) {
  if (B < 0 || N < 0 || nx != kNX) return kInvalid;
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (C == 4 && nuc == 3)
    return launch_apply<T, 4, 3>(cf, x, u, t, z, B, N, sd, stream);
  if (C == 2 && nuc == 3)
    return launch_apply<T, 2, 3>(cf, x, u, t, z, B, N, sd, stream);
  if (C == 2 && nuc == 6)
    return launch_apply<T, 2, 6>(cf, x, u, t, z, B, N, sd, stream);
  return kInvalid;
}

template <typename T>
int apply_T(Coef<T> cf, const T* z, T* x, T* u, T* t, int B, int N,
            int nx, int C, int nuc, Strides sd, void* stream) {
  if (B < 0 || N < 0 || nx != kNX) return kInvalid;
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (C == 4 && nuc == 3)
    return launch_apply_T<T, 4, 3>(cf, z, x, u, t, B, N, sd, stream);
  if (C == 2 && nuc == 3)
    return launch_apply_T<T, 2, 3>(cf, z, x, u, t, B, N, sd, stream);
  if (C == 2 && nuc == 6)
    return launch_apply_T<T, 2, 6>(cf, z, x, u, t, B, N, sd, stream);
  return kInvalid;
}

}  // namespace

extern "C" {

#define CMPC_APPLY(SFX, T)                                                   \
  int cmpc_constraint_apply##SFX(                                            \
      const T* d0, const T* Ah, const T* Bh, const T* Ih, const T* dN,       \
      const T* Gh, const T* coph, const T* Th, const T* wh, const T* sh,     \
      const T* x, const T* u, const T* t, T* z, int B, int N, int nx, int C, \
      int nuc, int xb, int xk, int xi, int ub, int uk, int ui, int tb,       \
      int tk, int zb, void* stream) {                                        \
    return apply<T>(coef<T>(d0, Ah, Bh, Ih, dN, Gh, coph, Th, wh, sh), x, u, \
                    t, z, B, N, nx, C, nuc,                                  \
                    Strides{xb, xk, xi, ub, uk, ui, tb, tk, zb}, stream);    \
  }                                                                          \
  int cmpc_constraint_apply_T##SFX(                                          \
      const T* d0, const T* Ah, const T* Bh, const T* Ih, const T* dN,       \
      const T* Gh, const T* coph, const T* Th, const T* wh, const T* sh,     \
      const T* z, T* x, T* u, T* t, int B, int N, int nx, int C, int nuc,    \
      int zb, int xb, int xk, int xi, int ub, int uk, int ui, int tb,        \
      int tk, void* stream) {                                                \
    return apply_T<T>(coef<T>(d0, Ah, Bh, Ih, dN, Gh, coph, Th, wh, sh), z,  \
                      x, u, t, B, N, nx, C, nuc,                             \
                      Strides{xb, xk, xi, ub, uk, ui, tb, tk, zb}, stream);  \
  }

CMPC_APPLY(_f32, float)
CMPC_APPLY(_f64, double)

#undef CMPC_APPLY

}  // extern "C"
