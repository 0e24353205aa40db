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
// The batch is not padded.  Square roots and divisions are IEEE-rounded
// (no rsqrt approximation, no fast-math).
//
// The factor: two launches on the caller's stream, both replacing
// factor_batched (_factor_kernel, _chol_inv).  Only C_k^{-1} and W_k
// depend on the knot before; Pfwd and Pbwd feed nothing later in the
// chain.  So:
//   - tridiag_factor_chain: one warp per scenario (32-thread blocks), lane
//     i owning row i (V <= 32).  Per knot: W_k = O_{k-1} C_{k-1}^{-T} (row
//     i of O in registers, rows of C_{k-1}^{-1} broadcast from shared
//     memory, the triangle only); S = D_k - W W' (W published through
//     shared memory); the Cholesky of S in registers, pivots and column
//     entries passed by __shfl_sync; C_k^{-1} by columns, lane j owning
//     column j and reading the rows of L from shared memory, so no lane
//     waits on another.  D_{k+1} and O_k are copied by cp.async into a
//     double buffer while knot k computes (16-byte copies when the blocks
//     and pointers allow, else one element each).  Only __syncwarp and
//     shuffles synchronise it.  It writes C_k^{-1} and, as scratch, W_k
//     into the Pfwd slot.  What bounds it: one warp's dependent latency
//     per knot (per pivot a shuffle, IEEE sqrt and reciprocal, the next
//     column's update), some 3.4k instructions (SASS, V=22 f32) issued by
//     a warp that is alone on its SM, so each waits out the latency of
//     the one before; at B=128 each of 128 SMs holds one such warp.
//   - tridiag_factor_couple: one block per (scenario, coupled knot), no
//     chain: it loads W_k, C_k^{-1} and C_{k-1}^{-1}, then writes
//     Pfwd[k-1] = C_k^{-1} W_k in place over W_k and Pbwd[k-1] =
//     C_{k-1}^{-T} W_k'.  No block reads what another writes.  Bytes bound
//     it: ~62 MB of whole blocks moved at B=128, N=50, V=22 in f32 against
//     142 MFLOP.
// No tensor cores: mma/wgmma in TF32 keeps ~10 mantissa bits, and the port
// runs f32 with TF32 off against a 1e-4 kernel-vs-plain bar (3xTF32 in
// the couple kernel is later work).  The function's bound is 15.0 us
// (bytes) at B=128, N=50, V=22 in f32.
//
// The sweeps.  Each must read per knot the lower triangle of a Cinv block
// and a dense coupling block: 20.1 MB per sweep at B=128, N=50, V=22 in
// f32, 6.0 us at 3.35 TB/s, against 9.6 MFLOP, so bytes bound them (the
// kernels read the Cinv blocks whole, 26.2 MB).  Half of each knot's work
// does not depend on the carried vector: c_k = Cinv_k b_k (forward) or
// d_k = Cinv_k' v_k (backward).  Only y_k = c_k - P_k y_prev is a chain.
// One thread block
// per scenario, six warps with fixed roles, over a ring of S shared-memory
// stages of four knots each (their Cinv blocks, coupling blocks and c):
//   - warp 0, the producer, keeps the ring up to S stages ahead of the
//     chain.  A stage's Cinv blocks are one contiguous run in device
//     memory, and so are its coupling blocks.  When V*V*sizeof(T) is a
//     multiple of 16 (V even) one thread copies each run with a TMA bulk
//     copy (cp.async.bulk) that completes on the stage's mbarrier (the
//     wrappers require Cinv and the coupling blocks 16-B aligned then);
//     else the warp copies them element by element with cp.async;
//   - warps 2-5 compute c for knot q = 0..3 of every stage, in parallel
//     and off the chain, with the rhs read from device memory one stage
//     ahead;
//   - warp 1 runs the chain: lane i owns row i (V <= 32).  y_prev is
//     broadcast through a double-buffered 32-entry vector in shared
//     memory, read with 16-byte loads; the P row and c of the next knot
//     load into a second register set while this knot's multiply-adds
//     run; the next stage's barriers are tested one stage ahead.
// Three mbarriers per stage order the roles: full (the copies landed),
// cdone (the four c are written) and empty (the chain and all c-warps are
// done with it).  Every waiter sees every phase of a barrier in order.
// The ring wraps whenever the horizon has more than 4 S knots (S = 8 at
// V=22 in f32 with one block per SM; it shrinks when blocks share an SM).
// V=22, the main path's (solo12, talos), is compiled with V known; other V
// (bolt's 16 among them) run one generic instantiation, 32 registers a
// row, with bounds checks.  What limits the sweeps now: the chain's
// latency per knot on one warp (the broadcast store and its dependent
// shared loads, V multiply-adds in 8 accumulators), which no other work of
// the scenario can shorten; at B=128 the HBM share of one SM comes close
// to it (PERF.md has the times).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxV = 32;
constexpr int kCoupleThreads = 256;

// ---------------------------------------------------------------------------
// Solve sweeps (design in the note at the top of the file).

constexpr int kGroup = 4;           // knots per stage
constexpr int kSweepCWarps = kGroup;  // one c-warp per knot of a stage
constexpr int kSweepThreads = 32 * (2 + kSweepCWarps);
constexpr int kMaxStages = 8;
constexpr size_t kRingBytes = 128 * 1024;  // ring bytes per SM
constexpr size_t kBarrierBytes = 3 * kMaxStages * sizeof(uint64_t);
// scratch elements: the chain's y, double-buffered, and each c-warp's rhs
constexpr int kScratch = 2 * 32 + kSweepCWarps * 32;

// Shape of one launch.  A stage holds kGroup knots, in elements of T, each
// part starting on a 16-B boundary: their Cinv blocks [blk], their
// coupling blocks [blk] (each run as contiguous as in device memory), and
// c [kGroup][vpad].
struct SweepShape {
  int n1, V;
  int stages;  // S
  int blk;     // kGroup*V*V rounded up to 16 B
  int vpad;    // V rounded up to 16 B
  int bulk;    // blocks go by TMA bulk copy (else by cp.async)
};

// 16 bytes of T.
template <typename T>
struct alignas(16) Chunk {
  T v[16 / sizeof(T)];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory loads and stores by 32-bit shared address, in program
// order with every other memory access.
__device__ __forceinline__ void st_shared(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, double v) {
  asm volatile("st.shared.f64 [%0], %1;" ::"r"(a), "d"(v) : "memory");
}
__device__ __forceinline__ void ld_shared(float& v, uint32_t a) {
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
}
__device__ __forceinline__ void ld_shared(double& v, uint32_t a) {
  asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(a) : "memory");
}
__device__ __forceinline__ void ld_shared2(float& x, float& y, uint32_t a) {
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(x), "=f"(y)
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ld_shared2(double& x, double& y,
                                           uint32_t a) {
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];"
               : "=d"(x), "=d"(y)
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ld_chunk(Chunk<float>& c, uint32_t a) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(c.v[0]), "=f"(c.v[1]), "=f"(c.v[2]), "=f"(c.v[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ld_chunk(Chunk<double>& c, uint32_t a) {
  ld_shared2(c.v[0], c.v[1], a);
}

// out[...] = v where lane < V, without a branch around the store.
__device__ __forceinline__ void st_global_if(bool p, float* a, float v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q st.global.f32 [%0], %1;\n\t}" ::"l"(a),
      "f"(v), "r"(static_cast<unsigned>(p))
      : "memory");
}
__device__ __forceinline__ void st_global_if(bool p, double* a, double v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q st.global.f64 [%0], %1;\n\t}" ::"l"(a),
      "d"(v), "r"(static_cast<unsigned>(p))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Whether the phase of parity `parity` of `bar` has completed (no wait).
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy global -> shared; its bytes complete on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Row of a V x V block at shared address `a` into registers, 0 past V:
// two elements a load when V is known and even (rows are then 2-element
// aligned).
template <typename T, int VB, int VX>
__device__ __forceinline__ void load_row(T (&d)[VB], uint32_t a, int V) {
#pragma unroll
  for (int j = 0; j < VB; j += 2) {
    if constexpr (VX > 0 && VX % 2 == 0) {
      if (j < VX)
        ld_shared2(d[j], d[j + 1], a + j * sizeof(T));
      else
        d[j] = d[j + 1] = T(0);
    } else {
      d[j] = d[j + 1] = T(0);
      if (j < V) ld_shared(d[j], a + j * sizeof(T));
      if (j + 1 < V) ld_shared(d[j + 1], a + (j + 1) * sizeof(T));
    }
  }
}

// One sweep of one scenario per thread block.  REVERSE=false is the
// forward sweep (Cinv applied as is, coupling P[k-1] on the previous
// knot); REVERSE=true the backward sweep (Cinv applied transposed,
// coupling P[k] on the next).  Step s runs knot k = s (forward) or
// n1-1-s (backward); group g holds steps 4g..4g+3 in stage g mod S, and
// the blocks of its q-th step sit at position q (forward) or gq-1-q
// (backward) of the stage, gq being the group's length.  VB >= V is the
// register width of a row, a multiple of 4; VX is V when it is known at
// compile time (the main path's V=22: no per-element bounds checks), else
// 0.
template <typename T, bool REVERSE, int VB, int VX>
__device__ __forceinline__ void sweep_body(const T* __restrict__ cinv,
                                           const T* __restrict__ coup,
                                           const T* __restrict__ rhs,
                                           T* __restrict__ out,
                                           const SweepShape sh) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int W = sizeof(T);
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sweep_smem);
  uint64_t* cdone = full + kMaxStages;
  uint64_t* empty = cdone + kMaxStages;
  T* scratch = reinterpret_cast<T*>(sweep_smem + kBarrierBytes);
  T* ring = scratch + kScratch;
  const int n1 = sh.n1, V = VX ? VX : sh.V, S = sh.stages;
  const int blk = sh.blk, vpad = sh.vpad;
  const int len = 2 * blk + kGroup * vpad;  // stage length
  const int ngroups = (n1 + kGroup - 1) / kGroup;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = lane < V ? lane : 0;  // idle lanes read row 0
  const int VV = V * V;
  const size_t b = blockIdx.x;
  const T* Cb = cinv + b * n1 * VV;
  const T* Pb = coup + b * (n1 - 1) * VV;
  const T* rb = rhs + b * n1 * V;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], sh.bulk ? 1 : 32);
      mbar_init(&cdone[i], 32 * kSweepCWarps);
      mbar_init(&empty[i], 32 + 32 * kSweepCWarps);  // chain and c-warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // producer: one thread with TMA, the warp without
    if (sh.bulk && lane != 0) return;
    int st = 0;
    unsigned par = 0;
    for (int g = 0; g < ngroups; ++g) {
      if (g >= S) mbar_wait(&empty[st], par ^ 1);
      const int g0 = g * kGroup, gq = min(kGroup, n1 - g0);
      const int clo = REVERSE ? n1 - g0 - gq : g0;  // first Cinv block
      const int pn = g == 0 ? gq - 1 : gq;           // coupling blocks
      const int plo = REVERSE ? clo : (g == 0 ? 0 : g0 - 1);
      T* dst_c = ring + (size_t)st * len;
      T* dst_p = dst_c + blk + ((!REVERSE && g == 0) ? VV : 0);
      const T* src_c = Cb + (size_t)clo * VV;
      const T* src_p = Pb + (size_t)plo * VV;
      if (sh.bulk) {
        const unsigned cbytes = gq * VV * W, pbytes = pn * VV * W;
        mbar_arrive_expect_tx(&full[st], cbytes + pbytes);
        bulk_copy(dst_c, src_c, cbytes, &full[st]);
        if (pn > 0) bulk_copy(dst_p, src_p, pbytes, &full[st]);
      } else {
        for (int e = lane; e < gq * VV; e += 32)
          cp_async_elem(dst_c + e, src_c + e);
        for (int e = lane; e < pn * VV; e += 32)
          cp_async_elem(dst_p + e, src_p + e);
        cp_async_arrive(&full[st]);
      }
      if (++st == S) {
        st = 0;
        par ^= 1;
      }
    }
  } else if (warp == 1) {  // the chain y_k = c_k - P y_prev
    const uint32_t ybuf = smem_addr(scratch);  // y of the last two steps
    const uint32_t ring_a = smem_addr(ring);
    T* optr = out + b * n1 * V + lane;
    if (REVERSE) optr += (size_t)(n1 - 1) * V;
    const ptrdiff_t ostep = REVERSE ? -V : V;
    // shared addresses of the P row and of c for step q of a group of
    // length gq in stage st
    auto p_at = [&](int st, int q, int gq) {
      const int pos = REVERSE ? gq - 1 - q : q;
      return ring_a + W * (st * len + blk + pos * VV + row * V);
    };
    auto c_at = [&](int st, int q) {
      return ring_a + W * (st * len + 2 * blk + q * vpad + row);
    };
    T pa[VB], pb[VB], ca, cb = T(0);
#pragma unroll
    for (int j = 0; j < VB; ++j) pa[j] = pb[j] = T(0);
    mbar_wait(&full[0], 0);
    mbar_wait(&cdone[0], 0);
    ld_shared(ca, c_at(0, 0));
    int st = 0;
    unsigned par = 0;
    bool ready = false;  // the next group's operands have landed
    // Step s = 4g + q: y from c and p, then the next step's operands
    // into (pn, cn) while the store of y settles.
    auto step = [&](int g, int q, int gq, const T(&p)[VB], T c, T(&pn)[VB],
                    T& cn) {
      const int s = g * kGroup + q;
      T y = c;
      if (s > 0) {
        const uint32_t yp = ybuf + ((s - 1) & 1) * 32 * W;
        T acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = T(0);
#pragma unroll
        for (int j = 0; j < VB; j += kPer) {
          Chunk<T> ch;
          ld_chunk(ch, yp + j * W);
#pragma unroll
          for (int t = 0; t < kPer; ++t)
            if (!VX || j + t < VX) acc[(j + t) % 8] += p[j + t] * ch.v[t];
        }
        y = c - (((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                 ((acc[4] + acc[5]) + (acc[6] + acc[7])));
      }
      // lanes >= V write 0: the padding of the next product adds 0
      st_shared(ybuf + (s & 1) * 32 * W + lane * W, lane < V ? y : T(0));
      __syncwarp();
      st_global_if(lane < V, optr, y);
      optr += ostep;
      if (q + 1 < gq) {
        load_row<T, VB, VX>(pn, p_at(st, q + 1, gq), V);
        ld_shared(cn, c_at(st, q + 1));
      } else if (s + 1 < n1) {  // first step of the next group
        const int st1 = st + 1 == S ? 0 : st + 1;
        const unsigned par1 = st + 1 == S ? par ^ 1 : par;
        if (!ready) {
          mbar_wait(&full[st1], par1);
          mbar_wait(&cdone[st1], par1);
        }
        load_row<T, VB, VX>(pn, p_at(st1, 0, min(kGroup, n1 - s - 1)), V);
        ld_shared(cn, c_at(st1, 0));
      }
    };
    for (int g = 0; g < ngroups; ++g) {
      const int gq = min(kGroup, n1 - g * kGroup);
      if (g + 1 < ngroups) {  // look ahead without waiting: usually done
        const int st1 = st + 1 == S ? 0 : st + 1;
        const unsigned par1 = st + 1 == S ? par ^ 1 : par;
        ready = mbar_test(&full[st1], par1) && mbar_test(&cdone[st1], par1);
      }
      // kGroup = 4 steps with the register sets in turns; only the last
      // group can be shorter, so every group starts from (pa, ca)
      step(g, 0, gq, pa, ca, pb, cb);
      if (gq > 1) step(g, 1, gq, pb, cb, pa, ca);
      if (gq > 2) step(g, 2, gq, pa, ca, pb, cb);
      if (gq > 3) step(g, 3, gq, pb, cb, pa, ca);
      mbar_arrive(&empty[st]);
      if (++st == S) {
        st = 0;
        par ^= 1;
      }
    }
  } else {  // c-warp q: c = Cinv rhs (forward), Cinv' rhs (backward)
    const int q = warp - 2;  // for the q-th knot of every group
    T* rbuf = scratch + 64 + q * 32;
    auto rhs_of = [&](int g) {
      const int s = g * kGroup + q;
      return (s < n1 && lane < V)
                 ? rb[(size_t)(REVERSE ? n1 - 1 - s : s) * V + lane]
                 : T(0);
    };
    int st = 0;
    unsigned par = 0;
    T r = rhs_of(0);
    for (int g = 0; g < ngroups; ++g) {
      const T rn = rhs_of(g + 1);  // in flight meanwhile
      __syncwarp();
      rbuf[lane] = r;
      __syncwarp();
      mbar_wait(&full[st], par);
      T* stg = ring + (size_t)st * len;
      const int gq = min(kGroup, n1 - g * kGroup);
      if (q < gq) {
        const T* M = stg + (REVERSE ? gq - 1 - q : q) * VV;
        T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
        for (int j = 0; j < VB; j += kPer) {
          const Chunk<T> ch = *reinterpret_cast<const Chunk<T>*>(rbuf + j);
#pragma unroll
          for (int t = 0; t < kPer; ++t) {
            const int jj = j + t;
            if (VX ? jj < VX : jj < V)
              acc[jj % 4] +=
                  (REVERSE ? M[jj * V + row] : M[row * V + jj]) * ch.v[t];
          }
        }
        if (lane < V)
          stg[2 * blk + q * vpad + lane] =
              (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      mbar_arrive(&cdone[st]);
      mbar_arrive(&empty[st]);
      if (++st == S) {
        st = 0;
        par ^= 1;
      }
      r = rn;
    }
  }
}

template <typename T, int VB, int VX>
__global__ void __launch_bounds__(kSweepThreads)
    tridiag_fwd_kernel(const T* __restrict__ cinv, const T* __restrict__ pfwd,
                       const T* __restrict__ b, T* __restrict__ out,
                       const SweepShape sh) {
  sweep_body<T, false, VB, VX>(cinv, pfwd, b, out, sh);
}

template <typename T, int VB, int VX>
__global__ void __launch_bounds__(kSweepThreads)
    tridiag_bwd_kernel(const T* __restrict__ cinv, const T* __restrict__ pbwd,
                       const T* __restrict__ v, T* __restrict__ out,
                       const SweepShape sh) {
  sweep_body<T, true, VB, VX>(cinv, pbwd, v, out, sh);
}

// ---------------------------------------------------------------------------
// Factor (design in the note at the top of the file).

__device__ __forceinline__ void st_chunk(uint32_t a, const Chunk<float>& c) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "f"(c.v[0]), "f"(c.v[1]), "f"(c.v[2]), "f"(c.v[3])
               : "memory");
}
__device__ __forceinline__ void st_chunk(uint32_t a, const Chunk<double>& c) {
  asm volatile("st.shared.v2.f64 [%0], {%1, %2};" ::"r"(a), "d"(c.v[0]),
               "d"(c.v[1])
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most `N` of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One V x V block (VV contiguous elements) into shared memory by the warp:
// 16 bytes a copy when `vec` (block and pointers 16-B aligned), else one
// element a copy.
template <typename T>
__device__ __forceinline__ void copy_block(T* dst, const T* src, int VV,
                                           bool vec, int lane) {
  if (vec) {
    const int n = VV * static_cast<int>(sizeof(T)) / 16;
    for (int e = lane; e < n; e += 32)
      cp_async16(reinterpret_cast<char*>(dst) + 16 * e,
                 reinterpret_cast<const char*>(src) + 16 * e);
  } else {
    for (int e = lane; e < VV; e += 32) cp_async_elem(dst + e, src + e);
  }
}

// The knot chain of one scenario per 32-thread block: C_k^{-1} into cinv
// and W_k into w (slot k-1).  Lane i owns row i; lanes V..31 carry
// identity rows, so the generic width (VX = 0) runs all VB = 32 columns
// with no bounds checks.  VX is V when known at compile time (the main
// path's 22: VB = 24), and then only its columns run.  Shared memory, in
// elements of T: D and O double-buffered [2][blkp] each (blocks as in
// device memory, blkp = V*V rounded up to 16 B), then three VB x VB
// blocks with 16-B rows: X (the last knot's C^{-1}), W and L.
template <typename T, int VB, int VX>
__global__ void __launch_bounds__(32)
    tridiag_factor_chain_kernel(const T* __restrict__ diag,
                                const T* __restrict__ off,
                                T* __restrict__ cinv, T* __restrict__ wout,
                                int n1, int Vr, int vec) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int NV = VX ? VX : VB;  // columns that run
  constexpr int Z = sizeof(T);
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const int V = VX ? VX : Vr;
  const int VV = V * V;
  const int blkp = (VV + kPer - 1) / kPer * kPer;
  T* Dsm = reinterpret_cast<T*>(chain_smem);
  T* Osm = Dsm + 2 * blkp;
  T* Xsm = Osm + 2 * blkp;
  T* Wsm = Xsm + VB * VB;
  T* Lsm = Wsm + VB * VB;
  const uint32_t xa = smem_addr(Xsm), wa = smem_addr(Wsm),
                 la = smem_addr(Lsm);
  const int lane = threadIdx.x;
  const bool real = lane < V;
  const bool owns = lane < VB;  // has a row of X, W and L
  const int row = real ? lane : 0;
  const size_t b = blockIdx.x;
  const T* Db = diag + b * n1 * VV;
  const T* Ob = off + b * (n1 - 1) * VV;
  T* Cb = cinv + b * n1 * VV;
  T* Wb = wout + b * (n1 - 1) * VV;

  for (int e = lane; e < 3 * VB * VB; e += 32) Xsm[e] = T(0);
  copy_block(Dsm, Db, VV, vec, lane);
  cp_async_commit();

  for (int k = 0; k < n1; ++k) {
    const int cur = k & 1;
    if (k + 1 < n1) {  // D_{k+1} and O_k in flight while knot k computes
      copy_block(Dsm + (cur ^ 1) * blkp, Db + (size_t)(k + 1) * VV, VV, vec,
                 lane);
      copy_block(Osm + (cur ^ 1) * blkp, Ob + (size_t)k * VV, VV, vec, lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    T s[VB];
    if (k > 0) {
      // W[i][j] = sum_{l<=j} O[i][l] X[j][l]   (W = O C_{k-1}^{-T})
      T o[VB];
      load_row<T, VB, VX>(o, smem_addr(Osm + cur * blkp + row * V), V);
      T w[VB];
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        w[j] = T(0);
        if (j >= NV) continue;
        T acc = T(0);
#pragma unroll
        for (int l0 = 0; l0 <= j; l0 += kPer) {
          Chunk<T> ch;
          ld_chunk(ch, xa + Z * (j * VB + l0));
#pragma unroll
          for (int t = 0; t < kPer; ++t)
            if (l0 + t <= j) acc += o[l0 + t] * ch.v[t];
        }
        w[j] = real ? acc : T(0);
      }
      if (owns) {
#pragma unroll
        for (int j = 0; j < VB; j += kPer) {
          Chunk<T> ch;
#pragma unroll
          for (int t = 0; t < kPer; ++t) ch.v[t] = w[j + t];
          st_chunk(wa + Z * (lane * VB + j), ch);
        }
      }
      __syncwarp();
      // S[i][j] = D[i][j] - sum_l W[i][l] W[j][l]
      load_row<T, VB, VX>(s, smem_addr(Dsm + cur * blkp + row * V), V);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        T acc = T(0);
#pragma unroll
        for (int l0 = 0; l0 < NV; l0 += kPer) {
          Chunk<T> ch;
          ld_chunk(ch, wa + Z * (j * VB + l0));
#pragma unroll
          for (int t = 0; t < kPer; ++t)
            if (l0 + t < NV) acc += w[l0 + t] * ch.v[t];
        }
        s[j] -= acc;
      }
    } else {
      load_row<T, VB, VX>(s, smem_addr(Dsm + row * V), V);
    }
    if (!real) {
#pragma unroll
      for (int j = 0; j < VB; ++j) s[j] = j == lane ? T(1) : T(0);
    }

    // Cholesky in registers, right-looking: the pivot of column c from
    // lane c, then row i's trailing entries lose L[i][c] L[j][c], L[j][c]
    // from lane j.  s becomes row i of L (zero right of the diagonal).
    T isq[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      isq[c] = T(1) / sqrt(__shfl_sync(0xffffffffu, s[c], c));
      const T lc = lane >= c ? s[c] * isq[c] : T(0);
      s[c] = lc;
#pragma unroll
      for (int j = c + 1; j < NV; ++j)
        s[j] -= lc * __shfl_sync(0xffffffffu, lc, j);
    }
    if (owns) {
#pragma unroll
      for (int j = 0; j < VB; j += kPer) {
        Chunk<T> ch;
#pragma unroll
        for (int t = 0; t < kPer; ++t)
          ch.v[t] = j + t < NV ? s[j + t] : T(0);
        st_chunk(la + Z * (lane * VB + j), ch);
      }
    }
    __syncwarp();

    // C_k^{-1} by columns: lane j runs X[i][j] = (delta_ij -
    // sum_{l<i} L[i][l] X[l][j]) / L[i][i] down its column, the rows of L
    // broadcast from shared memory (X[l][j] = 0 for l < j).
    T x[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      T acc = lane == i ? T(1) : T(0);
#pragma unroll
      for (int l0 = 0; l0 < i; l0 += kPer) {
        Chunk<T> ch;
        ld_chunk(ch, la + Z * (i * VB + l0));
#pragma unroll
        for (int t = 0; t < kPer; ++t)
          if (l0 + t < i) acc -= ch.v[t] * x[l0 + t];
      }
      x[i] = acc * isq[i];
    }
    if (owns) {
#pragma unroll
      for (int i = 0; i < NV; ++i) st_shared(xa + Z * (i * VB + lane), x[i]);
    }
    __syncwarp();

    // C_k^{-1} and W_k out, coalesced from shared memory
    for (int e = lane; e < VV; e += 32) {
      const int i = e / V, j = e - i * V;
      Cb[(size_t)k * VV + e] = Xsm[i * VB + j];
      if (k > 0) Wb[(size_t)(k - 1) * VV + e] = Wsm[i * VB + j];
    }
  }
}

// Pfwd[k-1] = C_k^{-1} W_k (over W_k, in place) and Pbwd[k-1] =
// C_{k-1}^{-T} W_k' for one (scenario, coupled knot k) per block.  The
// blocks sit in shared memory with the odd pitch V+1 (conflict-free
// column reads); only the nonzero part of each C^{-1} is summed.
template <typename T>
__global__ void __launch_bounds__(kCoupleThreads)
    tridiag_factor_couple_kernel(const T* __restrict__ cinv, T* pfwd,
                                 T* __restrict__ pbwd, int n, int V) {
  extern __shared__ __align__(16) unsigned char couple_smem[];
  T* W = reinterpret_cast<T*>(couple_smem);
  const int ld = V + 1;
  T* X = W + V * ld;   // C_k^{-1}
  T* Xp = X + V * ld;  // C_{k-1}^{-1}
  const int VV = V * V;
  const size_t slot = blockIdx.x;  // b * n + k - 1
  const size_t b = slot / n, k = slot % n + 1;
  const T* Ck = cinv + (b * (n + 1) + k) * VV;
  T* Pf = pfwd + slot * VV;
  T* Pb = pbwd + slot * VV;
  for (int e = threadIdx.x; e < VV; e += blockDim.x) {
    const int i = e / V, j = e - i * V;
    W[i * ld + j] = Pf[e];
    X[i * ld + j] = Ck[e];
    Xp[i * ld + j] = Ck[e - VV];
  }
  __syncthreads();  // every read of W before any write over it
  for (int e = threadIdx.x; e < 2 * VV; e += blockDim.x) {
    const bool fwd = e < VV;
    const int f = fwd ? e : e - VV;
    const int i = f / V, j = f - i * V;
    T acc = T(0);
    if (fwd) {
      for (int l = 0; l <= i; ++l) acc += X[i * ld + l] * W[l * ld + j];
      Pf[f] = acc;
    } else {
      for (int l = i; l < V; ++l) acc += Xp[l * ld + i] * W[j * ld + l];
      Pb[f] = acc;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T, int VB, int VX = 0>
cudaError_t launch_chain(const T* diag, const T* off, T* cinv, T* w, int B,
                         int n1, int V, int vec, cudaStream_t stream) {
  const int blkp = round_up(V * V, 16 / sizeof(T));
  const size_t bytes = sizeof(T) * (4 * blkp + 3 * VB * VB);
  auto kernel = tridiag_factor_chain_kernel<T, VB, VX>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, 32, bytes, stream>>>(diag, off, cinv, w, n1, V, vec);
  return cudaGetLastError();
}

// C_k^{-1} into cinv (B, n1, V, V) and W_k into w (B, n1-1, V, V).
template <typename T>
int factor_chain(const T* diag, const T* off, T* cinv, T* w, int B, int n1,
                 int V, void* stream) {
  if (B <= 0 || n1 <= 0 || V <= 0 || V > kMaxV)
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = (V * V * sizeof(T)) % 16 == 0 && aligned(diag) &&
                  (n1 == 1 || aligned(off));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      V == 22  // the main path's V = nx + nu + 1 of solo12
          ? launch_chain<T, 24, 22>(diag, off, cinv, w, B, n1, V, vec, st)
          : launch_chain<T, kMaxV>(diag, off, cinv, w, B, n1, V, vec, st);
  return static_cast<int>(err);
}

// Pfwd over W in pfwd (B, n1-1, V, V), Pbwd into pbwd, from cinv.
template <typename T>
int factor_couple(const T* cinv, T* pfwd, T* pbwd, int B, int n1, int V,
                  void* stream) {
  if (B <= 0 || n1 <= 0 || V <= 0 || V > kMaxV)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n1 == 1) return static_cast<int>(cudaSuccess);  // no coupled knot
  const size_t bytes = 3 * sizeof(T) * V * (V + 1);
  tridiag_factor_couple_kernel<T><<<B * (n1 - 1), kCoupleThreads, bytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      cinv, pfwd, pbwd, n1 - 1, V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int factor(const T* diag, const T* off, T* cinv, T* pfwd, T* pbwd, int B,
           int n1, int V, void* stream) {
  const int err = factor_chain<T>(diag, off, cinv, pfwd, B, n1, V, stream);
  if (err != 0) return err;
  return factor_couple<T>(cinv, pfwd, pbwd, B, n1, V, stream);
}

template <typename T, bool REVERSE, int VB, int VX = 0>
cudaError_t launch_sweep(const T* cinv, const T* coup, const T* rhs, T* out,
                         int B, const SweepShape& sh, size_t bytes,
                         cudaStream_t stream) {
  auto kernel = REVERSE ? tridiag_bwd_kernel<T, VB, VX>
                        : tridiag_fwd_kernel<T, VB, VX>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, kSweepThreads, bytes, stream>>>(cinv, coup, rhs, out, sh);
  return cudaGetLastError();
}

template <typename T, bool REVERSE>
int sweep(const T* cinv, const T* coup, const T* rhs, T* out, int B, int n1,
          int V, void* stream) {
  if (B <= 0 || n1 <= 0 || V <= 0 || V > kMaxV)
    return static_cast<int>(cudaErrorInvalidValue);
  // The ring's share of one SM: blocks that share an SM split it.
  int dev = 0, sms = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_sm = std::min((B + sms - 1) / sms, 4);
  const size_t budget = kRingBytes / per_sm;
  const int per16 = 16 / sizeof(T);
  SweepShape sh;
  sh.n1 = n1;
  sh.V = V;
  sh.vpad = round_up(V, per16);
  sh.blk = round_up(kGroup * V * V, per16);
  const size_t stage_bytes = sizeof(T) * (2 * sh.blk + kGroup * sh.vpad);
  const int smax = static_cast<int>(
      std::clamp<size_t>(budget / stage_bytes, 2, kMaxStages));
  sh.stages = std::min(smax, (n1 + kGroup - 1) / kGroup);
  // TMA needs 16-B aligned blocks; the wrappers check the pointers
  sh.bulk = (V * V * sizeof(T)) % 16 == 0;
  const size_t bytes =
      kBarrierBytes + kScratch * sizeof(T) + sh.stages * stage_bytes;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V == 22)  // the main path's V = nx + nu + 1 of solo12
    err = launch_sweep<T, REVERSE, 24, 22>(cinv, coup, rhs, out, B, sh,
                                           bytes, st);
  else
    err = launch_sweep<T, REVERSE, kMaxV>(cinv, coup, rhs, out, B, sh, bytes,
                                          st);
  return static_cast<int>(err);
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

int cmpc_tridiag_factor_chain_f32(const float* diag, const float* off,
                                  float* cinv, float* w, int B, int n1, int V,
                                  void* stream) {
  return factor_chain<float>(diag, off, cinv, w, B, n1, V, stream);
}

int cmpc_tridiag_factor_chain_f64(const double* diag, const double* off,
                                  double* cinv, double* w, int B, int n1,
                                  int V, void* stream) {
  return factor_chain<double>(diag, off, cinv, w, B, n1, V, stream);
}

int cmpc_tridiag_factor_couple_f32(const float* cinv, float* pfwd,
                                   float* pbwd, int B, int n1, int V,
                                   void* stream) {
  return factor_couple<float>(cinv, pfwd, pbwd, B, n1, V, stream);
}

int cmpc_tridiag_factor_couple_f64(const double* cinv, double* pfwd,
                                   double* pbwd, int B, int n1, int V,
                                   void* stream) {
  return factor_couple<double>(cinv, pfwd, pbwd, B, n1, V, stream);
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
