// Backward pass of the Mamba-2 SSD intra-chunk pass for sm_90a, its
// products on TF32 tensor cores (wgmma) in the 3xTF32 split.
//
// The forward (csrc/ssd_intra_chunk.cu) replaces the Pallas TPU kernel
// `ssd_intra_chunk` in src/repro/kernels/ssd_scan.py (pallas_call at :69,
// body `_kernel` at :31-58).  That kernel has no reverse mode: the JAX
// package trains on `ref.ssd_chunked` under autograd instead.  This is its
// gradient, written from the forward's equations (the plain version is
// `ref.ssd_intra_chunk_bwd`, its arithmetic on the CPU
// `ref.ssd_intra_chunk_bwd_tf32`).  Per (batch b, chunk z), with
// W[h,i,j] = (C_i . B_j) exp(dacs[i,h] - dacs[j,h]) for j <= i and
// decay[j,h] = exp(dacs[c-1,h] - dacs[j,h]), and dy, dstates the gradients
// of y_diag and states:
//
//   dW[h,i,j] = dy_h[i] . xdt_h[j]                       (j <= i)
//   dxdt_h[j] = sum_i W[h,i,j] dy_h[i]
//               + decay[j,h] sum_nn B[j,nn] dstates_h[nn]
//   dS        = sum_h dW (.) L_h;  dC = dS B
//   dB        = dS^T C + sum_h decay_h (.) (xdt_h dstates_h^T)
//   ddacs     = rowsum(dW (.) W) - colsum(dW (.) W) - E, plus sum_j E at c-1,
//               E[j,h] = decay[j,h] xdt_h[j] . (B_j dstates_h)
//
// What bounds it on the card: at mamba2-780m's training shape (b = 2,
// T = 1024, c = n = 128, nh = 48, hd = 64) the least work is 4.95 GFLOP and
// 105.6 MB; fp32 accuracy on the tensor cores takes three TF32 products per
// product (3xTF32), so operations (14.8 GFLOP at 495 TFLOP/s) and bytes
// (at 3.35 TB/s) bound it about equally near 0.03 ms.  What the design does
// about it:
//   * every product runs on wgmma m64n64k8 in TF32 with fp32 accumulators,
//     each operand split x = big + small (ptx::split_tf32, both rounded to
//     nearest) into two shared-memory tiles, and each product is
//     small*big + big*small + big*big.  A single TF32 product keeps 10
//     mantissa bits and misses the fp32 tolerance (1e-4).  TF32 wgmma
//     takes K-major operands only (no transpose outside 16-bit types), so
//     the operands summed over their rows are transposed on their way into
//     shared memory (128-byte swizzle, 32 floats a row);
//   * four launches, one warpgroup a block for the products, 64 x 64 tiles:
//     1. scores: S^T = B C^T once per chunk, each tile stored in the
//        accumulator's own order (what a thread holds, it reads back);
//     2. one block per (group of heads, chunk, batch), the group's heads in
//        order.  Per head and key tile jt: R = decay (.) (xdt_h
//        dstates_h^T) and q = B dstates_h^T over 64-column blocks of the
//        state (one fetch of dstates_h for both layouts); then, with
//        dx = decay q in the accumulator, against each
//        query tile it >= jt: dW^T = xdt_h dy_h^T (A = xdt rows, B = dy
//        rows: both K-major as stored); W^T, G = dW (.) W and dW (.) L in
//        registers, the masked decay a select before the exp (strong decay
//        must not give inf * 0); dx += W^T dy_h with W^T from registers as
//        the A operand, its k slots in the accumulator's column order (key
//        2t to slot t, 2t+1 to slot t+4) and dy stored transposed in that
//        order.  dW (.) L and R are summed over the
//        group's heads inside the block (a block-owned partial, written by
//        the first head and added to by the others in order), so the
//        scratches shrink by the group's size (ssd_scan.py::bwd_plan
//        picks the size that fits the blocks in the fewest rounds: 3
//        heads at mamba2-780m's shape, 256 blocks of 102 KB, two an SM);
//        the state term is the product X'D' over (head, head dim),
//        X' = decay (.) xdt, D' = dstates, split by head groups;
//     3. the groups' partials of dS and R added in group order (an
//        elementwise pass over every chunk's tiles: the sums need many
//        blocks, the products of 4. few);
//     4. one block per (row tile, dC or dB, chunk, batch): dS multiplied by
//        B or C (dC = dS B, dB = dS^T C), and for dB R added;
//   * a tile's loads go out 16 a thread before the first split and store,
//     so that they are in flight together (one load of dy feeds both of its
//     layouts): the splits and the transposes run through registers, so
//     cp.async cannot fill these tiles;
//   * the tensor cores round each addition to the accumulator's magnitude,
//     so the 3xTF32 cross terms (2^-11 below big * big) go first, and each
//     tile's W^T dy goes into a fresh accumulator that is added to dx in
//     fp32 (the error against the plain version at mamba2-780m's training
//     shape, in chip_smoke.py: 9.2e-5 of the 1e-4 tolerance before, 5.0e-5
//     after);
//   * no atomics: every sum runs in a fixed order, so two calls give the
//     same bits;
//   * any chunk length c (1 .. 512) and d_state n (1 .. 256): rows, keys
//     and state columns past the edge are zeros in shared memory and are not
//     stored; head dims below 64 are zero-padded to 64.
// The version it replaces ran scalar fp32 FMAs from shared memory: 0.7208
// ms at mamba2-780m's training shape and 0.4114 ms at hymba-1.5b's on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md), with per-head scratches of
// dW (.) L and of the state term (50.3 MB each at mamba2-780m's shape).

#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int NT = 128;           // threads per block: one warpgroup
constexpr int BT = 64;            // tile edge: rows, keys, state columns
constexpr int TILE = BT * BT;     // floats of a 64 x 64 tile
constexpr int MAX_SMEM = 232448;  // opt-in shared memory per block on sm_90

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Float index of element (r, k) of a K-major tile of `rows` rows in the
// 128-byte swizzle: k in blocks of 32 floats (one 128-byte row each), block
// kb at kb * rows * 32, row r at r * 32 in it, 16-byte chunk (k / 4) % 8
// XOR r % 8.
__device__ __forceinline__ int swz(int rows, int r, int k) {
  return (k >> 5) * rows * 32 + r * 32 + ((((k >> 2) & 7) ^ (r & 7)) << 2) +
         (k & 3);
}

// The k slot of key i in a step of 8 where W^T comes from the accumulator:
// the accumulator holds keys 2t and 2t+1, the A fragment slots t and t+4.
__device__ __forceinline__ int kperm(int i) {
  return (i & ~7) | ((i & 1) << 2) | ((i & 7) >> 1);
}

// A split operand: the TF32 big and small parts of one tile.
struct Split {
  float *big, *small;
};

__device__ __forceinline__ void put(const Split& s, int idx, float x) {
  uint32_t b, sm;
  ptx::split_tf32(x, b, sm);
  s.big[idx] = __uint_as_float(b & 0xFFFFE000u);
  s.small[idx] = __uint_as_float(sm & 0xFFFFE000u);
}

// wgmma descriptor of k-step kk (8 floats of K) of the 64 rows from r0 of a
// tile of `rows` rows
__device__ __forceinline__ uint64_t kdesc(const float* tile, int rows,
                                          int r0, int kk) {
  return ptx::desc_b128(tile + (kk >> 2) * rows * 32 + r0 * 32 + (kk & 3) * 8,
                        1, 64);
}

// Keeps the compiler from moving accesses to an accumulator across this
// point (placed around each wgmma pipeline: ptxas serialises wgmma whose
// accumulators other instructions touch while it runs).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B^T over NK k-steps in 3xTF32: A the 64 rows from a_r0 of `a`, B
// the 64 rows from b_r0 of `b`.  The cross terms of every k-step go first,
// while the accumulator is small: the tensor cores round each addition to
// the accumulator's magnitude, and the terms 2^-11 below it lose bits once
// big * big is in.  The caller fences, commits and waits.
template <int NK>
__device__ __forceinline__ void mma3(float (&d)[32], const Split& a,
                                     int a_rows, int a_r0, const Split& b,
                                     int b_rows, int b_r0) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    ptx::wgmma_tf32_ss(d, kdesc(a.small, a_rows, a_r0, kk),
                       kdesc(b.big, b_rows, b_r0, kk), 1);
    ptx::wgmma_tf32_ss(d, kdesc(a.big, a_rows, a_r0, kk),
                       kdesc(b.small, b_rows, b_r0, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    ptx::wgmma_tf32_ss(d, kdesc(a.big, a_rows, a_r0, kk),
                       kdesc(b.big, b_rows, b_r0, kk), 1);
}

constexpr float LOG2E = 1.4426950408889634f;

// exp(x) on the special-function unit, without a branch (relative error
// about 2^-22; 0 for very negative x)
__device__ __forceinline__ float exp_sfu(float x) {
  return ptx::exp2_approx(x * LOG2E);
}

// A thread's loads of a tile go out in batches of BATCH, all before the
// batch's first split and store, so that they are in flight together
// (neighbouring threads read neighbouring addresses).  A 64 x 64 tile is 32
// values a thread; batches of 16 by default, since 32 (a tile at once) made
// the head kernel spill; the scores kernel, with registers to spare, takes
// a tile at once.

// ROWS x COLS of a row-major fp32 matrix (row stride ld) into split
// K-major tiles: with ROWS_OUT, element (r, c) to (r, c) of `rows` (a tile
// of ROWS rows); with COLS_OUT, to (c, PERM ? kperm(r) : r) of `cols` (a
// tile of COLS rows: transposed).  Past nrows or ncols: 0.
template <int ROWS, int COLS, bool ROWS_OUT, bool COLS_OUT, bool PERM,
          int BATCH = 16>
__device__ __forceinline__ void load(const Split& rows, const Split& cols,
                                     const float* __restrict__ src,
                                     long long ld, int nrows, int ncols) {
  static_assert(ROWS * COLS % (NT * BATCH) == 0, "whole batches");
#pragma unroll 1
  for (int e0 = 0; e0 < ROWS * COLS; e0 += NT * BATCH) {
    float x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + threadIdx.x + u * NT, r = e / COLS, c = e % COLS;
      x[u] = r < nrows && c < ncols ? __ldg(src + r * ld + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + threadIdx.x + u * NT, r = e / COLS, c = e % COLS;
      if (ROWS_OUT) put(rows, swz(ROWS, r, c), x[u]);
      if (COLS_OUT) put(cols, swz(COLS, c, PERM ? kperm(r) : r), x[u]);
    }
  }
}
template <int ROWS, int COLS, int BATCH = 16>
__device__ __forceinline__ void load_rows(const Split& dst,
                                          const float* __restrict__ src,
                                          long long ld, int nrows,
                                          int ncols) {
  load<ROWS, COLS, true, false, false, BATCH>(dst, dst, src, ld, nrows,
                                              ncols);
}
template <int ROWS, int COLS>
__device__ __forceinline__ void load_cols(const Split& dst,
                                          const float* __restrict__ src,
                                          long long ld, int nrows,
                                          int ncols) {
  load<ROWS, COLS, false, true, false>(dst, dst, src, ld, nrows, ncols);
}

// s[4jj + q] of a thread's accumulator is tile element (row0 + 8 (q >> 1),
// 8jj + 2t + (q & 1)); tiles kept between launches are stored in this
// order, element e of thread tid at e * NT + tid.
__device__ __forceinline__ int acc_row(int e) {
  const int lane = threadIdx.x & 31;
  return (threadIdx.x >> 5) * 16 + (lane >> 2) + 8 * ((e & 3) >> 1);
}
__device__ __forceinline__ int acc_col(int e) {
  return 8 * (e >> 2) + 2 * (threadIdx.x & 3) + (e & 1);
}

// 1. S^T (jt, it) = B_jt C_it^T for every pair jt <= it of each chunk.
// grid (pairs, nc, b); pair p = it (it + 1) / 2 + jt.
__global__ void __launch_bounds__(NT)
ssd_bwd_scores(const float* __restrict__ Bm, const float* __restrict__ Cm,
               float* __restrict__ S, int nc, int c_len, int n) {
  extern __shared__ float smem_raw[];
  float* sm = smem_raw + (((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023)
                          >> 2);
  const Split sb{sm, sm + TILE}, sc{sm + 2 * TILE, sm + 3 * TILE};
  const int p = blockIdx.x;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= p) ++it;
  const int jt = p - it * (it + 1) / 2;
  const long long chunk = (long long)blockIdx.z * nc + blockIdx.y;
  const long long rows = chunk * c_len;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int n0 = 0; n0 < n; n0 += BT) {
    __syncthreads();  // the last chunk's tiles are read
    load_rows<BT, BT, 32>(sb, Bm + (rows + jt * BT) * n + n0, n,
                          c_len - jt * BT, n - n0);
    load_rows<BT, BT, 32>(sc, Cm + (rows + it * BT) * n + n0, n,
                          c_len - it * BT, n - n0);
    ptx::fence_proxy_async();
    __syncthreads();
    fence_acc(acc);
    ptx::wgmma_fence();
    mma3<BT / 8>(acc, sb, BT, 0, sc, BT, 0);
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();
    fence_acc(acc);
  }
  float* out = S + (chunk * gridDim.x + p) * TILE;
#pragma unroll
  for (int e = 0; e < 32; ++e) out[e * NT + threadIdx.x] = acc[e];
}

template <int HD>
struct HeadCfg {
  static constexpr int HDP = HD < BT ? BT : HD;  // head columns, padded
  static constexpr int NB = HDP / BT;            // 64-column blocks of them
  // xdt_h (big, small) and a region that holds, by phase, dy_h twice (as
  // stored and transposed), or dstates_h twice (as stored, where B follows,
  // and transposed)
  static constexpr int REGION = 4 * BT * HDP;
};

template <int HD>
__host__ __device__ size_t head_floats(int c_len) {
  return 2 * size_t(BT) * HeadCfg<HD>::HDP + HeadCfg<HD>::REGION +
         3 * size_t(cdiv(c_len, BT) * BT) + 4 * BT + 1 + 256;
}

// 2. one group of heads of one chunk.  grid (groups, nc, b).
template <int HD>
__global__ void __launch_bounds__(NT)
ssd_bwd_head(const float* __restrict__ xdt, const float* __restrict__ dacs,
             const float* __restrict__ Bm, const float* __restrict__ dy,
             const float* __restrict__ dstates, const float* __restrict__ S,
             float* __restrict__ dsp, float* __restrict__ rp,
             float* __restrict__ dxdt, float* __restrict__ ddacs, int nc,
             int c_len, int nh, int n, int gh) {
  using Cfg = HeadCfg<HD>;
  constexpr int HDP = Cfg::HDP, NB = Cfg::NB;
  extern __shared__ float smem_raw[];
  float* sm = smem_raw + (((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023)
                          >> 2);
  const Split xa{sm, sm + BT * HDP};  // xdt_h, rows j, K = head columns
  float* region = sm + 2 * BT * HDP;
  const Split yb{region, region + BT * HDP};  // dy_h, rows i, K = head cols
  const Split yt{region + 2 * BT * HDP, region + 3 * BT * HDP};  // rows p
  const Split dn{region, region + BT * HDP};  // dstates_h, rows nn, K = p
  const Split ba{region, region + TILE};      // B (after dn), rows j, K = nn
  const Split dt{region + 2 * BT * HDP, region + 3 * BT * HDP};  // rows p
  const int nt = cdiv(c_len, BT), cpad = nt * BT;
  float* da = region + Cfg::REGION;  // dacs of head h
  float* dd = da + cpad;             // rowsum(G) - colsum(G)
  float* es = dd + cpad;             // E
  float* colp = es + cpad;           // G's column sums, one row a warp
  float* esum = colp + 4 * BT;       // sum_j E[j]

  const int grp = blockIdx.x, ngroups = gridDim.x;
  const long long chunk = (long long)blockIdx.z * nc + blockIdx.y;
  const long long rows = chunk * c_len;
  const long long ld = (long long)nh * HD;
  const int npairs = nt * (nt + 1) / 2, ncol = cdiv(n, BT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h0 = grp * gh, h1 = min(h0 + gh, nh);

  for (int h = h0; h < h1; ++h) {
    const bool first = h == h0;  // the group's partials start here
    const float* xh = xdt + rows * ld + h * HD;
    const float* yh = dy + rows * ld + h * HD;
    const float* dsh = dstates + (chunk * nh + h) * (long long)n * HD;
    __syncthreads();  // the last head's arrays are read
    for (int j = tid; j < cpad; j += NT) {
      da[j] = j < c_len ? __ldg(dacs + (rows + j) * nh + h) : 0.f;
      dd[j] = es[j] = 0.f;
    }
    __syncthreads();
    const float last = da[c_len - 1];

    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * BT;
      __syncthreads();  // xa and the region are free
      load_rows<BT, HDP>(xa, xh + j0 * ld, ld, c_len - j0, HD);
      // q = B dstates_h^T and R = decay (.) (xdt_h dstates_h^T) over the
      // 64-column blocks of the state
      float dx[NB][32];  // q first, then dxdt_h
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 32; ++e) dx[nb][e] = 0.f;
      for (int ct = 0; ct < ncol; ++ct) {
        const int n0 = ct * BT;
        // dstates_h's rows nn, one fetch: as stored for R and transposed
        // for q
        load<BT, HDP, true, true, false>(dn, dt, dsh + (long long)n0 * HD,
                                         HD, n - n0, HD);
        ptx::fence_proxy_async();
        __syncthreads();
        float ra[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) ra[e] = 0.f;
        fence_acc(ra);
        ptx::wgmma_fence();
        mma3<HDP / 8>(ra, xa, BT, 0, dn, BT, 0);
        ptx::wgmma_commit();
        // while the product runs: the group's partial so far
        float* rt = rp + (((chunk * ngroups + grp) * nt + jt) * ncol + ct) *
                             TILE;
        float old[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) old[e] = first ? 0.f : rt[e * NT + tid];
        ptx::wgmma_wait<0>();
        fence_acc(ra);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int j = j0 + acc_row(e);
          const float v = j < c_len ? ra[e] * exp_sfu(last - da[j]) : 0.f;
          rt[e * NT + tid] = old[e] + v;
        }
        __syncthreads();  // dn is read: B's rows j take its place
        load_rows<BT, BT>(ba, Bm + (rows + j0) * n + n0, n, c_len - j0,
                          n - n0);
        ptx::fence_proxy_async();
        __syncthreads();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) fence_acc(dx[nb]);
        ptx::wgmma_fence();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mma3<BT / 8>(dx[nb], ba, BT, 0, dt, HDP, nb * BT);
        ptx::wgmma_commit();
        ptx::wgmma_wait<0>();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) fence_acc(dx[nb]);
        __syncthreads();  // the region is rewritten next
      }

      // E = decay xdt_h . q over the head columns; then dx = decay q, to
      // which the products below add W^T dy_h (rows past the chunk hold
      // zeros: their dy, B and dstates rows were zero-filled)
      float ep[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = min(j0 + acc_row(2 * r), c_len - 1);
        const bool row_ok = j0 + acc_row(2 * r) < c_len;
        const float dec = exp_sfu(last - da[j]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int e = 4 * jj + 2 * r, p = nb * BT + acc_col(e);
            if (row_ok && p < HD) {
              const float2 x = *reinterpret_cast<const float2*>(
                  xh + j * ld + p);
              ep[r] += x.x * dx[nb][e] + x.y * dx[nb][e + 1];
            }
            dx[nb][e] *= dec;
            dx[nb][e + 1] *= dec;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ep[r] += __shfl_xor_sync(0xffffffffu, ep[r], 1);
        ep[r] += __shfl_xor_sync(0xffffffffu, ep[r], 2);
        const int j = j0 + acc_row(2 * r);
        if ((lane & 3) == 0 && j < c_len) es[j] = exp_sfu(last - da[j]) * ep[r];
      }

      // dx += W^T dy_h over the query tiles it >= jt
      for (int it = jt; it < nt; ++it) {
        const int i0 = it * BT, pair = it * (it + 1) / 2 + jt;
        // dy_h's rows i, as stored for dW^T and transposed for dx
        load<BT, HDP, true, true, true>(yb, yt, yh + i0 * ld, ld, c_len - i0,
                                        HD);
        ptx::fence_proxy_async();
        __syncthreads();
        // dW^T = xdt_h dy_h^T: rows j, columns i
        float s[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = 0.f;
        fence_acc(s);
        ptx::wgmma_fence();
        mma3<HDP / 8>(s, xa, BT, 0, yb, BT, 0);
        ptx::wgmma_commit();
        // while the product runs (where the registers allow): the scores
        // and the group's partial so far
        const float* st = S + (chunk * npairs + pair) * TILE;
        float* dp = dsp + ((chunk * ngroups + grp) * npairs + pair) * TILE;
        float sv[32], pv[32];
        if constexpr (NB == 1) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            sv[e] = st[e * NT + tid];
            pv[e] = first ? 0.f : dp[e * NT + tid];
          }
        }
        ptx::wgmma_wait<0>();
        fence_acc(s);

        float rs[2] = {0.f, 0.f}, cs[16];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = 4 * jj + q;
            const int j = j0 + acc_row(e), i = i0 + acc_col(e);
            // select before the exp: for j > i it may overflow
            const float l = j <= i && i < c_len ? exp_sfu(da[i] - da[j]) : 0.f;
            const float sc = NB == 1 ? sv[e] : st[e * NT + tid];
            const float old = NB == 1 ? pv[e] : first ? 0.f : dp[e * NT + tid];
            const float w = sc * l;
            const float gv = s[e] * w, dl = s[e] * l;
            dp[e * NT + tid] = old + dl;
            rs[q >> 1] += gv;
            if (q < 2) cs[2 * jj + q] = gv;
            else cs[2 * jj + (q & 1)] += gv;
            s[e] = w;
          }
        }
        // W^T dy_h into a fresh accumulator, added to dx in fp32 (dx,
        // from decay q on, is large against one tile's terms); dy is
        // transposed in the slots' order; in two halves of the query keys
        // (16 A registers each, split), the cross terms first
        float part[NB][32];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 32; ++e) part[nb][e] = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t ab[4][4], as[4][4];
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const int jj = 4 * half + k4;
            // slots (g, t), (g+8, t), (g, t+4), (g+8, t+4) take keys
            // (g, 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1)
            ptx::split_tf32(s[4 * jj], ab[k4][0], as[k4][0]);
            ptx::split_tf32(s[4 * jj + 2], ab[k4][1], as[k4][1]);
            ptx::split_tf32(s[4 * jj + 1], ab[k4][2], as[k4][2]);
            ptx::split_tf32(s[4 * jj + 3], ab[k4][3], as[k4][3]);
          }
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) fence_acc(part[nb]);
          ptx::wgmma_fence();
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
            for (int k4 = 0; k4 < 4; ++k4) {
              const int jj = 4 * half + k4;
              ptx::wgmma_tf32_rs(part[nb], as[k4],
                                 kdesc(yt.big, HDP, nb * BT, jj), 1);
              ptx::wgmma_tf32_rs(part[nb], ab[k4],
                                 kdesc(yt.small, HDP, nb * BT, jj), 1);
            }
#pragma unroll
            for (int k4 = 0; k4 < 4; ++k4)
              ptx::wgmma_tf32_rs(part[nb], ab[k4],
                                 kdesc(yt.big, HDP, nb * BT, 4 * half + k4),
                                 1);
          }
          ptx::wgmma_commit();
          ptx::wgmma_wait<0>();
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) fence_acc(part[nb]);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 32; ++e) dx[nb][e] += part[nb][e];
        // G's sums: rows (keys j, -) over the 4 lanes of a row, columns
        // (queries i, +) over the 8 rows of a warp
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
          const int j = j0 + acc_row(2 * r);
          if ((lane & 3) == 0 && j < c_len) dd[j] -= rs[r];
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], 4);
          cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], 8);
          cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], 16);
          if (lane < 4) colp[warp * BT + acc_col(2 * (u >> 1) * 2 + (u & 1))] =
              cs[u];
        }
        __syncthreads();  // colp and the rows' updates are in
        if (tid < BT && i0 + tid < c_len)
          dd[i0 + tid] += ((colp[tid] + colp[BT + tid]) + colp[2 * BT + tid]) +
                          colp[3 * BT + tid];
        __syncthreads();  // the region is rewritten next
      }

      // dxdt_h = decay q + sum_i W^T dy_h
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + acc_row(2 * r);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int e = 4 * jj + 2 * r, p = nb * BT + acc_col(e);
            if (j < c_len && p < HD)
              *reinterpret_cast<float2*>(dxdt + (rows + j) * ld + h * HD +
                                         p) =
                  make_float2(dx[nb][e], dx[nb][e + 1]);
          }
      }
    }
    __syncthreads();
    // sum_j E[j] in a fixed order: lane l sums l, l + 32, ..., then a tree
    if (tid < 32) {
      float sum = 0.f;
      for (int j = tid; j < c_len; j += 32) sum += es[j];
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (tid == 0) *esum = sum;
    }
    __syncthreads();
    for (int i = tid; i < c_len; i += NT)
      ddacs[(rows + i) * nh + h] =
          dd[i] - es[i] + (i == c_len - 1 ? *esum : 0.f);
  }
}

// 3. the groups' partials of dS and R added in group order, into group 0's
// tiles; four floats a thread, over every chunk's tiles (ds_per and r_per
// floats a group).
__global__ void __launch_bounds__(256)
ssd_bwd_sum(float* __restrict__ dsp, float* __restrict__ rp,
            long long ds_per, long long r_per, int ngroups, long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const long long per4 = (ds_per + r_per) / 4;
  const long long chunk = i / per4, off = (i % per4) * 4;
  const bool is_ds = off < ds_per;
  const long long per = is_ds ? ds_per : r_per;
  float4* base = reinterpret_cast<float4*>(
      (is_ds ? dsp : rp) + chunk * ngroups * per +
      (is_ds ? off : off - ds_per));
  const long long step = per / 4;
  float4 v = base[0];
#pragma unroll 4
  for (int g = 1; g < ngroups; ++g) {
    const float4 x = base[g * step];
    v.x += x.x;
    v.y += x.y;
    v.z += x.z;
    v.w += x.w;
  }
  base[0] = v;
}

// 4. grid (2 nt, nc, b): blocks x < nt take dC rows x BT .., the rest dB
// rows; each takes dS, summed over the groups, into its A tile one k tile
// at a time, and multiplies it by B (dC = dS B) or C (dB = dS^T C) over
// NCOL 64-column blocks of the state; dB adds R, summed over the groups.
template <int NCOL>
__global__ void __launch_bounds__(NT)
ssd_bwd_reduce(const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ dsp, const float* __restrict__ rp,
               float* __restrict__ dB, float* __restrict__ dC, int nc,
               int c_len, int n, int ngroups) {
  extern __shared__ float smem_raw[];
  float* sm = smem_raw + (((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023)
                          >> 2);
  const Split sa{sm, sm + TILE}, sb{sm + 2 * TILE, sm + 3 * TILE};
  const int nt = cdiv(c_len, BT), npairs = nt * (nt + 1) / 2;
  const int ncol = cdiv(n, BT);
  const bool for_b = blockIdx.x >= nt;
  const int rt = blockIdx.x % nt, r0 = rt * BT;
  const long long chunk = (long long)blockIdx.z * nc + blockIdx.y;
  const long long rows = chunk * c_len;
  const float* M = (for_b ? Cm : Bm) + rows * n;
  const int tid = threadIdx.x;
  float acc[NCOL][32];
#pragma unroll
  for (int ct = 0; ct < NCOL; ++ct)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[ct][e] = 0.f;

  // dC[i] = sum_{j <= i} dS[i, j] B[j]: k tiles jt = 0 .. rt;
  // dB[j] = sum_{i >= j} dS[i, j] C[i]: k tiles it = rt .. nt - 1
  const int lo = for_b ? rt : 0, hi = for_b ? nt : rt + 1;
  for (int ot = lo; ot < hi; ++ot) {
    const int pair = for_b ? ot * (ot + 1) / 2 + rt : rt * (rt + 1) / 2 + ot;
    // the summed tiles (group 0's) hold dS^T: rows j, columns i
    const float* dst = dsp + (chunk * ngroups * npairs + pair) * TILE;
    // in two halves of 16 values a thread, so that NCOL = 4 accumulators
    // fit beside them
#pragma unroll
    for (int e0 = 0; e0 < 32; e0 += 16) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = dst[(e0 + u) * NT + tid];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int jl = acc_row(e0 + u), il = acc_col(e0 + u);
        put(sa, for_b ? swz(BT, jl, il) : swz(BT, il, jl), v[u]);
      }
    }
#pragma unroll
    for (int ct = 0; ct < NCOL; ++ct) {
      if (ct >= ncol) break;
      const int n0 = ct * BT;
      // rows of B or C, the k of the product, transposed
      load_cols<BT, BT>(sb, M + (long long)ot * BT * n + n0, n,
                        c_len - ot * BT, n - n0);
      ptx::fence_proxy_async();
      __syncthreads();
      fence_acc(acc[ct]);
      ptx::wgmma_fence();
      mma3<BT / 8>(acc[ct], sa, BT, 0, sb, BT, 0);
      ptx::wgmma_commit();
      ptx::wgmma_wait<0>();
      fence_acc(acc[ct]);
      __syncthreads();  // sb (and after the last, sa) is rewritten next
    }
  }
  float* out = (for_b ? dB : dC) + rows * n;
#pragma unroll
  for (int ct = 0; ct < NCOL; ++ct) {
    if (ct >= ncol) break;
    if (for_b) {
      const float* r = rp + ((chunk * ngroups * nt + rt) * ncol + ct) * TILE;
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[ct][e] += r[e * NT + tid];
    }
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int row = r0 + acc_row(e), col = ct * BT + acc_col(e);
      if (row >= c_len) continue;
      if (col < n) out[(long long)row * n + col] = acc[ct][e];
      if (col + 1 < n) out[(long long)row * n + col + 1] = acc[ct][e + 1];
    }
  }
}

// Lift the 48 KB default, and ask for the largest shared-memory carveout
// so that two head blocks (102 KB each at mamba2-780m's widths) share an SM.
template <typename K>
int allow_smem(K kernel) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return int(err);
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      int(cudaSharedmemCarveoutMaxShared)));
}

struct Args {
  const float *xdt, *dacs, *B, *C, *dy, *dstates;
  float *dxdt, *ddacs, *dB, *dC, *S, *dsp, *rp;
  int b, nc, c_len, nh, n, gh;
  cudaStream_t stream;
};

constexpr size_t TILE_SMEM = 4 * TILE * sizeof(float) + 1024;

template <int HD>
int launch_head(const Args& a) {
  static const int attr = allow_smem(ssd_bwd_head<HD>);
  if (attr != 0) return attr;
  const size_t bytes = head_floats<HD>(a.c_len) * sizeof(float);
  if (bytes > size_t(MAX_SMEM)) return int(cudaErrorInvalidValue);
  ssd_bwd_head<HD><<<dim3(cdiv(a.nh, a.gh), a.nc, a.b), NT, bytes,
                     a.stream>>>(a.xdt, a.dacs, a.B, a.dy, a.dstates, a.S,
                                 a.dsp, a.rp, a.dxdt, a.ddacs, a.nc, a.c_len,
                                 a.nh, a.n, a.gh);
  return int(cudaGetLastError());
}

template <int NCOL>
int launch_reduce(const Args& a) {
  static const int attr = allow_smem(ssd_bwd_reduce<NCOL>);
  if (attr != 0) return attr;
  ssd_bwd_reduce<NCOL><<<dim3(2 * cdiv(a.c_len, BT), a.nc, a.b), NT,
                         TILE_SMEM, a.stream>>>(
      a.B, a.C, a.dsp, a.rp, a.dB, a.dC, a.nc, a.c_len, a.n,
      cdiv(a.nh, a.gh));
  return int(cudaGetLastError());
}

}  // namespace

// All tensors fp32 and dense: xdt, dy, dxdt (b,nc,c,nh*hd); dacs, ddacs
// (b,nc,c,nh); B, C, dB, dC (b,nc,c,n); dstates (b,nc,nh,n,hd).  Scratch,
// with nt = ceil(c / 64), pairs = nt (nt + 1) / 2, groups = ceil(nh /
// heads_per_group), ncol = ceil(n / 64), in 64 x 64 tiles: scores (b, nc,
// pairs), dS partials (b, nc, groups, pairs), R partials (b, nc, groups,
// nt, ncol) (ssd_scan.py::bwd_plan).  hd is one of 8, 16, 32, 64, 128; c at
// most 512, n at most 256.  Four launches (three with one group); returns
// cudaGetLastError() after the last, or the first error.
extern "C" int ssd_intra_chunk_bwd(int hd, const void* xdt, const void* dacs,
                                   const void* B, const void* C,
                                   const void* dy, const void* dstates,
                                   void* dxdt, void* ddacs, void* dB,
                                   void* dC, void* scores, void* dsp,
                                   void* rp, int b, int nc, int c_len, int nh,
                                   int n, int heads_per_group, void* stream) {
  if (b <= 0 || nc <= 0 || c_len <= 0 || nh <= 0 || n <= 0 || nc > 65535 ||
      b > 65535 || c_len > 512 || n > 256 || heads_per_group <= 0)
    return int(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(xdt), static_cast<const float*>(dacs),
         static_cast<const float*>(B),   static_cast<const float*>(C),
         static_cast<const float*>(dy),  static_cast<const float*>(dstates),
         static_cast<float*>(dxdt),      static_cast<float*>(ddacs),
         static_cast<float*>(dB),        static_cast<float*>(dC),
         static_cast<float*>(scores),    static_cast<float*>(dsp),
         static_cast<float*>(rp),
         b, nc, c_len, nh, n, heads_per_group,
         static_cast<cudaStream_t>(stream)};
  static const int attr = allow_smem(ssd_bwd_scores);
  if (attr != 0) return attr;
  const int nt = cdiv(c_len, BT);
  ssd_bwd_scores<<<dim3(nt * (nt + 1) / 2, nc, b), NT, TILE_SMEM,
                   a.stream>>>(a.B, a.C, a.S, nc, c_len, n);
  int err = int(cudaGetLastError());
  if (err != 0) return err;
  switch (hd) {
    case 8: err = launch_head<8>(a); break;
    case 16: err = launch_head<16>(a); break;
    case 32: err = launch_head<32>(a); break;
    case 64: err = launch_head<64>(a); break;
    case 128: err = launch_head<128>(a); break;
    default: return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int groups = cdiv(nh, heads_per_group);
  if (groups > 1) {
    const long long ds_per = (long long)nt * (nt + 1) / 2 * TILE;
    const long long r_per = (long long)nt * cdiv(n, BT) * TILE;
    const long long n4 = (long long)b * nc * (ds_per + r_per) / 4;
    ssd_bwd_sum<<<unsigned((n4 + 255) / 256), 256, 0, a.stream>>>(
        a.dsp, a.rp, ds_per, r_per, groups, n4);
    err = int(cudaGetLastError());
    if (err != 0) return err;
  }
  if (n <= 64) return launch_reduce<1>(a);
  if (n <= 128) return launch_reduce<2>(a);
  return launch_reduce<4>(a);
}
