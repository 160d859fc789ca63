// Mamba-2 SSD intra-chunk pass for sm_90a, its three products on TF32
// tensor cores in the 3xTF32 split.
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk` in
// src/repro/kernels/ssd_scan.py (pallas_call at :69, body `_kernel` at
// :31-58).  Per (batch b, chunk z), on fp32 inputs xdt (b,nc,c,nh*hd), dacs
// (b,nc,c,nh) (within-chunk cumsum of the log-decay) and B/C (b,nc,c,n):
//
//   scores[i,j]     = C_i . B_j
//   y_diag[i,h,p]   = sum_{j<=i} scores[i,j] exp(dacs[i,h] - dacs[j,h]) xdt[j,h,p]
//   states[h,nn,p]  = sum_j exp(dacs[c-1,h] - dacs[j,h]) B[j,nn] xdt[j,h,p]
//
// with y_diag laid out as xdt and states as (b,nc,nh,n,hd), both fp32.
//
// What bounds it on the card: at mamba2's 512-token prefill (c = n = 128,
// nh = 48, hd = 64) the pass reads and writes 19.5 MB (5.8 us at 3.35 TB/s)
// and does 0.62 GFLOP, 1.87 GFLOP of TF32 products after the split (3.8 us
// at 495 TFLOP/s): bytes bound the function.  This kernel is bound by its
// own instruction issue instead (PERF.md): each mma comes with about seven
// other instructions (fragment loads, operand splits, the decay), and the
// y blocks recompute the scores for every head.  What the design does about the
// limits of the CUDA-core version it replaces:
//   * All three products run on mma.sync m16n8k8 TF32.  A plain TF32
//     product keeps 10 mantissa bits and misses the fp32 tolerance (1e-4)
//     at serving widths, so every operand is split, x = big + small with
//     big = tf32(x) and small = tf32(x - big), both rounded to nearest
//     (cvt.rna), and each product is small*big + big*small + big*big
//     (ptx::split_tf32, ptx::mma_3xtf32).
//   * The masked, decayed score tile is built in registers, straight into
//     the A fragment: the scores' mma accumulator holds (row g, keys 2t and
//     2t+1), and the second product takes key 2t to its k slot t and key
//     2t+1 to slot t+4.  Any k order gives the same sum as long as both
//     operands agree, so the accumulator is the A fragment as it stands and
//     the B fragment reads xdt rows 2t and 2t+1.  The state product takes
//     the same key order.
//   * The causal mask is a select on exp(dacs_i - dacs_j) before it meets
//     the score: for j > i the exp may overflow, and inf * 0 would be NaN.
//   * dacs is staged in shared memory once per block (y blocks: the head's
//     column; state blocks: the decay to the chunk's end, exp'd once), and
//     each thread keeps its own rows' dacs[i,h] in registers.
//   * Key tiles of B, C and xdt are copied with cp.async into a two-stage
//     ring, so the next tile is in flight while this one is multiplied.
//     Rows are padded by 4 floats, which makes every fragment read
//     conflict-free (rows 2t, 2t+1 land 8 banks apart; rows g, 4 apart).
//   * Grid (tasks, nc, b) with two kinds of block, 8 warps each.  Warp
//     (rg, kh) takes 16 output rows (row group rg of 4) and the 16 keys of
//     half kh of every 32-key tile; the two halves' sums meet in shared
//     memory at the end:
//       - y blocks: BM = 64 query rows of one head, the scores of each key
//         tile computed on the tensor cores by the warp that uses them;
//       - state blocks: one head x 64 state rows nn.
//     At mamba2 widths a 128-token chunk has 96 + 96 = 192 blocks, at
//     hymba's (nh = 50, n = 16) 100 + 50; y blocks come first, the heaviest
//     row tiles first.  At n = 128, hd = 64 a block takes 84 KB of shared
//     memory and 128 registers a thread, so two fit on an SM.
//   * Any chunk length c (1 .. MAX_CHUNK) and d_state n (1 .. MAX_STATE):
//     rows, keys and state rows past the edge are zeros in shared memory
//     (n is padded to a multiple of 8 for the k steps) and are not stored.

#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int NT = 256;           // threads per block (8 warps)
constexpr int BM = 64;            // output rows per block, 16 per row group
constexpr int BJ = 32;            // key positions per tile
constexpr int LDS = BM + 4;       // row stride of a state block's B tile
constexpr int MAX_SMEM = 232448;  // opt-in shared memory per block on sm_90

template <int HD>
struct Cfg {
  static constexpr int LDX = HD + 4;            // row stride of xdt tiles
  static constexpr int NP = HD / 8;             // mma n tiles across hd
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of each kind of block, in floats.
template <int HD>
__host__ __device__ size_t y_floats(int c_len, int n) {
  const int ldb = round_up(n, 8) + 4;
  return size_t(BM + 2 * BJ) * ldb + size_t(2 * BJ) * Cfg<HD>::LDX +
         round_up(c_len, BM);
}
template <int HD>
__host__ __device__ size_t state_floats(int c_len) {
  return size_t(2 * BJ) * LDS + size_t(2 * BJ) * Cfg<HD>::LDX +
         round_up(c_len, BM);
}

// Copy rows x cols floats from src (row stride lds) to dst (row stride ldd)
// with cp.async; rows >= nrows and columns >= ncols are zero-filled.  A warp
// takes a row at a time, its lanes the row's pieces: 16 bytes with vec
// (cols, ncols, lds and the start are multiples of 4 floats), else 4.
__device__ __forceinline__ void copy_tile(float* dst, int ldd,
                                          const float* __restrict__ src,
                                          long long lds, int rows, int cols,
                                          int nrows, int ncols, bool vec) {
  const int lane = threadIdx.x & 31;
  const int w = vec ? 4 : 1;             // floats per piece
  for (int r = threadIdx.x >> 5; r < rows; r += NT / 32)
    for (int q = lane * w; q < cols; q += 32 * w) {
      const bool ok = r < nrows && q < ncols;
      const float* from = ok ? src + r * lds + q : src;
      if (vec)
        ptx::cp_async16(dst + r * ldd + q, from, ok);
      else
        ptx::cp_async4(dst + r * ldd + q, from, ok);
    }
}

// acc[np] += A . X over one 8-key step: the A fragment split in (a_big,
// a_small), X the xdt tile (row stride LDX) at the step's first key, whose
// rows 2t and 2t+1 are the keys of k slots t and t+4.
template <int HD>
__device__ __forceinline__ void times_x(float (&acc)[Cfg<HD>::NP][4],
                                        const uint32_t (&a_big)[4],
                                        const uint32_t (&a_small)[4],
                                        const float* X) {
  constexpr int LDX = Cfg<HD>::LDX;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* x = X + 2 * t * LDX + g;
#pragma unroll
  for (int np = 0; np < Cfg<HD>::NP; ++np) {
    uint32_t b_big[2], b_small[2];
    ptx::split_tf32(x[8 * np], b_big[0], b_small[0]);
    ptx::split_tf32(x[LDX + 8 * np], b_big[1], b_small[1]);
    ptx::mma_3xtf32(acc[np], a_big, a_small, b_big, b_small);
  }
}

// Rows r and r + 8 of a warp's (16 x hd) accumulator to out (row stride
// ld), each where it is below `rows`.
template <int HD>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           long long ld, int r, int rows,
                                           const float (&acc)[Cfg<HD>::NP][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int np = 0; np < Cfg<HD>::NP; ++np) {
    if (r < rows)
      *reinterpret_cast<float2*>(out + r * ld + 8 * np + 2 * t) =
          make_float2(acc[np][0], acc[np][1]);
    if (r + 8 < rows)
      *reinterpret_cast<float2*>(out + (r + 8) * ld + 8 * np + 2 * t) =
          make_float2(acc[np][2], acc[np][3]);
  }
}

// The two key halves' partial sums of a row group's (16 x hd) tile meet in
// red, one float4 per lane and n tile: warps of key half 1 write theirs,
// key half 0 adds them.  Called by every thread after the key loop's last
// barrier (red overlays the tile ring).
template <int HD>
__device__ __forceinline__ void merge_halves(float* red, int rg, int kh,
                                             float (&acc)[Cfg<HD>::NP][4]) {
  constexpr int NP = Cfg<HD>::NP;
  float4* r = reinterpret_cast<float4*>(red) + rg * NP * 32 +
              (threadIdx.x & 31);
  if (kh == 1) {
#pragma unroll
    for (int np = 0; np < NP; ++np)
      r[np * 32] = make_float4(acc[np][0], acc[np][1], acc[np][2],
                               acc[np][3]);
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      const float4 v = r[np * 32];
      acc[np][0] += v.x;
      acc[np][1] += v.y;
      acc[np][2] += v.z;
      acc[np][3] += v.w;
    }
  }
}

// y block: rows i0 .. i0+BM-1 of the chunk, head h.  Warp (rg, kh) takes
// rows 16 rg .. 16 rg + 15 and keys 16 kh .. 16 kh + 15 of every tile
// (8-key groups kk = 2 kh, 2 kh + 1).
template <int HD>
__device__ void y_block(float* smem, const float* __restrict__ xdt,
                        const float* __restrict__ dacs,
                        const float* __restrict__ B,
                        const float* __restrict__ C, float* __restrict__ y,
                        int i0, int h, int c_len, int nh, int n) {
  constexpr int LDX = Cfg<HD>::LDX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, rg = warp & 3, kh = warp >> 2;
  const int n8 = round_up(n, 8), ldb = n8 + 4;
  float* cs = smem;                      // BM x ldb       C rows
  float* bs = cs + BM * ldb;             // 2 x BJ x ldb   B tiles
  float* xs = bs + 2 * BJ * ldb;         // 2 x BJ x LDX   xdt tiles of head h
  float* ds = xs + 2 * BJ * LDX;         // dacs of head h
  const int jend = min(i0 + BM, c_len);  // causal: j <= i < i0 + BM
  const int ntiles = (jend + BJ - 1) / BJ;
  const bool vec = n % 4 == 0;
  const long long ld = (long long)nh * HD;

  // dacs of head h for positions 0 .. i0+BM-1 (0 past c_len)
  for (int j = threadIdx.x; j < i0 + BM; j += NT)
    ds[j] = j < c_len ? __ldg(dacs + (long long)j * nh + h) : 0.f;
  auto issue = [&](int kt) {
    const int j0 = kt * BJ, st = kt & 1;
    copy_tile(bs + st * BJ * ldb, ldb, B + (long long)j0 * n, n, BJ, n8,
              c_len - j0, n, vec);
    copy_tile(xs + st * BJ * LDX, LDX, xdt + j0 * ld + h * HD, ld, BJ, HD,
              c_len - j0, HD, true);
  };
  copy_tile(cs, ldb, C + (long long)i0 * n, n, BM, n8, c_len - i0, n, vec);
  issue(0);
  ptx::cp_async_commit();

  // the warp's rows: ra and ra + 8; a key j counts for row i when j <= lim
  const int r0 = i0 + 16 * rg, ra = r0 + g;
  const int lim_a = ra < c_len ? ra : -1, lim_b = ra + 8 < c_len ? ra + 8 : -1;
  const int wmax = min(r0 + 15, c_len - 1);  // the warp's last row
  float di_a = 0.f, di_b = 0.f;          // dacs of rows ra, ra + 8
  float acc[Cfg<HD>::NP][4] = {};

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) {
      issue(kt + 1);
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();                     // tile kt (and C, dacs) arrived
    if (kt == 0) {
      di_a = ds[ra];
      di_b = ds[ra + 8];
    }
    const int jw = kt * BJ + 16 * kh;    // the warp's first key
    if (jw <= wmax) {
      // scores of the warp's 16 rows against its 16 keys, the big * big
      // and the cross terms in separate sums (two shorter mma chains)
      const float* bt = bs + (kt & 1) * BJ * ldb + (16 * kh + g) * ldb + t;
      const float* ca = cs + (16 * rg + g) * ldb + t;
      float s_big[2][4] = {}, s_x[2][4] = {};
      const bool two = jw + 8 <= wmax;   // the second 8-key group counts
#pragma unroll 2
      for (int k0 = 0; k0 < n8; k0 += 8) {
        uint32_t a_big[4], a_small[4];
        ptx::split_tf32(ca[k0], a_big[0], a_small[0]);
        ptx::split_tf32(ca[8 * ldb + k0], a_big[1], a_small[1]);
        ptx::split_tf32(ca[k0 + 4], a_big[2], a_small[2]);
        ptx::split_tf32(ca[8 * ldb + k0 + 4], a_big[3], a_small[3]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !two) continue;
          uint32_t b_big[2], b_small[2];
          ptx::split_tf32(bt[8 * u * ldb + k0], b_big[0], b_small[0]);
          ptx::split_tf32(bt[8 * u * ldb + k0 + 4], b_big[1], b_small[1]);
          ptx::mma_tf32_1688(s_x[u], a_small, b_big);
          ptx::mma_tf32_1688(s_x[u], a_big, b_small);
          ptx::mma_tf32_1688(s_big[u], a_big, b_big);
        }
      }
      // y += (scores . L_h) . xdt_h; the scores' accumulator {(g, 2t),
      // (g, 2t+1), (g+8, 2t), (g+8, 2t+1)} is the A fragment with keys 2t,
      // 2t+1 in k slots t, t+4
      const float* xt = xs + (kt & 1) * BJ * LDX + 16 * kh * LDX;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) continue;
        const int ja = jw + 8 * u + 2 * t;
        const float2 dj = *reinterpret_cast<const float2*>(ds + ja);
        const float l_a0 = ja <= lim_a ? __expf(di_a - dj.x) : 0.f;
        const float l_a1 = ja + 1 <= lim_a ? __expf(di_a - dj.y) : 0.f;
        const float l_b0 = ja <= lim_b ? __expf(di_b - dj.x) : 0.f;
        const float l_b1 = ja + 1 <= lim_b ? __expf(di_b - dj.y) : 0.f;
        uint32_t a_big[4], a_small[4];
        ptx::split_tf32((s_big[u][0] + s_x[u][0]) * l_a0, a_big[0], a_small[0]);
        ptx::split_tf32((s_big[u][2] + s_x[u][2]) * l_b0, a_big[1], a_small[1]);
        ptx::split_tf32((s_big[u][1] + s_x[u][1]) * l_a1, a_big[2], a_small[2]);
        ptx::split_tf32((s_big[u][3] + s_x[u][3]) * l_b1, a_big[3], a_small[3]);
        times_x<HD>(acc, a_big, a_small, xt + 8 * u * LDX);
      }
    }
    __syncthreads();                     // stage kt & 1 free for tile kt + 2
  }
  merge_halves<HD>(bs, rg, kh, acc);
  if (kh == 0) store_rows<HD>(y + h * HD, ld, ra, c_len, acc);
}

// state block: rows nn0 .. nn0+BM-1 of head h's outgoing state (n x hd).
// Warp (rg, kh) takes state rows 16 rg .. 16 rg + 15 and keys 16 kh .. 16
// kh + 15 of every tile.
template <int HD>
__device__ void state_block(float* smem, const float* __restrict__ xdt,
                            const float* __restrict__ dacs,
                            const float* __restrict__ B,
                            float* __restrict__ states, int h, int nn0,
                            int c_len, int nh, int n) {
  constexpr int LDX = Cfg<HD>::LDX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, rg = warp & 3, kh = warp >> 2;
  float* bs = smem;                      // 2 x BJ x LDS   B tiles, nn0..+BM
  float* xs = bs + 2 * BJ * LDS;         // 2 x BJ x LDX   xdt tiles of head h
  float* dec = xs + 2 * BJ * LDX;        // decay to the chunk's end, per key
  const int ntiles = (c_len + BJ - 1) / BJ;
  const bool vec = n % 4 == 0;
  const long long ld = (long long)nh * HD;
  const float last = __ldg(dacs + (long long)(c_len - 1) * nh + h);
  for (int j = threadIdx.x; j < ntiles * BJ; j += NT)
    dec[j] = j < c_len ? expf(last - __ldg(dacs + (long long)j * nh + h))
                       : 0.f;
  auto issue = [&](int kt) {
    const int j0 = kt * BJ, st = kt & 1;
    copy_tile(bs + st * BJ * LDS, LDS, B + (long long)j0 * n + nn0, n, BJ, BM,
              c_len - j0, min(BM, n - nn0), vec);
    copy_tile(xs + st * BJ * LDX, LDX, xdt + j0 * ld + h * HD, ld, BJ, HD,
              c_len - j0, HD, true);
  };
  issue(0);
  ptx::cp_async_commit();

  const int rw = 16 * rg;                // the warp's first row in the block
  float acc[Cfg<HD>::NP][4] = {};

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) {
      issue(kt + 1);
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();                     // tile kt (and the decay) arrived
    const int jw = kt * BJ + 16 * kh;    // the warp's first key
    if (nn0 + rw < n && jw < c_len) {
      const float* bt = bs + (kt & 1) * BJ * LDS;
      const float* xt = xs + (kt & 1) * BJ * LDX;
      // A[nn][j] = B[j][nn] * decay[j], keys 2t and 2t+1 in k slots t, t+4
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && jw + 8 >= c_len) continue;
        const int ja = 16 * kh + 8 * u + 2 * t;     // key within the tile
        const float2 dv = *reinterpret_cast<const float2*>(dec + kt * BJ + ja);
        const float* ba = bt + ja * LDS + rw + g;
        uint32_t a_big[4], a_small[4];
        ptx::split_tf32(ba[0] * dv.x, a_big[0], a_small[0]);
        ptx::split_tf32(ba[8] * dv.x, a_big[1], a_small[1]);
        ptx::split_tf32(ba[LDS] * dv.y, a_big[2], a_small[2]);
        ptx::split_tf32(ba[LDS + 8] * dv.y, a_big[3], a_small[3]);
        times_x<HD>(acc, a_big, a_small, xt + (16 * kh + 8 * u) * LDX);
      }
    }
    __syncthreads();                     // stage kt & 1 free for tile kt + 2
  }
  merge_halves<HD>(bs, rg, kh, acc);
  if (kh == 0)
    store_rows<HD>(states + ((long long)h * n + nn0) * HD, HD, rw + g,
                   n - nn0, acc);
}

// grid (n_y + n_state, nc, b): x < n_y are y blocks, heaviest row tiles
// first; the rest are state blocks.
template <int HD>
__global__ void __launch_bounds__(NT, 2)
ssd_intra_chunk_kernel(const float* __restrict__ xdt,
                       const float* __restrict__ dacs,
                       const float* __restrict__ B,
                       const float* __restrict__ C, float* __restrict__ y,
                       float* __restrict__ states, int nc, int c_len, int nh,
                       int n) {
  extern __shared__ __align__(16) float smem[];
  const long long chunk = (long long)blockIdx.z * nc + blockIdx.y;
  const long long rows = chunk * c_len;      // first row of this chunk
  const int n_itiles = (c_len + BM - 1) / BM;
  const int n_y = n_itiles * nh;
  const int task = blockIdx.x;
  xdt += rows * nh * HD;
  dacs += rows * nh;
  B += rows * n;
  if (task < n_y) {
    const int itile = n_itiles - 1 - task / nh;
    y_block<HD>(smem, xdt, dacs, B, C + rows * n, y + rows * nh * HD,
                itile * BM, task % nh, c_len, nh, n);
  } else {
    const int n_ntiles = (n + BM - 1) / BM;
    const int s = task - n_y;
    state_block<HD>(smem, xdt, dacs, B, states + chunk * nh * n * HD,
                    s / n_ntiles, (s % n_ntiles) * BM, c_len, nh, n);
  }
}

template <int HD>
int launch(const float* xdt, const float* dacs, const float* B,
           const float* C, float* y, float* states, int b, int nc, int c_len,
           int nh, int n, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return int(attr);
  const size_t floats = y_floats<HD>(c_len, n) > state_floats<HD>(c_len)
                            ? y_floats<HD>(c_len, n)
                            : state_floats<HD>(c_len);
  const size_t bytes = floats * sizeof(float);
  if (bytes > size_t(MAX_SMEM)) return int(cudaErrorInvalidValue);
  const int n_y = (c_len + BM - 1) / BM * nh;
  const int n_state = nh * ((n + BM - 1) / BM);
  const dim3 grid(n_y + n_state, nc, b);
  ssd_intra_chunk_kernel<HD><<<grid, NT, bytes, stream>>>(
      xdt, dacs, B, C, y, states, nc, c_len, nh, n);
  return int(cudaGetLastError());
}

}  // namespace

// All tensors fp32 and dense: xdt and y (b,nc,c,nh*hd), dacs (b,nc,c,nh),
// B and C (b,nc,c,n), states (b,nc,nh,n,hd).  hd is one of 8, 16, 32, 64,
// 128.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_intra_chunk_fwd(int hd, const void* xdt, const void* dacs,
                                   const void* B, const void* C, void* y,
                                   void* states, int b, int nc, int c_len,
                                   int nh, int n, void* stream) {
  if (b <= 0 || nc <= 0 || c_len <= 0 || nh <= 0 || n <= 0 || nc > 65535 ||
      b > 65535)
    return int(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(xdt);
  const auto* d = static_cast<const float*>(dacs);
  const auto* bb = static_cast<const float*>(B);
  const auto* cc = static_cast<const float*>(C);
  auto* yy = static_cast<float*>(y);
  auto* st = static_cast<float*>(states);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(x, d, bb, cc, yy, st, b, nc, c_len, nh, n, s);
    case 16: return launch<16>(x, d, bb, cc, yy, st, b, nc, c_len, nh, n, s);
    case 32: return launch<32>(x, d, bb, cc, yy, st, b, nc, c_len, nh, n, s);
    case 64: return launch<64>(x, d, bb, cc, yy, st, b, nc, c_len, nh, n, s);
    case 128: return launch<128>(x, d, bb, cc, yy, st, b, nc, c_len, nh, n, s);
    default: return int(cudaErrorInvalidValue);
  }
}
