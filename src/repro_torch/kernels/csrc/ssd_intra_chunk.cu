// Mamba-2 SSD intra-chunk pass for sm_90a.
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk` in
// src/repro/kernels/ssd_scan.py (pallas_call at :69, body `_kernel` at
// :31-58).  Per (batch b, chunk z), on fp32 inputs xdt (b,nc,c,nh*hd), dacs
// (b,nc,c,nh) (within-chunk cumsum of the log-decay) and B/C (b,nc,c,n):
//
//   y_diag[i,h,p]   = sum_{j<=i} (C_i . B_j) exp(dacs[i,h] - dacs[j,h]) xdt[j,h,p]
//   states[h,nn,p]  = sum_j exp(dacs[c-1,h] - dacs[j,h]) B[j,nn] xdt[j,h,p]
//
// with y_diag laid out as xdt and states as (b,nc,nh,n,hd), both fp32.
//
// What bounds it on the card: at mamba2's 512-token prefill (c = n = 128,
// nh = 48, hd = 64) the pass is 0.62 GFLOP (y over the causal pairs only)
// over 19.5 MB, about 32 FLOP/byte: under the H100's ridge for the tensor
// cores (~295), above it for fp32 CUDA cores (67 TFLOP/s over 3.35 TB/s, 20).
// This simple version runs fp32 FMAs on the CUDA cores out of shared memory
// (no wgmma, no TMA), so its own instruction rate bounds it.  The design:
//   * The TPU grid is (b, nc) with every head in one cell.  Here one launch
//     has two kinds of block, both over grid (tasks, nc, b):
//       - y blocks: BR = 32 query rows x HB = 4 heads.  The block computes
//         the causal strip of scores C_i . B_j (j < the strip's last row)
//         once into shared memory and reuses it for its HB heads;
//       - state blocks: one head x BR = 32 state rows nn.
//     At a 512-token mamba2 prefill that is 384 blocks, not the TPU's 4.
//   * Both kinds end in the same product, out (32 x hd) += A (32 x BJ) .
//     X (BJ x hd), over tiles of BJ = 32 key positions j.  For y, A is the
//     masked, decayed score tile; for states it is B^T scaled by the decay
//     to the chunk's end.  X is xdt of one head.
//   * The causal mask is a select before the exp: exp(dacs_i - dacs_j) for
//     j > i may overflow, and inf * 0 would be NaN.
//   * Any chunk length c (1 .. MAX_CHUNK): rows and keys past c are zeros in
//     shared memory and are not stored.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads per block (8 warps)
constexpr int BR = 32;            // output rows per block
constexpr int BJ = 32;            // key positions per tile
constexpr int HB = 4;             // heads per y block, sharing one score strip
constexpr int MAX_SMEM = 232448;  // opt-in shared memory per block on sm_90

// Output tile BR x HD spread over NT threads: thread (rg, pc) owns rows
// rg + k*NR and columns pc + q*NP, so a warp's columns are consecutive in
// shared and global memory.
template <int HD>
struct Map {
  static constexpr int PER = BR * HD / NT;          // outputs per thread
  static constexpr int TP = PER < 4 ? PER : 4;      // columns per thread
  static constexpr int TR = PER / TP;               // rows per thread
  static constexpr int NP = HD / TP;                // threads along columns
  static constexpr int NR = NT / NP;                // threads along rows
  static_assert(PER >= 1 && NP * TP == HD && NR * TR == BR, "tile mapping");
};

// Shared-memory layout, in floats.  The score strip and the C rows exist
// only in y blocks, but both kinds share one launch and one size.
struct Smem {
  float *c, *b, *s, *x, *a;
  int sld;                                   // leading dim of the strip

  __host__ __device__ static size_t floats(int c_len, int n, int hd) {
    const int sld = (c_len + BJ - 1) / BJ * BJ;
    return size_t(BR) * n + size_t(BJ) * (n + 1) + size_t(BR) * sld +
           size_t(BJ) * hd + size_t(BR) * (BJ + 1);
  }

  __device__ Smem(float* base, int c_len, int n, int hd) {
    sld = (c_len + BJ - 1) / BJ * BJ;
    c = base;                   // BR x n      C rows of the strip
    b = c + BR * n;             // BJ x (n+1)  B tile, padded: lanes read rows
    s = b + BJ * (n + 1);       // BR x sld    scores C_i . B_j
    x = s + BR * sld;           // BJ x hd     xdt tile of one head
    a = x + BJ * hd;            // BR x (BJ+1) left operand, padded
  }
};

// X tile: xdt rows j0 .. j0+BJ-1 of head h (row stride `ld` floats), rows at
// or past c_len are zero.  16-byte loads (the wrapper checks alignment).
template <int HD>
__device__ void load_x(float* dst, const float* __restrict__ src, long long ld,
                       int j0, int c_len) {
  constexpr int PER_ROW = HD / 4;
  for (int i = threadIdx.x; i < BJ * PER_ROW; i += NT) {
    const int jj = i / PER_ROW, q = (i % PER_ROW) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j0 + jj < c_len)
      v = *reinterpret_cast<const float4*>(src + (j0 + jj) * ld + q);
    *reinterpret_cast<float4*>(dst + jj * HD + q) = v;
  }
}

// acc += A (BR x BJ, leading dim BJ+1) . X (BJ x HD)
template <int HD>
__device__ __forceinline__ void product(const float* __restrict__ A,
                                        const float* __restrict__ X,
                                        float (&acc)[Map<HD>::TR][Map<HD>::TP]) {
  using M = Map<HD>;
  const int pc = threadIdx.x % M::NP, rg = threadIdx.x / M::NP;
#pragma unroll 8
  for (int j = 0; j < BJ; ++j) {
    float a[M::TR], x[M::TP];
#pragma unroll
    for (int k = 0; k < M::TR; ++k) a[k] = A[(rg + k * M::NR) * (BJ + 1) + j];
#pragma unroll
    for (int q = 0; q < M::TP; ++q) x[q] = X[j * HD + pc + q * M::NP];
#pragma unroll
    for (int k = 0; k < M::TR; ++k)
#pragma unroll
      for (int q = 0; q < M::TP; ++q) acc[k][q] = fmaf(a[k], x[q], acc[k][q]);
  }
}

// out[r * ld + p] = acc for the thread's rows r < rows
template <int HD>
__device__ void store(float* __restrict__ out, long long ld, int rows,
                      const float (&acc)[Map<HD>::TR][Map<HD>::TP]) {
  using M = Map<HD>;
  const int pc = threadIdx.x % M::NP, rg = threadIdx.x / M::NP;
#pragma unroll
  for (int k = 0; k < M::TR; ++k) {
    const int r = rg + k * M::NR;
    if (r < rows)
#pragma unroll
      for (int q = 0; q < M::TP; ++q) out[r * ld + pc + q * M::NP] = acc[k][q];
  }
}

template <int HD>
__device__ void zero(float (&acc)[Map<HD>::TR][Map<HD>::TP]) {
#pragma unroll
  for (int k = 0; k < Map<HD>::TR; ++k)
#pragma unroll
    for (int q = 0; q < Map<HD>::TP; ++q) acc[k][q] = 0.f;
}

// y block: rows i0 .. i0+BR-1 of the chunk, heads h0 .. h0+HB-1.
template <int HD>
__device__ void y_block(const Smem& sm, const float* __restrict__ xdt,
                        const float* __restrict__ dacs,
                        const float* __restrict__ B,
                        const float* __restrict__ C, float* __restrict__ y,
                        int i0, int h0, int c_len, int nh, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ni = min(BR, c_len - i0);
  const int jend = i0 + ni;                  // causal: j <= i < i0 + ni
  const long long ld = (long long)nh * HD;
  for (int i = threadIdx.x; i < BR * n; i += NT)
    sm.c[i] = i / n < ni ? C[(long long)(i0 + i / n) * n + i % n] : 0.f;
  // score strip S[r][j] = C_{i0+r} . B_j for j < jend: one key per lane,
  // four rows per warp (C reads are broadcasts, B rows padded to n + 1)
  constexpr int RPW = BR / (NT / 32);
  for (int j0 = 0; j0 < jend; j0 += BJ) {
    __syncthreads();                         // C loaded / B tile consumed
    for (int i = threadIdx.x; i < BJ * n; i += NT) {
      const int jj = i / n, nn = i % n;
      sm.b[jj * (n + 1) + nn] =
          j0 + jj < jend ? B[(long long)(j0 + jj) * n + nn] : 0.f;
    }
    __syncthreads();
    float dot[RPW];
#pragma unroll
    for (int k = 0; k < RPW; ++k) dot[k] = 0.f;
    const float* bj = sm.b + lane * (n + 1);
    for (int nn = 0; nn < n; ++nn) {
      const float bv = bj[nn];
#pragma unroll
      for (int k = 0; k < RPW; ++k)
        dot[k] = fmaf(sm.c[(warp * RPW + k) * n + nn], bv, dot[k]);
    }
#pragma unroll
    for (int k = 0; k < RPW; ++k) sm.s[(warp * RPW + k) * sm.sld + j0 + lane] = dot[k];
  }
  for (int h = h0; h < min(h0 + HB, nh); ++h) {
    float acc[Map<HD>::TR][Map<HD>::TP];
    zero<HD>(acc);
    for (int j0 = 0; j0 < jend; j0 += BJ) {
      __syncthreads();                       // strip written / tiles consumed
      load_x<HD>(sm.x, xdt + (long long)h * HD, ld, j0, c_len);
      for (int e = threadIdx.x; e < BR * BJ; e += NT) {
        const int r = e / BJ, jj = e % BJ, i = i0 + r, j = j0 + jj;
        float a = 0.f;
        if (i < c_len && j <= i)
          a = sm.s[r * sm.sld + j] *
              expf(__ldg(dacs + (long long)i * nh + h) -
                   __ldg(dacs + (long long)j * nh + h));
        sm.a[r * (BJ + 1) + jj] = a;
      }
      __syncthreads();
      product<HD>(sm.a, sm.x, acc);
    }
    store<HD>(y + (long long)i0 * ld + (long long)h * HD, ld, ni, acc);
  }
}

// state block: rows nn0 .. nn0+BR-1 of head h's outgoing state (n x hd).
template <int HD>
__device__ void state_block(const Smem& sm, const float* __restrict__ xdt,
                            const float* __restrict__ dacs,
                            const float* __restrict__ B,
                            float* __restrict__ states, int h, int nn0,
                            int c_len, int nh, int n) {
  const long long ld = (long long)nh * HD;
  const float last = __ldg(dacs + (long long)(c_len - 1) * nh + h);
  float acc[Map<HD>::TR][Map<HD>::TP];
  zero<HD>(acc);
  for (int j0 = 0; j0 < c_len; j0 += BJ) {
    __syncthreads();                         // tiles consumed
    load_x<HD>(sm.x, xdt + (long long)h * HD, ld, j0, c_len);
    // A[r][jj] = B[j][nn0 + r] * exp(dacs[c-1] - dacs[j]); r is the fast
    // index, so B reads are coalesced and the padded stores conflict-free
    for (int e = threadIdx.x; e < BR * BJ; e += NT) {
      const int r = e % BR, jj = e / BR, j = j0 + jj, nn = nn0 + r;
      float a = 0.f;
      if (j < c_len && nn < n)
        a = __ldg(B + (long long)j * n + nn) *
            expf(last - __ldg(dacs + (long long)j * nh + h));
      sm.a[r * (BJ + 1) + jj] = a;
    }
    __syncthreads();
    product<HD>(sm.a, sm.x, acc);
  }
  store<HD>(states + ((long long)h * n + nn0) * HD, HD, min(BR, n - nn0),
            acc);
}

// grid (n_y + n_state, nc, b): x < n_y are y blocks, heaviest row tiles
// first; the rest are state blocks.
template <int HD>
__global__ void __launch_bounds__(NT)
ssd_intra_chunk_kernel(const float* __restrict__ xdt,
                       const float* __restrict__ dacs,
                       const float* __restrict__ B,
                       const float* __restrict__ C, float* __restrict__ y,
                       float* __restrict__ states, int nc, int c_len, int nh,
                       int n) {
  extern __shared__ float smem[];
  const Smem sm(smem, c_len, n, HD);
  const long long chunk = (long long)blockIdx.z * nc + blockIdx.y;
  const long long rows = chunk * c_len;      // first row of this chunk
  const int n_itiles = (c_len + BR - 1) / BR;
  const int n_groups = (nh + HB - 1) / HB;
  const int n_y = n_itiles * n_groups;
  const int task = blockIdx.x;
  xdt += rows * nh * HD;
  dacs += rows * nh;
  B += rows * n;
  if (task < n_y) {
    const int itile = n_itiles - 1 - task / n_groups;
    y_block<HD>(sm, xdt, dacs, B, C + rows * n, y + rows * nh * HD,
                itile * BR, (task % n_groups) * HB, c_len, nh, n);
  } else {
    const int n_ntiles = (n + BR - 1) / BR;
    const int s = task - n_y;
    state_block<HD>(sm, xdt, dacs, B, states + chunk * nh * n * HD,
                    s / n_ntiles, (s % n_ntiles) * BR, c_len, nh, n);
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
  const size_t bytes = Smem::floats(c_len, n, HD) * sizeof(float);
  if (bytes > size_t(MAX_SMEM)) return int(cudaErrorInvalidValue);
  const int n_y = (c_len + BR - 1) / BR * ((nh + HB - 1) / HB);
  const int n_state = nh * ((n + BR - 1) / BR);
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
