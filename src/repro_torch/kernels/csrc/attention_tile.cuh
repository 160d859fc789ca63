// Tile routines of the attention kernels, flash_attention.cu (prefill) and
// decode_attention.cu (one new token).
//
// Two families, chosen by dtype only:
//
// * fp32: the scalar tile.  A thread block holds `rows` query rows in
//   shared memory (q tile rows for prefill, the G queries of one GQA group
//   for decode), walks the keys in tiles of BK = 32 positions, and keeps the
//   running (m, l, acc) of every row in shared memory, in fp32.  Scores,
//   probabilities and PV are fp32 FMAs on the CUDA cores: bf16 or TF32
//   tensor cores could not hold the fp32 tolerance of the reference (2e-5).
// * bf16: tiles stay bf16 in shared memory, filled by cp.async 16-byte
//   copies (load_rows_async for the padded row-major layout that ldmatrix
//   reads, load_tile_b128 for the 128-byte-swizzled layout that wgmma
//   reads); the products run on tensor cores (ptx.cuh).
//
// Conventions of the reference (src/repro/kernels/ref.py): a masked score is
// NEG_INF = -1e30 (not -inf), p is zeroed under the mask, and the final l is
// clamped at 1e-30, so a row with no valid key returns 0 and never NaN.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace attn {

constexpr int NT = 128;           // threads per block (4 warps)
constexpr int BK = 32;            // keys per tile: one key per lane
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;  // opt-in shared memory per block on sm_90

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout, in floats.  K rows are padded to D + 1 so that the
// 32 lanes of a warp, each reading a different key at the same d, hit 32
// different banks.
template <int D>
struct Smem {
  float *q, *k, *v, *s, *acc, *m, *l, *corr;

  static constexpr size_t floats(int rows) {
    return size_t(rows) * (2 * D + BK + 3) + size_t(BK) * (2 * D + 1);
  }

  __device__ Smem(float* base, int rows) {
    q = base;
    acc = q + rows * D;
    s = acc + rows * D;
    m = s + rows * BK;
    l = m + rows;
    corr = l + rows;
    k = corr + rows;
    v = k + BK * (D + 1);
  }

  __device__ void init_state(int rows) {
    for (int i = threadIdx.x; i < rows * D; i += NT) acc[i] = 0.f;
    for (int i = threadIdx.x; i < rows; i += NT) {
      m[i] = NEG_INF;
      l[i] = 0.f;
    }
  }
};

// Copy `n` <= BK rows of D values, `row_stride` elements apart, into a
// shared tile with leading dimension `ld`; rows n..BK-1 become 0.  Each
// thread issues all of its 16-byte loads before its first shared store, so
// they are in flight together (the wrapper checks the 16-byte alignment).
template <int D>
__device__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                          long long row_stride, int n) {
  constexpr int V = 4;                           // floats per load
  constexpr int PER_ROW = D / V;
  constexpr int TOTAL = BK * PER_ROW;
  constexpr int ITERS = (TOTAL + NT - 1) / NT;
  static_assert(D % V == 0, "rows are loaded 16 bytes at a time");
  uint4 buf[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * NT;
    const int j = i / PER_ROW, c = (i % PER_ROW) * V;
    buf[it] = (i < TOTAL && j < n)
                  ? *reinterpret_cast<const uint4*>(src + j * row_stride + c)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * NT;
    if (i < TOTAL) {
      const int j = i / PER_ROW, c = (i % PER_ROW) * V;
      const float* vals = reinterpret_cast<const float*>(&buf[it]);
#pragma unroll
      for (int e = 0; e < V; ++e) dst[j * ld + c + e] = vals[e];
    }
  }
}

// Attend every row to keys k0 .. k0+BK-1, already in sm.k / sm.v.
// valid(r, kpos) is the mask of the reference.  Ends with a barrier, so the
// caller may overwrite the K/V tile right after.
template <int D, typename Valid>
__device__ void attend_tile(const Smem<D>& sm, int rows, long long k0,
                            float scale, Valid valid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // scores: one (row, key) pair per thread and step; a warp shares its row.
  // Four partial sums break the FMA dependency chain.
#pragma unroll 2
  for (int i = threadIdx.x; i < rows * BK; i += NT) {
    const int r = i / BK, j = i % BK;
    const float* qr = sm.q + r * D;
    const float* kj = sm.k + j * (D + 1);
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      d0 += qr[d] * kj[d];
      d1 += qr[d + 1] * kj[d + 1];
      d2 += qr[d + 2] * kj[d + 2];
      d3 += qr[d + 3] * kj[d + 3];
    }
    const float dot = (d0 + d1) + (d2 + d3);
    sm.s[i] = valid(r, k0 + j) ? dot * scale : NEG_INF;
  }
  __syncthreads();
  // online softmax: one warp per row, one lane per key
  for (int r = warp; r < rows; r += NT / 32) {
    const float s = sm.s[r * BK + lane];
    float mx = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = sm.m[r];
    const float m_new = fmaxf(m_prev, mx);
    const float p = valid(r, k0 + lane) ? expf(s - m_new) : 0.f;
    sm.s[r * BK + lane] = p;
    float sum = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float c = expf(m_prev - m_new);
      sm.corr[r] = c;
      sm.l[r] = sm.l[r] * c + sum;
      sm.m[r] = m_new;
    }
  }
  __syncthreads();
  // acc = acc * corr + P V: consecutive threads take consecutive columns;
  // unrolled so that several independent columns are in flight per thread
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, c = i % D;
    const float* pr = sm.s + r * BK;
    float a = sm.acc[i] * sm.corr[r];
#pragma unroll 8
    for (int j = 0; j < BK; ++j) a += pr[j] * sm.v[j * D + c];
    sm.acc[i] = a;
  }
  __syncthreads();
}

// out[r, c] = acc[r, c] / max(l[r], 1e-30), row r written at out + r * ld
// for r < n.
template <int D>
__device__ void store_rows(const Smem<D>& sm, float* out, long long ld,
                           int n) {
  for (int i = threadIdx.x; i < n * D; i += NT) {
    const int r = i / D, c = i % D;
    out[r * ld + c] = sm.acc[i] / fmaxf(sm.l[r], 1e-30f);
  }
}

// ---- bf16 tiles for the tensor cores ---------------------------------------

// Copy `n` <= ROWS rows of D bf16 values, `row_stride` elements apart, into
// a row-major shared tile of pitch P elements; rows n..ROWS-1 become 0.
// Asynchronous: the caller commits the group and waits for it.
template <int ROWS, int D, int P>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride, int n) {
  constexpr int PER_ROW = D / 8;                  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool ok = r < n;
    ptx::cp_async16(dst + r * P + c, ok ? src + r * row_stride + c : src, ok);
  }
}

// The 128-byte-swizzled K-major layout that wgmma reads: the columns in
// blocks of 64 (128 bytes a row), each block ROWS x 128 bytes; element
// (r, c) of a block at byte r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2.
// The same bytes read as an MN-major operand (rows along K) serve PV.
template <int ROWS>
__device__ __forceinline__ char* b128_chunk(__nv_bfloat16* base, int r,
                                            int chunk) {
  return reinterpret_cast<char*>(base) + (chunk >> 3) * (ROWS * 128) +
         r * 128 + (((chunk & 7) ^ (r & 7)) << 4);
}

// Copy `n` <= ROWS rows of D bf16 values into the swizzled layout above;
// rows n..ROWS-1 become 0.  Asynchronous, like load_rows_async; the copies
// are shared by NTH threads, this one being number `tid`.
template <int ROWS, int D, int NTH>
__device__ __forceinline__ void load_tile_b128(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride, int n,
                                               int tid) {
  constexpr int PER_ROW = D / 8;
  for (int i = tid; i < ROWS * PER_ROW; i += NTH) {
    const int r = i / PER_ROW, c = i % PER_ROW;
    const bool ok = r < n;
    ptx::cp_async16(b128_chunk<ROWS>(dst, r, c),
                    ok ? src + r * row_stride + c * 8 : src, ok);
  }
}

// Zero columns D..DP-1 of a swizzled tile (head dims below a multiple of
// 64 are padded with zeros, which add nothing to QK^T and give unused
// columns of PV).  Plain stores: fence before wgmma reads them.
template <int ROWS, int D, int DP, int NTH>
__device__ __forceinline__ void zero_pad_b128(__nv_bfloat16* dst) {
  constexpr int PAD = (DP - D) / 8;
  for (int i = threadIdx.x; i < ROWS * PAD; i += NTH) {
    const int r = i / PAD, c = D / 8 + i % PAD;
    *reinterpret_cast<uint4*>(b128_chunk<ROWS>(dst, r, c)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Lift the 48 KB default once per kernel instantiation; the launch then asks
// for what it needs.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              MAX_SMEM);
}

}  // namespace attn

// Dispatch a runtime head_dim onto the template instantiations.
#define ATTN_DISPATCH_D(D_, ...)                       \
  switch (D_) {                                        \
    case 16: { constexpr int D = 16; __VA_ARGS__; break; }   \
    case 32: { constexpr int D = 32; __VA_ARGS__; break; }   \
    case 48: { constexpr int D = 48; __VA_ARGS__; break; }   \
    case 64: { constexpr int D = 64; __VA_ARGS__; break; }   \
    case 128: { constexpr int D = 128; __VA_ARGS__; break; } \
    case 256: { constexpr int D = 256; __VA_ARGS__; break; } \
    default: return int(cudaErrorInvalidValue);        \
  }
