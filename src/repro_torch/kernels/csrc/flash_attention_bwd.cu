// Flash attention's backward pass (training) for sm_90a.
//
// The JAX package has no backward kernel: its training differentiates the
// plain blocked algorithm under jax.checkpoint (src/repro/kernels/ref.py:
// 106-107), the backward of the Pallas kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at :134).  This is that
// backward for the forward of flash_attention.cu, with the forward's whole
// argument set: causal `kpos <= q_offset + qpos`, window
// `kpos > qpos - window`, ragged `kpos < lengths[b]` (null: every key),
// Tq != Tk, GQA head h -> h / G, D in {16, 32, 48, 64, 128, 256}, fp32 or
// bf16 operands, fp32 accumulation, dQ/dK/dV written in the input's dtype.
//
// The FlashAttention-2 equations, as ref.attention_bwd_naive writes them:
// from the forward's output O and its natural-log LSE (flash_attention.cu's
// `lse` output), delta = rowsum(dO * O), P = exp(S * scale - lse) (0 where
// masked), dV = P^T dO, dP = dO V^T, dS = P * (dP - delta),
// dQ = dS K * scale, dK = dS^T Q * scale.  Three launches:
//   * bwd_delta: delta, fp32 (B, Hq, Tq), one warp per row;
//   * dK/dV: one block per (key tile, kv head, batch).  It keeps its K and
//     V tiles in shared memory and its dK and dV in registers, and walks
//     the GQA group's query heads and their query tiles, so that the G
//     heads of one kv head sum into dK and dV without atomics (gemma-2b: 8
//     query heads over one kv head);
//   * dQ: one block per (query tile, head, batch), walking the key tiles
//     with dQ in registers.  It recomputes S and dP, which the dK/dV kernel
//     computed too: a second pass costs those two products again but needs
//     no atomics and no (B, Hq, Tq, Tk) buffer.
// Tiles that fail the mask as a whole are skipped with the forward's `run`
// test (flash_attention.py:63-66).
//
// What bounds it on the card: the five products, 10 * D FLOPs per unmasked
// (query, key) pair and head, against about 2 * (4 Tq Hq + 4 Tk Hkv) * D
// bytes in bf16: at gemma-2b's training shape (T = 1024, D = 256, causal)
// far above the H100's ridge, so tensor-core FLOPs bound the work.  What
// the design does about it:
//   * bf16 (training's dtype) runs the products on tensor cores, mma.sync
//     m16n8k16 with fp32 accumulators (as decode_attention.cu's split
//     kernel does).  The dK/dV block owns 16 keys and has four warps: each
//     computes S^T and dP^T for its 16 of a 64-query tile, writes P^T and
//     dS^T to shared memory in bf16, and then takes a quarter of D's
//     8-column tiles of dV += P^T dO and dK += dS^T Q over all 64 queries.
//     Sixteen keys a block keep gemma-2b's (B * Tk / 16 =) 128 blocks on
//     132 SMs, one a block each, so the block copies its next query tile
//     in (cp.async, two stages) while it computes this one.  The dQ block owns 64 query rows, 16 a warp, and walks
//     32-key tiles; dS stays in registers as the A operand of dQ += dS K.
//     Tiles are row-major in shared memory with a pitch of D + 8 (a
//     conflict-free ldmatrix), copied 16 bytes at a time, rows past the
//     tensor zero-filled;
//   * P and dS are rounded to bf16 for their products, as FlashAttention-2
//     rounds them; the plain version keeps fp32 (the tolerance in
//     chip_smoke.py says so);
//   * fp32 keeps scalar CUDA-core kernels (one (query, key) dot product or
//     one output element per thread from shared memory): tensor cores would
//     not hold the fp32 tolerance.
// The first version ran bf16 on those scalar kernels too, at 8.79 ms for
// gemma-2b's training shape (PERF.md, PR 19).

#include <type_traits>

#include "attention_tile.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int KT = 16, QT = 32;    // dK/dV block: keys owned, query tile
constexpr int QR = 16, KR = 32;    // dQ block: query rows owned, key tile

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// `n` <= ROWS rows of D values, `stride` elements apart, into a shared tile
// of pitch D + 1 floats (so that a warp reading one column of 32 rows hits
// 32 banks); rows n..ROWS-1 become 0.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int n) {
  for (int i = threadIdx.x; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r < n ? to_f(src[r * stride + c]) : 0.f;
  }
}

// The mask of one (query, key) pair, in absolute positions.
struct Mask {
  long long length, window;
  int causal;
  __device__ __forceinline__ bool ok(long long qpos, long long kpos) const {
    return kpos < length && (!causal || kpos <= qpos) && kpos > qpos - window;
  }
  // whether any pair of the query rows [q_lo, q_hi] and keys [k_lo, k_hi]
  // passes (the forward's `run` test)
  __device__ __forceinline__ bool run(long long q_lo, long long q_hi,
                                      long long k_lo, long long k_hi) const {
    return k_lo < length && (!causal || k_lo <= q_hi) && k_hi > q_lo - window;
  }
};

template <int D>
__device__ __forceinline__ void dots(const float* qr, const float* dor,
                                     const float* kr, const float* vr,
                                     float& s, float& dp) {
  float s0 = 0.f, s1 = 0.f, p0 = 0.f, p1 = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 2) {
    s0 += qr[d] * kr[d];
    s1 += qr[d + 1] * kr[d + 1];
    p0 += dor[d] * vr[d];
    p1 += dor[d + 1] * vr[d + 1];
  }
  s = s0 + s1;
  dp = p0 + p1;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ delta, long long rows, int Tq, int Hq,
          long long o_sb, long long o_st, long long do_sb, long long do_st) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // rows = B * Tq * Hq, in (b, t, h) order
  const int h = int(row % Hq), t = int(row / Hq % Tq);
  const long long b = row / Hq / Tq;
  const T* orow = o + b * o_sb + t * o_st + (long long)h * D;
  const T* drow = dout + b * do_sb + t * do_st + (long long)h * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[(b * Hq + h) * Tq + t] = s;
}

// ---- fp32: scalar CUDA-core kernels ----------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         const int* __restrict__ lengths, T* __restrict__ dk,
         T* __restrict__ dv, int Tq, int Tk, int Hq, int G, long long q_sb,
         long long q_st, long long k_sb, long long k_st, long long v_sb,
         long long v_st, long long do_sb, long long do_st, int causal,
         int q_offset, int window, float scale) {
  constexpr int P = D + 1, ACC = KT * D / NT;
  static_assert(KT * D % NT == 0, "whole accumulators per thread");
  extern __shared__ float smem[];
  float* sk = smem;            // [KT][P]
  float* sv = sk + KT * P;     // [KT][P]
  float* sq = sv + KT * P;     // [QT][P]
  float* sdo = sq + QT * P;    // [QT][P]
  float* sp = sdo + QT * P;    // [QT][KT]
  float* sds = sp + QT * KT;   // [QT][KT]
  float* slse = sds + QT * KT; // [QT]
  float* sdel = slse + QT;     // [QT]

  const int k0 = blockIdx.x * KT, hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = gridDim.y, nk = min(KT, Tk - k0);
  const Mask mask{lengths ? min(lengths[b], Tk) : Tk, window, causal};
  load_rows<KT, D>(sk, k + b * k_sb + k0 * k_st + (long long)hk * D, k_st,
                   nk);
  load_rows<KT, D>(sv, v + b * v_sb + k0 * v_st + (long long)hk * D, v_st,
                   nk);
  float dk_acc[ACC], dv_acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) dk_acc[a] = dv_acc[a] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const float* lse_h = lse + ((long long)b * Hq + h) * Tq;
    const float* del_h = delta + ((long long)b * Hq + h) * Tq;
    for (int q0 = 0; q0 < Tq; q0 += QT) {
      const long long q_lo = (long long)q_offset + q0;
      if (!mask.run(q_lo, q_lo + QT - 1, k0, k0 + KT - 1)) continue;
      const int nq = min(QT, Tq - q0);
      __syncthreads();  // the last tile's readers are done
      load_rows<QT, D>(sq, q + b * q_sb + q0 * q_st + (long long)h * D, q_st,
                       nq);
      load_rows<QT, D>(sdo, dout + b * do_sb + q0 * do_st + (long long)h * D,
                       do_st, nq);
      for (int i = threadIdx.x; i < QT; i += NT) {
        slse[i] = i < nq ? lse_h[q0 + i] : 0.f;
        sdel[i] = i < nq ? del_h[q0 + i] : 0.f;
      }
      __syncthreads();
      // P and dS of the (query, key) pairs, one dot product pair a thread
      for (int e = threadIdx.x; e < QT * KT; e += NT) {
        const int i = e / KT, j = e % KT;
        float s, dp;
        dots<D>(sq + i * P, sdo + i * P, sk + j * P, sv + j * P, s, dp);
        const float p = i < nq && mask.ok(q_lo + i, k0 + j)
                            ? expf(s * scale - slse[i]) : 0.f;
        sp[e] = p;
        sds[e] = p * (dp - sdel[i]);
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q: element (j, c) of each per thread
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int e = threadIdx.x + a * NT, j = e / D, c = e % D;
        float av = 0.f, ak = 0.f;
#pragma unroll 8
        for (int i = 0; i < QT; ++i) {
          av += sp[i * KT + j] * sdo[i * P + c];
          ak += sds[i * KT + j] * sq[i * P + c];
        }
        dv_acc[a] += av;
        dk_acc[a] += ak;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = threadIdx.x + a * NT, j = e / D, c = e % D;
    if (j < nk) {
      const long long at = (((long long)b * Tk + k0 + j) * Hkv + hk) * D + c;
      dk[at] = attn::from_f<T>(dk_acc[a] * scale);
      dv[at] = attn::from_f<T>(dv_acc[a]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       const int* __restrict__ lengths, T* __restrict__ dq, int Tq, int Tk,
       int G, long long q_sb, long long q_st, long long k_sb, long long k_st,
       long long v_sb, long long v_st, long long do_sb, long long do_st,
       int causal, int q_offset, int window, float scale) {
  constexpr int P = D + 1, ACC = QR * D / NT;
  static_assert(QR * D % NT == 0, "whole accumulators per thread");
  extern __shared__ float smem[];
  float* sq = smem;            // [QR][P]
  float* sdo = sq + QR * P;    // [QR][P]
  float* sk = sdo + QR * P;    // [KR][P]
  float* sv = sk + KR * P;     // [KR][P]
  float* sds = sv + KR * P;    // [QR][KR]
  float* slse = sds + QR * KR; // [QR]
  float* sdel = slse + QR;     // [QR]

  const int q0 = blockIdx.x * QR, h = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y, hk = h / G, nq = min(QR, Tq - q0);
  const Mask mask{lengths ? min(lengths[b], Tk) : Tk, window, causal};
  load_rows<QR, D>(sq, q + b * q_sb + q0 * q_st + (long long)h * D, q_st,
                   nq);
  load_rows<QR, D>(sdo, dout + b * do_sb + q0 * do_st + (long long)h * D,
                   do_st, nq);
  for (int i = threadIdx.x; i < QR; i += NT) {
    const long long at = ((long long)b * Hq + h) * Tq + q0 + i;
    slse[i] = i < nq ? lse[at] : 0.f;
    sdel[i] = i < nq ? delta[at] : 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;

  const long long q_lo = (long long)q_offset + q0;
  const T* kb = k + b * k_sb + (long long)hk * D;
  const T* vb = v + b * v_sb + (long long)hk * D;
  for (int k0 = 0; k0 < Tk; k0 += KR) {
    if (!mask.run(q_lo, q_lo + QR - 1, k0, k0 + KR - 1)) continue;
    const int nk = min(KR, Tk - k0);
    __syncthreads();  // the last tile's readers are done
    load_rows<KR, D>(sk, kb + k0 * k_st, k_st, nk);
    load_rows<KR, D>(sv, vb + k0 * v_st, v_st, nk);
    __syncthreads();
    for (int e = threadIdx.x; e < QR * KR; e += NT) {
      const int i = e / KR, j = e % KR;
      float s, dp;
      dots<D>(sq + i * P, sdo + i * P, sk + j * P, sv + j * P, s, dp);
      const float p = i < nq && mask.ok(q_lo + i, k0 + j)
                          ? expf(s * scale - slse[i]) : 0.f;
      sds[e] = p * (dp - sdel[i]);
    }
    __syncthreads();
    // dQ += dS K: element (i, c) per thread
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int e = threadIdx.x + a * NT, i = e / D, c = e % D;
      float x = 0.f;
#pragma unroll 8
      for (int j = 0; j < KR; ++j) x += sds[i * KR + j] * sk[j * P + c];
      acc[a] += x;
    }
  }
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = threadIdx.x + a * NT, i = e / D, c = e % D;
    if (i < nq)
      dq[(((long long)b * Tq + q0 + i) * Hq + h) * D + c] =
          attn::from_f<T>(acc[a] * scale);
  }
}

// ---- bf16: mma.sync -------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_NT = 128;                 // threads: four warps
constexpr int TC_KT = 16, TC_QT = 64;      // dK/dV block: keys, query tile
constexpr int TC_QR = 64, TC_KR = 32;      // dQ block: query rows, key tile
constexpr int TC_PP = TC_QT + 8;           // pitch of the P^T / dS^T tiles

template <int D>
struct TcSmem {
  static constexpr int P = D + 8;          // row pitch: conflict-free ldmatrix
  // K and V; two stages of Q, dO, LSE and delta; P^T and dS^T
  static constexpr size_t dkdv = 2 * (size_t(2 * TC_KT + 4 * TC_QT) * P +
                                      2 * size_t(TC_KT) * TC_PP) +
                                 4 * 4 * size_t(TC_QT);
  static constexpr size_t dq = 2 * size_t(2 * TC_QR + 2 * TC_KR) * P +
                               4 * 2 * size_t(TC_QR);
};

// `n` <= ROWS rows of D bf16 values, `stride` elements apart, into a shared
// tile of pitch D + 8 by cp.async, 16 bytes a copy; rows n..ROWS-1 become 0
// (a row of garbage would give NaN * 0 in the products).  The caller
// commits and waits.
template <int ROWS, int D>
__device__ __forceinline__ void load_tc(bf16* dst, const bf16* src,
                                        long long stride, int n) {
  constexpr int CH = D / 8, P = D + 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += TC_NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < n;
    ptx::cp_async16(dst + r * P + c, ok ? src + r * stride + c : src, ok);
  }
}

// `n` <= ROWS fp32 values into shared memory by cp.async, 0 past n.
template <int ROWS>
__device__ __forceinline__ void load_row_f32(float* dst, const float* src,
                                             int n) {
  for (int i = threadIdx.x; i < ROWS; i += TC_NT)
    ptx::cp_async4(dst + i, i < n ? src + i : src, i < n);
}

// The contiguous range [first, last] of `n_tiles` tiles of `width` whose
// rows pass the mask against the fixed range [lo, hi] (queries against a
// key tile, or keys against a query tile); last < first when none does.
struct TileRange {
  int first, last;
};
__device__ __forceinline__ TileRange passing_q_tiles(
    const Mask& mask, long long q_offset, int n_tiles, int width, int k_lo,
    int k_hi) {
  TileRange r{0, -1};
  for (int i = 0; i < n_tiles; ++i) {
    const long long q_lo = q_offset + (long long)i * width;
    if (mask.run(q_lo, q_lo + width - 1, k_lo, k_hi)) {
      if (r.last < r.first) r.first = i;
      r.last = i;
    }
  }
  return r;
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ lengths, bf16* __restrict__ dk,
            bf16* __restrict__ dv, int Tq, int Tk, int Hq, int G,
            long long q_sb, long long q_st, long long k_sb, long long k_st,
            long long v_sb, long long v_st, long long do_sb, long long do_st,
            int causal, int q_offset, int window, float scale) {
  constexpr int P = TcSmem<D>::P, PP = TC_PP;
  constexpr int NT8 = D / 8;               // 8-column tiles of dK and dV
  constexpr int PER = (NT8 + 3) / 4;       // of them per warp
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sk = reinterpret_cast<bf16*>(smem_tc);   // [KT][P]
  bf16* sv = sk + TC_KT * P;                     // [KT][P]
  bf16* sq0 = sv + TC_KT * P;                    // 2 stages of [QT][P]
  bf16* sdo0 = sq0 + 2 * TC_QT * P;              // 2 stages of [QT][P]
  bf16* sp = sdo0 + 2 * TC_QT * P;               // P^T [KT][PP]
  bf16* sds = sp + TC_KT * PP;                   // dS^T [KT][PP]
  float* slse0 = reinterpret_cast<float*>(sds + TC_KT * PP);  // 2 x [QT]
  float* sdel0 = slse0 + 2 * TC_QT;                           // 2 x [QT]

  const int k0 = blockIdx.x * TC_KT, hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = gridDim.y, nk = min(TC_KT, Tk - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Mask mask{lengths ? min(lengths[b], Tk) : Tk, window, causal};
  load_tc<TC_KT, D>(sk, k + b * k_sb + k0 * k_st + (long long)hk * D, k_st,
                    nk);
  load_tc<TC_KT, D>(sv, v + b * v_sb + k0 * v_st + (long long)hk * D, v_st,
                    nk);
  float dk_acc[PER][4], dv_acc[PER][4];
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  // the items: (query head of the group, query tile that passes the mask),
  // walked in order with the next item's tiles copied in (cp.async) while
  // this one computes
  const TileRange qr = passing_q_tiles(mask, q_offset,
                                       (Tq + TC_QT - 1) / TC_QT, TC_QT, k0,
                                       k0 + TC_KT - 1);
  const int n_run = qr.last - qr.first + 1, n_items = G * max(n_run, 0);
  auto load_item = [&](int item, int stage) {
    const int h = hk * G + item / n_run;
    const int q0 = (qr.first + item % n_run) * TC_QT;
    const int nq = min(TC_QT, Tq - q0);
    const long long row = ((long long)b * Hq + h) * Tq + q0;
    load_tc<TC_QT, D>(sq0 + stage * TC_QT * P,
                      q + b * q_sb + q0 * q_st + (long long)h * D, q_st, nq);
    load_tc<TC_QT, D>(sdo0 + stage * TC_QT * P,
                      dout + b * do_sb + q0 * do_st + (long long)h * D,
                      do_st, nq);
    load_row_f32<TC_QT>(slse0 + stage * TC_QT, lse + row, nq);
    load_row_f32<TC_QT>(sdel0 + stage * TC_QT, delta + row, nq);
  };
  if (n_items > 0) load_item(0, 0);
  ptx::cp_async_commit();  // with K and V

  for (int item = 0; item < n_items; ++item) {
    const int stage = item & 1;
    if (item + 1 < n_items) {
      load_item(item + 1, stage ^ 1);
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();  // this item's copies are in
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sq = sq0 + stage * TC_QT * P;
    const bf16* sdo = sdo0 + stage * TC_QT * P;
    const float* slse = slse0 + stage * TC_QT;
    const float* sdel = sdel0 + stage * TC_QT;
    const int q0 = (qr.first + item % n_run) * TC_QT;
    const long long q_lo = (long long)q_offset + q0;
    const int nq = min(TC_QT, Tq - q0);

    // S^T = K Q^T and dP^T = V dO^T: the block's 16 keys against this
    // warp's 16 queries, two 8-query n-tiles
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ptx::ldmatrix_x4(ak, sk + (lane & 15) * P + kk * 16 + (lane >> 4) * 8);
      ptx::ldmatrix_x4(av, sv + (lane & 15) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int row = warp * 16 + n * 8 + (lane & 7);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bq[2], bd[2];
        ptx::ldmatrix_x2(bq, sq + row * P + col);
        ptx::ldmatrix_x2(bd, sdo + row * P + col);
        ptx::mma_bf16_16816(s[n], ak, bq);
        ptx::mma_bf16_16816(dp[n], av, bd);
      }
    }
    // P^T and dS^T: s[n][e] is (key g + 8 (e >> 1), query
    // 16 warp + 8 n + 2t + (e & 1)); pairs of queries go out as bf16x2
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = g + 8 * r, qi = warp * 16 + n * 8 + 2 * t;
        float p[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = qi + c;
          p[c] = i < nq && mask.ok(q_lo + i, k0 + key)
                     ? expf(s[n][2 * r + c] * scale - slse[i]) : 0.f;
          ds[c] = p[c] * (dp[n][2 * r + c] - sdel[i]);
        }
        *reinterpret_cast<uint32_t*>(sp + key * PP + qi) =
            ptx::pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(sds + key * PP + qi) =
            ptx::pack_bf16(ds[0], ds[1]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the 64 queries: this warp's
    // 8-column tiles of D (warp, warp + 4, ...)
#pragma unroll
    for (int kk = 0; kk < TC_QT / 16; ++kk) {
      uint32_t ap[4], ad[4];
      ptx::ldmatrix_x4(ap, sp + (lane & 15) * PP + kk * 16 + (lane >> 4) * 8);
      ptx::ldmatrix_x4(ad, sds + (lane & 15) * PP + kk * 16 +
                               (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int j = warp + 4 * i;
        if (j < NT8) {
          uint32_t bd[2], bq[2];
          ptx::ldmatrix_x2_trans(bd, sdo + (kk * 16 + (lane & 15)) * P +
                                         j * 8);
          ptx::ldmatrix_x2_trans(bq, sq + (kk * 16 + (lane & 15)) * P +
                                         j * 8);
          ptx::mma_bf16_16816(dv_acc[i], ap, bd);
          ptx::mma_bf16_16816(dk_acc[i], ad, bq);
        }
      }
    }
    __syncthreads();  // this stage and P^T / dS^T are rewritten next
  }
  ptx::cp_async_wait<0>();  // K and V's copies, when no item ran
  // dv_acc[i][e] is (key g + 8 (e >> 1), column 8 (warp + 4i) + 2t + (e & 1))
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = warp + 4 * i;
    if (j >= NT8) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = g + 8 * r;
      if (key >= nk) continue;
      const long long at =
          (((long long)b * Tk + k0 + key) * Hkv + hk) * D + j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + at) = ptx::pack_bf16(
          dk_acc[i][2 * r] * scale, dk_acc[i][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          ptx::pack_bf16(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ lengths, bf16* __restrict__ dq, int Tq,
          int Tk, int G, long long q_sb, long long q_st, long long k_sb,
          long long k_st, long long v_sb, long long v_st, long long do_sb,
          long long do_st, int causal, int q_offset, int window,
          float scale) {
  constexpr int P = TcSmem<D>::P;
  constexpr int NT8 = D / 8;               // 8-column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sq = reinterpret_cast<bf16*>(smem_tc);   // [QR][P]
  bf16* sdo = sq + TC_QR * P;                    // [QR][P]
  bf16* sk = sdo + TC_QR * P;                    // [KR][P]
  bf16* sv = sk + TC_KR * P;                     // [KR][P]
  float* slse = reinterpret_cast<float*>(sv + TC_KR * P);  // [QR]
  float* sdel = slse + TC_QR;                              // [QR]

  const int q0 = blockIdx.x * TC_QR, h = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y, hk = h / G, nq = min(TC_QR, Tq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Mask mask{lengths ? min(lengths[b], Tk) : Tk, window, causal};
  load_tc<TC_QR, D>(sq, q + b * q_sb + q0 * q_st + (long long)h * D, q_st,
                    nq);
  load_tc<TC_QR, D>(sdo, dout + b * do_sb + q0 * do_st + (long long)h * D,
                    do_st, nq);
  const long long row = ((long long)b * Hq + h) * Tq + q0;
  load_row_f32<TC_QR>(slse, lse + row, nq);
  load_row_f32<TC_QR>(sdel, delta + row, nq);
  ptx::cp_async_commit();
  float acc[NT8][4];
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const long long q_lo = (long long)q_offset + q0;
  const bf16* kb = k + b * k_sb + (long long)hk * D;
  const bf16* vb = v + b * v_sb + (long long)hk * D;
  const int row0 = warp * 16;              // this warp's 16 query rows
  for (int k0 = 0; k0 < Tk; k0 += TC_KR) {
    if (!mask.run(q_lo, q_lo + TC_QR - 1, k0, k0 + TC_KR - 1)) continue;
    const int nk = min(TC_KR, Tk - k0);
    __syncthreads();  // the last tile's readers are done
    load_tc<TC_KR, D>(sk, kb + k0 * k_st, k_st, nk);
    load_tc<TC_KR, D>(sv, vb + k0 * v_st, v_st, nk);
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 32 keys, four 8-key n-tiles
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ad[4];
      ptx::ldmatrix_x4(aq, sq + (row0 + (lane & 15)) * P + kk * 16 +
                               (lane >> 4) * 8);
      ptx::ldmatrix_x4(ad, sdo + (row0 + (lane & 15)) * P + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int row = n * 8 + (lane & 7);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bk[2], bv[2];
        ptx::ldmatrix_x2(bk, sk + row * P + col);
        ptx::ldmatrix_x2(bv, sv + row * P + col);
        ptx::mma_bf16_16816(s[n], aq, bk);
        ptx::mma_bf16_16816(dp[n], ad, bv);
      }
    }
    // dS as the A operand of dQ += dS K: s[n][e] is (row g + 8 (e >> 1),
    // key 8n + 2t + (e & 1)); keys 16m..16m+15 make k-step m
    uint32_t a_ds[2][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + g + 8 * r;
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + n * 8 + 2 * t + c;
          const float p = i < nq && mask.ok(q_lo + i, key)
                              ? expf(s[n][2 * r + c] * scale - slse[i])
                              : 0.f;
          ds[c] = p * (dp[n][2 * r + c] - sdel[i]);
        }
        a_ds[n >> 1][(n & 1) * 2 + r] = ptx::pack_bf16(ds[0], ds[1]);
      }
#pragma unroll
    for (int m = 0; m < TC_KR / 16; ++m)
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        uint32_t bk[2];
        ptx::ldmatrix_x2_trans(bk, sk + (m * 16 + (lane & 15)) * P + j * 8);
        ptx::mma_bf16_16816(acc[j], a_ds[m], bk);
      }
  }
  ptx::cp_async_wait<0>();  // Q's copies, when no key tile ran
  // acc[j][e] is (row g + 8 (e >> 1), column 8j + 2t + (e & 1))
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    if (i >= nq) continue;
#pragma unroll
    for (int j = 0; j < NT8; ++j)
      *reinterpret_cast<uint32_t*>(
          dq + (((long long)b * Tq + q0 + i) * Hq + h) * D + j * 8 + 2 * t) =
          ptx::pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

template <int D>
int launch_tc(const bf16* q, const bf16* k, const bf16* v,
              const bf16* dout, const float* lse, const float* delta,
              const int* lengths, bf16* dq, bf16* dk, bf16* dv, int B, int Tq,
              int Tk, int Hq, int Hkv, long long q_sb, long long q_st,
              long long k_sb, long long k_st, long long v_sb, long long v_st,
              long long do_sb, long long do_st, int causal, int q_offset,
              int window, float scale, cudaStream_t stream) {
  static const cudaError_t attr1 = attn::allow_smem(bwd_dkdv_tc<D>);
  static const cudaError_t attr2 = attn::allow_smem(bwd_dq_tc<D>);
  if (attr1 != cudaSuccess) return int(attr1);
  if (attr2 != cudaSuccess) return int(attr2);
  const int G = Hq / Hkv;
  bwd_dkdv_tc<D><<<dim3((Tk + TC_KT - 1) / TC_KT, Hkv, B), TC_NT,
                   TcSmem<D>::dkdv, stream>>>(
      q, k, v, dout, lse, delta, lengths, dk, dv, Tq, Tk, Hq, G, q_sb, q_st,
      k_sb, k_st, v_sb, v_st, do_sb, do_st, causal, q_offset, window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  bwd_dq_tc<D><<<dim3((Tq + TC_QR - 1) / TC_QR, Hq, B), TC_NT,
                 TcSmem<D>::dq, stream>>>(
      q, k, v, dout, lse, delta, lengths, dq, Tq, Tk, G, q_sb, q_st, k_sb,
      k_st, v_sb, v_st, do_sb, do_st, causal, q_offset, window, scale);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* lengths, void* dq,
           void* dk, void* dv, void* delta, int B, int Tq, int Tk, int Hq,
           int Hkv, long long q_sb, long long q_st, long long k_sb,
           long long k_st, long long v_sb, long long v_st, long long o_sb,
           long long o_st, long long do_sb, long long do_st, int causal,
           int q_offset, int window, float scale, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdel = static_cast<float*>(delta);
  const int* lens = static_cast<const int*>(lengths);

  const long long rows = (long long)B * Tq * Hq;
  bwd_delta<T, D><<<unsigned((rows + NT / 32 - 1) / (NT / 32)), NT, 0,
                    stream>>>(static_cast<const T*>(o), tdo, fdel, rows, Tq,
                              Hq, o_sb, o_st, do_sb, do_st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  if constexpr (std::is_same_v<T, bf16>) {
    return launch_tc<D>(tq, tk, tv, tdo, flse, fdel, lens,
                        static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                        static_cast<bf16*>(dv), B, Tq, Tk, Hq, Hkv, q_sb,
                        q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st, causal,
                        q_offset, window, scale, stream);
  } else {
    static const cudaError_t attr1 = attn::allow_smem(bwd_dkdv<T, D>);
    static const cudaError_t attr2 = attn::allow_smem(bwd_dq<T, D>);
    if (attr1 != cudaSuccess) return int(attr1);
    if (attr2 != cudaSuccess) return int(attr2);
    const int G = Hq / Hkv;
    constexpr int P = D + 1;
    const size_t kv_bytes =
        (size_t(2 * KT * P + 2 * QT * P + 2 * QT * KT + 2 * QT)) * 4;
    bwd_dkdv<T, D><<<dim3((Tk + KT - 1) / KT, Hkv, B), NT, kv_bytes,
                     stream>>>(
        tq, tk, tv, tdo, flse, fdel, lens, static_cast<T*>(dk),
        static_cast<T*>(dv), Tq, Tk, Hq, G, q_sb, q_st, k_sb, k_st, v_sb,
        v_st, do_sb, do_st, causal, q_offset, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    const size_t q_bytes =
        (size_t(2 * QR * P + 2 * KR * P + QR * KR + 2 * QR)) * 4;
    bwd_dq<T, D><<<dim3((Tq + QR - 1) / QR, Hq, B), NT, q_bytes, stream>>>(
        tq, tk, tv, tdo, flse, fdel, lens, static_cast<T*>(dq), Tq, Tk, G,
        q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st, causal, q_offset,
        window, scale);
    return int(cudaGetLastError());
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike).
// Strides are in elements, the head and feature axes dense.  `lse` is the
// forward's dense fp32 (B,Hq,Tq) output; `delta`, dense fp32 (B,Hq,Tq), is
// scratch the call fills; dq (B,Tq,Hq,D) and dk/dv (B,Tk,Hkv,D) are dense.
// `lengths` may be null: every key is valid.  Three launches on `stream`;
// returns the first non-zero cudaGetLastError(), else 0.
extern "C" int flash_attention_bwd(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, const void* lengths,
    void* dq, void* dk, void* dv, void* delta, int B, int Tq, int Tk, int Hq,
    int Hkv, long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, long long o_sb, long long o_st,
    long long do_sb, long long do_st, int causal, int q_offset, int window,
    float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ATTN_DISPATCH_D(D, return launch<float, D>(
        q, k, v, o, dout, lse, lengths, dq, dk, dv, delta, B, Tq, Tk, Hq,
        Hkv, q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st, do_sb, do_st,
        causal, q_offset, window, scale, st))
  } else if (dtype == 1) {
    ATTN_DISPATCH_D(D, return launch<__nv_bfloat16, D>(
        q, k, v, o, dout, lse, lengths, dq, dk, dv, delta, B, Tq, Tk, Hq,
        Hkv, q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st, do_sb, do_st,
        causal, q_offset, window, scale, st))
  }
  return int(cudaErrorInvalidValue);
}
