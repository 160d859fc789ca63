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
// dQ = dS K * scale, dK = dS^T Q * scale.  Tiles that fail the mask as a
// whole are skipped with the forward's `run` test (flash_attention.py:
// 63-66).
//
// What bounds it on the card: the five products, 10 * D FLOPs per unmasked
// (query, key) pair and head, against about 2 * (4 Tq Hq + 4 Tk Hkv) * D
// bytes in bf16: at gemma-2b's training shape (B = 2, T = 1024, 8 query
// heads over 1, D = 256, causal) 21.5 GFLOP, 0.0217 ms at the bf16 peak,
// far above the H100's ridge, so tensor-core FLOPs bound the work.  What
// the design does about it (bf16, training's dtype; ref.attention_bwd_split
// is its arithmetic on the CPU):
//   * every product runs on wgmma with fp32 accumulators, 64-row tiles of
//     keys and queries in the forward's 128-byte-swizzled bf16 layout
//     (head dims below 64 zero-padded to 64);
//   * dK/dV: one block per (key tile, kv head, split of the GQA group,
//     batch), two warpgroups.  Warpgroup 0 computes S^T = K Q^T and P,
//     warpgroup 1 dP^T = V dO^T (both wgmma m64n64k16 from shared memory);
//     P crosses to warpgroup 1 through shared memory (fp32, one slot a
//     thread), which forms dS.  Each then feeds its result from registers,
//     rounded to bf16, as wgmma's A operand: dV += P^T dO on warpgroup 0,
//     dK += dS^T Q on warpgroup 1 (m64nDk16, the Q/dO tile MN-major).  So
//     each warpgroup holds one 64 x D fp32 accumulator: at D = 256 that is
//     128 registers a thread, where one warpgroup holding both would need
//     256 before S and dP.  The block walks its heads' query tiles with
//     the next Q/dO tile in flight (cp.async, two stages; 218 KB of shared
//     memory at D = 256);
//   * under MQA/GQA the kv heads alone give too few blocks (gemma-2b: 16
//     key tiles x 1 kv head x 2 = 32 on 132 SMs), so the group's query
//     heads are split across blocks (flash_attention.py::bwd_plan: 8
//     splits there, 256 blocks).  Each split writes fp32 partials of dK
//     and dV, and bwd_dkdv_sum adds them in split order; one split writes
//     bf16 dK/dV itself.  Blocks start with the first key tile, which the
//     most causal query tiles reach;
//   * dQ takes dS from the dK/dV kernel: warpgroup 1 writes each dS tile,
//     bf16, to a scratch of the passing (query tile, key tile) pairs
//     (gemma-2b: 136 tiles of 8 KB per head and batch, 17.8 MB), and
//     bwd_dq_wg runs dQ = dS K * scale as wgmma (dS by ldmatrix into
//     registers, K MN-major), one warpgroup per 64 query rows, the key
//     tiles double-buffered.  A separate pass that recomputed S and dP
//     would run seven products instead of five (about 30 GFLOP at
//     gemma-2b's shape) and hold three accumulators at once;
//   * no atomics: every sum runs in a fixed order, so two calls give the
//     same bits;
//   * P and dS are rounded to bf16 for their products, as FlashAttention-2
//     rounds them; the plain version keeps fp32 (the tolerance in
//     chip_smoke.py says so);
//   * fp32 keeps scalar CUDA-core kernels (one (query, key) dot product or
//     one output element per thread from shared memory): tensor cores would
//     not hold the fp32 tolerance.
// A bf16 call is four launches (three with one split): delta, dK/dV, the
// sum of the splits, dQ.  The versions it replaces took 8.7876 ms (scalar)
// and 0.6055 ms (mma.sync m16n8k16, dQ recomputing S and dP) at gemma-2b's
// training shape on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).

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


// ---- bf16: wgmma -----------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int WG = attn::NT;       // threads of a warpgroup
constexpr int BT = 64;             // keys or queries per tile: wgmma's M
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Wg {
  static constexpr int DP = (D + 63) / 64 * 64;  // whole 128-byte rows
  static constexpr int TILE = BT * DP;           // bf16 values of a tile
  static constexpr int DS_TILE = BT * BT;        // bf16 values of a dS tile
  // dK/dV block: K, V and two stages of Q and dO; the P exchange (fp32, 32
  // values a thread of a warpgroup); a dS tile; two stages of lse and
  // delta; room to align the base to 1024 bytes (the swizzle's period)
  static constexpr int DKDV_SMEM =
      6 * TILE * 2 + 32 * WG * 4 + DS_TILE * 2 + 2 * 2 * BT * 4 + 1024;
  // dQ block: two stages of a K tile and a dS tile
  static constexpr int DQ_SMEM = 2 * (TILE + DS_TILE) * 2 + 1024;
};

// The contiguous range [first, last] of tiles whose `run` test passes;
// last < first when none does.
struct TileRange {
  int first, last;
};
// query tiles against the key range [k_lo, k_hi]
__device__ __forceinline__ TileRange q_tiles(const Mask& mask, int q_offset,
                                             int nqt, int k_lo, int k_hi) {
  TileRange r{0, -1};
  for (int i = 0; i < nqt; ++i) {
    const long long q_lo = (long long)q_offset + i * BT;
    if (mask.run(q_lo, q_lo + BT - 1, k_lo, k_hi)) {
      if (r.last < r.first) r.first = i;
      r.last = i;
    }
  }
  return r;
}
// key tiles against the query tile starting at q_lo
__device__ __forceinline__ TileRange k_tiles(const Mask& mask, long long q_lo,
                                             int nkt) {
  TileRange r{0, -1};
  for (int j = 0; j < nkt; ++j) {
    if (mask.run(q_lo, q_lo + BT - 1, (long long)j * BT,
                 (long long)j * BT + BT - 1)) {
      if (r.last < r.first) r.first = j;
      r.last = j;
    }
  }
  return r;
}
// The first key tile of the query tile at q_lo in the dS scratch: the first
// that reaches into the window, whatever the lengths
// (flash_attention.py::bwd_plan lays the scratch out by the same rule).
__device__ __forceinline__ int ds_first(long long q_lo, long long window,
                                        int nkt) {
  for (int j = 0; j < nkt; ++j)
    if ((long long)j * BT + BT - 1 > q_lo - window) return j;
  return nkt;
}
__device__ __forceinline__ long long ds_tile(int b, int h, int qt, int Hq,
                                             int nqt, int ds_run) {
  return (((long long)b * Hq + h) * nqt + qt) * ds_run;
}

// At D <= 64 two blocks share an SM (74 KB of shared memory each), which
// caps a thread at 128 registers.
template <int D>
__global__ void __launch_bounds__(2 * WG, Wg<D>::DP == 64 ? 2 : 1)
bwd_dkdv_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ lengths, bf16* __restrict__ dk,
            bf16* __restrict__ dv, float* __restrict__ part,
            bf16* __restrict__ dsbuf, int B, int Tq, int Tk, int Hq, int Hkv,
            int ns, int ds_run, long long q_sb, long long q_st,
            long long k_sb, long long k_st, long long v_sb, long long v_st,
            long long do_sb, long long do_st, int causal, int q_offset,
            int window, float scale) {
  using Cfg = Wg<D>;
  constexpr int DP = Cfg::DP, TILE = Cfg::TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sk = reinterpret_cast<bf16*>(base);
  bf16* sv = sk + TILE;
  bf16* sqd = sv + TILE;  // stage s: Q at sqd + 2 s TILE, dO right after it
  float* sp = reinterpret_cast<float*>(sqd + 4 * TILE);  // [32][WG]
  bf16* sds = reinterpret_cast<bf16*>(sp + 32 * WG);     // [query][key]
  float* sml = reinterpret_cast<float*>(sds + Cfg::DS_TILE);

  const int kt = blockIdx.z, b = blockIdx.y;
  const int hk = blockIdx.x % Hkv, split = blockIdx.x / Hkv;
  const int G = Hq / Hkv, k0 = kt * BT, nk = min(BT, Tk - k0);
  const int nqt = (Tq + BT - 1) / BT, nkt = (Tk + BT - 1) / BT;
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;  // this thread's keys: row0, row0 + 8
  const Mask mask{lengths ? min(lengths[b], Tk) : Tk, window, causal};

  if constexpr (D < DP) {  // the padding columns are never copied
#pragma unroll
    for (int i = 0; i < 6; ++i)
      attn::zero_pad_b128<BT, D, DP, 2 * WG>(sk + i * TILE);
  }
  attn::load_tile_b128<BT, D, 2 * WG>(
      sk, k + b * k_sb + (long long)k0 * k_st + (long long)hk * D, k_st, nk,
      threadIdx.x);
  attn::load_tile_b128<BT, D, 2 * WG>(
      sv, v + b * v_sb + (long long)k0 * v_st + (long long)hk * D, v_st, nk,
      threadIdx.x);

  // the items: (query head of this split, query tile that passes the
  // mask), walked in order, the next item's tiles in flight
  const TileRange qr = q_tiles(mask, q_offset, nqt, k0, k0 + BT - 1);
  const int n_run = qr.last - qr.first + 1;
  const int h_lo = hk * G + split * G / ns;
  const int h_hi = hk * G + (split + 1) * G / ns;
  const int n_items = n_run > 0 ? (h_hi - h_lo) * n_run : 0;
  auto load_item = [&](int item, int stage) {
    const int h = h_lo + item / n_run, q0 = (qr.first + item % n_run) * BT;
    const int nq = min(BT, Tq - q0);
    bf16* sq = sqd + 2 * stage * TILE;
    attn::load_tile_b128<BT, D, 2 * WG>(
        sq, q + b * q_sb + (long long)q0 * q_st + (long long)h * D, q_st, nq,
        threadIdx.x);
    attn::load_tile_b128<BT, D, 2 * WG>(
        sq + TILE, dout + b * do_sb + (long long)q0 * do_st + (long long)h * D,
        do_st, nq, threadIdx.x);
    const long long row = ((long long)b * Hq + h) * Tq + q0;
    float* ml = sml + stage * 2 * BT;  // lse, then delta; 0 past Tq
    for (int i = threadIdx.x; i < 2 * BT; i += 2 * WG) {
      const bool ok = i % BT < nq;
      ptx::cp_async4(ml + i, ok ? (i < BT ? lse : delta) + row + i % BT : lse,
                     ok);
    }
  };
  if (n_items > 0) load_item(0, 0);
  ptx::cp_async_commit();  // with K and V

  float acc[DP / 2];  // dV (warpgroup 0) or dK / scale (warpgroup 1)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const float scale2 = scale * LOG2E;  // scores in log2 units: exp2 below

  for (int item = 0; item < n_items; ++item) {
    const int stage = item & 1;
    if (item + 1 < n_items) {
      load_item(item + 1, stage ^ 1);
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();  // this item's copies are in
    } else {
      ptx::cp_async_wait<0>();
    }
    ptx::fence_proxy_async();  // copies (and the zero padding) -> wgmma
    __syncthreads();
    const bf16* sq = sqd + 2 * stage * TILE;
    const bf16* sdo = sq + TILE;
    const float* slse = sml + stage * 2 * BT;
    const float* sdel = slse + BT;
    const int h = h_lo + item / n_run, qt = qr.first + item % n_run;
    const int q0 = qt * BT, nq = min(BT, Tq - q0), q_lo = q_offset + q0;

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): s[4j + e]
    // is (key row0 + 8 (e >> 1), query 8j + 2t + (e & 1)) of the tiles
    float s[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = 0.f;
    const bf16* sa = wg == 0 ? sk : sv;
    const bf16* sb = wg == 0 ? sq : sdo;
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      ptx::wgmma_ss<BT>(
          s, ptx::desc_b128(sa + (kk >> 2) * BT * 64 + (kk & 3) * 16, 1, 64),
          ptx::desc_b128(sb + (kk >> 2) * BT * 64 + (kk & 3) * 16, 1, 64), 1);
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();

    // P^T (warpgroup 0) or dS^T (warpgroup 1) in bf16 as wgmma's A
    // operand: keys are its rows, queries its k; pairs of queries pack.
    // Both warpgroups run the same wgmma instructions (a wgmma under a
    // branch on the warpgroup would be serialised by ptxas).
    uint32_t pa[BT / 16][4];
    if (wg == 0) {
      // tiles wholly inside the mask skip the per-element test
      const bool inside = nq == BT && k0 + BT <= mask.length &&
                          (!causal || k0 + BT - 1 <= q_lo) &&
                          (long long)k0 > (long long)q_lo + BT - 1 - window;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = k0 + row0 + 8 * r;
          float p[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qi = 8 * j + 2 * t + c, e = 4 * j + 2 * r + c;
            const bool ok =
                inside || (qi < nq && mask.ok((long long)q_lo + qi, key));
            p[c] = ok ? ptx::exp2_approx(s[e] * scale2 - slse[qi] * LOG2E)
                      : 0.f;
            sp[e * WG + tid] = p[c];
          }
          pa[j >> 1][(j & 1) * 2 + r] = ptx::pack_bf16(p[0], p[1]);
        }
    }
    ptx::bar_sync(1, 2 * WG);  // P is in shared memory
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = row0 + 8 * r;
          float d[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qi = 8 * j + 2 * t + c, e = 4 * j + 2 * r + c;
            d[c] = sp[e * WG + tid] * (s[e] - sdel[qi]);
            // dS, [query][key], for dQ
            reinterpret_cast<bf16*>(
                attn::b128_chunk<BT>(sds, qi, key >> 3))[key & 7] =
                __float2bfloat16(d[c]);
          }
          pa[j >> 1][(j & 1) * 2 + r] = ptx::pack_bf16(d[0], d[1]);
        }
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): 16 queries
    // per instruction, 2048 bytes apart; the tile's 64-column blocks are
    // BT * 128 bytes apart
    const bf16* sm = wg == 0 ? sdo : sq;
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      ptx::wgmma_rs_tb<DP>(acc, pa[kk],
                           ptx::desc_b128(sm + kk * 16 * 64, BT * 8, 64), 1);
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();
    if (wg == 1) {  // the dS tile goes to the scratch
      ptx::bar_sync(2, WG);
      uint4* dst = reinterpret_cast<uint4*>(
          dsbuf + (ds_tile(b, h, qt, Hq, nqt, ds_run) + kt -
                   ds_first(q_lo, window, nkt)) * Cfg::DS_TILE);
      for (int i = tid; i < Cfg::DS_TILE / 8; i += WG)
        dst[i] = reinterpret_cast<const uint4*>(sds)[i];
    }
    __syncthreads();  // this stage, P and the dS tile are rewritten next
  }
  ptx::cp_async_wait<0>();  // K and V's copies, when no item ran

  // acc[4j + e] is (key row0 + 8 (e >> 1), column 8j + 2t + (e & 1)): one
  // split writes dK and dV, several write fp32 partials for bwd_dkdv_sum
  const bool is_k = wg == 1;
  const long long n_out = (long long)B * Tk * Hkv * D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = row0 + 8 * r, col = 8 * j + 2 * t;
      if (key >= nk || col >= D) continue;
      const long long at =
          (((long long)b * Tk + k0 + key) * Hkv + hk) * D + col;
      const float x0 = acc[4 * j + 2 * r], x1 = acc[4 * j + 2 * r + 1];
      if (ns == 1) {
        const float f = is_k ? scale : 1.f;
        *reinterpret_cast<uint32_t*>((is_k ? dk : dv) + at) =
            ptx::pack_bf16(x0 * f, x1 * f);
      } else {
        *reinterpret_cast<float2*>(
            part + ((long long)split * 2 + (is_k ? 0 : 1)) * n_out + at) =
            make_float2(x0, x1);
      }
    }
}

// dK and dV from the splits' partials (ns, 2, B, Tk, Hkv, D), added in
// split order; four values a thread.
__global__ void __launch_bounds__(256)
bwd_dkdv_sum(const float4* __restrict__ part, bf16* __restrict__ dk,
             bf16* __restrict__ dv, long long n4, int ns, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    float4 s = part[which * n4 + i];
    for (int sp = 1; sp < ns; ++sp) {
      const float4 x = part[((long long)sp * 2 + which) * n4 + i];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    const float f = which == 0 ? scale : 1.f;
    *reinterpret_cast<uint2*>((which == 0 ? dk : dv) + 4 * i) =
        make_uint2(ptx::pack_bf16(s.x * f, s.y * f),
                   ptx::pack_bf16(s.z * f, s.w * f));
  }
}

// dQ = dS K * scale: one warpgroup per (query tile, head, batch) over the
// key tiles that pass the mask, dS from the dK/dV kernel's scratch.
template <int D>
__global__ void __launch_bounds__(WG)
bwd_dq_wg(const bf16* __restrict__ k, const bf16* __restrict__ dsbuf,
          const int* __restrict__ lengths, bf16* __restrict__ dq, int Tq,
          int Tk, int Hq, int G, int ds_run, long long k_sb, long long k_st,
          int causal, int q_offset, int window, float scale) {
  using Cfg = Wg<D>;
  constexpr int DP = Cfg::DP, TILE = Cfg::TILE;
  constexpr int STAGE = TILE + Cfg::DS_TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sm = reinterpret_cast<bf16*>(base);  // stage s: K, then dS

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qt * BT, nq = min(BT, Tq - q0), q_lo = q_offset + q0;
  const int nqt = gridDim.x, nkt = (Tk + BT - 1) / BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, row0 = warp * 16 + g;
  const Mask mask{lengths ? min(lengths[b], Tk) : Tk, window, causal};

  if constexpr (D < DP) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      attn::zero_pad_b128<BT, D, DP, WG>(sm + i * STAGE);
  }
  const TileRange kr = k_tiles(mask, q_lo, nkt);
  const int n = kr.last - kr.first + 1;
  const int f0 = ds_first(q_lo, window, nkt);
  const bf16* kb = k + b * k_sb + (long long)hk * D;
  const bf16* dsq = dsbuf + ds_tile(b, h, qt, Hq, nqt, ds_run) * Cfg::DS_TILE;
  auto load = [&](int i, int stage) {
    const int kt = kr.first + i;
    bf16* st = sm + stage * STAGE;
    attn::load_tile_b128<BT, D, WG>(st, kb + (long long)kt * BT * k_st, k_st,
                                    min(BT, Tk - kt * BT), tid);
    const bf16* src = dsq + (long long)(kt - f0) * Cfg::DS_TILE;
    for (int c = tid; c < Cfg::DS_TILE / 8; c += WG)
      ptx::cp_async16(st + TILE + c * 8, src + c * 8, true);
  };
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  if (n > 0) load(0, 0);
  ptx::cp_async_commit();

  for (int i = 0; i < n; ++i) {
    const int stage = i & 1;
    if (i + 1 < n) {
      load(i + 1, stage ^ 1);
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    ptx::fence_proxy_async();
    __syncthreads();
    const bf16* sk = sm + stage * STAGE;
    bf16* sds = sm + stage * STAGE + TILE;
    // dS's rows 16 warp .. +15 as the A fragments of four k-steps of 16
    // keys: matrix m = lane / 8 of ldmatrix is rows 8 (m & 1), keys
    // 8 (m >> 1) of the step
    uint32_t a[BT / 16][4];
    const int m = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      ptx::ldmatrix_x4(a[kk], attn::b128_chunk<BT>(
                                  sds, warp * 16 + (lane & 7) + 8 * (m & 1),
                                  2 * kk + (m >> 1)));
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      ptx::wgmma_rs_tb<DP>(acc, a[kk],
                           ptx::desc_b128(sk + kk * 16 * 64, BT * 8, 64), 1);
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();
    __syncthreads();  // this stage is rewritten next
  }
  ptx::cp_async_wait<0>();

  bf16* qb = dq + ((long long)b * Tq + q0) * Hq * D + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nq) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D)
        *reinterpret_cast<uint32_t*>(qb + (long long)row * Hq * D + col) =
            ptx::pack_bf16(acc[4 * j + 2 * r] * scale,
                           acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

template <int D>
int launch_wg(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
              const float* lse, const float* delta, const int* lengths,
              bf16* dq, bf16* dk, bf16* dv, float* part, bf16* dsbuf, int B,
              int Tq, int Tk, int Hq, int Hkv, int ns, int ds_run,
              long long q_sb, long long q_st, long long k_sb, long long k_st,
              long long v_sb, long long v_st, long long do_sb,
              long long do_st, int causal, int q_offset, int window,
              float scale, cudaStream_t stream) {
  static const cudaError_t attr1 = attn::allow_smem(bwd_dkdv_wg<D>);
  static const cudaError_t attr2 = attn::allow_smem(bwd_dq_wg<D>);
  if (attr1 != cudaSuccess) return int(attr1);
  if (attr2 != cudaSuccess) return int(attr2);
  const int nqt = (Tq + BT - 1) / BT, nkt = (Tk + BT - 1) / BT;
  bwd_dkdv_wg<D><<<dim3(ns * Hkv, B, nkt), 2 * WG, Wg<D>::DKDV_SMEM,
                   stream>>>(
      q, k, v, dout, lse, delta, lengths, dk, dv, part, dsbuf, B, Tq, Tk, Hq,
      Hkv, ns, ds_run, q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st,
      causal, q_offset, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (ns > 1) {
    const long long n4 = (long long)B * Tk * Hkv * D / 4;
    bwd_dkdv_sum<<<unsigned((n4 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(part), dk, dv, n4, ns, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  bwd_dq_wg<D><<<dim3(nqt, Hq, B), WG, Wg<D>::DQ_SMEM, stream>>>(
      k, dsbuf, lengths, dq, Tq, Tk, Hq, Hq / Hkv, ds_run, k_sb, k_st,
      causal, q_offset, window, scale);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* lengths, void* dq,
           void* dk, void* dv, void* delta, void* part, void* ds, int B,
           int Tq, int Tk, int Hq, int Hkv, int ns, int ds_run,
           long long q_sb, long long q_st, long long k_sb, long long k_st,
           long long v_sb, long long v_st, long long o_sb, long long o_st,
           long long do_sb, long long do_st, int causal, int q_offset,
           int window, float scale, cudaStream_t stream) {
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
    if (ns < 1 || ns > Hq / Hkv || ds_run < 1 || !ds || (ns > 1 && !part))
      return int(cudaErrorInvalidValue);
    return launch_wg<D>(tq, tk, tv, tdo, flse, fdel, lens,
                        static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                        static_cast<bf16*>(dv), static_cast<float*>(part),
                        static_cast<bf16*>(ds), B, Tq, Tk, Hq, Hkv, ns,
                        ds_run, q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb,
                        do_st, causal, q_offset, window, scale, stream);
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
// `lengths` may be null: every key is valid.  bf16 only (fp32 passes null
// and 1, 1): `n_splits` of the GQA group, `part` the splits' fp32 partials
// (n_splits, 2, B, Tk, Hkv, D) (null for one split), `ds` the bf16 dS
// scratch of B * Hq * ceil(Tq / 64) * ds_run tiles of 64 x 64, ds_run the
// longest run of key tiles a query tile reaches (bwd_plan in
// flash_attention.py).  Launches on `stream`; returns the first non-zero
// cudaGetLastError(), else 0.
extern "C" int flash_attention_bwd(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, const void* lengths,
    void* dq, void* dk, void* dv, void* delta, void* part, void* ds, int B,
    int Tq, int Tk, int Hq, int Hkv, int n_splits, int ds_run,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, long long o_sb, long long o_st,
    long long do_sb, long long do_st, int causal, int q_offset, int window,
    float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || (Tk + BT - 1) / BT > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ATTN_DISPATCH_D(D, return launch<float, D>(
        q, k, v, o, dout, lse, lengths, dq, dk, dv, delta, part, ds, B, Tq,
        Tk, Hq, Hkv, n_splits, ds_run, q_sb, q_st, k_sb, k_st, v_sb, v_st,
        o_sb, o_st, do_sb, do_st, causal, q_offset, window, scale, st))
  } else if (dtype == 1) {
    ATTN_DISPATCH_D(D, return launch<__nv_bfloat16, D>(
        q, k, v, o, dout, lse, lengths, dq, dk, dv, delta, part, ds, B, Tq,
        Tk, Hq, Hkv, n_splits, ds_run, q_sb, q_st, k_sb, k_st, v_sb, v_st,
        o_sb, o_st, do_sb, do_st, causal, q_offset, window, scale, st))
  }
  return int(cudaErrorInvalidValue);
}
