// Flash attention (prefill / training forward) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at :134, body `_kernel`
// at :40-95): q (B,Tq,Hq,D), k/v (B,Tk,Hkv,D), output in q's dtype, online
// softmax (m, l, acc) in fp32, causal `kpos <= q_offset + qpos`, window
// `kpos > qpos - window`, ragged `kpos < lengths[b]`, GQA head h -> h / G.
//
// What bounds it on the card: at long T the work is 4*T*T/2*D FLOPs per head
// against ~4*T*D bytes, far above the H100's ~295 FLOP/byte ridge, so it is
// bound by tensor-core FLOPs once the tiles are big enough; at the serving
// shapes (T <= 1024) by how fast one block walks its chain of kv tiles,
// since 64-row tiles give fewer blocks than SMs.  What the design does
// about it:
//   * bf16 runs on wgmma.  A block owns BM = 64 query rows of one head; the
//     grid is (ceil(Tq/64), Hq, B), the q tiles in reverse, so the causal
//     tiles with the most kv tiles start first.  The kv tiles go round a
//     two-stage ring of bf16 K/V tiles in shared memory, filled by
//     cp.async; stage i % 2 belongs to warpgroup i % 2 of two (256
//     threads), which split the block's tiles, even and odd, each with its
//     own (m, l, O), and merge at the end.  While one copies its next tile
//     in or runs its softmax, the other keeps the tensor cores busy, and
//     each walks half the chain (one warpgroup alone was no faster than
//     SDPA at gemma-2b's prefill);
//   * S = Q K^T is wgmma m64n64k16 with Q and the K tile in shared memory
//     (K-major, 128-byte swizzle).  S is masked in registers from each
//     element's (row, key) in the accumulator layout, only on tiles that
//     cross the mask's edge; the online softmax runs in log2 units on
//     ex2.approx and reduces each row over the 4 lanes that hold it; P,
//     rounded to bf16, is the register A operand of wgmma m64nDk16 against
//     the V tile (MN-major, transposed by the instruction).  O, m and l stay
//     fp32 in registers; the epilogue divides by max(l, 1e-30);
//   * head dims below a multiple of 64 are zero-padded in shared memory (D =
//     16/32/48 run as 64); rows past Tq and keys past Tk are zero-filled and
//     masked;
//   * whole kv tiles that fail the mask are skipped with the TPU kernel's
//     own test (`run` at :63-66); they form one contiguous range;
//   * no GQA packing: at gemma-2b's prefill (G = 8) packing 8 heads x 8
//     positions into the 64 rows loads as many kv tiles as 64-row tiles per
//     head do, and one head's K/V lives in L2;
//   * fp32 keeps the scalar CUDA-core tile of attention_tile.cuh, 16 query
//     rows per block: tensor cores would not hold the fp32 tolerance.
//
// Training: where `lse` is not null, both kernels also write each row's
// log-sum-exp of its scaled scores over its valid keys, fp32 (B, Hq, Tq), in
// natural-log units whatever the kernel's own (the wgmma kernel keeps its
// running max and sum in log2 units and converts once, ln 2 (m + log2 l));
// NEG_INF for a row with no valid key.  flash_attention_bwd.cu reads it as
// P = exp(S * scale - lse).  The serving path passes null and writes none.

#include "attention_tile.cuh"

namespace {

// ---- fp32: scalar tile -----------------------------------------------------

constexpr int BQ = 16;

template <int D>
__global__ void __launch_bounds__(attn::NT)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, const int* __restrict__ lengths, int Tq,
          int Tk, int Hq, int G,
          long long q_sb, long long q_st, long long k_sb, long long k_st,
          long long v_sb, long long v_st, int causal, int q_offset,
          int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / G;
  const int nq = min(BQ, Tq - q0);
  attn::Smem<D> sm(smem, BQ);

  const float* qb = q + b * q_sb + (long long)q0 * q_st + (long long)h * D;
  for (int i = threadIdx.x; i < BQ * D; i += attn::NT) {
    const int r = i / D, c = i % D;
    sm.q[i] = r < nq ? qb[r * q_st + c] : 0.f;
  }
  sm.init_state(BQ);
  __syncthreads();

  const long long length = lengths ? min(lengths[b], Tk) : Tk;
  const long long q_lo = (long long)q_offset + q0;  // first absolute q pos
  const long long q_hi = q_lo + BQ - 1;
  const long long win = window;
  auto valid = [=](int r, long long kpos) {
    const long long qpos = q_lo + r;
    return kpos < length && (!causal || kpos <= qpos) && kpos > qpos - win;
  };
  const float* kb = k + b * k_sb + (long long)hk * D;
  const float* vb = v + b * v_sb + (long long)hk * D;
  for (long long k_lo = 0; k_lo < Tk; k_lo += attn::BK) {
    const long long k_hi = k_lo + attn::BK - 1;
    const bool run = k_lo < length && (!causal || k_lo <= q_hi) &&
                     k_hi > q_lo - win;
    if (!run) continue;  // uniform across the block
    const int n = (int)min((long long)attn::BK, Tk - k_lo);
    attn::load_rows<D>(sm.k, D + 1, kb + k_lo * k_st, k_st, n);
    attn::load_rows<D>(sm.v, D, vb + k_lo * v_st, v_st, n);
    __syncthreads();
    attn::attend_tile<D>(sm, BQ, k_lo, scale, valid);
  }
  float* ob = o + ((long long)b * Tq + q0) * Hq * D + (long long)h * D;
  attn::store_rows<D>(sm, ob, (long long)Hq * D, nq);
  if (lse)
    for (int r = threadIdx.x; r < nq; r += attn::NT)
      lse[((long long)b * Hq + h) * Tq + q0 + r] =
          sm.l[r] > 0.f ? sm.m[r] + logf(sm.l[r]) : attn::NEG_INF;
}

// ---- bf16: wgmma -----------------------------------------------------------

constexpr int BM = 64;               // query rows per block: wgmma's M
constexpr int BN = 64;               // keys per kv tile
constexpr int NWG = 2;               // warpgroups, each on every other tile
constexpr int NTB = NWG * attn::NT;  // threads per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct WgCfg {
  static constexpr int DP = (D + 63) / 64 * 64;  // whole 128-byte rows
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;
  // Q, a K and a V tile per warpgroup, and room to align the base to 1024
  // bytes.  After the loop the tiles' space holds warpgroup 1's (m, l, O).
  static constexpr int SMEM = Q_BYTES + NWG * 2 * KV_BYTES + 1024;
  static constexpr int O_PITCH = DP + 4;  // floats: conflict-free float2
  static_assert(BM * (O_PITCH + 2) * 4 <= NWG * 2 * KV_BYTES,
                "the merge buffer fits in the tiles' space");
};

template <int D>
__global__ void __launch_bounds__(NTB, 1)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
           float* __restrict__ lse, const int* __restrict__ lengths, int Tq,
           int Tk, int Hq, int G,
           long long q_sb, long long q_st, long long k_sb, long long k_st,
           long long v_sb, long long v_st, int causal, int q_offset,
           int window, float scale) {
  using bf16 = __nv_bfloat16;
  using Cfg = WgCfg<D>;
  constexpr int DP = Cfg::DP;
  constexpr int KV_ELEMS = Cfg::KV_BYTES / 2;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  unsigned char* base =
      smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sq = reinterpret_cast<bf16*>(base);
  bf16* skv = reinterpret_cast<bf16*>(base + Cfg::Q_BYTES);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int nq = min(BM, Tq - q0);
  const int wg = threadIdx.x / attn::NT, tid = threadIdx.x % attn::NT;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  bf16* sk = skv + wg * 2 * KV_ELEMS;  // this warpgroup's K and V tiles
  bf16* sv = sk + KV_ELEMS;

  if constexpr (D < DP) {  // the padding columns are never copied
    attn::zero_pad_b128<BM, D, DP, NTB>(sq);
#pragma unroll
    for (int i = 0; i < 2 * NWG; ++i)
      attn::zero_pad_b128<BN, D, DP, NTB>(skv + i * KV_ELEMS);
  }

  // the contiguous range of kv tiles that pass the TPU kernel's `run` test
  const int length = lengths ? min(lengths[b], Tk) : Tk;
  const int q_lo = q_offset + q0, q_hi = q_lo + BM - 1;
  const int n_kt = (Tk + BN - 1) / BN;
  int first = -1, last = -2;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_lo = kt * BN, k_hi = k_lo + BN - 1;
    if (k_lo < length && (!causal || k_lo <= q_hi) && k_hi > q_lo - window) {
      if (first < 0) first = kt;
      last = kt;
    }
  }
  const int ntile = last - first + 1;

  const bf16* kb = k + b * k_sb + (long long)hk * D;
  const bf16* vb = v + b * v_sb + (long long)hk * D;
  auto load_kv = [&](int kt) {
    const int k_lo = kt * BN, n = min(BN, Tk - k_lo);
    attn::load_tile_b128<BN, D, attn::NT>(sk, kb + k_lo * k_st, k_st, n, tid);
    attn::load_tile_b128<BN, D, attn::NT>(sv, vb + k_lo * v_st, v_st, n, tid);
  };
  attn::load_tile_b128<BM, D, NTB>(
      sq, q + b * q_sb + (long long)q0 * q_st + (long long)h * D, q_st, nq,
      threadIdx.x);
  if (wg < ntile) load_kv(first + wg);
  ptx::cp_async_commit();
  ptx::cp_async_wait<0>();
  ptx::fence_proxy_async();  // copies (and the zero padding) -> wgmma
  __syncthreads();

  const float scale2 = scale * LOG2E;  // scores in log2 units: exp2 below
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {attn::NEG_INF, attn::NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = wg; it < ntile; it += NWG) {
    // S = Q K^T: 16 columns of D per instruction; a 64-column block of the
    // swizzled tiles holds four, 32 bytes apart within each 128-byte row
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      ptx::wgmma_ss<BN>(
          s, ptx::desc_b128(sq + (kk >> 2) * BM * 64 + (kk & 3) * 16, 1, 64),
          ptx::desc_b128(sk + (kk >> 2) * BN * 64 + (kk & 3) * 16, 1, 64),
          kk > 0);
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();

    // s[4j + e] is (row0 + 8 * (e >> 1), key 8j + 2t + (e & 1)) of the tile.
    // Tiles wholly inside the mask skip the per-element test.
    const int kt = first + it, k_lo = kt * BN, k_hi = k_lo + BN - 1;
    const bool inside = k_hi < length && (!causal || k_hi <= q_lo) &&
                        k_lo > q_hi - window;
    float mx[2] = {attn::NEG_INF, attn::NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale2;
        if (!inside) {
          const int kpos = k_lo + 8 * j + 2 * t + (e & 1);
          const int qpos = q_lo + row0 + 8 * (e >> 1);
          if (!(kpos < length && (!causal || kpos <= qpos) &&
                kpos > qpos - window))
            x = attn::NEG_INF;
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ptx::exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];  // this thread's share of the row sum
    }
    // P = 2^(S - m), 0 where masked; packed to bf16 as wgmma's A fragments
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = e >> 1;
        const float p0 = s[4 * j + e] == attn::NEG_INF
                             ? 0.f : ptx::exp2_approx(s[4 * j + e] - m[r]);
        const float p1 = s[4 * j + e + 1] == attn::NEG_INF
                             ? 0.f : ptx::exp2_approx(s[4 * j + e + 1] - m[r]);
        l[r] += p0 + p1;
        pa[j >> 1][(j & 1) * 2 + r] = ptx::pack_bf16(p0, p1);
      }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }

    // O += P V: 16 keys per instruction, 2048 bytes apart; the V tile's
    // 64-column blocks are BN * 128 bytes apart (the leading byte offset)
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      ptx::wgmma_rs_tb<DP>(acc, pa[kk],
                           ptx::desc_b128(sv + kk * 16 * 64, BN * 8, 64), 1);
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();

    // the warpgroup's next tile: this one's readers are done first; the
    // other warpgroup computes while the copy is in flight
    if (it + NWG < ntile) {
      ptx::bar_sync(1 + wg, attn::NT);
      load_kv(first + it + NWG);
      ptx::cp_async_commit();
      ptx::cp_async_wait<0>();
      ptx::fence_proxy_async();
      ptx::bar_sync(1 + wg, attn::NT);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the row sums, gathered over their 4 lanes
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // merge: warpgroup 1 hands (m, l, O) over in shared memory
  float* so = reinterpret_cast<float*>(skv);  // [BM][O_PITCH]
  float* sml = so + BM * Cfg::O_PITCH;        // [BM][2]
  __syncthreads();  // every tile has been read
  if (wg == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (t == 0) {
        sml[2 * row] = m[r];
        sml[2 * row + 1] = l[r];
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        *reinterpret_cast<float2*>(so + row * Cfg::O_PITCH + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
  __syncthreads();
  if (wg == 1) return;

  // out = O / max(l, 1e-30) over both halves of the tiles
  bf16* ob = o + ((long long)b * Tq + q0) * Hq * D + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float m1 = sml[2 * row], l1 = sml[2 * row + 1];
    const float mm = fmaxf(m[r], m1);
    const float c0 = ptx::exp2_approx(m[r] - mm);
    const float c1 = ptx::exp2_approx(m1 - mm);
    const float lsum = l[r] * c0 + l1 * c1;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    if (row >= nq) continue;
    if (lse && t == 0)  // natural log: ln 2 * (m + log2 l), m in log2 units
      lse[((long long)b * Hq + h) * Tq + q0 + row] =
          lsum > 0.f ? (mm + log2f(lsum)) * LN2 : attn::NEG_INF;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 o1 =
          *reinterpret_cast<const float2*>(so + row * Cfg::O_PITCH + c);
      if (c < D)
        *reinterpret_cast<uint32_t*>(ob + (long long)row * Hq * D + c) =
            ptx::pack_bf16((acc[4 * j + 2 * r] * c0 + o1.x * c1) * inv,
                           (acc[4 * j + 2 * r + 1] * c0 + o1.y * c1) * inv);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, const void* lengths, int B, int Tq, int Tk,
               int Hq, int Hkv,
               long long q_sb, long long q_st, long long k_sb, long long k_st,
               long long v_sb, long long v_st, int causal, int q_offset,
               int window, float scale, cudaStream_t stream) {
  static const cudaError_t attr = attn::allow_smem(flash_f32<D>);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  const size_t bytes = attn::Smem<D>::floats(BQ) * sizeof(float);
  flash_f32<D><<<grid, attn::NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const int*>(lengths), Tq, Tk,
      Hq, Hq / Hkv, q_sb, q_st, k_sb, k_st, v_sb, v_st, causal, q_offset,
      window, scale);
  return int(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, const void* lengths, int B, int Tq, int Tk,
               int Hq, int Hkv,
                long long q_sb, long long q_st, long long k_sb, long long k_st,
                long long v_sb, long long v_st, int causal, int q_offset,
                int window, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  static const cudaError_t attr = attn::allow_smem(flash_bf16<D>);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((Tq + BM - 1) / BM, Hq, B);
  flash_bf16<D><<<grid, NTB, WgCfg<D>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(lengths), Tq, Tk,
      Hq, Hq / Hkv, q_sb, q_st, k_sb, k_st, v_sb, v_st, causal, q_offset,
      window, scale);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head and
// feature axes must be dense (stride D and 1).  `o` is a dense
// (B,Tq,Hq,D) tensor; `lse`, null or a dense fp32 (B,Hq,Tq) tensor, gets
// each row's log-sum-exp (see the top).  `lengths` may be null: every key
// is valid (the encoder's and the cross-attention's calls), and no lengths
// tensor has to be made and copied to the card for them.  Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_fwd(
    int dtype, int D, const void* q, const void* k, const void* v, void* o,
    void* lse, const void* lengths, int B, int Tq, int Tk, int Hq, int Hkv,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, int causal, int q_offset, int window,
    float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ATTN_DISPATCH_D(D, return launch_f32<D>(
        q, k, v, o, lse, lengths, B, Tq, Tk, Hq, Hkv, q_sb, q_st, k_sb, k_st,
        v_sb, v_st, causal, q_offset, window, scale, st))
  } else if (dtype == 1) {
    ATTN_DISPATCH_D(D, return launch_bf16<D>(
        q, k, v, o, lse, lengths, B, Tq, Tk, Hq, Hkv, q_sb, q_st, k_sb, k_st,
        v_sb, v_st, causal, q_offset, window, scale, st))
  }
  return int(cudaErrorInvalidValue);
}
