// Decode attention (one new token per sequence against the KV cache) for
// sm_90a, split over the SMs (flash-decoding).
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (pallas_call at :104, body `_kernel`
// at :33-74): q (B,1,Hq,D), caches (B,S,Hkv,D), lengths (B,), output
// (B,1,Hq,D); mask `length - window <= kpos < length`; the whole GQA group
// of G = Hq/Hkv queries is processed with each kv head.
//
// What bounds it on the card: each cache byte is used for about 2*G FLOPs,
// far below the H100's ~295 FLOP/byte ridge, so it is bound by the bytes of
// K and V it must read: 2 * valid_len * Hkv * D * sizeof(T) per sequence.
// At serving shapes that is a megabyte or so, under a microsecond at
// 3.35 TB/s, so what counts is how many SMs read at once and how soon.
// What the design does about it:
//   * two launches.  The split kernel's grid is (n_splits, Hkv, B): block
//     (s, hk, b) takes the s-th equal share, in whole tiles of BK = 32
//     keys, of its sequence's own valid range [max(0, len - window),
//     min(len, S)), so short sequences and windowed layers spread over the
//     SMs too.  It writes fp32 partials (m, l, acc) per query head and
//     split.  The combine kernel merges them:
//     out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30).  A
//     split with no valid key writes m = -1e30, l = 0, acc = 0, and a row
//     whose every split is empty comes out 0, never NaN;
//   * the combine moves a few bytes per FLOP and little in all (1 MiB of
//     partials at gemma-2b's serving shape, already in L2), so what bounds
//     it is latency: how many 16-byte loads are in flight and how many
//     trips to memory a row takes.  A warp owns a run of 16-byte columns of
//     one row; its lanes split the row's partials between them, each lane
//     issuing all its loads at once (one trip to memory); M and the
//     denominator come from the lane's own splits or from shuffles, and
//     each column sums its partials in ascending split order, passed
//     between the lanes through the warp's share of shared memory where
//     they split a column.  No block-wide barrier.  The arithmetic is
//     fixed operation for operation (decode_combine), so the output is the
//     same bits for any grid.  The grid
//     (decode_attention.combine_plan, from the shapes alone) spreads a
//     few rows over the SMs by narrower runs and packs many rows into a
//     block of up to 4 warps;
//   * n_splits comes from the shapes alone (the wrapper's split_plan), never
//     from the values in `lengths`, so no host sync is needed;
//   * a rank's share of a cache split over the sequence (tensor-parallel
//     serving): `k_offset` is the global position of the share's first row,
//     and the valid local range is the global one shifted by it and clamped
//     to [0, S).  The combine can write each row's log-sum-exp (fp32;
//     NEG_INF for a row with no valid key), and a second entry point,
//     decode_attention_merge, runs the same combine kernel over the ranks'
//     (out, lse), each rank one partial with m = lse and l = 1 (l = 0 when
//     it had no key);
//   * bf16: K/V tiles stay bf16 in shared memory, two stages filled by
//     cp.async, so the next tile is in flight while this one is computed.
//     The G <= 16 queries of the group are the rows of one mma.sync
//     m16n8k16 A tile (groups of 16 rows in turn when G > 16); each warp
//     scores 8 keys of the tile, and for PV each warp owns a quarter of the
//     output columns, with P (bf16) shared through shared memory;
//   * fp32: the same split grid and combine, with the scalar fp32 tile of
//     attention_tile.cuh (tensor cores would not hold the fp32 tolerance).

#include <type_traits>

#include "attention_tile.cuh"

namespace {

constexpr int BK = attn::BK;  // keys per tile; the split plan counts these
constexpr int MR = 16;        // query rows of one mma tile

// Keys [a, b) of split s of ns over the valid range [lo, hi): whole tiles
// of BK keys counted from lo, split as evenly as floor division allows.
// The range is the global [max(0, len - window), len) shifted by the
// share's first position k_offset and clamped to the share's S rows.
// The wrapper's plain version (ref.decode_attention_split) does the same.
__device__ __forceinline__ long long clamp_rows(long long x, int S) {
  return min(max(x, 0LL), (long long)S);
}

__device__ __forceinline__ void split_range(long long length, int S,
                                            int window, long long k_offset,
                                            int s, int ns, long long& a,
                                            long long& b) {
  const long long lo =
      clamp_rows(max(0LL, length - (long long)window) - k_offset, S);
  const long long hi = clamp_rows(length - k_offset, S);
  const long long tiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  a = lo + tiles * s / ns * BK;
  b = min(hi, lo + tiles * (s + 1) / ns * BK);
}

struct Partials {
  float* acc;  // (B, Hq, ns, D) unnormalised output
  float* ml;   // (B, Hq, ns, 2) running max and sum
  int ns;
  __device__ long long row(int b, int Hq, int h, int s) const {
    return ((long long)b * Hq + h) * ns + s;
  }
};

// ---- fp32: scalar tile over one split --------------------------------------

template <int D>
__global__ void __launch_bounds__(attn::NT)
decode_split_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, Partials part,
                 const int* __restrict__ lengths, int S, int Hq, int G,
                 long long q_sb, long long k_sb, long long k_st,
                 long long v_sb, long long v_st, int window,
                 long long k_offset, float scale) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  attn::Smem<D> sm(smem, G);

  const float* qb = q + b * q_sb + (long long)hk * G * D;
  for (int i = threadIdx.x; i < G * D; i += attn::NT) sm.q[i] = qb[i];
  sm.init_state(G);
  __syncthreads();

  long long ka, kb_;
  split_range(lengths[b], S, window, k_offset, s, part.ns, ka, kb_);
  auto valid = [=](int, long long kpos) { return kpos >= ka && kpos < kb_; };
  const float* kb = k + b * k_sb + (long long)hk * D;
  const float* vb = v + b * v_sb + (long long)hk * D;
  for (long long k0 = ka; k0 < kb_; k0 += BK) {
    const int n = (int)min((long long)BK, kb_ - k0);
    attn::load_rows<D>(sm.k, D + 1, kb + k0 * k_st, k_st, n);
    attn::load_rows<D>(sm.v, D, vb + k0 * v_st, v_st, n);
    __syncthreads();
    attn::attend_tile<D>(sm, G, k0, scale, valid);
  }
  for (int i = threadIdx.x; i < G * D; i += attn::NT) {
    const int r = i / D, c = i % D;
    part.acc[part.row(b, Hq, hk * G + r, s) * D + c] = sm.acc[i];
  }
  for (int r = threadIdx.x; r < G; r += attn::NT) {
    const long long o = part.row(b, Hq, hk * G + r, s) * 2;
    part.ml[o] = sm.m[r];
    part.ml[o + 1] = sm.l[r];
  }
}

// ---- bf16: mma.sync tile over one split ------------------------------------

template <int D>
struct DecodeSmem {
  static constexpr int P = D + 8;       // row pitch: conflict-free ldmatrix
  static constexpr int PP = BK + 8;     // pitch of the P tile
  static constexpr size_t bytes =
      2 * (size_t(MR) * P + 4 * size_t(BK) * P + size_t(MR) * PP) +
      4 * (size_t(MR) * BK + 3 * MR);
};

template <int D>
__global__ void __launch_bounds__(attn::NT)
decode_split_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, Partials part,
                  const int* __restrict__ lengths, int S, int Hq, int G,
                  long long q_sb, long long k_sb, long long k_st,
                  long long v_sb, long long v_st, int window,
                  long long k_offset, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int P = DecodeSmem<D>::P, PP = DecodeSmem<D>::PP;
  constexpr int NT8 = D / 8;            // 8-column tiles of the output
  constexpr int PER = (NT8 + 3) / 4;    // of them per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [MR][P]
  bf16* sk = sq + MR * P;                         // [2][BK][P]
  bf16* sv = sk + 2 * BK * P;                     // [2][BK][P]
  bf16* sp = sv + 2 * BK * P;                     // [MR][PP]
  float* ss = reinterpret_cast<float*>(sp + MR * PP);  // [MR][BK] scores
  float* s_m = ss + MR * BK;
  float* s_l = s_m + MR;
  float* s_c = s_l + MR;

  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  long long ka, kb_;
  split_range(lengths[b], S, window, k_offset, s, part.ns, ka, kb_);
  const int ntile = (int)((kb_ - ka + BK - 1) / BK);  // 0 when empty
  const bf16* kb = k + b * k_sb + (long long)hk * D + ka * k_st;
  const bf16* vb = v + b * v_sb + (long long)hk * D + ka * v_st;
  auto load_kv = [&](int it, int st) {
    const int n = (int)min((long long)BK, kb_ - ka - (long long)it * BK);
    attn::load_rows_async<BK, D, P>(sk + st * BK * P, kb + it * BK * k_st,
                                    k_st, n);
    attn::load_rows_async<BK, D, P>(sv + st * BK * P, vb + it * BK * v_st,
                                    v_st, n);
  };

  for (int g0 = 0; g0 < G; g0 += MR) {
    const int rows = min(MR, G - g0);
    const bf16* qb = q + b * q_sb + ((long long)hk * G + g0) * D;
    attn::load_rows_async<MR, D, P>(sq, qb, D, rows);
    if (ntile > 0) load_kv(0, 0);
    ptx::cp_async_commit();
    if (tid < MR) {
      s_m[tid] = attn::NEG_INF;
      s_l[tid] = 0.f;
    }
    float acc[PER][4];
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

    for (int it = 0; it < ntile; ++it) {
      const int st = it & 1;
      if (it + 1 < ntile) {
        load_kv(it + 1, st ^ 1);
        ptx::cp_async_commit();
        ptx::cp_async_wait<1>();
      } else {
        ptx::cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* skt = sk + st * BK * P;
      const bf16* svt = sv + st * BK * P;

      // scores: warp w takes keys 8w..8w+7 of the tile
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], bb[2];
        ptx::ldmatrix_x4(a, sq + (lane & 15) * P + kk * 16 + (lane >> 4) * 8);
        ptx::ldmatrix_x2(bb, skt + (warp * 8 + (lane & 7)) * P + kk * 16 +
                                 ((lane >> 3) & 1) * 8);
        ptx::mma_bf16_16816(sc, a, bb);
      }
      const int nval = (int)min((long long)BK, kb_ - ka - (long long)it * BK);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = warp * 8 + 2 * t + (e & 1), r = g + 8 * (e >> 1);
        ss[r * BK + j] = j < nval ? sc[e] * scale : attn::NEG_INF;
      }
      __syncthreads();

      // online softmax: 8 threads per row, 4 keys each
      {
        const int r = tid >> 3, c0 = (tid & 7) * 4;
        float x[4], mx = attn::NEG_INF;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = ss[r * BK + c0 + e];
          mx = fmaxf(mx, x[e]);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = s_m[r];
        const float m_new = fmaxf(m_prev, mx);
        float p[4], sum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = c0 + e < nval ? expf(x[e] - m_new) : 0.f;
          sum += p[e];
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        uint32_t* pr = reinterpret_cast<uint32_t*>(sp + r * PP + c0);
        pr[0] = ptx::pack_bf16(p[0], p[1]);
        pr[1] = ptx::pack_bf16(p[2], p[3]);
        if ((tid & 7) == 0) {
          const float c = expf(m_prev - m_new);
          s_c[r] = c;
          s_l[r] = s_l[r] * c + sum;
          s_m[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * corr + P V over this warp's output columns
      const float c_lo = s_c[g], c_hi = s_c[g + 8];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        acc[i][0] *= c_lo;
        acc[i][1] *= c_lo;
        acc[i][2] *= c_hi;
        acc[i][3] *= c_hi;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        ptx::ldmatrix_x4(a, sp + (lane & 15) * PP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int j = warp + 4 * i;
          if (j < NT8) {
            uint32_t bb[2];
            ptx::ldmatrix_x2_trans(bb, svt + (kk * 16 + (lane & 15)) * P +
                                           j * 8);
            ptx::mma_bf16_16816(acc[i], a, bb);
          }
        }
      }
      __syncthreads();  // the stage and the P tile are rewritten next
    }
    ptx::cp_async_wait<0>();  // q's copy, when no tile ran

    // partials of rows g0..g0+rows-1
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = warp + 4 * i;
      if (j >= NT8) continue;
      const int c = j * 8 + 2 * t;
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int r = g + 8 * hlf;
        if (r < rows) {
          float* dst = part.acc + part.row(b, Hq, hk * G + g0 + r, s) * D + c;
          dst[0] = acc[i][2 * hlf];
          dst[1] = acc[i][2 * hlf + 1];
        }
      }
    }
    if (tid < rows) {
      const long long o = part.row(b, Hq, hk * G + g0 + tid, s) * 2;
      part.ml[o] = s_m[tid];
      part.ml[o + 1] = s_l[tid];
    }
    __syncthreads();  // sq and the row state are reused by the next group
  }
}

// ---- combine ---------------------------------------------------------------

constexpr int MAX_SPLITS = 256;  // splits of the plan, or ranks of a merge
constexpr int CK = 8;            // 16-byte partial loads a lane keeps in flight
constexpr int COMBINE_WARPS = 4;  // most warps in a combine block

// 16 bytes of partials: one load of four 32-bit words, then N fp32
// values.  The two steps are apart so that a lane issues all its loads
// before it uses any.
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
template <typename TA> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(uint4 r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ void unpack(uint4 r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// y += e * the split's 16 bytes, for a split with a key (e >= 0; an empty
// split has e = -1 and adds nothing)
template <typename TA>
__device__ __forceinline__ void add_split(float e, uint4 v,
                                          float (&y)[Vec16<TA>::N]) {
  float x[Vec16<TA>::N];
  Vec16<TA>::unpack(v, x);
#pragma unroll
  for (int j = 0; j < Vec16<TA>::N; ++j)
    y[j] = e >= 0.f ? fmaf(e, x[j], y[j]) : y[j];
}

// N output values in one store: 16 bytes (4 fp32, 8 bf16) or 8 (4 bf16).
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* x) {
  if constexpr (std::is_same<T, float>::value) {
    static_assert(N == 4, "fp32 output from fp32 partials");
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(ptx::pack_bf16(x[0], x[1]), ptx::pack_bf16(x[2], x[3]),
                   ptx::pack_bf16(x[4], x[5]), ptx::pack_bf16(x[6], x[7]));
  } else {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(ptx::pack_bf16(x[0], x[1]), ptx::pack_bf16(x[2], x[3]));
  }
}

// Merges each row's `ns` partials: `acc` (rows, ns, D) in TA; `ml` (rows,
// ns, 2) running max and sum, or, with FROM_LSE, (rows, ns) log-sum-exps of
// normalised partials (l = 1, or 0 for NEG_INF).  Writes each row's output
// and, where `lse` is given, its log-sum-exp M + log(den) (NEG_INF when
// every partial is empty).
//
// The arithmetic, which the grid does not change (the output is the same
// bits for any combine_plan): M = max_s m_s; each split with a key (l >=
// 1; an empty one has l = 0 and adds nothing) weighs w_s = e^(m_s - M);
// den sums w_s l_s, lane j of 32 over splits j, j + 32, ... in turn, then
// across the lanes by a butterfly (16, 8, 4, 2, 1); each output value sums
// w_s acc_s over the splits in ascending order, then times 1 / max(den,
// 1e-30), so a row whose every split is empty comes out 0.
//
// The grid: a row's D values are `nv` columns of 16 bytes.  Warp w (block
// b's warp j is w = b * warps + j) takes row w / (nv / chunk) and its
// (w % (nv / chunk))-th run of `chunk` columns; lane l takes column
// l % chunk of the run and loads the partials l / chunk, l / chunk + g,
// ... of it, g = 32 / chunk (decode_attention.combine_lanes walks the same
// mapping).  Each lane issues all its loads first, so a row is one trip to
// memory.  No block-wide barrier.  Where one lane holds all its column's
// splits (g = 1, ns <= CK: the merge's ranks, a few splits) M, den and the
// sums are its own, with no exchange; otherwise M and den come from the
// (m, l) of splits l, l + 32, ... and shuffles, and where the lanes of a
// column split its partials (g > 1) they pass them through the warp's
// share of shared memory, CK splits a lane at a time.
template <typename TA, typename T, bool FROM_LSE>
__global__ void __launch_bounds__(32 * COMBINE_WARPS)
decode_combine(const TA* __restrict__ acc, const float* __restrict__ ml,
               T* __restrict__ o, float* __restrict__ lse, long long rows,
               int ns, int nv, int chunk) {
  using V = Vec16<TA>;
  constexpr int N = V::N;
  constexpr int MK = MAX_SPLITS / 32;  // (m, l) pairs a lane reads for M
  constexpr unsigned FULL = 0xffffffffu;
  // where g > 1, each warp's 32 * CK partials and their weights on their
  // way between the lanes
  extern __shared__ uint4 stage_all[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  uint4* stage = stage_all + wib * 32 * CK;
  float* stage_w = reinterpret_cast<float*>(stage_all + (blockDim.x >> 5) *
                                            32 * CK) + wib * 32 * CK;
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
  const int runs = nv / chunk;
  const long long row = w / runs;
  if (row >= rows) return;  // a whole warp past the last row
  const int run = (int)(w - row * runs);
  const int cl = lane & (chunk - 1), grp = lane / chunk;
  const int g = 32 / chunk;  // lanes of a column, each loading its splits
  const bool local = g == 1 && ns <= CK;  // a lane holds all its splits
  const int D = nv * N;
  const TA* a = acc + row * ns * D + (run * chunk + cl) * N;
  const float* m = ml + row * ns * (FROM_LSE ? 1 : 2);
  auto ml_at = [&](int s, float& ms, float& ls) {
    if constexpr (FROM_LSE) {
      ms = __ldg(m + s);
      ls = 1.f;  // set from ms once it is in
    } else {
      const float2 p = __ldg(reinterpret_cast<const float2*>(m) + s);
      ms = p.x;
      ls = p.y;
    }
  };
  auto live = [](float ms, float ls) {
    return FROM_LSE ? ms > 0.5f * attn::NEG_INF : ls > 0.f;
  };

  // this lane's splits s0 + grp + g * i: their partials and (m, l)
  uint4 raw[CK];
  float ms[CK], ls[CK];
  auto load_own = [&](int s0) {
#pragma unroll
    for (int i = 0; i < CK; ++i)
      if (s0 + grp + i * g < ns)
        raw[i] = load16(a + (long long)(s0 + grp + i * g) * D);
#pragma unroll
    for (int i = 0; i < CK; ++i) {
      ms[i] = attn::NEG_INF;
      ls[i] = 0.f;
      if (s0 + grp + i * g < ns) ml_at(s0 + grp + i * g, ms[i], ls[i]);
    }
  };
  load_own(0);
  // and, unless it holds them all, the row's (m, l), lane-parallel
  float mr[MK], lr[MK];
#pragma unroll
  for (int k = 0; k < MK; ++k) {
    mr[k] = attn::NEG_INF;
    lr[k] = 0.f;
    if (!local && lane + 32 * k < ns) ml_at(lane + 32 * k, mr[k], lr[k]);
  }

  float M = attn::NEG_INF, den = 0.f;
  float wt[CK];  // this lane's splits' weights; -1 for an empty split
  auto weigh = [&]() {  // every exp taken, no branch: they overlap
#pragma unroll
    for (int i = 0; i < CK; ++i) {
      const float e = expf(ms[i] - M);
      wt[i] = live(ms[i], ls[i]) ? e : -1.f;
    }
  };
  if (local) {
    // the butterfly over lanes 0..CK-1, the others holding 0
    static_assert(CK == 8, "the local butterfly is written for 8 splits");
#pragma unroll
    for (int i = 0; i < CK; ++i) M = fmaxf(M, ms[i]);
    weigh();
    float d[CK];
#pragma unroll
    for (int i = 0; i < CK; ++i)
      d[i] = wt[i] >= 0.f ? fmaf(wt[i], ls[i], 0.f) : 0.f;
    den = ((d[0] + d[4]) + (d[2] + d[6])) + ((d[1] + d[5]) + (d[3] + d[7]));
  } else {
#pragma unroll
    for (int k = 0; k < MK; ++k) M = fmaxf(M, mr[k]);
#pragma unroll
    for (int x = 16; x > 0; x >>= 1)
      M = fmaxf(M, __shfl_xor_sync(FULL, M, x));
#pragma unroll
    for (int k = 0; k < MK; ++k) {
      if constexpr (FROM_LSE) lr[k] = live(mr[k], 0.f) ? 1.f : 0.f;
      const float e = expf(mr[k] - M);
      den = lr[k] > 0.f ? fmaf(e, lr[k], den) : den;
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) den += __shfl_xor_sync(FULL, den, x);
    weigh();
  }

  // each column's sum over the live splits in ascending order
  float y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) y[j] = 0.f;
  for (int s0 = 0; s0 < ns; s0 += g * CK) {
    if (s0 > 0) {
      load_own(s0);
      weigh();
    }
    if (g == 1) {
#pragma unroll
      for (int i = 0; i < CK; ++i)
        if (s0 + i < ns) add_split<TA>(wt[i], raw[i], y);
      continue;
    }
    // splits s0 + t, t = i * g + grp, through shared memory
#pragma unroll
    for (int i = 0; i < CK; ++i) {
      stage[(i * g + grp) * chunk + cl] = raw[i];
      if (cl == 0) stage_w[i * g + grp] = wt[i];
    }
    __syncwarp();
    const int nt = min(g * CK, ns - s0);
    for (int t = 0; t < nt; ++t)
      add_split<TA>(stage_w[t], stage[t * chunk + cl], y);
    __syncwarp();  // read before the next splits are written
  }
  if (grp == 0) {
    const float inv = 1.f / fmaxf(den, 1e-30f);  // every split empty: 0
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] *= inv;
    store_vec<T, N>(o + row * D + (run * chunk + cl) * N, y);
  }
  if (lse != nullptr && run == 0 && lane == 0)
    lse[row] = den > 0.f ? M + logf(den) : attn::NEG_INF;
}

// The combine's launch from decode_attention.combine_plan: `chunk` columns
// of 16 bytes a warp (a power of two, at most 32, dividing the row's nv),
// `warps` warps a block.  Returns the launch's cudaGetLastError().
template <typename TA, typename T, bool FROM_LSE>
int launch_combine(const TA* acc, const float* ml, T* o, float* lse,
                   long long rows, int ns, int D, int chunk, int warps,
                   cudaStream_t stream) {
  constexpr int N = Vec16<TA>::N;
  if (D % N != 0 || chunk < 1 || chunk > 32 || (chunk & (chunk - 1)) ||
      (D / N) % chunk != 0 || warps < 1 || warps > COMBINE_WARPS)
    return int(cudaErrorInvalidValue);
  const int nv = D / N;
  const long long blocks = (rows * (nv / chunk) + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  // the staging buffers, used where the lanes of a column split its partials
  const size_t smem =
      chunk < 32 ? size_t(warps) * 32 * CK * (sizeof(uint4) + sizeof(float))
                 : 0;
  decode_combine<TA, T, FROM_LSE>
      <<<(unsigned)blocks, 32 * warps, smem, stream>>>(acc, ml, o, lse, rows,
                                                      ns, nv, chunk);
  return int(cudaGetLastError());
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, const void* lengths, Partials part, int B, int S,
           int Hq, int Hkv, long long q_sb, long long k_sb, long long k_st,
           long long v_sb, long long v_st, int window, long long k_offset,
           float scale, int chunk, int warps, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const dim3 grid(part.ns, Hkv, B);
  if constexpr (std::is_same<T, float>::value) {
    static const cudaError_t attr = attn::allow_smem(decode_split_f32<D>);
    if (attr != cudaSuccess) return int(attr);
    const size_t bytes = attn::Smem<D>::floats(G) * sizeof(float);
    if (bytes > size_t(attn::MAX_SMEM)) return int(cudaErrorInvalidValue);
    decode_split_f32<D><<<grid, attn::NT, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), part, static_cast<const int*>(lengths),
        S, Hq, G, q_sb, k_sb, k_st, v_sb, v_st, window, k_offset, scale);
  } else {
    static const cudaError_t attr = attn::allow_smem(decode_split_bf16<D>);
    if (attr != cudaSuccess) return int(attr);
    decode_split_bf16<D><<<grid, attn::NT, DecodeSmem<D>::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), part, static_cast<const int*>(lengths), S,
        Hq, G, q_sb, k_sb, k_st, v_sb, v_st, window, k_offset, scale);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return launch_combine<float, T, false>(
      part.acc, part.ml, static_cast<T*>(o), lse, (long long)B * Hq, part.ns,
      D, chunk, warps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head and
// feature axes must be dense (stride D and 1), and q's heads too.  `o` is a
// dense (B,1,Hq,D) tensor; `lse`, if not null, a dense (B,Hq) fp32 tensor
// that receives each row's log-sum-exp; `part_acc` (B,Hq,n_splits,D) and
// `part_ml` (B,Hq,n_splits,2) are fp32 scratch.  The cache's row 0 is the
// global position k_offset (0 for a whole cache).  `combine_chunk` and
// `combine_warps` are combine_plan's for B*Hq rows of n_splits partials.
// Two launches (split, combine); returns the first non-zero
// cudaGetLastError() after them.
extern "C" int decode_attention_fwd(
    int dtype, int D, const void* q, const void* k, const void* v, void* o,
    void* lse, const void* lengths, void* part_acc, void* part_ml,
    int n_splits, int combine_chunk, int combine_warps, int B, int S, int Hq,
    int Hkv, long long q_sb, long long k_sb, long long k_st, long long v_sb,
    long long v_st, int window, long long k_offset, float scale,
    void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || n_splits <= 0 ||
      n_splits > MAX_SPLITS)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Partials part{static_cast<float*>(part_acc),
                      static_cast<float*>(part_ml), n_splits};
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    ATTN_DISPATCH_D(D, return launch<D, float>(
        q, k, v, o, l, lengths, part, B, S, Hq, Hkv, q_sb, k_sb, k_st, v_sb,
        v_st, window, k_offset, scale, combine_chunk, combine_warps, st))
  } else if (dtype == 1) {
    ATTN_DISPATCH_D(D, return launch<D, __nv_bfloat16>(
        q, k, v, o, l, lengths, part, B, S, Hq, Hkv, q_sb, k_sb, k_st, v_sb,
        v_st, window, k_offset, scale, combine_chunk, combine_warps, st))
  }
  return int(cudaErrorInvalidValue);
}

// The merge of R ranks' results over a cache split along the sequence:
// `parts` (B,Hq,R,D) the ranks' normalised outputs in dtype, `lses`
// (B,Hq,R) fp32 their log-sum-exps (NEG_INF for a rank with no valid key);
// `o` (B,1,Hq,D) in dtype and, if not null, `lse` (B,Hq) fp32.  `parts`
// and `o` start on 16 bytes and D is a multiple of 16 bytes' elements;
// `chunk` and `warps` are combine_plan's for B*Hq rows of R partials.  One
// launch of the combine kernel, each rank one partial.
extern "C" int decode_attention_merge(int dtype, int D, const void* parts,
                                      const void* lses, void* o, void* lse,
                                      int R, int B, int Hq, int chunk,
                                      int warps, void* stream) {
  if (B <= 0 || Hq <= 0 || R <= 0 || R > MAX_SPLITS)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * Hq;
  const float* ml = static_cast<const float*>(lses);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_combine<float, float, true>(
        static_cast<const float*>(parts), ml, static_cast<float*>(o), l, rows,
        R, D, chunk, warps, st);
  if (dtype == 1)
    return launch_combine<__nv_bfloat16, __nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(parts), ml,
        static_cast<__nv_bfloat16*>(o), l, rows, R, D, chunk, warps, st);
  return int(cudaErrorInvalidValue);
}
