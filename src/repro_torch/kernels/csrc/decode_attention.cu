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
//     split.  The combine kernel, one block per (q head, batch), merges them:
//     out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30).  A
//     split with no valid key writes m = -1e30, l = 0, acc = 0, and a row
//     whose every split is empty comes out 0, never NaN;
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

constexpr int MAX_SPLITS = 256;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One block per (q head, batch) row merges its ns partials.  `acc` (rows,
// ns, D) in TA; `ml` (rows, ns, 2) running max and sum, or, with
// `from_lse`, (rows, ns) log-sum-exps of normalised partials (l = 1, or 0
// for NEG_INF).  Writes the row's output and, where `lse` is given, its
// log-sum-exp M + log(den) (NEG_INF when every partial is empty).
template <typename TA, typename T>
__global__ void __launch_bounds__(attn::NT)
decode_combine(const TA* __restrict__ acc, const float* __restrict__ ml,
               T* __restrict__ o, float* __restrict__ lse, int ns, int D,
               bool from_lse) {
  __shared__ float w[MAX_SPLITS];  // e^(m_s - M) of the splits with a key
  __shared__ int live[MAX_SPLITS];  // and their numbers
  __shared__ int n_live;
  __shared__ float inv;
  const long long row = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const int mstride = from_lse ? 1 : 2;
  const float* m = ml + row * ns * mstride;
  if (threadIdx.x < 32) {
    // warp 0: M, the weights and the denominator.  A split with a key has
    // l >= 1 (its largest score gives p = 1); an empty one has l = 0 and
    // acc = 0, adds nothing and is left out of the column sums.
    const int lane = threadIdx.x;
    float M = attn::NEG_INF;
    for (int s = lane; s < ns; s += 32) M = fmaxf(M, m[mstride * s]);
#pragma unroll
    for (int x = 16; x > 0; x >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, x));
    float den = 0.f;
    int count = 0;
    for (int s0 = 0; s0 < ns; s0 += 32) {
      const int s = s0 + lane;
      float ls = 0.f;
      if (s < ns)
        ls = from_lse ? (m[s] > 0.5f * attn::NEG_INF ? 1.f : 0.f)
                      : m[2 * s + 1];
      const unsigned has = __ballot_sync(0xffffffffu, ls > 0.f);
      if (ls > 0.f) {
        const int at = count + __popc(has & ((1u << lane) - 1u));
        w[at] = expf(m[mstride * s] - M);
        live[at] = s;
        den += w[at] * ls;
      }
      count += __popc(has);
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, x);
    if (lane == 0) {
      n_live = count;
      inv = 1.f / fmaxf(den, 1e-30f);  // every split empty: the row is 0
      if (lse != nullptr)
        lse[row] = count > 0 ? M + logf(den) : attn::NEG_INF;
    }
  }
  __syncthreads();
  const int nl = n_live;
  const TA* a = acc + row * ns * D;
  for (int c = 2 * threadIdx.x; c < D; c += 2 * attn::NT) {
    float x0 = 0.f, x1 = 0.f;
#pragma unroll 8
    for (int i = 0; i < nl; ++i) {
      const float2 p = load2(a + live[i] * D + c);
      x0 += w[i] * p.x;
      x1 += w[i] * p.y;
    }
    o[row * D + c] = attn::from_f<T>(x0 * inv);
    o[row * D + c + 1] = attn::from_f<T>(x1 * inv);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, const void* lengths, Partials part, int B, int S,
           int Hq, int Hkv, long long q_sb, long long k_sb, long long k_st,
           long long v_sb, long long v_st, int window, long long k_offset,
           float scale, cudaStream_t stream) {
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
  decode_combine<float, T><<<dim3(Hq, B), attn::NT, 0, stream>>>(
      part.acc, part.ml, static_cast<T*>(o), lse, part.ns, D, false);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head and
// feature axes must be dense (stride D and 1), and q's heads too.  `o` is a
// dense (B,1,Hq,D) tensor; `lse`, if not null, a dense (B,Hq) fp32 tensor
// that receives each row's log-sum-exp; `part_acc` (B,Hq,n_splits,D) and
// `part_ml` (B,Hq,n_splits,2) are fp32 scratch.  The cache's row 0 is the
// global position k_offset (0 for a whole cache).  Two launches (split,
// combine); returns the first non-zero cudaGetLastError() after them.
extern "C" int decode_attention_fwd(
    int dtype, int D, const void* q, const void* k, const void* v, void* o,
    void* lse, const void* lengths, void* part_acc, void* part_ml,
    int n_splits, int B, int S, int Hq, int Hkv, long long q_sb,
    long long k_sb, long long k_st, long long v_sb, long long v_st,
    int window, long long k_offset, float scale, void* stream) {
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
        v_st, window, k_offset, scale, st))
  } else if (dtype == 1) {
    ATTN_DISPATCH_D(D, return launch<D, __nv_bfloat16>(
        q, k, v, o, l, lengths, part, B, S, Hq, Hkv, q_sb, k_sb, k_st, v_sb,
        v_st, window, k_offset, scale, st))
  }
  return int(cudaErrorInvalidValue);
}

// The merge of R ranks' results over a cache split along the sequence:
// `parts` (B,Hq,R,D) the ranks' normalised outputs in dtype, `lses`
// (B,Hq,R) fp32 their log-sum-exps (NEG_INF for a rank with no valid key);
// `o` (B,1,Hq,D) in dtype and, if not null, `lse` (B,Hq) fp32.  One launch
// of the combine kernel, each rank one partial.
extern "C" int decode_attention_merge(int dtype, int D, const void* parts,
                                      const void* lses, void* o, void* lse,
                                      int R, int B, int Hq, void* stream) {
  if (B <= 0 || Hq <= 0 || R <= 0 || R > MAX_SPLITS || D % 2 != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hq, B);
  const float* ml = static_cast<const float*>(lses);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    decode_combine<float, float><<<grid, attn::NT, 0, st>>>(
        static_cast<const float*>(parts), ml, static_cast<float*>(o), l, R,
        D, true);
  } else if (dtype == 1) {
    decode_combine<__nv_bfloat16, __nv_bfloat16><<<grid, attn::NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(parts), ml,
        static_cast<__nv_bfloat16*>(o), l, R, D, true);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
