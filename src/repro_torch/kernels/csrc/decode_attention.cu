// Decode attention (one new token per sequence against the KV cache) for
// sm_90a.
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
// What the design does about it:
//   * one block per (kv head, batch) with the G queries together, as the
//     TPU kernel does (:95, :108), so every K/V tile is read from device
//     memory once for the whole group;
//   * the loop runs over [max(0, len - window), len) only, so a windowed
//     layer and a short sequence read only their valid positions;
//   * K/V tiles go through shared memory in fp32, one key per lane.
// With B * Hkv blocks the grid is small (4 of 132 SMs for gemma-2b at B=4):
// splitting the cache across SMs (flash-decoding) is a later change.

#include "attention_tile.cuh"

namespace {

template <int D, typename T>
__global__ void __launch_bounds__(attn::NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              const int* __restrict__ lengths, int S, int Hq, int G,
              long long q_sb, long long k_sb, long long k_st, long long v_sb,
              long long v_st, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, hk = blockIdx.x;
  attn::Smem<D> sm(smem, G);

  // the group's queries are G consecutive heads of one token
  const T* qb = q + b * q_sb + (long long)hk * G * D;
  for (int i = threadIdx.x; i < G * D; i += attn::NT)
    sm.q[i] = attn::to_f(qb[i]);
  sm.init_state(G);
  __syncthreads();

  const long long length = lengths[b];
  const long long lo = max(0LL, length - (long long)window);
  const long long hi = min(length, (long long)S);
  auto valid = [=](int, long long kpos) { return kpos >= lo && kpos < hi; };
  const T* kb = k + b * k_sb + (long long)hk * D;
  const T* vb = v + b * v_sb + (long long)hk * D;
  for (long long k0 = lo; k0 < hi; k0 += attn::BK) {
    const int n = (int)min((long long)attn::BK, hi - k0);
    attn::load_rows<D>(sm.k, D + 1, kb + k0 * k_st, k_st, n);
    attn::load_rows<D>(sm.v, D, vb + k0 * v_st, v_st, n);
    __syncthreads();
    attn::attend_tile<D>(sm, G, k0, scale, valid);
  }
  T* ob = o + (long long)b * Hq * D + (long long)hk * G * D;
  attn::store_rows<D>(sm, ob, D, G);
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* lengths, int B, int S, int Hq, int Hkv, long long q_sb,
           long long k_sb, long long k_st, long long v_sb, long long v_st,
           int window, float scale, cudaStream_t stream) {
  static const cudaError_t attr = attn::allow_smem(decode_kernel<D, T>);
  if (attr != cudaSuccess) return int(attr);
  const int G = Hq / Hkv;
  const size_t bytes = attn::Smem<D>::floats(G) * sizeof(float);
  if (bytes > size_t(attn::MAX_SMEM)) return int(cudaErrorInvalidValue);
  const dim3 grid(Hkv, B);
  decode_kernel<D, T><<<grid, attn::NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(lengths), S, Hq, G, q_sb, k_sb, k_st, v_sb,
      v_st, window, scale);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head and
// feature axes must be dense (stride D and 1), and q's heads too.  `o` is a
// dense (B,1,Hq,D) tensor.  Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_fwd(
    int dtype, int D, const void* q, const void* k, const void* v, void* o,
    const void* lengths, int B, int S, int Hq, int Hkv, long long q_sb,
    long long k_sb, long long k_st, long long v_sb, long long v_st,
    int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ATTN_DISPATCH_D(D, return launch<D, float>(
        q, k, v, o, lengths, B, S, Hq, Hkv, q_sb, k_sb, k_st, v_sb, v_st,
        window, scale, st))
  } else if (dtype == 1) {
    ATTN_DISPATCH_D(D, return launch<D, __nv_bfloat16>(
        q, k, v, o, lengths, B, S, Hq, Hkv, q_sb, k_sb, k_st, v_sb, v_st,
        window, scale, st))
  }
  return int(cudaErrorInvalidValue);
}
