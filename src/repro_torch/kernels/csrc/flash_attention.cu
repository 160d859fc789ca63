// Flash attention (prefill / training forward) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at :134, body `_kernel`
// at :40-95): q (B,Tq,Hq,D), k/v (B,Tk,Hkv,D), output in q's dtype, online
// softmax (m, l, acc) in fp32, causal `kpos <= q_offset + qpos`, window
// `kpos > qpos - window`, ragged `kpos < lengths[b]`, GQA head h -> h / G.
//
// What bounds it on the card: at long T the work is 4*T*T/2*D FLOPs per head
// against ~4*T*D bytes, far above the H100's ~295 FLOP/byte ridge, so a fast
// version is bound by tensor-core FLOPs.  This simple version is bound by
// its own instruction rate instead: scores and PV run as fp32 FMAs out of
// shared memory on the CUDA cores.  What the design does about it:
//   * one block per (q tile of BQ = 16 rows, q head, batch); the loop over kv
//     tiles inside the block replaces the TPU's sequential ("arbitrary") kv
//     grid axis, with (m, l, acc) in shared memory across iterations;
//   * whole kv tiles that fail the mask are skipped with the TPU kernel's own
//     test (`run` at :63-66), so causal prefill does about half the work and
//     a windowed layer only its band;
//   * (B,T,H,D) strides are read directly: no head-major transpose and no
//     padding of T; the ragged edges are masked instead.
// Tensor cores (wgmma), TMA and sharing K/V across the GQA group come later.

#include "attention_tile.cuh"

namespace {

constexpr int BQ = 16;

template <int D, typename T>
__global__ void __launch_bounds__(attn::NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             const int* __restrict__ lengths, int Tq, int Tk, int Hq, int G,
             long long q_sb, long long q_st, long long k_sb, long long k_st,
             long long v_sb, long long v_st, int causal, int q_offset,
             int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / G;
  const int nq = min(BQ, Tq - q0);
  attn::Smem<D> sm(smem, BQ);

  const T* qb = q + b * q_sb + (long long)q0 * q_st + (long long)h * D;
  for (int i = threadIdx.x; i < BQ * D; i += attn::NT) {
    const int r = i / D, c = i % D;
    sm.q[i] = r < nq ? attn::to_f(qb[r * q_st + c]) : 0.f;
  }
  sm.init_state(BQ);
  __syncthreads();

  const long long length = min(lengths[b], Tk);
  const long long q_lo = (long long)q_offset + q0;  // first absolute q pos
  const long long q_hi = q_lo + BQ - 1;
  const long long win = window;
  auto valid = [=](int r, long long kpos) {
    const long long qpos = q_lo + r;
    return kpos < length && (!causal || kpos <= qpos) && kpos > qpos - win;
  };
  const T* kb = k + b * k_sb + (long long)hk * D;
  const T* vb = v + b * v_sb + (long long)hk * D;
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
  T* ob = o + ((long long)b * Tq + q0) * Hq * D + (long long)h * D;
  attn::store_rows<D>(sm, ob, (long long)Hq * D, nq);
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* lengths, int B, int Tq, int Tk, int Hq, int Hkv,
           long long q_sb, long long q_st, long long k_sb, long long k_st,
           long long v_sb, long long v_st, int causal, int q_offset,
           int window, float scale, cudaStream_t stream) {
  static const cudaError_t attr = attn::allow_smem(flash_kernel<D, T>);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  const size_t bytes = attn::Smem<D>::floats(BQ) * sizeof(float);
  flash_kernel<D, T><<<grid, attn::NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(lengths), Tq, Tk, Hq, Hq / Hkv, q_sb, q_st,
      k_sb, k_st, v_sb, v_st, causal, q_offset, window, scale);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head and
// feature axes must be dense (stride D and 1).  `o` is a dense
// (B,Tq,Hq,D) tensor.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(
    int dtype, int D, const void* q, const void* k, const void* v, void* o,
    const void* lengths, int B, int Tq, int Tk, int Hq, int Hkv,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, int causal, int q_offset, int window,
    float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ATTN_DISPATCH_D(D, return launch<D, float>(
        q, k, v, o, lengths, B, Tq, Tk, Hq, Hkv, q_sb, q_st, k_sb, k_st,
        v_sb, v_st, causal, q_offset, window, scale, st))
  } else if (dtype == 1) {
    ATTN_DISPATCH_D(D, return launch<D, __nv_bfloat16>(
        q, k, v, o, lengths, B, Tq, Tk, Hq, Hkv, q_sb, q_st, k_sb, k_st,
        v_sb, v_st, causal, q_offset, window, scale, st))
  }
  return int(cudaErrorInvalidValue);
}
