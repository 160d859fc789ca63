// Mamba-2 SSM decode step for sm_90a: the state updated in place, read once
// and written once.
//
// Replaces no Pallas kernel: the JAX package runs this step outside Pallas
// too (src/repro/kernels/ops.py::ssd_decode_step, plain jnp), and the port
// ran it as plain PyTorch (ref.ssd_decode_step) and then copied the new
// state into the cache.  That passed over the state about eight times (dBx,
// h * dA and h_new each materialised, the readout's einsum reading h_new
// again, the copy reading and writing it) in ~15 launches.  Per row b, head
// h and head row p, in fp32:
//
//   dA          = exp(dt[b,h] * A[h])
//   xdt         = x[b,h,p] * dt[b,h]
//   h[b,h,p,:] <- h[b,h,p,:] * dA + B[b,:] * xdt        (where it was read)
//   y[b,h,p]    = sum_n h_new[b,h,p,n] * C[b,n] + D[h] * x[b,h,p]
//
// Each product and sum of the state is rounded as ref.ssd_decode_step
// rounds it (no fused multiply-add there), so the new state is the plain
// version's; the readout's sum runs in another order.  y is stored in x's
// dtype.
//
// What bounds it on the card: bytes.  The fp32 state is read once and
// written once, one multiply-add for every 8 of its bytes.  At
// granite-4.0-h-small's decode (256 rows, 128 heads of 64, d_state 128)
// that is 1.074 GB each way, 2.147 GB in 0.641 ms at 3.35 TB/s; x, B, C,
// dt, A, D and y are under 0.1% of it.  What the design does about that:
//   * A head row's n state columns are n/4 float4 chunks over L lanes, L
//     the power of two >= n/4 and at most 32 (K = 2 chunks a lane above
//     n = 128): 32 lanes a row at n = 128, 4 lanes and 8 rows a warp at
//     n = 16.  Head rows are contiguous, so a warp's 16-byte loads cover
//     512 contiguous bytes.
//   * Each thread loads U = 4 / K rows' chunks before it uses the first
//     (64 bytes), two rounds a block of 256 threads: 32 KB of state a
//     block, eight blocks and ~128 KB in flight an SM.
//   * State loads and stores are streaming (ld.global.cs, st.global.cs):
//     the state passes through the 50 MB L2 once a step.
//   * B[b,:] and C[b,:] are loaded into registers once a thread (a lane
//     keeps the same columns for every row it takes); dt, A and D are
//     loaded per row and hit L1.
//   * The readout's sum is a butterfly of warp shuffles over the row's L
//     lanes; the row's first lane adds D x and stores y.
//   * x, B, C and dt take their row (and head) strides, since the mixer
//     passes views into its conv output; the state takes its row and head
//     strides, its (hd, n) rows dense and on 16 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int ROUNDS = 2;      // rounds of U rows a thread, per block
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  float* h;
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  int nh, hd, n;
  long long shb, shh, sxb, sxh, sdb, sdh, sbb, scb;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// h * dA + b * xdt, each product and the sum rounded on its own
__device__ __forceinline__ float step(float h, float dA, float b, float xdt) {
  return __fadd_rn(__fmul_rn(h, dA), __fmul_rn(b, xdt));
}

template <typename T, int L, int K>
__global__ void __launch_bounds__(NT)
    ssd_decode_step_kernel(Args a) {
  constexpr int S = NT / L;             // rows a round of the block
  constexpr int U = 4 / K;              // rows a thread keeps in flight
  constexpr int RPB = S * U * ROUNDS;   // rows a block
  const int lane = threadIdx.x % L;
  const int slot = threadIdx.x / L;
  const int b = blockIdx.y;
  const int rows = a.nh * a.hd;
  const int c4 = a.n / 4;
  const T* x = static_cast<const T*>(a.x) + b * a.sxb;
  const T* Bp = static_cast<const T*>(a.B) + b * a.sbb;
  const T* Cp = static_cast<const T*>(a.C) + b * a.scb;
  const float* dt = a.dt + b * a.sdb;
  float* hb = a.h + b * a.shb;
  T* y = static_cast<T*>(a.y) + static_cast<long long>(b) * rows;

  float bv[K][4], cv[K][4];
  bool on[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + k * L;
    on[k] = c < c4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[k][j] = on[k] ? to_f(Bp[4 * c + j]) : 0.f;
      cv[k][j] = on[k] ? to_f(Cp[4 * c + j]) : 0.f;
    }
  }

  const int base = blockIdx.x * RPB;
#pragma unroll
  for (int round = 0; round < ROUNDS; ++round) {
    float4 s[U][K];
    float xv[U], dtv[U], av[U], dv[U];
    int row[U];
    bool ok[U];
    float* ptr[U];
    // every load of the round before the first use
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + (round * U + u) * S + slot;
      ok[u] = r < rows;
      row[u] = r;
      const int hh = ok[u] ? r / a.hd : 0;
      const int p = ok[u] ? r - hh * a.hd : 0;
      ptr[u] = hb + hh * a.shh + static_cast<long long>(p) * a.n;
      xv[u] = ok[u] ? to_f(x[hh * a.sxh + p]) : 0.f;
      dtv[u] = ok[u] ? dt[hh * a.sdh] : 0.f;
      av[u] = ok[u] ? a.A[hh] : 0.f;
      dv[u] = ok[u] ? a.D[hh] : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        s[u][k] = (ok[u] && on[k])
                      ? __ldcs(reinterpret_cast<const float4*>(
                            ptr[u] + 4 * (lane + k * L)))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float dA = expf(__fmul_rn(dtv[u], av[u]));
      const float xdt = __fmul_rn(xv[u], dtv[u]);
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float4 v = s[u][k];
        v.x = step(v.x, dA, bv[k][0], xdt);
        v.y = step(v.y, dA, bv[k][1], xdt);
        v.z = step(v.z, dA, bv[k][2], xdt);
        v.w = step(v.w, dA, bv[k][3], xdt);
        part = fmaf(v.x, cv[k][0], part);
        part = fmaf(v.y, cv[k][1], part);
        part = fmaf(v.z, cv[k][2], part);
        part = fmaf(v.w, cv[k][3], part);
        if (ok[u] && on[k])
          __stcs(reinterpret_cast<float4*>(ptr[u] + 4 * (lane + k * L)), v);
      }
      // every lane of the warp takes part, its row in range or not
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2)
        part += __shfl_xor_sync(FULL, part, off);
      if (ok[u] && lane == 0)
        y[row[u]] = from_f<T>(__fadd_rn(part, __fmul_rn(xv[u], dv[u])));
    }
  }
}

template <typename T, int L, int K>
int launch(const Args& a, int b, cudaStream_t s) {
  constexpr int RPB = (NT / L) * (4 / K) * ROUNDS;
  const int rows = a.nh * a.hd;
  const dim3 grid((rows + RPB - 1) / RPB, b);
  ssd_decode_step_kernel<T, L, K><<<grid, NT, 0, s>>>(a);
  return int(cudaGetLastError());
}

// the lanes a row takes, from n alone
template <typename T>
int by_state(const Args& a, int b, cudaStream_t s) {
  const int c4 = a.n / 4;
  if (c4 > 32) return launch<T, 32, 2>(a, b, s);
  if (c4 > 16) return launch<T, 32, 1>(a, b, s);
  if (c4 > 8) return launch<T, 16, 1>(a, b, s);
  if (c4 > 4) return launch<T, 8, 1>(a, b, s);
  if (c4 > 2) return launch<T, 4, 1>(a, b, s);
  if (c4 > 1) return launch<T, 2, 1>(a, b, s);
  return launch<T, 1, 1>(a, b, s);
}

}  // namespace

// dtype: 0 for fp32 x, B, C and y, 1 for bf16.  Strides in elements.
extern "C" int ssd_decode_step(int dtype, void* h, const void* x,
                               const void* dt, const void* A, const void* B,
                               const void* C, const void* D, void* y, int b,
                               int nh, int hd, int n, long long shb,
                               long long shh, long long sxb, long long sxh,
                               long long sdb, long long sdh, long long sbb,
                               long long scb, void* stream) {
  if (b <= 0 || b > 65535 || nh <= 0 || hd <= 0 || n < 4 || n > 256 ||
      n % 4 != 0 || static_cast<long long>(nh) * hd > (1LL << 30))
    return int(cudaErrorInvalidValue);
  Args a{static_cast<float*>(h), x, static_cast<const float*>(dt),
         static_cast<const float*>(A), B, C, static_cast<const float*>(D),
         y, nh, hd, n, shb, shh, sxb, sxh, sdb, sdh, sbb, scb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_state<float>(a, b, s);
    case 1: return by_state<__nv_bfloat16>(a, b, s);
    default: return int(cudaErrorInvalidValue);
  }
}
