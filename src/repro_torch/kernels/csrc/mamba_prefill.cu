// The Mamba-2 mixer's prefill between its two projections, for sm_90a: five
// passes around the SSD intra-chunk kernel (csrc/ssd_intra_chunk.cu, which
// stays as it is and runs between passes 2 and 3).
//
// Replaces no Pallas kernel: the JAX package runs this work in XLA
// (src/repro/models/layers.py, the Mamba-2 block; src/repro/kernels/
// ssd_scan.py, the scan's wrapper around its Pallas kernel).  The port ran it
// as eager PyTorch (layers.mamba_block, ssd_scan.ssd): about 70 launches a
// layer and prompt, plus two a chunk, and ~2 MB of device memory a token at
// granite-4.0-h-small's widths.  On a prompt of t rows, zxbcdt = (z | x | B |
// C | dt) the input projection, T the activations' dtype (bf16 or fp32):
//
//   1. ssd_dt_kernel: dt = softplus(dt_raw + dt_bias) and its cumsum of
//      dt * A (A = -exp(A_log)) within each chunk, the time axis padded to
//      whole chunks (dt 0 on the pad rows, so the cumsum stays flat there).
//   2. mamba_conv_kernel: the depthwise causal conv over x|B|C (read as the
//      strided columns of zxbcdt they are), its bias and SiLU, written in T;
//      the new conv context; and the intra-chunk kernel's fp32 operands x*dt,
//      B and C in the padded chunk layout, zero on the pad rows.
//   3. ssd_states_kernel: the recurrence across chunks, h <- h * exp(dacs of
//      the chunk's last row) + the chunk's state, from h0 or zeros; each
//      chunk's entering state overwrites its own state in place, and the
//      final state is written in the cache's (nh, hd, n) layout.
//   4. ssd_output_kernel: y = y_diag + exp(dacs) * (C . h_in) + D * x, in
//      fp32 (C . h_in by fp32 multiply-adds), stored in T.
//   5. gated_rmsnorm_kernel: g = y * silu(z), then g * rsqrt(mean(g^2) +
//      eps) * (1 + w), stored in T.
//
// Arithmetic: each pass rounds where the eager code rounds (layers.
// mamba_block, ssd_scan.ssd, layers.rmsnorm): products and sums the eager
// code takes in T are rounded to T one by one (no contraction into a fused
// multiply-add), silu, softplus, exp and rsqrt are the same device functions
// PyTorch's kernels call, and the weights are read in their own dtype and
// rounded as the eager code casts them.  Sums over many terms (C . h_in,
// the sum of squares) run in another order.
//
// What bounds them on the card: bytes.  At granite's widths (128 heads of
// 64, d_state 128, chunk 256) a token moves ~0.33 MB through the five passes
// and the intra-chunk kernel, and ~2.1 MFLOP of fp32 multiply-adds in C .
// h_in: far below the balance point of either fp32 unit.  What the design
// does about it:
//   * No pass reads an intermediate the eager code made only to feed the
//     next op: zxbcdt is read in place (no cat, no split copies), the pads
//     and casts happen on the way to the operands, and C . h_in is
//     accumulated in registers instead of the eager einsum's (c, nh, n)
//     fp32 outer product.
//   * The conv keeps its window in registers, one channel a thread and 64
//     rows a block, with a group of 8 rows' loads in flight before the
//     first is used.
//   * The state pass runs one thread per 4 state values over the chunks in
//     order, the next chunk's load in flight, and moves h0 and the final
//     state through a shared tile to transpose them.
//   * The output pass tiles C . h_in as a small fp32 matrix product per
//     (chunk, head, 128 rows): C's tile transposed (swizzled, no bank
//     conflicts) and h_in's in shared memory, an 8 x 4 register tile a
//     thread at hd 64 (three 16-byte shared loads for 32 multiply-adds);
//     the first chunk skips it without h0.
//   * The norm takes one block a token row and reads y and z twice (the
//     second time from L1/L2) instead of keeping g in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int CONV_ROWS = 64; // time rows of a conv block
constexpr int CONV_U = 8;     // conv rows whose loads go out together
constexpr int MAX_CW = 4;     // widest conv
constexpr int KT = 32;        // state columns of a C . h_in step
constexpr int DT_ROWS = 64;   // rows of a dt round

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
  return __float2bfloat16_rn(v);
}
// v rounded to T, as a float
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// element i of a weight stored in fp32 (bf16 = 0) or bf16 (bf16 = 1)
__device__ __forceinline__ float param(const void* p, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// PyTorch's silu and softplus (beta 1, threshold 20) in fp32
__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}
__device__ __forceinline__ float softplus(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

// ---------------------------------------------------------------- 1. dt

struct DtArgs {
  const void* raw;            // (b, t, nh) T, head stride 1
  long long srb, srt;         // its batch and row strides
  const void* bias;           // dt_bias (nh,)
  const void* alog;           // A_log (nh,)
  int bias_bf16, alog_bf16;
  float* dt;                  // (b, nc * c, nh)
  float* dacs;                // (b, nc, c, nh)
  int t, c, nh;
};

// A block per (batch, chunk, 32 heads), DT_ROWS rows at a time: its 8 warps
// compute dt for the rows (a warp a row, a lane a head: the loads of a
// round all in flight), then warp 0 adds dt * A down the rows in order, a
// lane a head, from shared memory: the cumsum adds in the order of
// PyTorch's cumsum over a non-innermost axis.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_dt_kernel(DtArgs a) {
  __shared__ float prod[DT_ROWS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x * 32 + lane;
  const bool on = h < a.nh;
  const int z = blockIdx.y, b = blockIdx.z;
  const float bias = on ? param(a.bias, a.bias_bf16, h) : 0.0f;
  const float A = on ? -expf(param(a.alog, a.alog_bf16, h)) : 0.0f;
  const T* raw = static_cast<const T*>(a.raw) + b * a.srb + h;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + z) * a.c;
  float* dt = a.dt + row0 * a.nh + h;
  float* dacs = a.dacs + row0 * a.nh + h;
  float acc = 0.0f;
  for (int r0 = 0; r0 < a.c; r0 += DT_ROWS) {
    const int rows = min(DT_ROWS, a.c - r0);
#pragma unroll
    for (int k = 0; k < DT_ROWS / (NT / 32); ++k) {
      const int i = warp + k * (NT / 32), tau = z * a.c + r0 + i;
      if (i < rows) {
        const float d = on && tau < a.t
            ? softplus(__fadd_rn(to_f(raw[tau * a.srt]), bias)) : 0.0f;
        if (on) dt[static_cast<long long>(r0 + i) * a.nh] = d;
        prod[i][lane] = __fmul_rn(d, A);
      }
    }
    __syncthreads();
    if (warp == 0 && on)
      for (int i = 0; i < rows; ++i) {
        acc = __fadd_rn(acc, prod[i][lane]);
        dacs[static_cast<long long>(r0 + i) * a.nh] = acc;
      }
    __syncthreads();
  }
}

// ---------------------------------------------------------- 2. the conv

struct ConvArgs {
  const void* xbc;            // (b, t, cc) T, channel stride 1
  long long sxb, sxt;
  const void* state;          // (b, cw - 1, cc) T dense, or null (zeros)
  const void* w;              // (cw, cc) dense
  const void* bias;           // (cc,) or null
  int w_bf16, bias_bf16;
  const float* dt;            // (b, tp, nh)
  void* out;                  // (b, t, cc) T
  void* new_state;            // (b, cw - 1, cc) T
  float* xdt;                 // (b, tp, di)
  float* B;                   // (b, tp, n)
  float* C;                   // (b, tp, n)
  int t, tp, cc, di, n, nh, hd, cw;
};

// One thread per channel, CONV_ROWS rows a block.  The window w[k], win[k]
// is right-aligned in MAX_CW registers: tap i of a width-cw conv sits at
// k = MAX_CW - cw + i, so that every register index is a constant.
template <typename T>
__global__ void __launch_bounds__(NT, 4) mamba_conv_kernel(ConvArgs a) {
  const int ch = blockIdx.x * NT + threadIdx.x;
  if (ch >= a.cc) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * CONV_ROWS;
  const int off = MAX_CW - a.cw;
  const T* __restrict__ x = static_cast<const T*>(a.xbc) + b * a.sxb + ch;
  const T* __restrict__ st =
      a.state ? static_cast<const T*>(a.state) +
                    static_cast<long long>(b) * (a.cw - 1) * a.cc + ch
              : nullptr;
  // row j of the context followed by x: the context for j < cw - 1
  auto full = [&](int j) -> float {
    if (j >= a.cw - 1) return to_f(x[(j - a.cw + 1) * a.sxt]);
    return st ? to_f(st[static_cast<long long>(j) * a.cc]) : 0.0f;
  };
  if (blockIdx.y == 0) {
    T* ns = static_cast<T*>(a.new_state) +
            static_cast<long long>(b) * (a.cw - 1) * a.cc + ch;
    for (int k = 0; k < a.cw - 1; ++k)
      ns[static_cast<long long>(k) * a.cc] = from_f<T>(full(a.t + k));
  }
  const long long row0 = static_cast<long long>(b) * a.tp;
  const int h = ch < a.di ? ch / a.hd : 0;
  float* __restrict__ dst;
  long long ld;
  if (ch < a.di) {
    dst = a.xdt + row0 * a.di + ch;
    ld = a.di;
  } else if (ch < a.di + a.n) {
    dst = a.B + row0 * a.n + (ch - a.di);
    ld = a.n;
  } else {
    dst = a.C + row0 * a.n + (ch - a.di - a.n);
    ld = a.n;
  }
  const float* __restrict__ dt = a.dt + row0 * a.nh + h;
  const int t1 = min(t0 + CONV_ROWS, a.tp);
  const int tv = min(t1, a.t);          // rows of x in this block
  for (int tau = max(t0, tv); tau < t1; ++tau) dst[tau * ld] = 0.0f;
  if (t0 >= tv) return;

  float w[MAX_CW], win[MAX_CW];
#pragma unroll
  for (int k = 0; k < MAX_CW; ++k) {
    const int i = k - off;
    w[k] = i >= 0 ? rnd<T>(param(a.w, a.w_bf16,
                                 static_cast<long long>(i) * a.cc + ch))
                  : 0.0f;
    // taps 0 .. cw - 2 of row t0: the cw - 1 rows of full before x row t0
    win[k] = (i >= 0 && k < MAX_CW - 1) ? full(t0 + i) : 0.0f;
  }
  const float bias = a.bias ? rnd<T>(param(a.bias, a.bias_bf16, ch)) : 0.0f;
  T* __restrict__ out =
      static_cast<T*>(a.out) + static_cast<long long>(b) * a.t * a.cc + ch;

  for (int g0 = t0; g0 < tv; g0 += CONV_U) {
    float nx[CONV_U], ndt[CONV_U];
#pragma unroll
    for (int u = 0; u < CONV_U; ++u) {
      const int tau = g0 + u;
      nx[u] = tau < tv ? to_f(x[tau * a.sxt]) : 0.0f;
      ndt[u] = (tau < tv && ch < a.di) ? dt[tau * a.nh] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < CONV_U; ++u) {
      const int tau = g0 + u;
      if (tau >= tv) break;
      win[MAX_CW - 1] = nx[u];
      // sum(0 + p_0 + p_1 + ...), each product and sum rounded to T
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_CW; ++k)
        if (k >= off)
          acc = rnd<T>(__fadd_rn(acc, rnd<T>(__fmul_rn(win[k], w[k]))));
      if (a.bias) acc = rnd<T>(__fadd_rn(acc, bias));
      const T o = from_f<T>(silu(acc));
      out[static_cast<long long>(tau) * a.cc] = o;
      const float v = to_f(o);
      dst[tau * ld] = ch < a.di ? __fmul_rn(v, ndt[u]) : v;
#pragma unroll
      for (int k = 0; k < MAX_CW - 1; ++k) win[k] = win[k + 1];
    }
  }
}

// ------------------------------------------------ 3. across the chunks

// A block takes R = 1024 / HD state rows (d_state index) of one (batch,
// head), all HD columns, 4 consecutive columns a thread.
template <int HD>
__global__ void __launch_bounds__(NT)
    ssd_states_kernel(float* __restrict__ states,
                      const float* __restrict__ dacs,
                      const float* __restrict__ h0, float* __restrict__ hout,
                      int nc, int c, int nh, int n) {
  constexpr int R = 1024 / HD;
  __shared__ float tile[R][HD + 1];
  const int bh = blockIdx.y, h = bh % nh, b = bh / nh;
  const int nn0 = blockIdx.x * R;
  const int e = threadIdx.x * 4, rl = e / HD, p = e % HD;
  const bool ok = nn0 + rl < n;
  float hv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (h0) {
    for (int j = threadIdx.x; j < R * HD; j += NT) {
      const int pp = j / R, r = j % R;
      tile[r][pp] = nn0 + r < n
          ? h0[(static_cast<long long>(bh) * HD + pp) * n + nn0 + r] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) hv[k] = tile[rl][p + k];
  }
  const long long zs = static_cast<long long>(nh) * n * HD;
  float* s = states + (static_cast<long long>(b) * nc * nh + h) * n * HD +
             static_cast<long long>(nn0 + rl) * HD + p;
  const float* d = dacs + static_cast<long long>(b) * nc * c * nh +
                   static_cast<long long>(c - 1) * nh + h;
  const long long ds = static_cast<long long>(c) * nh;
  float4 cur = ok ? *reinterpret_cast<const float4*>(s)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < nc; ++z) {
    const float4 nxt = (ok && z + 1 < nc)
        ? *reinterpret_cast<const float4*>(s + (z + 1) * zs)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float decay = expf(d[z * ds]);
    if (ok)
      *reinterpret_cast<float4*>(s + z * zs) =
          make_float4(hv[0], hv[1], hv[2], hv[3]);
    hv[0] = __fadd_rn(__fmul_rn(hv[0], decay), cur.x);
    hv[1] = __fadd_rn(__fmul_rn(hv[1], decay), cur.y);
    hv[2] = __fadd_rn(__fmul_rn(hv[2], decay), cur.z);
    hv[3] = __fadd_rn(__fmul_rn(hv[3], decay), cur.w);
    cur = nxt;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) tile[rl][p + k] = hv[k];
  __syncthreads();
  for (int j = threadIdx.x; j < R * HD; j += NT) {
    const int pp = j / R, r = j % R;
    if (nn0 + r < n)
      hout[(static_cast<long long>(bh) * HD + pp) * n + nn0 + r] = tile[r][pp];
  }
}

// -------------------------------------------------------- 4. the output

template <int HD>
struct Out {
  static constexpr int NTN = HD / 4;                    // threads across hd
  static constexpr int NTM = NT / NTN;                  // threads across rows
  static constexpr int BM = NTM * 8 < 128 ? NTM * 8 : 128;  // rows a block
  static constexpr int TM = BM / NTM;                   // rows a thread
};

struct OutArgs {
  const float* ydiag;         // (b, nc, c, nh * hd)
  const float* hin;           // (b, nc, nh, n, hd)
  const float* dacs;          // (b, nc, c, nh)
  const float* C;             // (b, nc, c, n)
  const void* x;              // (b, t, ...) T, x[b, tau, h * hd + p]
  long long sxb, sxt;
  const void* D;              // (nh,)
  int d_bf16;
  void* y;                    // (b, t, nh * hd) T
  int t, c, nh, n, skip_first;
};

// Block (row tile, head) of chunk z: y_off = C[rows] . h_in[z, h] over n in
// steps of KT, a TM x 4 register tile a thread.  C's tile is held
// transposed, a row per state column, so that a thread reads its TM rows'
// values 16 bytes at a time; it is loaded 16 bytes a thread along the state
// columns and stored with its float4 groups XOR-swizzled by the column's
// group of four (conflict-free stores; a group stays contiguous).
template <typename T, int HD>
__global__ void __launch_bounds__(NT) ssd_output_kernel(OutArgs a) {
  using O = Out<HD>;
  constexpr int TM = O::TM, BM = O::BM;
  __shared__ __align__(16) float cs[KT][BM];
  __shared__ __align__(16) float hs[KT][HD];
  const int h = blockIdx.x % a.nh, r0 = (blockIdx.x / a.nh) * BM;
  const int z = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tn = threadIdx.x % O::NTN, tm = threadIdx.x / O::NTN;
  const long long crow = (static_cast<long long>(b) * nc + z) * a.c;
  auto swz = [](int k, int m) { return m ^ (((k >> 2) & 7) << 2); };
  float acc[TM][4] = {};
  if (!(a.skip_first && z == 0)) {
    const float* Cz = a.C + crow * a.n;
    const float* Hz = a.hin +
        ((static_cast<long long>(b) * nc + z) * a.nh + h) * a.n * HD;
    // n is a multiple of 4 (the wrapper checks it): float4 loads of C
    for (int k0 = 0; k0 < a.n; k0 += KT) {
      for (int j = threadIdx.x; j < BM * (KT / 4); j += NT) {
        const int m = j / (KT / 4), k = (j % (KT / 4)) * 4;
        const float4 v = (r0 + m < a.c && k0 + k < a.n)
            ? *reinterpret_cast<const float4*>(
                  Cz + static_cast<long long>(r0 + m) * a.n + k0 + k)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        cs[k][swz(k, m)] = v.x;
        cs[k + 1][swz(k + 1, m)] = v.y;
        cs[k + 2][swz(k + 2, m)] = v.z;
        cs[k + 3][swz(k + 3, m)] = v.w;
      }
      for (int j = threadIdx.x; j < KT * HD / 4; j += NT) {
        const int k = j / (HD / 4), q = (j % (HD / 4)) * 4;
        *reinterpret_cast<float4*>(&hs[k][q]) = k0 + k < a.n
            ? *reinterpret_cast<const float4*>(
                  Hz + static_cast<long long>(k0 + k) * HD + q)
            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KT; ++k) {
        const float4 hv = *reinterpret_cast<const float4*>(&hs[k][tn * 4]);
        float cv[TM];
        if constexpr (TM % 4 == 0) {
#pragma unroll
          for (int i = 0; i < TM; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                &cs[k][swz(k, tm * TM + i)]);
            cv[i] = v.x;
            cv[i + 1] = v.y;
            cv[i + 2] = v.z;
            cv[i + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) cv[i] = cs[k][swz(k, tm * TM + i)];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = fmaf(cv[i], hv.x, acc[i][0]);
          acc[i][1] = fmaf(cv[i], hv.y, acc[i][1]);
          acc[i][2] = fmaf(cv[i], hv.z, acc[i][2]);
          acc[i][3] = fmaf(cv[i], hv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }
  const float D = param(a.D, a.d_bf16, h);
  const T* x = static_cast<const T*>(a.x) + b * a.sxb + h * HD + tn * 4;
  T* y = static_cast<T*>(a.y) + static_cast<long long>(b) * a.t * a.nh * HD +
         h * HD + tn * 4;
#pragma unroll
  for (int i = 0; i < O::TM; ++i) {
    const int r = r0 + tm * O::TM + i, tau = z * a.c + r;
    if (r >= a.c || tau >= a.t) continue;
    const float e = expf(a.dacs[(crow + r) * a.nh + h]);
    const float4 yd = *reinterpret_cast<const float4*>(
        a.ydiag + (crow + r) * a.nh * HD + h * HD + tn * 4);
    const float ydv[4] = {yd.x, yd.y, yd.z, yd.w};
    const T* xr = x + tau * a.sxt;
    T* yr = y + static_cast<long long>(tau) * a.nh * HD;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      yr[k] = from_f<T>(__fadd_rn(__fadd_rn(ydv[k], __fmul_rn(e, acc[i][k])),
                                  __fmul_rn(to_f(xr[k]), D)));
  }
}

// ------------------------------------------------------ 5. the gated norm

struct NormArgs {
  const void* y;              // (rows, di) T dense
  const void* z;              // (b, t, di) T, channel stride 1
  long long szb, szt;
  const void* w;              // (di,)
  int w_bf16;
  void* out;                  // (rows, di) T
  int t, di;
  float eps;
};

template <typename T>
__device__ __forceinline__ float gate(const T* y, const T* z, int c) {
  return rnd<T>(__fmul_rn(to_f(y[c]), rnd<T>(silu(to_f(z[c])))));
}

// Two passes over the row: the sum of squares, then the scaling, each
// computing g from y and z (the second pass reads them from L1/L2).
template <typename T>
__global__ void __launch_bounds__(NT) gated_rmsnorm_kernel(NormArgs a) {
  __shared__ float part[NT / 32];
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / a.t), tau = static_cast<int>(row % a.t);
  const T* y = static_cast<const T*>(a.y) + row * a.di;
  const T* z = static_cast<const T*>(a.z) + b * a.szb + tau * a.szt;
  float ss = 0.0f;
  for (int c = threadIdx.x; c < a.di; c += NT) {
    const float g = gate(y, z, c);
    ss = __fadd_rn(ss, __fmul_rn(g, g));
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) ss += part[i];
  const float r = rsqrtf(__fadd_rn(ss / static_cast<float>(a.di), a.eps));
  T* out = static_cast<T*>(a.out) + row * a.di;
  for (int c = threadIdx.x; c < a.di; c += NT) {
    const float onew = a.w_bf16
        ? rnd<__nv_bfloat16>(1.0f + param(a.w, 1, c))
        : 1.0f + param(a.w, 0, c);
    out[c] = from_f<T>(__fmul_rn(__fmul_rn(gate(y, z, c), r), onew));
  }
}

// ------------------------------------------------------------- launches

int last() { return static_cast<int>(cudaGetLastError()); }

template <typename T>
int output_by_hd(int hd, const OutArgs& a, int b, int nc,
                 cudaStream_t s) {
  auto go = [&](auto kernel, int bm) {
    const dim3 grid((a.c + bm - 1) / bm * a.nh, nc, b);
    kernel<<<grid, NT, 0, s>>>(a);
    return last();
  };
  switch (hd) {
    case 8: return go(ssd_output_kernel<T, 8>, Out<8>::BM);
    case 16: return go(ssd_output_kernel<T, 16>, Out<16>::BM);
    case 32: return go(ssd_output_kernel<T, 32>, Out<32>::BM);
    case 64: return go(ssd_output_kernel<T, 64>, Out<64>::BM);
    case 128: return go(ssd_output_kernel<T, 128>, Out<128>::BM);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool grid_ok(long long x, long long y, long long z) {
  return x > 0 && y > 0 && z > 0 && x < (1LL << 31) && y <= 65535 &&
         z <= 65535;
}

}  // namespace

// dtype codes: 0 fp32, 1 bf16, for the activations and each weight alike.
// Strides in elements.  Each returns cudaGetLastError() after its launch.

extern "C" int ssd_dt(int dtype, const void* raw, long long srb,
                      long long srt, const void* bias, int bias_bf16,
                      const void* alog, int alog_bf16, void* dt, void* dacs,
                      int b, int t, int c, int nc, int nh, void* stream) {
  if (!grid_ok((nh + 31) / 32, nc, b) || t <= 0 || c <= 0 ||
      static_cast<long long>(nc) * c < t)
    return static_cast<int>(cudaErrorInvalidValue);
  DtArgs a{raw, srb, srt, bias, alog, bias_bf16, alog_bf16,
           static_cast<float*>(dt), static_cast<float*>(dacs), t, c, nh};
  const dim3 grid((nh + 31) / 32, nc, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: ssd_dt_kernel<float><<<grid, NT, 0, s>>>(a); return last();
    case 1: ssd_dt_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(a); return last();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mamba_conv(int dtype, const void* xbc, long long sxb,
                          long long sxt, const void* state, const void* w,
                          int w_bf16, const void* bias, int bias_bf16,
                          const void* dt, void* out, void* new_state,
                          void* xdt, void* B, void* C, int b, int t, int tp,
                          int cc, int di, int n, int nh, int hd, int cw,
                          void* stream) {
  if (!grid_ok((cc + NT - 1) / NT, (tp + CONV_ROWS - 1) / CONV_ROWS, b) ||
      t <= 0 || tp < t || cw < 1 || cw > MAX_CW || hd <= 0 ||
      static_cast<long long>(nh) * hd != di || di + 2 * n != cc)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a{xbc, sxb, sxt, state, w, bias, w_bf16, bias_bf16,
             static_cast<const float*>(dt), out, new_state,
             static_cast<float*>(xdt), static_cast<float*>(B),
             static_cast<float*>(C), t, tp, cc, di, n, nh, hd, cw};
  const dim3 grid((cc + NT - 1) / NT, (tp + CONV_ROWS - 1) / CONV_ROWS, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: mamba_conv_kernel<float><<<grid, NT, 0, s>>>(a); return last();
    case 1:
      mamba_conv_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(a);
      return last();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int ssd_states(int hd, void* states, const void* dacs,
                          const void* h0, void* hout, int b, int nc, int c,
                          int nh, int n, void* stream) {
  if (nc <= 0 || c <= 0 || n <= 0 ||
      !grid_ok(1, static_cast<long long>(b) * nh, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<float*>(states);
  const auto* d = static_cast<const float*>(dacs);
  const auto* h = static_cast<const float*>(h0);
  auto* o = static_cast<float*>(hout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel, int hd_) {
    const int rows = 1024 / hd_;
    kernel<<<dim3((n + rows - 1) / rows, b * nh), NT, 0, s>>>(st, d, h, o, nc,
                                                             c, nh, n);
    return last();
  };
  switch (hd) {
    case 8: return go(ssd_states_kernel<8>, 8);
    case 16: return go(ssd_states_kernel<16>, 16);
    case 32: return go(ssd_states_kernel<32>, 32);
    case 64: return go(ssd_states_kernel<64>, 64);
    case 128: return go(ssd_states_kernel<128>, 128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int ssd_output(int dtype, int hd, const void* ydiag,
                          const void* hin, const void* dacs, const void* C,
                          const void* x, long long sxb, long long sxt,
                          const void* D, int d_bf16, void* y, int b, int t,
                          int nc, int c, int nh, int n, int skip_first,
                          void* stream) {
  if (t <= 0 || c <= 0 || n <= 0 || n % 4 ||
      static_cast<long long>(nc) * c < t ||
      !grid_ok(static_cast<long long>(c) * nh, nc, b))
    return static_cast<int>(cudaErrorInvalidValue);
  OutArgs a{static_cast<const float*>(ydiag), static_cast<const float*>(hin),
            static_cast<const float*>(dacs), static_cast<const float*>(C),
            x, sxb, sxt, D, d_bf16, y, t, c, nh, n, skip_first};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return output_by_hd<float>(hd, a, b, nc, s);
    case 1: return output_by_hd<__nv_bfloat16>(hd, a, b, nc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gated_rmsnorm(int dtype, const void* y, const void* z,
                             long long szb, long long szt, const void* w,
                             int w_bf16, void* out, int b, int t, int di,
                             float eps, void* stream) {
  if (!grid_ok(static_cast<long long>(b) * t, 1, 1) || di <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  NormArgs a{y, z, szb, szt, w, w_bf16, out, t, di, eps};
  const dim3 grid(b * t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: gated_rmsnorm_kernel<float><<<grid, NT, 0, s>>>(a); return last();
    case 1:
      gated_rmsnorm_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(a);
      return last();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
