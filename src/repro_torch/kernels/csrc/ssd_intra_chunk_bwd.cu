// Backward pass of the Mamba-2 SSD intra-chunk pass for sm_90a, in fp32 on
// the CUDA cores.
//
// The forward (csrc/ssd_intra_chunk.cu) replaces the Pallas TPU kernel
// `ssd_intra_chunk` in src/repro/kernels/ssd_scan.py (pallas_call at :69,
// body `_kernel` at :31-58).  That kernel has no reverse mode: the JAX
// package trains on `ref.ssd_chunked` under autograd instead.  This is its
// gradient, written from the forward's equations (the plain version is
// `ref.ssd_intra_chunk_bwd`).  Per (batch b, chunk z), with
// W[h,i,j] = (C_i . B_j) exp(dacs[i,h] - dacs[j,h]) for j <= i and
// decay[j,h] = exp(dacs[c-1,h] - dacs[j,h]), and dy, dstates the gradients
// of y_diag and states:
//
//   dW[h,i,j] = dy_h[i] . xdt_h[j]                       (j <= i)
//   dxdt_h[j] = sum_i W[h,i,j] dy_h[i]
//               + decay[j,h] sum_nn B[j,nn] dstates_h[nn]
//   dS        = sum_h dW (.) L_h;  dC = dS B
//   dB        = dS^T C + sum_h decay_h (.) (xdt_h dstates_h^T)
//   ddacs     = rowsum(dW (.) W) - colsum(dW (.) W) - E, plus sum_j E at c-1,
//               E[j,h] = decay[j,h] xdt_h[j] . (B_j dstates_h)
//
// Three launches on the wrapper's stream, 256 threads a block, 32 x 32
// tiles:
//   1. scores: C . B^T of each chunk's tiles on or below the diagonal, into
//      a scratch (b, nc, c, c), once per chunk rather than once per head;
//   2. one block per (head, chunk, batch): walks the key tiles j and, for
//      each, the query tiles i >= j; writes dxdt and ddacs of its head,
//      and its head's dW (.) L and its term of dB's state part,
//      decay_h (.) (xdt_h dstates_h^T), into scratches (b, nc, nh, c, c)
//      and (b, nc, nh, c, n);
//   3. one block per (row tile, dB or dC, chunk, batch): sums the heads'
//      dW (.) L in a fixed order (no atomics: two runs give the same bits)
//      and multiplies by B or C; the dB blocks add the heads' state terms,
//      in a fixed order too.
//
// What bounds it on the card: at mamba2-780m's training shape (b = 2,
// T = 1024, c = n = 128, nh = 48, hd = 64) the least work is about 5 GFLOP
// and 105 MB, so bytes and operations bound it about equally near 0.03 ms.
// This first version runs scalar fp32 FMAs from shared memory, about one
// shared-memory load an FMA in the per-head kernel, so the shared-memory
// reads bound it instead: 0.72 ms at that shape on an NVIDIA H100 80GB
// HBM3 at 700 W, 0.52 ms of it per head (PERF.md).  It keeps fp32
// accuracy: every sum is an fp32 FMA chain.
// The causal mask is a select before the exp, as in the forward: for j > i
// exp(dacs_i - dacs_j) may overflow, and inf * 0 would be NaN.
// Any chunk length c (1 .. 512) and d_state n (1 .. 256): rows, keys and
// state columns past the edge are zeros in shared memory and are not
// stored.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int T = 32;             // tile edge: query rows, keys, state rows
constexpr int TP = T + 1;         // padded row of a T x T tile
constexpr int MAX_SMEM = 232448;  // opt-in shared memory per block on sm_90

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// rows x HD floats from src (row stride lds) into dst (row stride HD + 1),
// rows >= nrows zero.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          long long lds, int nrows) {
  for (int e = threadIdx.x; e < T * HD; e += NT) {
    const int r = e / HD, p = e % HD;
    dst[r * (HD + 1) + p] = r < nrows ? __ldg(src + r * lds + p) : 0.f;
  }
}

// 1. scores[i, j] = C_i . B_j for the 32 x 32 tiles with jt <= it.
// grid (nt * nt, nc, b); thread (r, q) takes row r, keys q + 8u.
__global__ void __launch_bounds__(NT)
ssd_bwd_scores(const float* __restrict__ B, const float* __restrict__ C,
               float* __restrict__ S, int nc, int c_len, int n) {
  __shared__ float cs[T * TP], bs[T * TP];
  const int nt = cdiv(c_len, T);
  const int it = blockIdx.x / nt, jt = blockIdx.x % nt;
  if (jt > it) return;
  const long long chunk = (long long)blockIdx.z * nc + blockIdx.y;
  B += chunk * c_len * n;
  C += chunk * c_len * n;
  S += chunk * c_len * c_len;
  const int i0 = it * T, j0 = jt * T;
  const int tid = threadIdx.x, r = tid >> 3, q = tid & 7;
  float acc[4] = {};
  for (int k0 = 0; k0 < n; k0 += T) {
    for (int e = tid; e < T * T; e += NT) {
      const int rr = e / T, kk = e % T;
      const bool k_ok = k0 + kk < n;
      cs[rr * TP + kk] = i0 + rr < c_len && k_ok
                             ? __ldg(C + (long long)(i0 + rr) * n + k0 + kk)
                             : 0.f;
      bs[rr * TP + kk] = j0 + rr < c_len && k_ok
                             ? __ldg(B + (long long)(j0 + rr) * n + k0 + kk)
                             : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < T; ++kk) {
      const float cv = cs[r * TP + kk];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += cv * bs[(q + 8 * u) * TP + kk];
    }
    __syncthreads();
  }
  const int i = i0 + r;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = j0 + q + 8 * u;
    if (i < c_len && j < c_len) S[(long long)i * c_len + j] = acc[u];
  }
}

template <int HD>
__host__ __device__ size_t head_floats(int c_len) {
  return 3 * size_t(cdiv(c_len, T) * T) + 2 * size_t(T) * (HD + 1) +
         3 * size_t(T) * TP + 1;
}

// 2. one head of one chunk.  Thread (r, q) = (tid / 8, tid % 8) takes query
// row r against keys q + 8u of a tile (dW, W, P, G), and key row r at head
// columns q + 8k for dxdt and the state term.
template <int HD>
__global__ void __launch_bounds__(NT)
ssd_bwd_head(const float* __restrict__ xdt, const float* __restrict__ dacs,
             const float* __restrict__ B, const float* __restrict__ dy,
             const float* __restrict__ dstates, const float* __restrict__ S,
             float* __restrict__ P, float* __restrict__ R,
             float* __restrict__ dxdt, float* __restrict__ ddacs, int nc,
             int c_len, int nh, int n) {
  constexpr int LD = HD + 1;
  constexpr int NP = HD >= 8 ? HD / 8 : 1;   // head columns per thread
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const long long chunk = (long long)blockIdx.z * nc + blockIdx.y;
  const long long rows = chunk * c_len;
  const long long ld = (long long)nh * HD;
  xdt += rows * ld + h * HD;
  dy += rows * ld + h * HD;
  dxdt += rows * ld + h * HD;
  dacs += rows * nh + h;
  ddacs += rows * nh + h;
  B += rows * n;
  dstates += (chunk * nh + h) * (long long)n * HD;
  S += chunk * c_len * c_len;
  P += (chunk * nh + h) * (long long)c_len * c_len;
  R += (chunk * nh + h) * (long long)c_len * n;

  const int nt = cdiv(c_len, T), cpad = nt * T;
  float* da = smem;                  // cpad     dacs of head h
  float* dd = da + cpad;             // cpad     rowsum(G) - colsum(G)
  float* es = dd + cpad;             // cpad     E
  float* xj = es + cpad;             // T x LD   xdt rows of the key tile
  float* yi = xj + T * LD;           // T x LD   dy rows, then dstates rows
  float* st = yi + T * LD;           // T x TP   scores tile, then W
  float* gt = st + T * TP;           // T x TP   G
  float* bt = gt + T * TP;           // T x TP   B tile (state term)
  float* esum = bt + T * TP;         // 1        sum_j E[j]
  const int tid = threadIdx.x, r = tid >> 3, q = tid & 7;

  for (int j = tid; j < cpad; j += NT) {
    da[j] = j < c_len ? __ldg(dacs + (long long)j * nh) : 0.f;
    dd[j] = 0.f;
  }
  const float last = __ldg(dacs + (long long)(c_len - 1) * nh);

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * T;
    __syncthreads();                 // da, dd ready; last tile's xj read
    load_rows<HD>(xj, xdt + j0 * ld, ld, c_len - j0);
    float dx[NP] = {};
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * T;
      load_rows<HD>(yi, dy + i0 * ld, ld, c_len - i0);
      for (int e = tid; e < T * T; e += NT) {
        const int ii = e / T, jj = e % T;
        st[ii * TP + jj] = i0 + ii < c_len && j0 + jj < c_len
                               ? S[(long long)(i0 + ii) * c_len + j0 + jj]
                               : 0.f;
      }
      __syncthreads();
      const int i = i0 + r;
      const float di = da[i];
      float dw[4] = {};
#pragma unroll 16
      for (int p = 0; p < HD; ++p) {
        const float yv = yi[r * LD + p];
#pragma unroll
        for (int u = 0; u < 4; ++u) dw[u] += yv * xj[(q + 8 * u) * LD + p];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = q + 8 * u, j = j0 + jj;
        // select before the exp: for j > i it may overflow
        const float l = j <= i && i < c_len ? expf(di - da[j]) : 0.f;
        const float w = st[r * TP + jj] * l;
        if (i < c_len && j < c_len) P[(long long)i * c_len + j] = dw[u] * l;
        st[r * TP + jj] = w;         // each thread reads and writes its own
        gt[r * TP + jj] = dw[u] * w;
      }
      __syncthreads();
      // dxdt[j] += sum_i W[i, j] dy[i]
#pragma unroll 4
      for (int ii = 0; ii < T; ++ii) {
        const float w = st[ii * TP + r];
#pragma unroll
        for (int k = 0; k < NP; ++k)
          if (q + 8 * k < HD) dx[k] += w * yi[ii * LD + q + 8 * k];
      }
      // ddacs: + row sums of G at i, - column sums at j (one thread an
      // index, so the diagonal tile's two updates do not race)
      if (tid < T) {
        float rs = 0.f, cs = 0.f;
        for (int jj = 0; jj < T; ++jj) rs += gt[tid * TP + jj];
        for (int ii = 0; ii < T; ++ii) cs += gt[ii * TP + tid];
        dd[i0 + tid] += rs;
        dd[j0 + tid] -= cs;
      }
      __syncthreads();
    }
    // the state terms of key row j = j0 + r: qv[p] = sum_nn B[j, nn]
    // dstates[nn, p] for dxdt and E, and R[j, nn] = decay[j] sum_p
    // xdt[j, p] dstates[nn, p] for dB (state rows nn = n0 + q + 8u)
    const int j = j0 + r;
    const float dec = j < c_len ? expf(last - da[j]) : 0.f;
    float qv[NP] = {};
    for (int n0 = 0; n0 < n; n0 += T) {
      for (int e = tid; e < T * T; e += NT) {
        const int jj = e / T, kk = e % T;
        bt[jj * TP + kk] = j0 + jj < c_len && n0 + kk < n
                               ? __ldg(B + (long long)(j0 + jj) * n + n0 + kk)
                               : 0.f;
      }
      load_rows<HD>(yi, dstates + (long long)n0 * HD, HD, n - n0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < T; ++kk) {
        const float bv = bt[r * TP + kk];
#pragma unroll
        for (int k = 0; k < NP; ++k)
          if (q + 8 * k < HD) qv[k] += bv * yi[kk * LD + q + 8 * k];
      }
      float rv[4] = {};
#pragma unroll 16
      for (int p = 0; p < HD; ++p) {
        const float xv = xj[r * LD + p];
#pragma unroll
        for (int u = 0; u < 4; ++u) rv[u] += xv * yi[(q + 8 * u) * LD + p];
      }
      if (j < c_len) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n0 + q + 8 * u < n)
            R[(long long)j * n + n0 + q + 8 * u] = dec * rv[u];
      }
      __syncthreads();
    }
    float e = 0.f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (q + 8 * k < HD) {
        dx[k] += dec * qv[k];
        e += xj[r * LD + q + 8 * k] * qv[k];
      }
    }
    // the 8 lanes of key row r sit together in one warp
    e += __shfl_xor_sync(0xffffffffu, e, 1);
    e += __shfl_xor_sync(0xffffffffu, e, 2);
    e += __shfl_xor_sync(0xffffffffu, e, 4);
    if (q == 0) es[j] = dec * e;
    if (j < c_len) {
#pragma unroll
      for (int k = 0; k < NP; ++k)
        if (q + 8 * k < HD) dxdt[(long long)j * ld + q + 8 * k] = dx[k];
    }
  }
  __syncthreads();
  // sum_j E[j] in a fixed order: lane l sums l, l + 32, ..., then a tree
  if (tid < 32) {
    float s = 0.f;
    for (int j = tid; j < c_len; j += 32) s += es[j];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tid == 0) *esum = s;
  }
  __syncthreads();
  for (int i = tid; i < c_len; i += NT)
    ddacs[(long long)i * nh] =
        dd[i] - es[i] + (i == c_len - 1 ? *esum : 0.f);
}

template <int NK>
__host__ __device__ size_t reduce_floats() {
  return size_t(T) * TP + size_t(T) * (8 * NK + 1);
}

// 3. grid (2 nt, nc, b): blocks x < nt take dC rows x T .. x T + 31, the
// rest dB rows.  Thread (r, q) takes row r at state columns q + 8k.
template <int NK>
__global__ void __launch_bounds__(NT)
ssd_bwd_reduce(const float* __restrict__ B, const float* __restrict__ C,
               const float* __restrict__ P, const float* __restrict__ R,
               float* __restrict__ dB, float* __restrict__ dC, int nc,
               int c_len, int nh, int n) {
  constexpr int NW = 8 * NK, LDN = NW + 1;
  constexpr int EPT = T * T / NT;    // dS elements per thread
  extern __shared__ float smem[];
  float* sd = smem;                  // T x TP    dS tile (dB: transposed)
  float* mt = sd + T * TP;           // T x LDN   B or C rows
  const int nt = cdiv(c_len, T);
  const bool for_b = blockIdx.x >= nt;
  const int rt = blockIdx.x % nt, r0 = rt * T;
  const long long chunk = (long long)blockIdx.z * nc + blockIdx.y;
  const long long rows = chunk * c_len;
  const long long plane = (long long)c_len * c_len;
  P += chunk * nh * plane;
  const float* M = (for_b ? C : B) + rows * n;
  const int tid = threadIdx.x, r = tid >> 3, q = tid & 7;
  float acc[NK] = {};

  // dC[r] = sum_{j <= r} dS[r, j] B[j];  dB[r] = sum_{i >= r} dS[i, r] C[i]
  const int lo = for_b ? rt : 0, hi = for_b ? nt : rt + 1;
  for (int ot = lo; ot < hi; ++ot) {
    const int o0 = ot * T;
    // dS = sum_h P_h over the tile, heads in order; element e = tid + NT u
    // is P tile row e / T, column e % T
    float ds[EPT] = {};
    for (int hh = 0; hh < nh; ++hh) {
      const float* ph = P + hh * plane;
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        const int e = tid + NT * u, a = e / T, bc = e % T;
        const int pi = (for_b ? o0 : r0) + a, pj = (for_b ? r0 : o0) + bc;
        if (pi < c_len && pj <= pi)      // the part of P that was written
          ds[u] += ph[(long long)pi * c_len + pj];
      }
    }
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = tid + NT * u, a = e / T, bc = e % T;
      if (for_b)
        sd[bc * TP + a] = ds[u];
      else
        sd[a * TP + bc] = ds[u];
    }
    for (int e = tid; e < T * NW; e += NT) {
      const int rr = e / NW, nn = e % NW;
      mt[rr * LDN + nn] = o0 + rr < c_len && nn < n
                              ? __ldg(M + (long long)(o0 + rr) * n + nn)
                              : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      const float s = sd[r * TP + kk];
#pragma unroll
      for (int k = 0; k < NK; ++k) acc[k] += s * mt[kk * LDN + q + 8 * k];
    }
    __syncthreads();
  }
  const int i = r0 + r;
  // dB's state part: the heads' terms, in order
  if (for_b && i < c_len) {
    const float* rh = R + (chunk * nh * c_len + i) * (long long)n;
    for (int hh = 0; hh < nh; ++hh) {
#pragma unroll
      for (int k = 0; k < NK; ++k)
        if (q + 8 * k < n) acc[k] += rh[hh * (long long)c_len * n + q + 8 * k];
    }
  }
  float* out = (for_b ? dB : dC) + rows * n;
  if (i < c_len) {
#pragma unroll
    for (int k = 0; k < NK; ++k)
      if (q + 8 * k < n) out[(long long)i * n + q + 8 * k] = acc[k];
  }
}

template <typename K>
int allow_smem(K kernel) {
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM));
}

struct Args {
  const float *xdt, *dacs, *B, *C, *dy, *dstates;
  float *dxdt, *ddacs, *dB, *dC, *S, *P, *R;
  int b, nc, c_len, nh, n;
  cudaStream_t stream;
};

template <int HD>
int launch_head(const Args& a) {
  static const int attr = allow_smem(ssd_bwd_head<HD>);
  if (attr != 0) return attr;
  const size_t bytes = head_floats<HD>(a.c_len) * sizeof(float);
  if (bytes > size_t(MAX_SMEM)) return int(cudaErrorInvalidValue);
  ssd_bwd_head<HD><<<dim3(a.nh, a.nc, a.b), NT, bytes, a.stream>>>(
      a.xdt, a.dacs, a.B, a.dy, a.dstates, a.S, a.P, a.R, a.dxdt, a.ddacs,
      a.nc, a.c_len, a.nh, a.n);
  return int(cudaGetLastError());
}

template <int NK>
int launch_reduce(const Args& a) {
  static const int attr = allow_smem(ssd_bwd_reduce<NK>);
  if (attr != 0) return attr;
  const size_t bytes = reduce_floats<NK>() * sizeof(float);
  ssd_bwd_reduce<NK><<<dim3(2 * cdiv(a.c_len, T), a.nc, a.b), NT, bytes,
                       a.stream>>>(a.B, a.C, a.P, a.R, a.dB, a.dC, a.nc,
                                   a.c_len, a.nh, a.n);
  return int(cudaGetLastError());
}

}  // namespace

// All tensors fp32 and dense: xdt, dy, dxdt (b,nc,c,nh*hd); dacs, ddacs
// (b,nc,c,nh); B, C, dB, dC (b,nc,c,n); dstates (b,nc,nh,n,hd); scratch
// scores (b,nc,c,c), P (b,nc,nh,c,c) and R (b,nc,nh,c,n).  hd is one of 8,
// 16, 32, 64, 128;
// c at most 512, n at most 256.  Three launches; returns cudaGetLastError()
// after the last, or the first error.
extern "C" int ssd_intra_chunk_bwd(int hd, const void* xdt, const void* dacs,
                                   const void* B, const void* C,
                                   const void* dy, const void* dstates,
                                   void* dxdt, void* ddacs, void* dB,
                                   void* dC, void* scores, void* P,
                                   void* R, int b, int nc, int c_len, int nh,
                                   int n, void* stream) {
  if (b <= 0 || nc <= 0 || c_len <= 0 || nh <= 0 || n <= 0 || nc > 65535 ||
      b > 65535 || c_len > 512 || n > 256)
    return int(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(xdt), static_cast<const float*>(dacs),
         static_cast<const float*>(B),   static_cast<const float*>(C),
         static_cast<const float*>(dy),  static_cast<const float*>(dstates),
         static_cast<float*>(dxdt),      static_cast<float*>(ddacs),
         static_cast<float*>(dB),        static_cast<float*>(dC),
         static_cast<float*>(scores),    static_cast<float*>(P),
         static_cast<float*>(R),
         b, nc, c_len, nh, n, static_cast<cudaStream_t>(stream)};
  const int nt = cdiv(c_len, T);
  ssd_bwd_scores<<<dim3(nt * nt, nc, b), NT, 0, a.stream>>>(
      a.B, a.C, a.S, nc, c_len, n);
  int err = int(cudaGetLastError());
  if (err != 0) return err;
  switch (hd) {
    case 8: err = launch_head<8>(a); break;
    case 16: err = launch_head<16>(a); break;
    case 32: err = launch_head<32>(a); break;
    case 64: err = launch_head<64>(a); break;
    case 128: err = launch_head<128>(a); break;
    default: return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  if (n <= 8) return launch_reduce<1>(a);
  if (n <= 16) return launch_reduce<2>(a);
  if (n <= 32) return launch_reduce<4>(a);
  if (n <= 64) return launch_reduce<8>(a);
  if (n <= 128) return launch_reduce<16>(a);
  return launch_reduce<32>(a);
}
