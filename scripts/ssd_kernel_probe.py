#!/usr/bin/env python3
"""Where the SSD intra-chunk kernel's time goes, on one NVIDIA GPU, without
a profiler (``ncu`` and ``nsys`` may not run where the card is).

    python3 scripts/ssd_kernel_probe.py [rate] [timeline] [variants]

Run from the root of a checkout on a machine with the card and the CUDA
toolkit; with no argument all three run.  Every library is built into a
temporary directory from ``src/repro_torch/kernels/csrc``; nothing in the
checkout changes.

* ``rate``: mma.sync throughput of this card from a kernel of independent
  mma's (m16n8k8 TF32, m16n8k16 bf16), and the same with one dependent
  chain per warp.
* ``timeline``: the kernel with ``clock64`` and ``%globaltimer`` stamps in
  each block (warp 7, lane 0): cycles in the prologue, waiting at the
  key-tile barriers, in the arithmetic, and after the key loop, per kind
  of block and number of key tiles, at ``chip_smoke.SSD_PREFILL``.
* ``variants``: copies of the source with one part switched off, each
  built and timed at ``chip_smoke.SSD_PREFILL`` (device ms, as
  ``chip_smoke.py`` times the kernel).  Their outputs are wrong by design.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ssd_scan  # noqa: E402

CSRC = _build.CSRC
SOURCE = (CSRC / "ssd_intra_chunk.cu").read_text()

RATE_SRC = r'''
#include <cuda_runtime.h>
#include "ptx.cuh"
template <int ILP, bool TF32>
__global__ void rate(float* out, int iters) {
  float d[ILP][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(threadIdx.x * 2e-3f + i);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      if (TF32) ptx::mma_tf32_1688(d[k], a, b);
      else ptx::mma_bf16_16816(d[k], a, b);
    }
  float s = 0.f;
  for (int k = 0; k < ILP; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  if (s == 12345.f) out[0] = s;
}
extern "C" int run(int which, int blocks, int threads, int iters, void* out) {
  float* o = static_cast<float*>(out);
  if (which == 0) rate<8, true><<<blocks, threads>>>(o, iters);
  if (which == 1) rate<8, false><<<blocks, threads>>>(o, iters);
  if (which == 2) rate<1, true><<<blocks, threads>>>(o, iters);
  return int(cudaGetLastError());
}
'''


def build(src: str, tmp: Path, name: str) -> ctypes.CDLL:
    cu = tmp / f"{name}.cu"
    cu.write_text(src)
    out = tmp / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC),
                        "-o", str(out), str(cu)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    log = r.stdout + r.stderr                # ptxas reports on stderr
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    print(f"  built {name}: registers {regs}, spill stores {spills}",
          flush=True)
    return ctypes.CDLL(str(out))


def edit(src: str, old: str, new: str) -> str:
    """``src`` with every ``old`` replaced; fails if the source no longer
    has it (the variant then needs rewriting for the new source)."""
    if old not in src:
        raise KeyError(f"the source no longer contains {old!r}")
    return src.replace(old, new)


def rate(tmp: Path) -> None:
    lib = build(RATE_SRC, tmp, "rate")
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out = torch.zeros(1, device="cuda")
    blocks, iters = 4 * 132, 2000
    for which, name, macs, ilp in ((0, "tf32 m16n8k8, 8 chains", 1024, 8),
                                   (1, "bf16 m16n8k16, 8 chains", 2048, 8),
                                   (2, "tf32 m16n8k8, 1 chain", 1024, 1)):
        for threads in (128, 256, 512):
            lib.run(which, blocks, threads, iters, out.data_ptr())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.run(which, blocks, threads, iters, out.data_ptr())
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            flops = 2.0 * macs * ilp * iters * blocks * threads / 32
            print(f"rate {name}, {threads} threads a block: "
                  f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)


def operands(shape):
    b, t, nh, hd, n, chunk = shape
    ops = ssd_scan.chunk_operands(
        *chip_smoke.ssd_case(b, t, nh, hd, n, 800)[:5], chunk)
    return ops, nh, hd


def caller(lib, ops, nh, hd):
    lib.ssd_intra_chunk_fwd.argtypes = ssd_scan._SIGNATURES[
        "ssd_intra_chunk_fwd"]
    xdt, dacs, B, C = ops
    b, nc, c, _ = xdt.shape
    n = B.shape[-1]
    y = torch.empty_like(xdt)
    st = torch.empty((b, nc, nh, n, hd), device="cuda")

    def call():
        err = lib.ssd_intra_chunk_fwd(
            hd, xdt.data_ptr(), dacs.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), st.data_ptr(), b, nc, c, nh, n,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
    return call


STAMPS = r'''
__device__ unsigned long long g_stamps[1 << 20];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_SLOT ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x)
#define STAMP_WRITE(kind)                                                   \
  __syncthreads();                                                          \
  if (threadIdx.x == 224) {                                                 \
    unsigned long long* r = g_stamps + STAMP_SLOT * 8;                      \
    r[0] = kind; r[1] = c_loop - c_start; r[2] = c_wait; r[3] = c_comp;     \
    r[4] = clock64() - c_end; r[5] = g_start; r[6] = gtime(); r[7] = ntiles; \
  }
'''


def timeline_source() -> str:
    """The kernel's source with the stamps and ``read_stamps``."""
    src = edit(SOURCE, '#include "ptx.cuh"\n', '#include "ptx.cuh"\n' + STAMPS)
    src = edit(src, "  auto issue = [&](int kt) {",
               "  const long long c_start = clock64();\n"
               "  const unsigned long long g_start = gtime();\n"
               "  auto issue = [&](int kt) {")
    src = edit(src, "  for (int kt = 0; kt < ntiles; ++kt) {\n",
               "  long long c_loop = clock64(), c_wait = 0, c_comp = 0;\n"
               "  for (int kt = 0; kt < ntiles; ++kt) {\n"
               "    long long c_t = clock64();\n")
    for what in ("(and C, dacs)", "(and the decay)"):
        line = f"    __syncthreads();                     // tile kt {what} arrived\n"
        src = edit(src, line, line + "    c_wait += clock64() - c_t;\n"
                                     "    c_t = clock64();\n")
    src = edit(src, "    __syncthreads();                     // stage kt & 1 "
               "free for tile kt + 2\n  }\n",
               "    c_comp += clock64() - c_t;\n"
               "    __syncthreads();\n  }\n  const long long c_end = clock64();\n")
    src = edit(src, "  if (kh == 0) store_rows<HD>(y + h * HD, ld, ra, c_len, "
               "acc);\n",
               "  if (kh == 0) store_rows<HD>(y + h * HD, ld, ra, c_len, "
               "acc);\n  STAMP_WRITE(1)\n")
    src = edit(src, "                   n - nn0, acc);\n}\n",
               "                   n - nn0, acc);\n  STAMP_WRITE(2)\n}\n")
    src += ('extern "C" int read_stamps(void* dst, int blocks) {\n'
            '  return int(cudaMemcpyFromSymbol(dst, g_stamps, size_t(blocks) '
            '* 8 * sizeof(unsigned long long)));\n}\n')
    return src


def timeline(tmp: Path) -> None:
    lib = build(timeline_source(), tmp, "timeline")
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for shape in chip_smoke.SSD_PREFILL:
        ops, nh, hd = operands(shape)
        call = caller(lib, ops, nh, hd)
        ms = chip_smoke.time_ms(call, None)
        torch.cuda._sleep(chip_smoke.SLEEP_CYCLES)
        call()
        torch.cuda.synchronize()
        b, nc, c, _ = ops[0].shape
        n = ops[2].shape[-1]
        blocks = ((c + 63) // 64 * nh + nh * ((n + 63) // 64)) * nc * b
        buf = (ctypes.c_ulonglong * (8 * blocks))()
        if lib.read_stamps(buf, blocks):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        rec = [buf[8 * i:8 * i + 8] for i in range(blocks)]
        g0 = min(r[5] for r in rec)
        span = (max(r[6] for r in rec) - g0) / 1e3
        print(f"timeline {shape}: {ms:.4f} ms timed, {blocks} blocks over "
              f"{span:.2f} us of globaltimer", flush=True)
        for kind, name in ((1, "y"), (2, "state")):
            for nt in sorted({r[7] for r in rec if r[0] == kind}):
                q = [r for r in rec if r[0] == kind and r[7] == nt]

                def med(i, q=q):
                    return statistics.median(r[i] for r in q)
                dur = [(r[6] - r[5]) / 1e3 for r in q]
                print(f"  {name} blocks, {nt} key tiles: {len(q)}; cycles: "
                      f"prologue {med(1):.0f}, waits {med(2):.0f}, "
                      f"arithmetic {med(3):.0f}, after the loop "
                      f"{med(4):.0f}; us median {statistics.median(dur):.2f}"
                      f", max {max(dur):.2f}; last start "
                      f"{max((r[5] - g0) / 1e3 for r in q):.2f} us",
                      flush=True)


def variants() -> dict[str, str]:
    kernel_top = "  const long long chunk = (long long)blockIdx.z * nc + blockIdx.y;"
    y_top = "    const int itile = n_itiles - 1 - task / nh;"
    state_top = "    const int n_ntiles = (n + BM - 1) / BM;"
    out = {"as is": SOURCE}
    out["empty blocks"] = edit(SOURCE, kernel_top,
                               "  if (nc > 0) return;\n" + kernel_top)
    out["y blocks only"] = edit(SOURCE, state_top, "    return;\n" + state_top)
    out["state blocks only"] = edit(SOURCE, y_top, "    return;\n" + y_top)
    out["heaviest y blocks only"] = edit(
        out["y blocks only"], y_top,
        y_top + "\n    if (itile != n_itiles - 1) return;")
    out["no score product"] = edit(SOURCE, "for (int k0 = 0; k0 < n8; k0 += 8)",
                                   "for (int k0 = 0; k0 < 0; k0 += 8)")
    out["first key tile copied only"] = edit(
        SOURCE, "    if (kt + 1 < ntiles) {\n      issue(kt + 1);",
        "    if (kt + 1 < ntiles) {\n      if (n < 0) issue(kt + 1);")
    out["no arithmetic"] = edit(edit(
        SOURCE, "    if (jw <= wmax) {", "    if (jw <= wmax && n < 0) {"),
        "    if (nn0 + rw < n && jw < c_len) {",
        "    if (nn0 + rw < n && jw < c_len && n < 0) {")
    out["no 2-block register cap"] = edit(
        SOURCE, "__launch_bounds__(NT, 2)", "__launch_bounds__(NT)")
    return out


def time_variants(tmp: Path) -> None:
    libs = {name: build(src, tmp, f"v{i}")
            for i, (name, src) in enumerate(variants().items())}
    cases = [operands(s) for s in chip_smoke.SSD_PREFILL]
    print(f"variants, device ms at {chip_smoke.SSD_PREFILL}:")
    for rnd in range(2):
        for name, lib in libs.items():
            ms = [chip_smoke.time_ms(caller(lib, *case), None)
                  for case in cases]
            print(f"  round {rnd} {name:28s} "
                  + " ".join(f"{m:.4f}" for m in ms), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card()}", flush=True)
    parts = sys.argv[1:] or ["rate", "timeline", "variants"]
    with tempfile.TemporaryDirectory() as tmp:
        for part in parts:
            {"rate": rate, "timeline": timeline,
             "variants": time_variants}[part](Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
