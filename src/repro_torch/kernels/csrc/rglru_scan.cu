// RG-LRU diagonal recurrence, fp32, sm_90a:
//   h_t = a_t * h_{t-1} + x_t   over (B, S, W), all h_t and the final h.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py rglru_scan (Pallas
// grid (B, W / bw, S / chunk) with the chunk axis sequential and h in VMEM
// scratch; S and W padded to the blocks with a = 1, x = 0). The width
// channels are independent, so here one thread owns one (sequence,
// channel), keeps h in a register and steps through exactly S steps:
// nothing is padded and nothing past S or W is read. Neighbouring threads
// hold neighbouring channels, so every load and store is coalesced along
// W. Each thread loads CH steps of a and x ahead into registers (2 * CH
// independent loads in flight) before it steps through them.
//
// Bound on an H100: bytes. Each (b, t, w) reads a and x and writes h,
// 12 bytes, against 2 flops; far below the fp32 ridge.
//
// The step is rounded as two operations (__fmul_rn, __fadd_rn), never
// contracted to an FMA, so the kernel repeats the plain PyTorch loop
// bit for bit.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 64;  // channels per block: 40 blocks per row at W 2560
constexpr int CH = 8;        // time steps loaded ahead

__global__ void rglru_kernel(const float* __restrict__ a,
                             const float* __restrict__ x,
                             const float* __restrict__ h0,
                             float* __restrict__ hs,
                             float* __restrict__ h_final, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  float h = h0[(size_t)b * W + w];
  size_t off = (size_t)b * S * W + w;
  int t = 0;
  for (; t + CH <= S; t += CH) {
    float av[CH], xv[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      av[c] = __ldg(a + off + (size_t)c * W);
      xv[c] = __ldg(x + off + (size_t)c * W);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      h = __fadd_rn(__fmul_rn(av[c], h), xv[c]);
      hs[off + (size_t)c * W] = h;
    }
    off += (size_t)CH * W;
  }
  for (; t < S; ++t, off += W) {
    h = __fadd_rn(__fmul_rn(__ldg(a + off), h), __ldg(x + off));
    hs[off] = h;
  }
  h_final[(size_t)b * W + w] = h;
}

}  // namespace

// a, x, hs (B,S,W) and h0, h_final (B,W), fp32 contiguous. Launches on
// `stream` without synchronising; returns the launch's cudaError_t (0 on
// success).
extern "C" int rglru_scan_f32(const float* a, const float* x, const float* h0,
                              float* hs, float* h_final, int B, int S, int W,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, x, h0, hs,
                                                          h_final, S, W);
  return (int)cudaGetLastError();
}
