// Grouped per-expert GEMM, fp32, sm_90a:
//   out[e] = x[e] @ w[e]   for x (E, C, D), w (E, D, F), out (E, C, F).
//
// Replaces the TPU kernel repro/kernels/moe_matmul.py moe_matmul (Pallas
// grid (E, C / bc, F / bf, D / bd) with the contraction axis innermost and
// sequential, an f32 accumulator tile in VMEM, and C, D and F padded to the
// blocks with jnp.pad). Here one block owns one (C tile, F tile, expert),
// loops over D itself with its accumulators in registers, and guards its
// edges: it reads nothing past C, D or F, and nothing is padded.
//
// Bound on an H100: bytes on the serving path. The MoE capacity is 8 rows
// per expert at decode and at most 16 in a 512-token prefill chunk, so each
// weight element (4 bytes) meets at most 16 rows, 32 flops: below the fp32
// ridge (67 TFLOP/s over 3.35 TB/s, 20 flops a byte, 80 per weight). A
// round's one-shot prefill (C = 80 at arctic-480b's widths) crosses it. So
// the design streams w once, at the full width of the memory system:
// - each thread owns COLS = 4 neighbouring columns of the block's F tile
//   and reads them as one float4 (a warp reads 512 contiguous bytes of a
//   row of w; 128 threads a 2 KB row segment);
// - UNROLL = 8 rows of w are loaded before they are used: 8 independent
//   16-byte loads in flight per thread;
// - the block's C tile of x (CT = 8 or 16 rows) is staged in shared memory
//   DT rows of the contraction at a time, transposed to [d][c] so that one
//   float4 read hands four rows' x values to every thread (a broadcast);
// - each thread holds CT x 4 fp32 accumulators; plain FMA, no tensor cores.
// Blocks of one (expert, F tile) with different C tiles are neighbours in
// the grid (blockIdx.x), so when C > CT the later ones find w in L2.
// The wrapper guarantees F % 4 == 0 and a 16-byte aligned w and out, so a
// thread's four columns are all in range or none is.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 4;               // output columns per thread
constexpr int FT = THREADS * COLS;    // columns per block
constexpr int DT = 64;                // contraction rows staged per pass
constexpr int UNROLL = 8;             // rows of w loaded ahead

// acc[c][j] += x[c] * w[j] for the CT staged rows of one contraction step.
template <int CT>
__device__ __forceinline__ void fma_step(float (&acc)[CT][COLS],
                                         const float* xrow, float4 wv) {
#pragma unroll
  for (int q = 0; q < CT / 4; ++q) {
    const float4 xv = reinterpret_cast<const float4*>(xrow)[q];
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* a = acc[4 * q + r];
      a[0] = fmaf(xa[r], wv.x, a[0]);
      a[1] = fmaf(xa[r], wv.y, a[1]);
      a[2] = fmaf(xa[r], wv.z, a[2]);
      a[3] = fmaf(xa[r], wv.w, a[3]);
    }
  }
}

template <int CT>
__global__ void __launch_bounds__(THREADS)
moe_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int C, int D, int F) {
  __shared__ __align__(16) float xs[DT][CT];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CT;
  const int rows = min(CT, C - c0);
  const size_t e = blockIdx.z;
  const float* xe = x + (e * C + c0) * (size_t)D;
  const float* we = w + e * D * (size_t)F;
  float* oe = out + (e * C + c0) * (size_t)F;
  const int f = blockIdx.y * FT + COLS * tid;  // the thread's first column
  // past F, the thread only helps stage x
  const bool active = f < F;
  float acc[CT][COLS];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[c][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DT) {
    const int dn = min(DT, D - d0);
    __syncthreads();  // every thread is done with the previous x tile
    for (int i = tid; i < CT * DT; i += THREADS) {
      const int c = i / DT, dd = i % DT;  // neighbours read neighbouring d
      xs[dd][c] = (c < rows && dd < dn)
                      ? __ldg(xe + (size_t)c * D + d0 + dd) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const float* wr = we + (size_t)d0 * F;
    int dd = 0;
    for (; dd + UNROLL <= dn; dd += UNROLL) {
      float4 wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        wv[u] = __ldg(reinterpret_cast<const float4*>(
            wr + (size_t)(dd + u) * F + f));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) fma_step<CT>(acc, xs[dd + u], wv[u]);
    }
    for (; dd < dn; ++dd)
      fma_step<CT>(acc, xs[dd], __ldg(reinterpret_cast<const float4*>(
                                    wr + (size_t)dd * F + f)));
  }
  if (!active) return;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    if (c >= rows) continue;
    *reinterpret_cast<float4*>(oe + (size_t)c * F + f) =
        make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
  }
}

template <int CT>
void launch(const float* x, const float* w, float* out, int E, int C, int D,
            int F, cudaStream_t stream) {
  const dim3 grid((C + CT - 1) / CT, (F + FT - 1) / FT, E);
  moe_matmul_kernel<CT><<<grid, THREADS, 0, stream>>>(x, w, out, C, D, F);
}

}  // namespace

// x (E,C,D), w (E,D,F), out (E,C,F), fp32 contiguous, F % 4 == 0, w and
// out 16-byte aligned; E, C, F >= 1, E <= 65535. Launches on `stream`
// without synchronising; returns the launch's cudaError_t (0 on success).
extern "C" int moe_matmul_f32(const float* x, const float* w, float* out,
                              int E, int C, int D, int F, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C <= 8)
    launch<8>(x, w, out, E, C, D, F, s);
  else
    launch<16>(x, w, out, E, C, D, F, s);
  return (int)cudaGetLastError();
}
