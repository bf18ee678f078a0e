// RWKV-6 WKV recurrence, fp32, sm_90a. Per (sequence, head) with a
// (hd, hd) state S and the step's r, k, v, w (hd,) and the bonus u (hd,):
//   out_t[j] = sum_i r_i (S_ij + u_i k_i v_j)
//   S_ij    <- w_i S_ij + k_i v_j            (decay per key channel i)
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py rwkv6_scan (Pallas
// grid (B, H, S / chunk), chunk axis sequential with the state in VMEM
// scratch; S padded to the chunk with w = 1, r = k = v = 0). Here, as in
// the RWKV CUDA kernel that the TPU kernel's docstring names, one thread
// block owns one (sequence, head) and steps through exactly S steps;
// thread j holds column j of the state in registers. Each step's r, k
// and w are staged in shared memory (double-buffered: one barrier per
// step) and every thread sweeps the hd key channels with float4 reads;
// thread j loads the next step's values while it computes this one.
// Nothing past S is read. Head sizes up to 128 are supported: the block
// has HD = 32, 64 or 128 threads, and the channels past hd hold zeros.
//
// Bound on an H100: per (b, t, head) about 20 * hd bytes (r, k, v, w
// read, out written) against 5 * hd^2 + 5 * hd flops (r . S, the decay
// and update; the bonus factors as v_j * sum_i r_i u_i k_i), so bytes
// lead slightly at hd 64 between the 3.35 TB/s of HBM and the 67 TFLOP/s
// of fp32 outside the tensor cores. This simple form runs one block per
// (sequence, head), a few per cent of the card at small batch; chunked
// two-pass scans come later.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

template <int HD>
__global__ void __launch_bounds__(HD)
rwkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ out, float* __restrict__ s_final, int S,
             int H, int hd) {
  __shared__ __align__(16) float sr[2][HD];
  __shared__ __align__(16) float sk[2][HD];
  __shared__ __align__(16) float sw[2][HD];
  __shared__ __align__(16) float su[HD];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const bool live = j < hd;
  // state (B, H, hd, hd): row i, column j
  const size_t s_base = ((size_t)b * H + h) * hd * hd;
  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i)
    st[i] = (live && i < hd) ? s0[s_base + (size_t)i * hd + j] : 0.f;
  su[j] = live ? u[(size_t)h * hd + j] : 0.f;
  // r, k, v, w, out (B, S, H, hd): element (b, t, h, j)
  const size_t step = (size_t)H * hd;
  size_t off = ((size_t)b * S * H + h) * hd + j;
  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
  if (live && S > 0) {
    rn = __ldg(r + off); kn = __ldg(k + off);
    vn = __ldg(v + off); wn = __ldg(w + off);
  }
  for (int t = 0; t < S; ++t, off += step) {
    const int buf = t & 1;
    const float vj = vn;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sw[buf][j] = wn;
    __syncthreads();
    if (live && t + 1 < S) {
      const size_t o = off + step;
      rn = __ldg(r + o); kn = __ldg(k + o);
      vn = __ldg(v + o); wn = __ldg(w + o);
    }
    float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
    for (int i = 0; i < HD; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(&sr[buf][i]);
      const float4 k4 = *reinterpret_cast<const float4*>(&sk[buf][i]);
      const float4 w4 = *reinterpret_cast<const float4*>(&sw[buf][i]);
      const float4 u4 = *reinterpret_cast<const float4*>(&su[i]);
      float kv;
      kv = k4.x * vj; y0 += r4.x * (st[i] + u4.x * kv);
      st[i] = w4.x * st[i] + kv;
      kv = k4.y * vj; y1 += r4.y * (st[i + 1] + u4.y * kv);
      st[i + 1] = w4.y * st[i + 1] + kv;
      kv = k4.z * vj; y2 += r4.z * (st[i + 2] + u4.z * kv);
      st[i + 2] = w4.z * st[i + 2] + kv;
      kv = k4.w * vj; y3 += r4.w * (st[i + 3] + u4.w * kv);
      st[i + 3] = w4.w * st[i + 3] + kv;
    }
    if (live) out[off] = (y0 + y1) + (y2 + y3);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < HD; ++i)
      if (i < hd) s_final[s_base + (size_t)i * hd + j] = st[i];
  }
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0,
                   float* out, float* s_final, int B, int S, int H, int hd,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  rwkv6_kernel<HD><<<grid, HD, 0, stream>>>(r, k, v, w, u, s0, out, s_final,
                                            S, H, hd);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, out (B,S,H,hd); u (H,hd); state, s_final (B,H,hd,hd); fp32
// contiguous, 1 <= hd <= 128. Launches on `stream` without synchronising;
// returns the launch's cudaError_t (0 on success).
extern "C" int rwkv6_scan_f32(const float* r, const float* k, const float* v,
                              const float* w, const float* u,
                              const float* state, float* out, float* s_final,
                              int B, int S, int H, int hd, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  if (hd <= 32) return (int)launch<32>(r, k, v, w, u, state, out, s_final, B,
                                       S, H, hd, st);
  if (hd <= 64) return (int)launch<64>(r, k, v, w, u, state, out, s_final, B,
                                       S, H, hd, st);
  return (int)launch<128>(r, k, v, w, u, state, out, s_final, B, S, H, hd,
                          st);
}
