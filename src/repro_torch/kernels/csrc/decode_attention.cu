// Dense-cache decode attention, fp32, sm_90a: one query token per sequence
// attends its (C, KV, hd) cache row under a validity mask (B, C) that
// carries the linear frontier, ring-buffer holes and the window (GQA).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// decode_attention (Pallas grid (B, H, C/bc), which streamed the whole
// cache once per query head and multiplied masked slots' values by zero).
// Here one thread block serves one (sequence, KV head) and holds all
// G = H / KV query heads of the group; it sweeps C in tiles staged in
// shared memory and reads K/V only at valid slots, skipping tiles with
// none, so invalid slots may hold anything, NaN included.
// Bound on an H100: the bytes of the valid K/V (4 * hd flops per 8 * hd
// bytes per head pair, far below the fp32 ridge).
#include "attention.cuh"

namespace {

constexpr int BK = 64;  // cache slots staged per tile

__global__ void decode_kernel(const float* __restrict__ q,
                              float* __restrict__ out,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const unsigned char* __restrict__ valid, int C,
                              int H, int KV, int hd, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  // q, out (B, 1, H, hd): the group's heads are contiguous
  const size_t base = ((size_t)b * H + (size_t)kvh * G) * hd;
  // k, v (B, C, KV, hd): head kvh of sequence b
  const size_t kv_base = ((size_t)b * C * KV + kvh) * hd;
  const attn::ValidSrc src{valid + (size_t)b * C, (size_t)KV * hd};
  attn::attend(q + base, out + base, (size_t)H * hd, 1, G, hd, k + kv_base,
               v + kv_base, (size_t)KV * hd, src, 0, C, BK, scale, smem);
}

}  // namespace

// q (B,1,H,hd), out (B,1,H,hd), k/v (B,C,KV,hd) fp32 contiguous; valid
// (B,C) one byte per slot, nonzero = attend. Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
extern "C" int decode_attention_f32(const float* q, float* out, const float* k,
                                    const float* v, const unsigned char* valid,
                                    int B, int C, int H, int KV, int hd,
                                    float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::smem_bytes(H / KV, hd, BK);
  err = attn::allow_smem(decode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KV, B);
  decode_kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(
      q, out, k, v, valid, C, H, KV, hd, scale);
  return (int)cudaGetLastError();
}
