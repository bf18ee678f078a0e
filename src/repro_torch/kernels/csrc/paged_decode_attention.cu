// Paged decode attention, fp32, sm_90a: one query token per sequence
// attends its KV blocks through the block table (GQA).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// paged_decode_attention (Pallas grid (B, H, nb), which streamed every K/V
// block once per query head). Here one thread block serves one
// (sequence, KV head) and holds all G = H / KV query heads of the group,
// so each live K/V block is read from device memory once. The sweep loads
// block_tables[b, j] itself, only for live j < ceil(seq_lens[b] / bs).
// Bound on an H100: the bytes of live K/V (decode does 4 * hd flops per
// 8 * hd bytes of K/V per head pair, far below the fp32 ridge).
#include "attention.cuh"

namespace {

__global__ void paged_decode_kernel(const float* __restrict__ q,
                                    float* __restrict__ out,
                                    const float* __restrict__ k_pool,
                                    const float* __restrict__ v_pool,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ seq_lens, int H,
                                    int KV, int hd, int n_pool, int bs,
                                    int nb, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  // q, out (B, 1, H, hd): the group's heads are contiguous
  const size_t base = ((size_t)b * H + (size_t)kvh * G) * hd;
  const int lim0 = seq_lens[b] - 1;
  const attn::PagedSrc src{tables + (size_t)b * nb, n_pool, bs, G, lim0,
                           (size_t)bs * KV * hd};
  // slots past the table's nb blocks do not exist
  const int t_end = min(lim0 + 1, nb * bs);
  attn::attend(q + base, out + base, (size_t)H * hd, 1, G, hd,
               k_pool + (size_t)kvh * hd, v_pool + (size_t)kvh * hd,
               (size_t)KV * hd, src, 0, t_end, bs, scale, smem);
}

}  // namespace

// q (B,1,H,hd), out (B,1,H,hd), pools (n_pool,bs,KV,hd) fp32 contiguous;
// tables (B,nb), seq_lens (B,) int32. Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode_attention_f32(
    const float* q, float* out, const float* k_pool, const float* v_pool,
    const int* tables, const int* seq_lens, int B, int H, int KV, int hd,
    int n_pool, int bs, int nb, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn::smem_bytes(H / KV, hd, bs);
  err = attn::allow_smem(paged_decode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KV, B);
  paged_decode_kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(
      q, out, k_pool, v_pool, tables, seq_lens, H, KV, hd, n_pool, bs, nb,
      scale);
  return (int)cudaGetLastError();
}
