// Paged chunk-prefill attention, fp32, sm_90a: T chunk queries per
// sequence, row i at absolute position pos[b] + i, attend the block pool
// through the block table under the mask slot <= pos[b] + i (GQA).
//
// Replaces the TPU kernel repro/kernels/prefill_attention.py
// paged_prefill_attention (Pallas grid (B, H, nb) holding the whole padded
// chunk resident per query head). Here one thread block serves one
// (sequence, KV head, tile of TQ query rows) and holds the tile's rows for
// all G = H / KV heads of the group: TQ = 16 rows times G heads fits in
// shared memory at any T, including T = 512. Each live K/V block is
// staged once per tile; the sweep stops at the tile's last live block, so
// early tiles read less. Rows i >= T are neither computed nor written.
// Bound on an H100: bytes of live K/V at small T; at large T the score and
// value products (4 * hd flops per query row and attended slot), against
// 67 TFLOP/s fp32 outside the tensor cores.
#include "attention.cuh"

namespace {

__global__ void paged_prefill_kernel(const float* __restrict__ q,
                                     float* __restrict__ out,
                                     const float* __restrict__ k_pool,
                                     const float* __restrict__ v_pool,
                                     const int* __restrict__ tables,
                                     const int* __restrict__ pos, int T,
                                     int H, int KV, int hd, int n_pool,
                                     int bs, int nb, int tq, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int i0 = tile * tq;
  const int n_rows = min(tq, T - i0);
  // q, out (B, T, H, hd): row i of the tile, heads of the group contiguous
  const size_t base = (((size_t)b * T + i0) * H + (size_t)kvh * G) * hd;
  const int lim0 = pos[b] + i0;
  const attn::PagedSrc src{tables + (size_t)b * nb, n_pool, bs, G, lim0,
                           (size_t)bs * KV * hd};
  // the sweep stops at the last row's limit; slots past the table's nb
  // blocks do not exist
  const int t_end = min(lim0 + n_rows, nb * bs);
  attn::attend(q + base, out + base, (size_t)H * hd, n_rows, G, hd,
               k_pool + (size_t)kvh * hd, v_pool + (size_t)kvh * hd,
               (size_t)KV * hd, src, 0, t_end, bs, scale, smem);
}

}  // namespace

// q (B,T,H,hd), out (B,T,H,hd), pools (n_pool,bs,KV,hd) fp32 contiguous;
// tables (B,nb), pos (B,) int32. Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
extern "C" int paged_prefill_attention_f32(
    const float* q, float* out, const float* k_pool, const float* v_pool,
    const int* tables, const int* pos, int B, int T, int H, int KV, int hd,
    int n_pool, int bs, int nb, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  // 16 query rows per tile; fewer when a wide group would not fit the
  // 227 KB of shared memory a block may use
  int tq = 16;
  while (tq > 1 && attn::smem_bytes(tq * G, hd, bs) > attn::SMEM_MAX)
    tq /= 2;
  const size_t smem = attn::smem_bytes(tq * G, hd, bs);
  err = attn::allow_smem(paged_prefill_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tq - 1) / tq, KV, B);
  paged_prefill_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      q, out, k_pool, v_pool, tables, pos, T, H, KV, hd, n_pool, bs, nb, tq,
      scale);
  return (int)cudaGetLastError();
}
