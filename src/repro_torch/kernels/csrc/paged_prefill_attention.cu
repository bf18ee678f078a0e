// Paged chunk-prefill attention, fp32, sm_90a: T chunk queries per
// sequence, row i at absolute position pos[b] + i, attend the block pool
// through the block table under the mask slot <= pos[b] + i (GQA).
//
// Replaces the TPU kernel repro/kernels/prefill_attention.py
// paged_prefill_attention (Pallas grid (B, H, nb) holding the whole padded
// chunk resident per query head). Here one block of 256 threads serves one
// (sequence, KV head, tile of tq query rows) and holds the tile's rows for
// all G = H / KV heads of the group: 64 score rows, tq = 64 / G (32 at
// qwen3-0.6b's G = 2, so a 512-token chunk is 16 tiles x 8 KV heads = 128
// blocks on 132 SMs). It sweeps 64-slot K/V tiles (four pool blocks) up
// to its last row's position, staged with cp.async into a two-stage ring
// so the next tile loads while this one computes, and tiles both products
// in registers (4 x 4 micro-tiles of S = Q K^T, 4 rows x 8 dims of
// O += P V): the body in paged_attention.cuh. Rows i >= T are neither
// computed nor written. Bound on an H100: at large T the two products
// (4 * hd flops per query row and attended slot) against 67 TFLOP/s fp32
// outside the tensor cores; the bytes of live K/V at small T.
#include "paged_attention.cuh"

// q (B,T,H,hd), out (B,T,H,hd), pools (n_pool,bs,KV,hd) fp32 contiguous;
// tables (B,nb), pos (B,) int32; G = H / KV <= 64, hd <= 256. The tile
// plan is derived here: tq = 64 / G query rows per block and
// prefill_tile_slots(hd / 64) slots per K/V tile (64, or 32 at hd > 128).
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).
extern "C" int paged_prefill_attention_f32(
    const float* q, float* out, const float* k_pool, const float* v_pool,
    const int* tables, const int* pos, int B, int T, int H, int KV, int hd,
    int n_pool, int bs, int nb, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  if (G < 1 || G > pattn::PF_ROWS) return cudaErrorInvalidValue;
  const int tq = pattn::PF_ROWS / G;
  const int nj = (hd + 63) / 64;
  const int tk = pattn::prefill_tile_slots(nj);
  const size_t smem = pattn::prefill_smem_bytes(nj, tk);
  const pattn::PrefillArgs a{q, out, k_pool, v_pool, tables, pos, T, H, KV,
                             hd, n_pool, bs, nb, tq, scale};
  const dim3 grid((T + tq - 1) / tq, KV, B);
  const cudaStream_t st = (cudaStream_t)stream;
#define PATTN_PREFILL_CASE(NJ_, TK_)                                       \
  if (nj == NJ_ && tk == TK_) {                                            \
    err = pattn::allow_smem(pattn::paged_prefill_kernel<NJ_, TK_>, smem);  \
    if (err != cudaSuccess) return (int)err;                               \
    pattn::paged_prefill_kernel<NJ_, TK_>                                  \
        <<<grid, pattn::PF_THREADS, smem, st>>>(a);                        \
    return (int)cudaGetLastError();                                        \
  }
  PATTN_PREFILL_CASE(1, 64)
  PATTN_PREFILL_CASE(2, 64)
  PATTN_PREFILL_CASE(3, 32)
  PATTN_PREFILL_CASE(4, 32)
#undef PATTN_PREFILL_CASE
  return cudaErrorInvalidValue;
}
