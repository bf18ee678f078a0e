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
// O += P V): the prefill body of paged_attention.cuh over its PAGED
// source (flash_attention.cu runs the same body over contiguous K/V). Rows
// i >= T are neither computed nor written. Bound on an H100: at large T
// the two products (4 * hd flops per query row and attended slot) against
// 67 TFLOP/s fp32 outside the tensor cores; the bytes of live K/V at
// small T.
#include "paged_attention.cuh"

// q (B,T,H,hd), out (B,T,H,hd), pools (n_pool,bs,KV,hd) fp32 contiguous;
// tables (B,nb), pos (B,) int32; G = H / KV <= 64, hd <= 256 (the tile
// plan: launch_prefill). Launches on `stream` without synchronising;
// returns the launch's cudaError_t (0 on success).
extern "C" int paged_prefill_attention_f32(
    const float* q, float* out, const float* k_pool, const float* v_pool,
    const int* tables, const int* pos, int B, int T, int H, int KV, int hd,
    int n_pool, int bs, int nb, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  pattn::PrefillArgs a{};
  a.q = q;
  a.out = out;
  a.k = k_pool;
  a.v = v_pool;
  a.tables = tables;
  a.pos = pos;
  a.T = T;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.n_pool = n_pool;
  a.bs = bs;
  a.nb = nb;
  a.scale = scale;
  return (int)pattn::launch_prefill<pattn::PAGED>(a, B,
                                                  (cudaStream_t)stream);
}
