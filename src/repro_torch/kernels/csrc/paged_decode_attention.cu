// Paged decode attention, fp32, sm_90a: one query token per sequence
// attends its KV blocks through the block table (GQA).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// paged_decode_attention (Pallas grid (B, H, nb), which streamed every K/V
// block once per query head). Here one block of eight warps serves one
// (KV head, sequence) and holds the G = H / KV query heads of the group in
// registers (groups past 8 heads in chunks), so each live K/V slot is read
// from device memory once, by one warp, as one coalesced 16-byte load per
// lane; the warps sweep disjoint slots with no barrier and merge once at
// the end (paged_attention.cuh, the decode body over its PAGED source). It
// loads its own table entries, only for live columns j < ceil(seq_lens[b]
// / bs). Bound on an H100: the bytes of live K/V (4 * hd flops per 8 * hd
// bytes per head pair, far below the fp32 ridge), so the body keeps 8 to
// 16 independent 16-byte loads per lane in flight.
// This is the one-split case of the split-K kernel
// (paged_decode_attention_splitk.cu, the same body with several splits
// writing partials); decode_splits in kernels/decode_attention.py picks
// between them from measured times.
#include "paged_attention.cuh"

// q (B,1,H,hd), out (B,1,H,hd), pools (n_pool,bs,KV,hd) fp32 contiguous;
// tables (B,nb), seq_lens (B,) int32; hd <= 256. Launches on `stream`
// without synchronising; returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode_attention_f32(
    const float* q, float* out, const float* k_pool, const float* v_pool,
    const int* tables, const int* seq_lens, int B, int H, int KV, int hd,
    int n_pool, int bs, int nb, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  pattn::DecodeArgs a{};
  a.q = q;
  a.out = out;
  a.k = k_pool;
  a.v = v_pool;
  a.tables = tables;
  a.seq_lens = seq_lens;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.n_pool = n_pool;
  a.bs = bs;
  a.nb = nb;
  a.n_splits = 1;
  a.split_slots = nb * bs;
  a.scale = scale;
  return (int)pattn::launch_decode<pattn::PAGED, false>(a, B,
                                                       (cudaStream_t)stream);
}
