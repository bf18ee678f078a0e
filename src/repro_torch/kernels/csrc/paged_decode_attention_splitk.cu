// Split-K paged decode attention, fp32, sm_90a: one query token per
// sequence attends its KV blocks through the block table (GQA), with the
// logical sweep cut into n_splits segments that run as separate blocks.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// paged_decode_attention_splitk (Pallas grid (B, H, n_splits, bps), which
// streamed every K/V block once per query head, then merged the splits'
// partials outside the kernel). Here two kernels run back to back on the
// stream (paged_attention.cuh, launch_decode_splitk):
//   1. the decode body over its PAGED source (the one
//      paged_decode_attention.cu runs whole), grid (KV * chunks, n_splits,
//      B): one block of eight warps per (KV head, split, sequence) holds
//      the group's query heads in registers, so each live K/V slot is read
//      once. Split s sweeps the logical blocks [s * bps, (s + 1) * bps)
//      that lie inside the table and before seq_lens[b]: the last split's
//      range is cut at nb before any table read, and blocks past the
//      frontier are never read. It writes the split's UNNORMALISED
//      accumulator and its max m and denominator l; an empty split writes
//      m = NEG, l = 0 and acc = 0.
//   2. splitk_combine_kernel, grid (H, B), the log-sum-exp merge of the
//      partials (dense decode's splits use it too).
// Why split: one block per (KV head, sequence) runs KV * B blocks, 32 at
// qwen3-0.6b's 8 KV heads and 4 sequences, on 132 SMs; the split
// multiplies that by n_splits. Bound on an H100: the bytes of live K/V,
// plus q, the output and the partials written and read back.
#include "paged_attention.cuh"

// q (B,1,H,hd), out (B,1,H,hd), pools (n_pool,bs,KV,hd) fp32 contiguous;
// acc (B,H,n_splits,hd), m and l (B,H,n_splits) fp32 scratch; tables
// (B,nb), seq_lens (B,) int32; n_splits * bps >= nb > (n_splits - 1) *
// bps; hd <= 256. Launches both kernels on `stream`
// without synchronising; returns the first failing launch's cudaError_t
// (0 on success).
extern "C" int paged_decode_attention_splitk_f32(
    const float* q, float* out, float* acc, float* m, float* l,
    const float* k_pool, const float* v_pool, const int* tables,
    const int* seq_lens, int B, int H, int KV, int hd, int n_pool, int bs,
    int nb, int n_splits, int bps, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  pattn::DecodeArgs a{};
  a.q = q;
  a.out = out;
  a.acc = acc;
  a.m = m;
  a.l = l;
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
  a.n_splits = n_splits;
  a.split_slots = bps * bs;
  a.scale = scale;
  return (int)pattn::launch_decode_splitk<pattn::PAGED>(
      a, B, (cudaStream_t)stream);
}
