// Split-K paged decode attention, fp32, sm_90a: one query token per
// sequence attends its KV blocks through the block table (GQA), with the
// logical sweep cut into n_splits segments that run as separate blocks.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// paged_decode_attention_splitk (Pallas grid (B, H, n_splits, bps), which
// streamed every K/V block once per query head, then merged the splits'
// partials outside the kernel). Here two kernels run back to back on the
// stream:
//   1. the decode body of paged_attention.cuh (the one
//      paged_decode_attention.cu runs whole), grid (KV * chunks, n_splits,
//      B): one block of eight warps per (KV head, split, sequence) holds
//      the group's query heads in registers, so each live K/V slot is read
//      once. Split s sweeps the logical blocks [s * bps, (s + 1) * bps)
//      that lie inside the table and before seq_lens[b]: the last split's
//      range is cut at nb before any table read, and blocks past the
//      frontier are never read. It writes the split's UNNORMALISED
//      accumulator and its max m and denominator l; an empty split writes
//      m = NEG, l = 0 and acc = 0.
//   2. splitk_combine_kernel, grid (H, B): rescales each split to the
//      global max, w_s = exp(m_s - max_s m_s) (an empty split weighs
//      exp(NEG - m) = 0), and writes sum_s w_s acc_s / max(sum_s w_s l_s,
//      1e-30). A second small kernel rather than a last-block-done
//      counter: no atomics and no counter to reset between launches.
// Why split: one block per (KV head, sequence) runs KV * B blocks, 32 at
// qwen3-0.6b's 8 KV heads and 4 sequences, on 132 SMs; the split
// multiplies that by n_splits. Bound on an H100: the bytes of live K/V,
// plus q, the output and the partials written and read back.
#include "paged_attention.cuh"

namespace {

__global__ void splitk_combine_kernel(const float* __restrict__ acc,
                                      const float* __restrict__ m,
                                      const float* __restrict__ l,
                                      float* __restrict__ out, int H, int hd,
                                      int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const float* ms = m + bh * n_splits;
  const float* ls = l + bh * n_splits;
  float m_g = pattn::NEG;
  for (int s = 0; s < n_splits; ++s) m_g = fmaxf(m_g, ms[s]);
  float l_g = 0.f;
  for (int s = 0; s < n_splits; ++s) l_g += ls[s] * expf(ms[s] - m_g);
  l_g = fmaxf(l_g, 1e-30f);
  const float* as = acc + bh * n_splits * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < n_splits; ++s)
      o += as[(size_t)s * hd + d] * expf(ms[s] - m_g);
    out[bh * hd + d] = o / l_g;
  }
}

}  // namespace

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
  const cudaStream_t st = (cudaStream_t)stream;
  const pattn::DecodeArgs a{q, nullptr, acc, m, l, k_pool, v_pool, tables,
                            seq_lens, H, KV, hd, n_pool, bs, nb, n_splits,
                            bps, /*n_chunks=*/0, scale};
  err = pattn::launch_decode<true>(a, B, st);
  if (err != cudaSuccess) return (int)err;
  splitk_combine_kernel<<<dim3(H, B), 128, 0, st>>>(acc, m, l, out, H, hd,
                                                    n_splits);
  return (int)cudaGetLastError();
}
