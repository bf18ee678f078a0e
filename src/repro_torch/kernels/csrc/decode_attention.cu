// Dense-cache decode attention, fp32, sm_90a: one query token per sequence
// attends its (C, KV, hd) cache row under a validity mask (B, C) that
// carries the linear frontier, ring-buffer holes and the window (GQA).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// decode_attention (Pallas grid (B, H, C/bc), which streamed the whole
// cache once per query head and multiplied masked slots' values by zero).
// Here the decode body of paged_attention.cuh (the one paged decode runs)
// reads the cache row directly (its DENSE source): one block of eight
// warps per (KV head, chunk of at most 8 query heads, split of C,
// sequence) holds the chunk's heads in registers, and each warp reads a
// valid slot's K and V as one coalesced 16-byte load per lane, several
// slots in flight, with no staging and no barrier in the sweep. A slot
// marked invalid is never loaded and weighs 0, so it may hold anything,
// NaN included; a split or a row with no valid slot contributes nothing
// (a row with none at all comes out as zeros). With n_splits > 1 each
// split writes its partials and splitk_combine_kernel merges them, as in
// paged split-K: at recurrentgemma-2b's MQA shape (B * KV = 8) the splits
// are what fills the card's 132 SMs. Bound on an H100: the bytes of the
// valid K/V (4 * hd flops per 8 * hd bytes per head pair, far below the
// fp32 ridge).
#include "paged_attention.cuh"

// q (B,1,H,hd), out (B,1,H,hd), k/v (B,C,KV,hd) fp32 contiguous; valid
// (B,C) one byte per slot, nonzero = attend; hd <= 256. Split s sweeps
// slots [s * split_slots, (s + 1) * split_slots), split_slots a multiple
// of 16; with n_splits > 1, acc (B,H,n_splits,hd), m and l (B,H,n_splits)
// are fp32 scratch (unused, may be null, with one split). Launches on
// `stream` without synchronising; returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int decode_attention_f32(const float* q, float* out, float* acc,
                                    float* m, float* l, const float* k,
                                    const float* v,
                                    const unsigned char* valid, int B, int C,
                                    int H, int KV, int hd, int n_splits,
                                    int split_slots, float scale, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  pattn::DecodeArgs a{};
  a.q = q;
  a.out = out;
  a.acc = acc;
  a.m = m;
  a.l = l;
  a.k = k;
  a.v = v;
  a.valid = valid;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.C = C;
  a.n_splits = n_splits;
  a.split_slots = split_slots;
  a.scale = scale;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(n_splits > 1
                   ? pattn::launch_decode_splitk<pattn::DENSE>(a, B, st)
                   : pattn::launch_decode<pattn::DENSE, false>(a, B, st));
}
