// Full-sequence GQA flash attention, forward only, fp32, sm_90a: q rows at
// positions 0..S-1 attend K/V rows at positions 0..T-1 under the causal
// and/or sliding-window mask (prefill semantics).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py flash_attention
// (Pallas grid (B, H, S/bq, T/bk) with the K sweep innermost and
// sequential, which fetched every K/V tile once per query head). Here the
// prefill body of paged_attention.cuh (the one paged prefill runs) reads
// contiguous K/V (its DENSE source): one block of 256 threads per
// (sequence, KV head, tile of tq = 64 / G query rows) holds the tile's
// rows for all G = H / KV heads of the group, 64 score rows, and streams
// K/V tiles of 64 slots (32 at hd > 128) through a two-stage cp.async
// ring, with both products in register micro-tiles. It sweeps only from
// the tile holding its first row's window edge to its last row's causal
// limit (every K/V row when not causal); K/V rows past T are zero-filled,
// never read, and only the tiles that cross an edge are masked. The grid
// (tiles, KV, B) launches the heaviest query tile first. Bound on an H100:
// at prefill lengths the score and value products (4 * hd flops per
// attended (query row, key) pair) against 67 TFLOP/s fp32 outside the
// tensor cores; at short lengths the bytes of q, k, v and out.
#include "paged_attention.cuh"

// q (B,S,H,hd), out (B,S,H,hd), k/v (B,T,KV,hd) fp32 contiguous; causal 0
// or 1; window <= 0 for none; G = H / KV <= 64, hd <= 256 (the tile plan:
// launch_prefill). Launches on `stream` without synchronising; returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_attention_f32(const float* q, float* out, const float* k,
                                   const float* v, int B, int S, int T, int H,
                                   int KV, int hd, int causal, int window,
                                   float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  pattn::PrefillArgs a{};
  a.q = q;
  a.out = out;
  a.k = k;
  a.v = v;
  a.T = S;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.T_kv = T;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return (int)pattn::launch_prefill<pattn::DENSE>(a, B,
                                                  (cudaStream_t)stream);
}
