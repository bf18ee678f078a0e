// Full-sequence GQA flash attention, forward only, fp32, sm_90a: q rows at
// positions 0..S-1 attend K/V rows at positions 0..T-1 under the causal
// and/or sliding-window mask (prefill semantics).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py flash_attention
// (Pallas grid (B, H, S/bq, T/bk) with the K sweep innermost and
// sequential, which fetched every K/V tile once per query head). Here one
// thread block serves one (sequence, KV head, tile of TQ query rows) and
// holds the tile's rows for all G = H / KV heads of the group, so each
// K/V tile is staged in shared memory once per query tile. The sweep runs
// only from the first K tile the window reaches to the tile holding the
// query tile's last causal position; K/V rows past T are never read.
// Bound on an H100: at prefill lengths the score and value products
// (4 * hd flops per attended (query row, key) pair), against 67 TFLOP/s
// fp32 outside the tensor cores; at short lengths the bytes of q, k, v
// and out.
#include "attention.cuh"

namespace {

constexpr int BK = 64;  // K/V slots staged per tile

__global__ void flash_kernel(const float* __restrict__ q,
                             float* __restrict__ out,
                             const float* __restrict__ k,
                             const float* __restrict__ v, int S, int T, int H,
                             int KV, int hd, int tq, int causal, int window,
                             float scale) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int i0 = tile * tq;
  const int n_rows = min(tq, S - i0);
  // q, out (B, S, H, hd): row i of the tile, heads of the group contiguous
  const size_t base = (((size_t)b * S + i0) * H + (size_t)kvh * G) * hd;
  // k, v (B, T, KV, hd): head kvh of sequence b
  const size_t kv_base = ((size_t)b * T * KV + kvh) * hd;
  const attn::DenseSrc src{(size_t)KV * hd, G, i0, T, causal, window};
  const int t_begin = window > 0 ? max(0, i0 - window + 1) : 0;
  const int t_end = causal ? min(T, i0 + n_rows) : T;
  attn::attend(q + base, out + base, (size_t)H * hd, n_rows, G, hd,
               k + kv_base, v + kv_base, (size_t)KV * hd, src, t_begin,
               t_end, BK, scale, smem);
}

}  // namespace

// q (B,S,H,hd), out (B,S,H,hd), k/v (B,T,KV,hd) fp32 contiguous; causal 0
// or 1; window <= 0 for none. Launches on `stream` without synchronising;
// returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_f32(const float* q, float* out, const float* k,
                                   const float* v, int B, int S, int T, int H,
                                   int KV, int hd, int causal, int window,
                                   float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  // 16 query rows per tile; fewer when a wide group would not fit the
  // shared memory a block may use
  int tq = 16;
  while (tq > 1 && attn::smem_bytes(tq * G, hd, BK) > attn::SMEM_MAX)
    tq /= 2;
  const size_t smem = attn::smem_bytes(tq * G, hd, BK);
  err = attn::allow_smem(flash_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + tq - 1) / tq, KV, B);
  flash_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      q, out, k, v, S, T, H, KV, hd, tq, causal, window, scale);
  return (int)cudaGetLastError();
}
