// RG-LRU diagonal recurrence, fp32, sm_90a:
//   h_t = a_t * h_{t-1} + x_t   over (B, S, W), all h_t and the final h.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py rglru_scan (Pallas
// grid (B, W / bw, S / chunk) with the chunk axis sequential and h in VMEM
// scratch; S and W padded to the blocks with a = 1, x = 0).
//
// Bound on an H100: bytes. Each (b, t, w) reads a and x and writes h,
// 12 bytes, against 2 flops; far below the fp32 ridge. To run at the
// 3.35 TB/s of HBM the card needs about 3.4 MB in flight (the rate times
// a round trip of about 1 us), and one channel's recurrence is serial.
//
// Design: a deep copy pipeline, and a split over time where the channels
// alone cannot keep enough bytes in flight.
// - One block is one warp of CB = 32 neighbouring channels (a lane per
//   channel, 128 bytes of a row: whole 32-byte sectors) over one chunk of
//   time of one sequence. a and x stream through a ring of RING = 32 steps
//   in shared memory with cp.async (16-byte copies: one round of the
//   warp's copies brings a and x of two steps), so 32 steps of every
//   channel are in flight while the lane steps through the ring.
// - One pass (the plan's one chunk, e.g. B = 8 at W = 2560: 20,480
//   channels, 5.2 MB in flight): each lane runs its channel's exact
//   sequential recurrence from h0.
// - Two passes (B * W too small, e.g. B = 1 at W = 2560, where one pass
//   took 0.049 ms on an H100 and 16 chunks 0.014): S is split into
//   C <= 16 chunks of L steps (rglru_plan in rglru_scan.py). Pass 1
//   composes each chunk but the last into a summary, A = prod a and X = h
//   from 0, written to a (2, B, C, W) scratch. Pass 2 folds the summaries
//   of the chunks before its own into its start state (at most C - 1
//   steps, the summaries loaded together while the chunk's copies fly),
//   then runs the chunk's exact sequential recurrence from there, writing
//   hs and, in the last chunk, h_final. Pass 2's re-read of a and x finds
//   them in the 50 MB L2 at the shapes that split.
//
// Every step is rounded as two operations (__fmul_rn, __fadd_rn), never
// contracted to an FMA, so one pass repeats the plain PyTorch loop bit for
// bit; with two passes only the chunks' start states are rounded
// differently, and that difference decays by a. Nothing past S or W is
// read.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int CB = 32;          // channels per block: one warp
constexpr int RING = 32;        // steps of a and x in flight per channel
constexpr int MAX_CHUNKS = 16;  // time chunks of the two-pass form

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const float *a, *x, *h0;
  float *hs, *h_final;
  float *sum_a, *sum_x;  // (B, C, W) each: the chunks' summaries
  int S, W, n_chunks, L;
};

// Start the copies of steps 2p and 2p + 1 of the chunk (those below n)
// into their ring slots: a and x rows of the block's ncol channels. VEC:
// 16-byte pieces, one per lane (2 steps x 2 arrays x 8 pieces); else 4
// bytes, four per lane.
template <bool VEC>
__device__ __forceinline__ void fetch_pair(float (*ring)[2][CB], const Args& g,
                                      size_t base, int p, int n, int ncol) {
  const int lane = threadIdx.x;
  if (VEC) {
    const int t = 2 * p + (lane >> 4), arr = (lane >> 3) & 1,
              e = 4 * (lane & 7);
    if (t < n && e < ncol)
      cp_async16(&ring[t % RING][arr][e],
                 (arr ? g.x : g.a) + base + (size_t)t * g.W + e);
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int t = 2 * p + s;
      if (t < n && lane < ncol) {
        cp_async4(&ring[t % RING][0][lane], g.a + base + (size_t)t * g.W +
                                                lane);
        cp_async4(&ring[t % RING][1][lane], g.x + base + (size_t)t * g.W +
                                                lane);
      }
    }
  }
  cp_async_commit();  // one group per pair, empty past the chunk's end
}

// SUMMARY: pass 1 (compose chunk blockIdx.y from h = 0 into A, X);
// else one pass or pass 2 (fold the earlier chunks' summaries, then write
// hs over the chunk and h_final after the last one).
template <bool SUMMARY, bool VEC>
__global__ void __launch_bounds__(CB) rglru_kernel(const Args g) {
  __shared__ __align__(16) float ring[RING][2][CB];
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * CB, ch = blockIdx.y, b = blockIdx.z;
  const int w = w0 + lane;
  const int ncol = min(CB, g.W - w0);
  const bool live = lane < ncol;
  const int t0 = ch * g.L;
  const int n = min(g.L, g.S - t0);
  const size_t base = ((size_t)b * g.S + t0) * g.W + w0;  // (b, t0, w0)
  constexpr int PAIRS = RING / 2;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) fetch_pair<VEC>(ring, g, base, p, n, ncol);

  float h = 0.f, A = 1.f;
  if (!SUMMARY) {
    h = live ? g.h0[(size_t)b * g.W + w] : 0.f;
    if (ch > 0 && live) {
      // the earlier chunks' summaries, loaded together, then folded
      const size_t s0 = (size_t)b * g.n_chunks * g.W + w;
      float sa[MAX_CHUNKS - 1], sx[MAX_CHUNKS - 1];
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS - 1; ++c) {
        if (c < ch) {
          sa[c] = g.sum_a[s0 + (size_t)c * g.W];
          sx[c] = g.sum_x[s0 + (size_t)c * g.W];
        }
      }
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS - 1; ++c)
        if (c < ch) h = __fadd_rn(__fmul_rn(sa[c], h), sx[c]);
    }
  }

  const size_t out = base + lane;
  for (int p = 0; 2 * p < n; ++p) {
    cp_async_wait<PAIRS - 1>();
    __syncwarp();  // pair p has landed, every lane's copies visible
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int t = 2 * p + s;
      if (t < n) {
        const float av = ring[t % RING][0][lane];
        const float xv = ring[t % RING][1][lane];
        h = __fadd_rn(__fmul_rn(av, h), xv);
        if (SUMMARY)
          A = __fmul_rn(A, av);
        else if (live)
          g.hs[out + (size_t)t * g.W] = h;
      }
    }
    __syncwarp();  // every lane has read pair p's slots
    fetch_pair<VEC>(ring, g, base, p + PAIRS, n, ncol);
  }
  if (!live) return;
  if (SUMMARY) {
    const size_t s = ((size_t)b * g.n_chunks + ch) * g.W + w;
    g.sum_a[s] = A;
    g.sum_x[s] = h;
  } else if (ch == g.n_chunks - 1) {
    g.h_final[(size_t)b * g.W + w] = h;
  }
}

template <bool SUMMARY, bool VEC>
cudaError_t launch(const Args& g, int B, int chunks, cudaStream_t stream) {
  const dim3 grid((g.W + CB - 1) / CB, chunks, B);
  rglru_kernel<SUMMARY, VEC><<<grid, CB, 0, stream>>>(g);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t run(const Args& g, int B, cudaStream_t stream) {
  if (g.n_chunks > 1) {
    const cudaError_t err = launch<true, VEC>(g, B, g.n_chunks - 1, stream);
    if (err != cudaSuccess) return err;
  }
  return launch<false, VEC>(g, B, g.n_chunks, stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// a, x, hs (B,S,W) and h0, h_final (B,W), fp32 contiguous. The plan
// (rglru_plan): cb channels per block (must be 32), n_chunks time chunks
// of chunk_len steps, ceil(S / chunk_len) == n_chunks <= 16; with
// n_chunks > 1, `summaries` is a (2, B, n_chunks, W) fp32 scratch (else
// unused). Launches on `stream` without synchronising; returns the
// launches' cudaError_t (0 on success).
extern "C" int rglru_scan_f32(const float* a, const float* x, const float* h0,
                              float* hs, float* h_final, float* summaries,
                              int B, int S, int W, int cb, int n_chunks,
                              int chunk_len, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the chunks cover S and none is empty (S = 0: one chunk)
  if (cb != CB || n_chunks < 1 || n_chunks > MAX_CHUNKS || chunk_len < 1 ||
      (long long)n_chunks * chunk_len < S ||
      (n_chunks > 1 && (long long)(n_chunks - 1) * chunk_len >= S) ||
      (n_chunks > 1 && summaries == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)B * n_chunks * W;
  Args g{a, x, h0, hs, h_final, summaries,
         summaries ? summaries + plane : nullptr, S, W, n_chunks,
         chunk_len};
  cudaStream_t st = (cudaStream_t)stream;
  if (W % 4 == 0 && aligned16(a) && aligned16(x))
    return (int)run<true>(g, B, st);
  return (int)run<false>(g, B, st);
}
