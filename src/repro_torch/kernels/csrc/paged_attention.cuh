// The attention bodies of the port (fp32 IEEE FMAs, SIMT, sm_90a): the one
// header every attention kernel builds on. Each body reads its K/V slots
// from a source chosen at compile time: PAGED, the block pool (N, bs, KV,
// hd) read through one sequence's table row, or DENSE, one sequence's own
// contiguous rows.
//   - The decode body (decode_body), one query token per sequence, whole
//     or one split of a split-K sweep:
//       paged_decode_attention.cu         PAGED, one split
//       paged_decode_attention_splitk.cu  PAGED, splits + the combine
//       decode_attention.cu               DENSE under a validity mask, one
//                                         split or splits + the combine
//   - The prefill body (prefill_body), a tile of query rows:
//       paged_prefill_attention.cu        PAGED, causal from pos[b]
//       flash_attention.cu                DENSE, causal or not, windowed
//   - splitk_combine_kernel merges split partials for both split users.
//
// Both bodies follow the reference's semantics: a masked score weighs
// exactly 0; table ids outside [0, n_pool) read the null block 0; nothing
// past a sequence's frontier (paged decode: slot >= seq_lens[b]; prefill:
// a slot past the tile's last row's limit or past the K/V rows), no table
// column past it and no dense slot marked invalid is ever read; the output
// divides by max(l, 1e-30), so a row that attends nothing comes out as
// zeros.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace pattn {

constexpr float NEG = -1.0e30f;

// The most dynamic shared memory one block may use on sm_90.
constexpr size_t SMEM_MAX = 227 * 1024;

// Raise the kernel's dynamic shared-memory cap when it needs more than
// the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Where a body's K/V slots live.
enum Source { PAGED, DENSE };

__device__ __forceinline__ int table_entry(const int* table, int col,
                                           int n_pool) {
  const int phys = __ldg(table + col);
  return (phys < 0 || phys >= n_pool) ? 0 : phys;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y),
                     fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

// ------------------------------------------------------------------ decode
// One block serves (KV head, chunk of GB heads of its GQA group, split,
// sequence) with DEC_WARPS warps and no shared-memory staging: decode does
// 4 * hd flops per 8 * hd bytes of K/V and head, far below the fp32 ridge,
// so the design is about bytes in flight. Lane l holds dims [4l, 4l + 4)
// (and [128 + 4l, ...) at NC = 2) of the GB query heads in registers. The
// split's slots are dealt out to the warps U at a time (warp w takes
// slots t_begin + (w + k * DEC_WARPS) * U ...); per live slot the warp
// makes one coalesced 16-byte-per-lane load of K and one of V, all U
// slots' loads issued before any is used. A slot that is not live (past
// the split or the frontier; DENSE: marked invalid) is never loaded: its
// registers stay zero and it weighs 0. The GB * U dot products reduce with
// __shfl_xor_sync, and each lane keeps the online softmax (m, l) and the
// acc float4s of every head in registers. PAGED: one table read serves a
// chunk of U slots (bs % U == 0 keeps a chunk inside one pool block).
// There is no __syncthreads in the sweep: the warps' (m, l, acc) merge
// once through shared memory at the end.
constexpr int DEC_WARPS = 8;

// U: slots per warp iteration, so that each lane has 2 * U * NC
// independent 16-byte loads in flight; halved for wide groups to keep the
// scores and loads in registers.
template <int GB, int NC>
struct DecodeTile {
  static constexpr int U = (GB > 4 ? 4 : 8) / NC;
};

struct DecodeArgs {
  const float* q;      // (B, 1, H, hd)
  float* out;          // (B, 1, H, hd), normalised (one split)
  float* acc;          // (B, H, n_splits, hd) partials (several splits)
  float* m;            // (B, H, n_splits)
  float* l;            // (B, H, n_splits)
  const float* k;      // PAGED: pool (n_pool, bs, KV, hd); DENSE: (B, C, KV, hd)
  const float* v;
  const int* tables;   // PAGED: (B, nb)
  const int* seq_lens;  // PAGED: (B,)
  const unsigned char* valid;  // DENSE: (B, C), nonzero = attend
  int H, KV, hd;
  int n_pool, bs, nb;  // PAGED
  int C;               // DENSE: slots per sequence
  // split s sweeps slots [s * split_slots, (s + 1) * split_slots) (a
  // multiple of 16, so of U; PAGED: of bs)
  int n_splits, split_slots;
  int n_chunks;        // set by launch_decode
  float scale;
};

// Query heads one decode block holds in registers (the instantiations of
// launch_decode): a wider group runs in ceil(G / 8) near-equal chunks
// (10 -> 5 + 5, 16 -> 8 + 8), each block reading the KV head's slots once
// for its chunk.
constexpr int DEC_MAX_HEADS = 8;

inline int decode_heads_per_block(int G) {
  const int n = (G + DEC_MAX_HEADS - 1) / DEC_MAX_HEADS;
  return (G + n - 1) / n;
}

inline size_t decode_smem_bytes(int gb, int nc) {
  return sizeof(float) * DEC_WARPS * gb * (nc * 128 + 2);
}

// PARTIAL: write the split's UNNORMALISED (acc, m, l) (an empty split
// writes m = NEG, l = 0, acc = 0); else the normalised output.
template <Source SRC, int GB, int NC, bool PARTIAL>
__device__ __forceinline__ void decode_body(const DecodeArgs& a,
                                            float* smem) {
  constexpr int U = DecodeTile<GB, NC>::U;
  constexpr int HDR = NC * 128;  // a head's row in the merge buffer
  const int kvh = blockIdx.x / a.n_chunks;
  const int g0 = (blockIdx.x % a.n_chunks) * GB;
  const int s = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int gn = min(GB, G - g0);  // heads of this chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = a.hd;
  const size_t slot_stride = (size_t)a.KV * hd;
  // slots past the frontier (PAGED: the sequence's length and the
  // table's nb blocks; DENSE: C) or this split are not swept
  int frontier = a.C;
  const int* table = nullptr;
  const unsigned char* valid = nullptr;
  const float* kbase = a.k + (size_t)kvh * hd;
  const float* vbase = a.v + (size_t)kvh * hd;
  if constexpr (SRC == PAGED) {
    frontier = min(__ldg(a.seq_lens + b), a.nb * a.bs);
    table = a.tables + (size_t)b * a.nb;
  } else {
    valid = a.valid + (size_t)b * a.C;
    kbase += (size_t)b * a.C * slot_stride;
    vbase += (size_t)b * a.C * slot_stride;
  }
  const int t_begin = s * a.split_slots;
  const int t_end = min(frontier, t_begin + a.split_slots);
  const size_t head0 = (size_t)b * a.H + (size_t)kvh * G + g0;

  float4 q[GB][NC], o[GB][NC];
  float m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * lane + 128 * c;
      q[g][c] = (g < gn && d < hd) ? ldg4(a.q + (head0 + g) * hd + d)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      o[g][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    m[g] = NEG;
    l[g] = 0.f;
  }

  for (int t0 = t_begin + warp * U; t0 < t_end; t0 += DEC_WARPS * U) {
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      live[u] = t0 + u < t_end;
      if constexpr (SRC == DENSE) live[u] = live[u] && __ldg(valid + t0 + u);
    }
    int col0 = 0, phys0 = 0;
    if constexpr (SRC == PAGED) {
      col0 = t0 / a.bs;
      phys0 = table_entry(table, col0, a.n_pool);
    }
    float4 kk[U][NC], vv[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        kk[u][c] = make_float4(0.f, 0.f, 0.f, 0.f);
        vv[u][c] = kk[u][c];
      }
      if (live[u]) {
        size_t off = (size_t)t * slot_stride;
        if constexpr (SRC == PAGED) {
          const int col = t / a.bs;
          const int phys =
              col == col0 ? phys0 : table_entry(table, col, a.n_pool);
          off = (size_t)phys * a.bs * slot_stride +
                (size_t)(t - col * a.bs) * slot_stride;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = 4 * lane + 128 * c;
          if (d < hd) {
            kk[u][c] = ldg4(kbase + off + d);
            vv[u][c] = ldg4(vbase + off + d);
          }
        }
      }
    }
    float sc[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) p = dot4(q[g][c], kk[u][c], p);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        sc[u][g] = live[u] ? p * a.scale : NEG;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
      const float alpha = expf(m[g] - mx);
      float sum = 0.f;
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = live[u] ? expf(sc[u][g] - mx) : 0.f;
        sum += p[u];
      }
      m[g] = mx;
      l[g] = fmaf(l[g], alpha, sum);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float4 acc = make_float4(o[g][c].x * alpha, o[g][c].y * alpha,
                                 o[g][c].z * alpha, o[g][c].w * alpha);
#pragma unroll
        for (int u = 0; u < U; ++u) acc = fma4(p[u], vv[u][c], acc);
        o[g][c] = acc;
      }
    }
  }

  // merge the warps: rows (warp, g) of HDR floats, then m and l
  float* s_o = smem;                             // DEC_WARPS x GB x HDR
  float* s_m = s_o + DEC_WARPS * GB * HDR;       // DEC_WARPS x GB
  float* s_l = s_m + DEC_WARPS * GB;             // DEC_WARPS x GB
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      reinterpret_cast<float4*>(s_o + (warp * GB + g) * HDR)[lane + 32 * c] =
          o[g][c];
    if (lane == 0) {
      s_m[warp * GB + g] = m[g];
      s_l[warp * GB + g] = l[g];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gn * hd; e += DEC_WARPS * 32) {
    const int g = e / hd, d = e % hd;
    float mg = NEG;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mg = fmaxf(mg, s_m[w * GB + g]);
    float lg = 0.f, og = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float wt = expf(s_m[w * GB + g] - mg);
      lg = fmaf(s_l[w * GB + g], wt, lg);
      og = fmaf(s_o[(w * GB + g) * HDR + d], wt, og);
    }
    const size_t h = head0 + g;
    if (PARTIAL) {
      const size_t part = h * a.n_splits + s;
      a.acc[part * hd + d] = og;
      if (d == 0) {
        a.m[part] = mg;
        a.l[part] = lg;
      }
    } else {
      a.out[h * hd + d] = og / fmaxf(lg, 1e-30f);
    }
  }
}

// One kernel name per source, so a profile tells paged from dense decode.
template <int GB, int NC, bool PARTIAL>
__global__ void __launch_bounds__(DEC_WARPS * 32, 1)
    paged_decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  decode_body<PAGED, GB, NC, PARTIAL>(a, smem);
}

template <int GB, int NC, bool PARTIAL>
__global__ void __launch_bounds__(DEC_WARPS * 32, 1)
    dense_decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  decode_body<DENSE, GB, NC, PARTIAL>(a, smem);
}

template <Source SRC, int GB, int NC, bool PARTIAL>
inline cudaError_t launch_decode_as(const DecodeArgs& a, dim3 grid,
                                    size_t smem, cudaStream_t st) {
  void (*kernel)(DecodeArgs);
  if constexpr (SRC == PAGED)
    kernel = paged_decode_kernel<GB, NC, PARTIAL>;
  else
    kernel = dense_decode_kernel<GB, NC, PARTIAL>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, DEC_WARPS * 32, smem, st>>>(a);
  return cudaGetLastError();
}

// Launch the decode body: grid (KV * n_chunks, n_splits, B), gb =
// decode_heads_per_block(G) heads per block (a.n_chunks = ceil(G / gb)),
// nc = hd / 128 rounded up (1 or 2). Returns the launch's cudaError_t.
template <Source SRC, bool PARTIAL>
inline cudaError_t launch_decode(DecodeArgs a, int B, cudaStream_t st) {
  const int G = a.H / a.KV;
  if (G < 1) return cudaErrorInvalidValue;
  const int gb = decode_heads_per_block(G);
  const int nc = (a.hd + 127) / 128;
  a.n_chunks = (G + gb - 1) / gb;
  const dim3 grid(a.KV * a.n_chunks, a.n_splits, B);
  const size_t smem = decode_smem_bytes(gb, nc);
#define PATTN_DECODE_CASE(GB_, NC_)                                   \
  if (gb == GB_ && nc == NC_)                                         \
    return launch_decode_as<SRC, GB_, NC_, PARTIAL>(a, grid, smem, st);
#define PATTN_DECODE_NC(GB_) PATTN_DECODE_CASE(GB_, 1) PATTN_DECODE_CASE(GB_, 2)
  PATTN_DECODE_NC(1) PATTN_DECODE_NC(2) PATTN_DECODE_NC(3)
  PATTN_DECODE_NC(4) PATTN_DECODE_NC(5) PATTN_DECODE_NC(6)
  PATTN_DECODE_NC(7) PATTN_DECODE_NC(8)
#undef PATTN_DECODE_NC
#undef PATTN_DECODE_CASE
  return cudaErrorInvalidValue;
}

// The split-K combine, grid (H, B): rescales each split to the global
// max, w_s = exp(m_s - max_s m_s) (an empty split weighs exp(NEG - m) = 0),
// and writes sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30). A second small
// kernel rather than a last-block-done counter: no atomics and no counter
// to reset between launches.
static __global__ void splitk_combine_kernel(const float* __restrict__ acc,
                                             const float* __restrict__ m,
                                             const float* __restrict__ l,
                                             float* __restrict__ out, int H,
                                             int hd, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const float* ms = m + bh * n_splits;
  const float* ls = l + bh * n_splits;
  float m_g = NEG;
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

// Split-K decode: the body writes each split's partials into a.acc, a.m,
// a.l, then the combine writes a.out. Returns the first failing launch's
// cudaError_t.
template <Source SRC>
inline cudaError_t launch_decode_splitk(const DecodeArgs& a, int B,
                                        cudaStream_t st) {
  const cudaError_t err = launch_decode<SRC, true>(a, B, st);
  if (err != cudaSuccess) return err;
  splitk_combine_kernel<<<dim3(a.H, B), 128, 0, st>>>(a.acc, a.m, a.l,
                                                      a.out, a.H, a.hd,
                                                      a.n_splits);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- prefill
// One block of 256 threads serves (sequence, KV head, query tile of TQ rows
// x the G heads of the group): RP = 64 score rows r = i * G + g, TQ = 64 /
// G (rows r >= TQ * G, or past the T query rows, are padding: computed,
// never written). Row r at position qpos attends slots t in [lo, hi]: hi =
// qpos if causal (at most the last K/V row), else the last K/V row; lo =
// qpos - window + 1 with a window, else 0 (PAGED: causal from qpos = pos[b]
// + i, no window). The block sweeps the tiles of TK slots from the one
// holding the first row's lo up to the last row's hi (64: four pool blocks
// of 16), read with cp.async 16-byte copies into a two-stage ring, so tile
// k + 1 loads while tile k computes. Slots past the sweep's end are
// zero-filled, never read. Thread (ty, tx) = (tid / 16, tid % 16) owns
// score rows ty + 16 i (i < 4) and columns tx + 16 j (j < TK / 16), a 4 x 4
// micro-tile of S = Q K^T at TK = 64 (each float4 it reads from shared
// memory feeds 16 FMAs), and output rows ty + 16 i times dims 4 tx + 64 jj
// (jj < NJ = hd / 64) of O += P V, the same rows, so the per-row (m, l) and
// the rescale alpha live in registers; the 16 threads that share a row
// reduce its max and sum with shuffles. Only tiles that cross an edge (a
// slot past the first row's hi, or before the last row's lo) are masked.
// Blocks launch heaviest query tile first.
constexpr int PF_THREADS = 256;
constexpr int PF_ROWS = 64;
constexpr int PF_STAGES = 2;

// floats of a padded K/V/Q row at NJ: a multiple of 4 (float4 rows) that
// puts consecutive rows 4 banks apart
__host__ __device__ constexpr int pf_row(int nj) { return nj * 64 + 4; }

inline size_t prefill_smem_bytes(int nj, int tk) {
  const size_t row = pf_row(nj);
  return sizeof(float) * (PF_ROWS * row + PF_STAGES * 2 * (size_t)tk * row +
                          PF_ROWS * (size_t)(tk + 4));
}

// Slots per K/V tile at NJ = hd / 64 (rounded up): 64 where the two-stage
// ring fits SMEM_MAX (hd <= 128: 186,368 bytes at hd 128), else 32 (hd
// 256: 208,896 bytes; 64 would take 335,872).
inline int prefill_tile_slots(int nj) {
  return prefill_smem_bytes(nj, 64) <= SMEM_MAX ? 64 : 32;
}

struct PrefillArgs {
  const float* q;   // (B, T, H, hd)
  float* out;       // (B, T, H, hd)
  const float* k;   // PAGED: pool (n_pool, bs, KV, hd); DENSE: (B, T_kv, KV, hd)
  const float* v;
  const int* tables;  // PAGED: (B, nb)
  const int* pos;     // PAGED: (B,) position of query row 0
  int T, H, KV, hd;
  int n_pool, bs, nb;  // PAGED
  int T_kv;            // DENSE: K/V rows per sequence (query row i at i)
  int causal, window;  // DENSE: window <= 0 for none
  int tq;              // set by launch_prefill
  float scale;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool live) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a prefill block's K/V slots live: slot t < t_end lies at
// kbase/vbase + t * slot_stride (DENSE) or at table[t / bs]'s block, row
// t % bs (PAGED); slots past t_end are not read.
struct PfTileSrc {
  const int* table;
  int n_pool, bs;
  size_t slot_stride;
  int hd4, t_end;
  const float* kbase;
  const float* vbase;
};

// Issue the cp.async copies of K/V tile kt (TK slots) into its stage of
// the ring and commit them as one group; dead slots are zero-filled.
template <Source SRC, int ROW, int TK>
__device__ __forceinline__ void pf_load_tile(const PfTileSrc& src,
                                             float* s_kv, int kt) {
  float* sk = s_kv + (kt % PF_STAGES) * 2 * TK * ROW;
  float* sv = sk + TK * ROW;
  const int t0 = kt * TK;
  for (int e = threadIdx.x; e < TK * src.hd4; e += PF_THREADS) {
    const int ts = e / src.hd4, d4 = e % src.hd4;
    const int t = t0 + ts;
    const bool live = t < src.t_end;
    size_t off = 0;
    if (live) {
      off = (size_t)t * src.slot_stride + 4 * d4;
      if constexpr (SRC == PAGED) {
        const int col = t / src.bs;
        off = ((size_t)table_entry(src.table, col, src.n_pool) * src.bs +
               (t - col * src.bs)) * src.slot_stride + 4 * d4;
      }
    }
    cp_async16(sk + ts * ROW + 4 * d4, src.kbase + off, live);
    cp_async16(sv + ts * ROW + 4 * d4, src.vbase + off, live);
  }
  cp_async_commit();
}

template <Source SRC, int NJ, int TK>
__device__ __forceinline__ void prefill_body(const PrefillArgs& a,
                                             float* smem) {
  constexpr int ROW = pf_row(NJ);
  constexpr int CN = TK / 16;  // score columns per thread
  constexpr int PROW = TK + 4;
  float* s_q = smem;                                   // PF_ROWS x ROW
  float* s_kv = s_q + PF_ROWS * ROW;                   // stages x {K, V}
  float* s_p = s_kv + PF_STAGES * 2 * TK * ROW;        // PF_ROWS x PROW

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV, hd = a.hd, hd4 = hd / 4;
  const int i0 = tile * a.tq;
  const int n_rows = min(a.tq, a.T - i0);
  const int R = n_rows * G;
  const size_t slot_stride = (size_t)a.KV * hd;
  const float* kbase = a.k + (size_t)kvh * hd;
  const float* vbase = a.v + (size_t)kvh * hd;
  // q0: the first row's position; n_slots: the slots that exist
  int q0 = i0, n_slots = a.T_kv, causal = a.causal, window = a.window;
  const int* table = nullptr;
  if constexpr (SRC == PAGED) {
    q0 += __ldg(a.pos + b);
    n_slots = a.nb * a.bs;
    causal = 1;
    window = 0;
    table = a.tables + (size_t)b * a.nb;
  } else {
    kbase += (size_t)b * a.T_kv * slot_stride;
    vbase += (size_t)b * a.T_kv * slot_stride;
  }
  // the sweep ends at the last row's hi and starts at the tile holding
  // the first row's lo: tiles wholly outside every row's window are not
  // swept
  const int t_end = causal ? min(q0 + n_rows, n_slots) : n_slots;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / TK : 0;
  const int n_tiles = (t_end + TK - 1) / TK;
  // a tile is masked where it crosses the first row's hi or the last
  // row's lo; hi never passes the last slot (DENSE causal with more query
  // rows than K/V rows: rows past T_kv attend every slot, and the
  // zero-filled slots after it stay masked)
  const int hi_first = causal ? min(q0, n_slots - 1) : n_slots - 1;
  const int lo_last = window > 0 ? q0 + n_rows - window : 0;

  // q rows of the tile (zeros past R and past hd); the K/V rows' dims
  // past hd are zeroed once (the copies never write them)
  for (int e = tid; e < PF_ROWS * (ROW / 4); e += PF_THREADS) {
    const int r = e / (ROW / 4), d4 = e % (ROW / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R && d4 < hd4) {
      const int i = r / G, g = r % G;
      x = ldg4(a.q + (((size_t)b * a.T + i0 + i) * a.H + (size_t)kvh * G +
                      g) * hd + 4 * d4);
    }
    reinterpret_cast<float4*>(s_q + r * ROW)[d4] = x;
  }
  for (int e = tid; e < PF_STAGES * 2 * TK * (ROW / 4 - hd4);
       e += PF_THREADS) {
    const int row = e / (ROW / 4 - hd4), d4 = hd4 + e % (ROW / 4 - hd4);
    reinterpret_cast<float4*>(s_kv + row * ROW)[d4] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float acc[4][NJ][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][jj][c] = 0.f;
  }
  // each owned row's window [lo, hi] (past R: hi = -1, attends nothing)
  int lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r / G;
    hi[i] = r < R ? (causal ? min(qpos, n_slots - 1) : n_slots - 1) : -1;
    lo[i] = window > 0 ? qpos - window + 1 : 0;
  }

  const PfTileSrc src{table, a.n_pool, a.bs, slot_stride, hd4, t_end,
                      kbase, vbase};
  if (kt_begin < n_tiles) pf_load_tile<SRC, ROW, TK>(src, s_kv, kt_begin);
  for (int kt = kt_begin; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      pf_load_tile<SRC, ROW, TK>(src, s_kv, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = s_kv + (kt % PF_STAGES) * 2 * TK * ROW;
    const float* sv = sk + TK * ROW;
    const int t0 = kt * TK;

    float s[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < NJ * 16; ++d4) {
      float4 qv[4], kv[CN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = reinterpret_cast<const float4*>(s_q + (ty + 16 * i) * ROW)[d4];
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = reinterpret_cast<const float4*>(sk + (tx + 16 * j) * ROW)[d4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

    const bool masked = t0 + TK - 1 > hi_first || t0 < lo_last;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int t = t0 + tx + 16 * j;
        s[i][j] = (masked && (t > hi[i] || t < lo[i])) ? NEG
                                                       : s[i][j] * a.scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = s[i][j] == NEG ? 0.f : expf(s[i][j] - mx);
        s_p[(ty + 16 * i) * PROW + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[i] = mx;
      l[i] = fmaf(l[i], alpha, sum);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][jj][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int t4 = 0; t4 < TK / 4; ++t4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = reinterpret_cast<const float4*>(s_p + (ty + 16 * i) * PROW)[t4];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const float* vrow = sv + (4 * t4 + tt) * ROW;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 vv =
              reinterpret_cast<const float4*>(vrow)[tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = tt == 0 ? pv[i].x : tt == 1 ? pv[i].y
                            : tt == 2 ? pv[i].z : pv[i].w;
            acc[i][jj][0] = fmaf(p, vv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(p, vv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(p, vv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(p, vv.w, acc[i][jj][3]);
          }
        }
      }
    }
    __syncthreads();  // the stage and P are rewritten next
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= R) continue;
    const int qi = r / G, g = r % G;
    float* orow = a.out + (((size_t)b * a.T + i0 + qi) * a.H +
                           (size_t)kvh * G + g) * hd;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = 4 * tx + 64 * jj;
      if (d < hd)
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[i][jj][0] / den, acc[i][jj][1] / den,
                        acc[i][jj][2] / den, acc[i][jj][3] / den);
    }
  }
}

// One kernel name per source, so a profile tells paged prefill from flash.
template <int NJ, int TK>
__global__ void __launch_bounds__(PF_THREADS, 1)
    paged_prefill_kernel(PrefillArgs a) {
  extern __shared__ __align__(16) float smem[];
  prefill_body<PAGED, NJ, TK>(a, smem);
}

template <int NJ, int TK>
__global__ void __launch_bounds__(PF_THREADS, 1)
    flash_kernel(PrefillArgs a) {
  extern __shared__ __align__(16) float smem[];
  prefill_body<DENSE, NJ, TK>(a, smem);
}

template <Source SRC, int NJ, int TK>
inline cudaError_t launch_prefill_as(const PrefillArgs& a, dim3 grid,
                                     size_t smem, cudaStream_t st) {
  void (*kernel)(PrefillArgs);
  if constexpr (SRC == PAGED)
    kernel = paged_prefill_kernel<NJ, TK>;
  else
    kernel = flash_kernel<NJ, TK>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, PF_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// Launch the prefill body, grid (ceil(T / tq), KV, B), with the tile plan
// derived from G and hd: a.tq = 64 / G query rows per block (G <= 64)
// and prefill_tile_slots(hd / 64) slots per K/V tile (64, or 32 at hd >
// 128; hd <= 256). Returns the launch's cudaError_t.
template <Source SRC>
inline cudaError_t launch_prefill(PrefillArgs a, int B, cudaStream_t st) {
  const int G = a.H / a.KV;
  if (G < 1 || G > PF_ROWS || a.hd > 256) return cudaErrorInvalidValue;
  a.tq = PF_ROWS / G;
  const int nj = (a.hd + 63) / 64;
  const int tk = prefill_tile_slots(nj);
  const size_t smem = prefill_smem_bytes(nj, tk);
  const dim3 grid((a.T + a.tq - 1) / a.tq, a.KV, B);
#define PATTN_PREFILL_CASE(NJ_, TK_) \
  if (nj == NJ_ && tk == TK_) return launch_prefill_as<SRC, NJ_, TK_>(a, grid, smem, st);
  PATTN_PREFILL_CASE(1, 64)
  PATTN_PREFILL_CASE(2, 64)
  PATTN_PREFILL_CASE(3, 32)
  PATTN_PREFILL_CASE(4, 32)
#undef PATTN_PREFILL_CASE
  return cudaErrorInvalidValue;
}

}  // namespace pattn
