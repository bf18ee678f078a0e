// Online-softmax body shared by every attention kernel of the port (fp32,
// sm_90a): paged decode, paged chunk prefill, full-sequence flash
// attention and dense-cache decode.
//
// One thread block attends R = n_rows * G query rows of ONE sequence and
// ONE KV head: the n_rows query rows times the G = H / KV query heads of
// the GQA group. Row r = i * G + g is query row i, head kvh * G + g. It
// sweeps the logical K/V slots [t_begin, t_end) in tiles of `tile` slots,
// stages each tile's K and V rows in shared memory once for all R rows,
// and keeps the running max m, denominator l and the (R, hd) accumulator
// in shared memory.
//
// Where a tile's rows live, which slots are read and which slots a row
// attends come from a slot source `Src` (below: PagedSrc, DenseSrc,
// ValidSrc). A slot the source does not load is staged as zeros and never
// read from device memory; a tile with no loaded slot is skipped whole.
// Masked scores take the reference's NEG = -1e30 and weigh exactly 0; l is
// clamped at 1e-30 on output, so a row that attends nothing at all comes
// out as zeros (the reference would average every slot).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace attn {

constexpr float NEG = -1.0e30f;

// Shared-memory layout; K/V/Q rows are padded to hd + 1 floats so that a
// warp reading one column of different rows hits distinct banks.
struct Smem {
  float* q;      // R x (hd + 1)
  float* k;      // tile x (hd + 1)
  float* v;      // tile x (hd + 1)
  float* s;      // R x tile: scores, then probabilities
  float* acc;    // R x hd
  float* m;      // R
  float* l;      // R
  float* alpha;  // R
};

inline size_t smem_bytes(int R, int hd, int tile) {
  const size_t pad = (size_t)hd + 1;
  return sizeof(float) * ((size_t)R * pad + 2 * (size_t)tile * pad +
                          (size_t)R * tile + (size_t)R * hd + 3 * (size_t)R);
}

__device__ inline Smem carve(float* base, int R, int hd, int tile) {
  const int pad = hd + 1;
  Smem sm;
  sm.q = base;
  sm.k = sm.q + R * pad;
  sm.v = sm.k + tile * pad;
  sm.s = sm.v + tile * pad;
  sm.acc = sm.s + R * tile;
  sm.m = sm.acc + R * hd;
  sm.l = sm.m + R;
  sm.alpha = sm.l + R;
  return sm;
}

// Slots of a block pool read through one sequence's table row: a tile is
// one block (tile == bs, t_begin a multiple of bs), and row r attends
// slots <= lim0 + r / G. A table entry outside [0, n_pool) reads the null
// block 0 instead.
struct PagedSrc {
  const int* table;
  int n_pool, bs, G, lim0;
  size_t block_floats;  // bs * KV * hd
  __device__ size_t tile_offset(int t0) const {
    int phys = __ldg(table + t0 / bs);
    if (phys < 0 || phys >= n_pool) phys = 0;
    return (size_t)phys * block_floats;
  }
  __device__ bool load(int) const { return true; }
  __device__ bool ok(int r, int t) const { return t <= lim0 + r / G; }
};

// Contiguous slots 0..T-1 of one sequence (full-sequence attention): row
// r is query position q0 + r / G and attends slot t when t < T, t <= its
// position if causal, and its position - t < window if window > 0.
struct DenseSrc {
  size_t slot_floats;  // KV * hd
  int G, q0, T, causal, window;
  __device__ size_t tile_offset(int t0) const { return t0 * slot_floats; }
  __device__ bool load(int) const { return true; }
  __device__ bool ok(int r, int t) const {
    const int qpos = q0 + r / G;
    return t < T && (!causal || t <= qpos) &&
           (window <= 0 || qpos - t < window);
  }
};

// Contiguous slots 0..C-1 of one sequence's dense cache under a validity
// row (one byte per slot): only valid slots are read or attended.
struct ValidSrc {
  const unsigned char* valid;
  size_t slot_floats;  // KV * hd
  __device__ size_t tile_offset(int t0) const { return t0 * slot_floats; }
  __device__ bool load(int t) const { return __ldg(valid + t) != 0; }
  __device__ bool ok(int, int t) const { return load(t); }
};

// q_base/o_base point at row i = 0, head kvh * G of this block; rows are
// row_stride floats apart and the G heads of a row are contiguous.
// k_base/v_base point at head kvh of the sequence's K/V; slot t of the
// tile starting at t0 lies at tile_offset(t0) + (t - t0) * slot_stride.
template <class Src>
__device__ inline void attend(const float* __restrict__ q_base,
                              float* __restrict__ o_base, size_t row_stride,
                              int n_rows, int G, int hd,
                              const float* __restrict__ k_base,
                              const float* __restrict__ v_base,
                              size_t slot_stride, const Src& src,
                              int t_begin, int t_end, int tile, float scale,
                              float* smem) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int R = n_rows * G;
  const int pad = hd + 1;
  const int hd4 = hd / 4;
  Smem sm = carve(smem, R, hd, tile);

  for (int e = tid; e < R * hd4; e += nt) {
    const int r = e / hd4, d4 = e % hd4;
    const int i = r / G, g = r % G;
    const float4 x = reinterpret_cast<const float4*>(
        q_base + (size_t)i * row_stride + (size_t)g * hd)[d4];
    float* dst = sm.q + r * pad + d4 * 4;
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }
  for (int e = tid; e < R * hd; e += nt) sm.acc[e] = 0.f;
  for (int r = tid; r < R; r += nt) {
    sm.m[r] = NEG;
    sm.l[r] = 0.f;
  }
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += tile) {
    const int nv = min(tile, t_end - t0);
    const size_t off = src.tile_offset(t0);
    bool loaded = false;
    for (int e = tid; e < nv * hd4; e += nt) {
      const int t = e / hd4, d4 = e % hd4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (src.load(t0 + t)) {
        const size_t o = off + (size_t)t * slot_stride;
        kk = reinterpret_cast<const float4*>(k_base + o)[d4];
        vv = reinterpret_cast<const float4*>(v_base + o)[d4];
        loaded = true;
      }
      float* kd = sm.k + t * pad + d4 * 4;
      float* vd = sm.v + t * pad + d4 * 4;
      kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    if (!__syncthreads_or(loaded)) continue;  // nothing here to attend

    for (int e = tid; e < R * nv; e += nt) {
      const int r = e / nv, t = e % nv;
      float sc = NEG;
      if (src.ok(r, t0 + t)) {
        const float* qr = sm.q + r * pad;
        const float* kr = sm.k + t * pad;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      sm.s[r * tile + t] = sc;
    }
    __syncthreads();

    for (int r = tid; r < R; r += nt) {
      float* sr = sm.s + r * tile;
      const float m_old = sm.m[r];
      float mx = m_old;
      for (int t = 0; t < nv; ++t) mx = fmaxf(mx, sr[t]);
      const float alpha = expf(m_old - mx);
      float sum = 0.f;
      for (int t = 0; t < nv; ++t) {
        const float p = sr[t] == NEG ? 0.f : expf(sr[t] - mx);
        sr[t] = p;
        sum += p;
      }
      sm.m[r] = mx;
      sm.l[r] = sm.l[r] * alpha + sum;
      sm.alpha[r] = alpha;
    }
    __syncthreads();

    for (int e = tid; e < R * hd; e += nt) {
      const int r = e / hd, d = e % hd;
      const float* pr = sm.s + r * tile;
      float a = sm.acc[e] * sm.alpha[r];
      for (int t = 0; t < nv; ++t) a = fmaf(pr[t], sm.v[t * pad + d], a);
      sm.acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * hd; e += nt) {
    const int r = e / hd, d = e % hd;
    const int i = r / G, g = r % G;
    o_base[(size_t)i * row_stride + (size_t)g * hd + d] =
        sm.acc[e] / fmaxf(sm.l[r], 1e-30f);
  }
}

// Raise the kernel's dynamic shared-memory cap when it needs more than
// the default 48 KB (at most 227 KB on sm_90).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The most dynamic shared memory one block may use on sm_90.
constexpr size_t SMEM_MAX = 227 * 1024;

}  // namespace attn
