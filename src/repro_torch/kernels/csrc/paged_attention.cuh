// Online-softmax body shared by the paged decode and paged chunk-prefill
// attention kernels (fp32, sm_90a).
//
// One thread block attends R = n_rows * G query rows of ONE sequence and
// ONE KV head: the n_rows chunk rows times the G = H / KV query heads of
// the GQA group. Row r = i * G + g is query row i, head kvh * G + g. It
// sweeps the sequence's live logical blocks in order, reading each
// physical block id from the table itself, stages the block's K and V rows
// in shared memory once for all R rows, and keeps the running max m,
// denominator l and the (R, hd) accumulator in shared memory.
//
// Row i attends logical slots <= lim0 + i. The sweep stops at the block
// holding the last row's limit, so table columns past it are never read,
// and inside that block only slots up to the limit are loaded. A table
// entry outside [0, n_pool) reads the null block 0 instead. Masked scores
// take the reference's NEG = -1e30; l is clamped at 1e-30 on output.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace paged_attn {

constexpr float NEG = -1.0e30f;

// Shared-memory layout; K/V/Q rows are padded to hd + 1 floats so that a
// warp reading one column of different rows hits distinct banks.
struct Smem {
  float* q;      // R x (hd + 1)
  float* k;      // bs x (hd + 1)
  float* v;      // bs x (hd + 1)
  float* s;      // R x bs: scores, then probabilities
  float* acc;    // R x hd
  float* m;      // R
  float* l;      // R
  float* alpha;  // R
};

inline size_t smem_bytes(int R, int hd, int bs) {
  const size_t pad = (size_t)hd + 1;
  return sizeof(float) * ((size_t)R * pad + 2 * (size_t)bs * pad +
                          (size_t)R * bs + (size_t)R * hd + 3 * (size_t)R);
}

__device__ inline Smem carve(float* base, int R, int hd, int bs) {
  const int pad = hd + 1;
  Smem sm;
  sm.q = base;
  sm.k = sm.q + R * pad;
  sm.v = sm.k + bs * pad;
  sm.s = sm.v + bs * pad;
  sm.acc = sm.s + R * bs;
  sm.m = sm.acc + R * hd;
  sm.l = sm.m + R;
  sm.alpha = sm.l + R;
  return sm;
}

// q_base/o_base point at row i = 0, head kvh * G of this block; rows are
// row_stride floats apart and the G heads of a row are contiguous.
// table points at this sequence's row of nb block ids.
__device__ inline void attend(const float* __restrict__ q_base,
                              float* __restrict__ o_base, size_t row_stride,
                              int n_rows, int G, int hd,
                              const float* __restrict__ k_pool,
                              const float* __restrict__ v_pool,
                              const int* __restrict__ table, int nb,
                              int n_pool, int bs, int KV, int kvh, int lim0,
                              float scale, float* smem) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int R = n_rows * G;
  const int pad = hd + 1;
  const int hd4 = hd / 4;
  Smem sm = carve(smem, R, hd, bs);

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

  const int last = lim0 + n_rows - 1;  // the last row's limit
  int n_live = last < 0 ? 0 : last / bs + 1;
  if (n_live > nb) n_live = nb;  // slots past the table do not exist
  __syncthreads();

  for (int j = 0; j < n_live; ++j) {
    int phys = __ldg(table + j);
    if (phys < 0 || phys >= n_pool) phys = 0;
    const int nv = min(bs, last - j * bs + 1);  // slots any row attends

    for (int e = tid; e < nv * hd4; e += nt) {
      const int t = e / hd4, d4 = e % hd4;
      const size_t off = (((size_t)phys * bs + t) * KV + kvh) * hd;
      const float4 kk = reinterpret_cast<const float4*>(k_pool + off)[d4];
      const float4 vv = reinterpret_cast<const float4*>(v_pool + off)[d4];
      float* kd = sm.k + t * pad + d4 * 4;
      float* vd = sm.v + t * pad + d4 * 4;
      kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    __syncthreads();

    for (int e = tid; e < R * nv; e += nt) {
      const int r = e / nv, t = e % nv;
      float sc = NEG;
      if (j * bs + t <= lim0 + r / G) {
        const float* qr = sm.q + r * pad;
        const float* kr = sm.k + t * pad;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      sm.s[r * bs + t] = sc;
    }
    __syncthreads();

    for (int r = tid; r < R; r += nt) {
      float* sr = sm.s + r * bs;
      const float m_old = sm.m[r];
      float mx = m_old;
      for (int t = 0; t < nv; ++t) mx = fmaxf(mx, sr[t]);
      const float alpha = expf(m_old - mx);
      float sum = 0.f;
      for (int t = 0; t < nv; ++t) {
        const float p = expf(sr[t] - mx);
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
      const float* pr = sm.s + r * bs;
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

}  // namespace paged_attn
