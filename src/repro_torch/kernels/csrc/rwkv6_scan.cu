// RWKV-6 WKV recurrence, fp32, sm_90a. Per (sequence, head) with a
// (hd, hd) state S and the step's r, k, v, w (hd,) and the bonus u (hd,):
//   out_t[j] = sum_i r_i (S_ij + u_i k_i v_j)
//   S_ij    <- w_i S_ij + k_i v_j            (decay per key channel i)
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py rwkv6_scan (Pallas
// grid (B, H, S / chunk), chunk axis sequential with the state in VMEM
// scratch; S padded to the chunk with w = 1, r = k = v = 0).
//
// Bound on an H100: per (b, t, head) about 20 * hd bytes (r, k, v, w
// read, out written) against 5 * hd^2 + 5 * hd flops, so bytes lead
// slightly at hd 64 between the 3.35 TB/s of HBM and the 67 TFLOP/s of
// fp32 outside the tensor cores. The recurrence is serial in time: one
// block per (sequence, head) is held back by its step chain.
//
// Design: parallel over the state, staged over time. A form chunked over
// time (products of w inside a chunk) underflows fp32 at rwkv6-3b's
// decays (w down to exp(-e) = 0.066, so 0.066^32 ~ 1e-38), so each state
// element keeps the plain loop's update, one FMA per step, and the work is
// split over the hd x hd independent elements instead:
// - one block per (column group, head, sequence); the block owns JC value
//   columns of one (b, h). Thread (g, cq) = (tid / (JC / 4), tid %
//   (JC / 4)) holds the 4 x 4 state elements of key rows 4g .. 4g + 3 and
//   value columns j0 + 4cq .. j0 + 4cq + 3 in registers, with the
//   matching u; R = ceil(hd / 4) threads cover a column group's rows
//   (rows past hd hold zeros);
// - r, k and w (T x hd of the head) and v (T x JC) are staged in shared
//   memory T = 32 steps at a time with cp.async, in a ring of STAGES = 3
//   chunk buffers (two chunks in flight while one is computed), so the
//   step loop makes no global load and passes no barrier;
// - a step reads r, k, w of its rows and v of its columns as float4s
//   (each read feeds 16 updates: shared-memory wavefronts, not FMAs, limit
//   a thread with fewer), and for each element does kv = k_i v_j,
//   y_j += r_i (S_ij + u_i kv), S_ij = w_i S_ij + kv; its 4 y, R-way
//   partials of out_t, go to shared memory. Steps run in groups of 4
//   whose reads all precede their updates;
// - once per chunk each thread sums the R partials of its columns at
//   steps g, g + R, .. and writes them to out; the final state is written
//   once.
// The plan (JC, R, ROWS = 4) comes from rwkv6_plan in rwkv6_scan.py: the
// narrowest column group whose blocks still fit one wave on the card (one
// block an SM), else the widest, so that few blocks re-stage a head's r,
// k and w.
//
// Only the order of the hd-long sum behind out differs from the plain
// loop (and the FMA contraction of each update). Nothing past S, hd or
// the inputs' ends is read.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int T = 32;              // steps staged per chunk
constexpr int STAGES = 3;          // chunk buffers: two chunks in flight
constexpr int ROWS = 4;            // key rows per thread
constexpr int COLS = 4;            // value columns per thread
constexpr int GROUP = 4;           // steps whose reads go first, together
constexpr int MAX_THREADS = 256;   // JC / COLS * R
constexpr size_t MAX_SMEM = 232448;

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
  const float *r, *k, *v, *w, *u, *s0;
  float *out, *s_final;
  int S, H, hd, jc, R;
  bool vec;  // hd % 4 == 0 and every tensor but u and s0 16-byte aligned
};

// How the block's threads share the copies of one array's rows, `width`
// pieces (V floats each) a row, worked out once per kernel: where width
// divides the thread count (hd 64 or 128, every column group of the
// plans) each thread keeps one column of pieces, from row t0 every dt
// rows; else (fast false) the threads take pieces in turn.
struct CopyPlan {
  int width, dt, t0, e;
  bool fast;
};

template <int V>
__device__ __forceinline__ CopyPlan copy_plan(int width) {
  const int nt = blockDim.x, tid = threadIdx.x;
  CopyPlan c{width, 0, 0, 0, nt % width == 0};
  if (c.fast) {
    c.dt = nt / width;
    c.t0 = tid / width;
    c.e = V * (tid - c.t0 * width);
  }
  return c;
}

// Copy n rows from src (rows src_stride floats apart) to dst (dst_stride
// apart) by plan c.
template <int V>
__device__ __forceinline__ void copy_rows(const CopyPlan& c, float* dst,
                                          int dst_stride, const float* src,
                                          size_t src_stride, int n) {
  if (c.fast) {
    const float* s = src + c.t0 * src_stride + c.e;
    float* d = dst + c.t0 * dst_stride + c.e;
    for (int t = c.t0; t < n;
         t += c.dt, s += c.dt * src_stride, d += c.dt * dst_stride) {
      if (V == 4)
        cp_async16(d, s);
      else
        cp_async4(d, s);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < n * c.width; idx += blockDim.x) {
    const int t = idx / c.width, e = V * (idx - t * c.width);
    if (V == 4)
      cp_async16(dst + t * dst_stride + e, src + t * src_stride + e);
    else
      cp_async4(dst + t * dst_stride + e, src + t * src_stride + e);
  }
}

// Stage chunk ch (steps ch*T .. of sequence b, head h) into `buf`:
// r, k, w rows (T x hdp, the first hd columns) and v (T x jc, the block's
// live columns), then commit them as one group (empty past S). Steps past
// S are not read.
template <int V>
__device__ __forceinline__ void stage(const Args& a, const CopyPlan& rows,
                                      const CopyPlan& cols, float* buf,
                                      int ch, int b, int h, int j0,
                                      int hdp) {
  const int t0 = ch * T;
  if (t0 < a.S) {
    const int n = min(T, a.S - t0);
    const size_t row0 = ((size_t)b * a.S + t0) * a.H + h;  // (b, t0, h)
    const size_t step = (size_t)a.H * a.hd;
    copy_rows<V>(rows, buf, hdp, a.r + row0 * a.hd, step, n);
    copy_rows<V>(rows, buf + T * hdp, hdp, a.k + row0 * a.hd, step, n);
    copy_rows<V>(rows, buf + 2 * T * hdp, hdp, a.w + row0 * a.hd, step, n);
    copy_rows<V>(cols, buf + 3 * T * hdp, a.jc, a.v + row0 * a.hd + j0,
                 step, n);
  }
  cp_async_commit();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One step's operands of a thread: r, k, w of its rows, v of its columns.
struct Step {
  float4 r, k, w, v;
};

// One step of a thread's 4 x 4 state elements; returns its 4 partials of
// out_t.
__device__ __forceinline__ float4 update(const Step& x, float (&st)[4][4],
                                         const float (&uu)[4]) {
  const float r[4] = {x.r.x, x.r.y, x.r.z, x.r.w};
  const float k[4] = {x.k.x, x.k.y, x.k.z, x.k.w};
  const float w[4] = {x.w.x, x.w.y, x.w.z, x.w.w};
  const float v[4] = {x.v.x, x.v.y, x.v.z, x.v.w};
  float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
#pragma unroll
    for (int e = 0; e < COLS; ++e) {
      float& s = st[m][e];
      const float kv = k[m] * v[e];
      y[e] = fmaf(r[m], fmaf(uu[m], kv, s), y[e]);
      s = fmaf(w[m], s, kv);
    }
  }
  return make_float4(y[0], y[1], y[2], y[3]);
}

// G steps from t: the operands of all G are read from shared memory
// first, then the G updates run and their partials are stored (rows of
// sy_row float4s from y_out), so the reads of later steps overlap the
// updates of earlier ones.
template <int G>
__device__ __forceinline__ void steps(const float* buf, int t, int hdp,
                                      int jc, int i0, int jl,
                                      float (&st)[4][4], const float (&uu)[4],
                                      float4* y_out, int sy_row) {
  Step x[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float* rr = buf + (t + i) * hdp + i0;
    x[i] = {ld4(rr), ld4(rr + T * hdp), ld4(rr + 2 * T * hdp),
            ld4(buf + 3 * T * hdp + (t + i) * jc + jl)};
  }
#pragma unroll
  for (int i = 0; i < G; ++i) y_out[(t + i) * sy_row] = update(x[i], st, uu);
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
rwkv6_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int jc = a.jc, hd = a.hd, jq = jc / COLS;
  const int hdp = a.R * ROWS;                // rows, padded past hd
  const int buf_len = 3 * T * hdp + T * jc;  // r, k, w, then v
  const int tid = threadIdx.x, nt = blockDim.x;
  // T rows of the threads' partials, each padded by one float4 (the pad
  // staggers the banks of a column's rows)
  const int sy_row = nt + 1;
  float4* sy = reinterpret_cast<float4*>(smem + STAGES * buf_len);
  const int cq = tid % jq, g = tid / jq;
  const int j0 = blockIdx.x * jc, h = blockIdx.y, b = blockIdx.z;
  const int jl = COLS * cq;  // the thread's first column in the group
  const int live_cols = min(jc, hd - j0);
  const int i0 = g * ROWS;

  // rows hd..hdp of r, k and w are never copied: zeros, in every buffer
  if (hdp > hd) {
    const int pad = hdp - hd;
    for (int idx = tid; idx < STAGES * 3 * T * pad; idx += nt) {
      const int row = idx / pad;  // (buffer, array, t)
      smem[(row / (3 * T)) * buf_len + (row % (3 * T)) * hdp + hd +
           idx % pad] = 0.f;
    }
  }
  const size_t s_base = ((size_t)b * a.H + h) * hd * hd + j0 + jl;
  float st[4][4], uu[4];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int i = i0 + m;
    uu[m] = i < hd ? a.u[(size_t)h * hd + i] : 0.f;
#pragma unroll
    for (int e = 0; e < COLS; ++e)
      st[m][e] = (i < hd && jl + e < live_cols)
                     ? a.s0[s_base + (size_t)i * hd + e]
                     : 0.f;
  }

  const int n_chunks = (a.S + T - 1) / T;
  const size_t step = (size_t)a.H * hd;
  const int V = a.vec ? 4 : 1;
  const CopyPlan rows_plan =
      a.vec ? copy_plan<4>(hd / V) : copy_plan<1>(hd / V);
  const CopyPlan cols_plan =
      a.vec ? copy_plan<4>(live_cols / V) : copy_plan<1>(live_cols / V);
  auto stage_chunk = [&](int c) {
    float* buf = smem + (c % STAGES) * buf_len;
    if (a.vec)
      stage<4>(a, rows_plan, cols_plan, buf, c, b, h, j0, hdp);
    else
      stage<1>(a, rows_plan, cols_plan, buf, c, b, h, j0, hdp);
  };
  for (int c = 0; c < STAGES - 1; ++c) stage_chunk(c);
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk ch has landed; the last chunk's sums are read
    const float* buf = smem + (ch % STAGES) * buf_len;
    const int n = min(T, a.S - ch * T);
    float4* y_out = sy + tid;
    int t = 0;
#pragma unroll 1
    for (; t + GROUP <= n; t += GROUP)
      steps<GROUP>(buf, t, hdp, jc, i0, jl, st, uu, y_out, sy_row);
#pragma unroll 1
    for (; t < n; ++t) steps<1>(buf, t, hdp, jc, i0, jl, st, uu, y_out, sy_row);
    __syncthreads();  // partials complete; chunk ch - 1's buffer is free
    stage_chunk(ch + STAGES - 1);
    // thread (g, cq) sums its columns' R partials of steps g, g + R, ..:
    // four running sums, each over every fourth partial
    if (jl < live_cols) {
      float* dst = a.out + (((size_t)b * a.S + ch * T) * a.H + h) * hd + j0 +
                   jl;
      const int nl = min(COLS, live_cols - jl);
      for (int tt = g; tt < n; tt += a.R) {
        const float4* p = sy + tt * sy_row + cq;
        float4 acc[4] = {};
        int gg = 0;
        for (; gg + 4 <= a.R; gg += 4) {
          float4 q[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) q[i] = p[(gg + i) * jq];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i].x += q[i].x;
            acc[i].y += q[i].y;
            acc[i].z += q[i].z;
            acc[i].w += q[i].w;
          }
        }
        for (; gg < a.R; ++gg) {
          const float4 q = p[gg * jq];
          acc[0].x += q.x;
          acc[0].y += q.y;
          acc[0].z += q.z;
          acc[0].w += q.w;
        }
        const float4 o = make_float4(
            (acc[0].x + acc[1].x) + (acc[2].x + acc[3].x),
            (acc[0].y + acc[1].y) + (acc[2].y + acc[3].y),
            (acc[0].z + acc[1].z) + (acc[2].z + acc[3].z),
            (acc[0].w + acc[1].w) + (acc[2].w + acc[3].w));
        float* d = dst + tt * step;
        if (a.vec) {
          *reinterpret_cast<float4*>(d) = o;
        } else {
          d[0] = o.x;
          if (nl > 1) d[1] = o.y;
          if (nl > 2) d[2] = o.z;
          if (nl > 3) d[3] = o.w;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int e = 0; e < COLS; ++e)
      if (i0 + m < hd && jl + e < live_cols)
        a.s_final[s_base + (size_t)(i0 + m) * hd + e] = st[m][e];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// r, k, v, w, out (B,S,H,hd); u (H,hd); state, s_final (B,H,hd,hd); fp32
// contiguous, 1 <= hd <= 128. The plan (rwkv6_plan): jc value columns per
// block (8 to 64, a power of two), R threads per 4 columns, rows = 4 key
// rows per thread, R * 4 >= hd, jc / 4 * R <= 256, and the shared memory
// within the card's 227 KB. Launches on `stream` without synchronising;
// returns the launch's cudaError_t (0 on success).
extern "C" int rwkv6_scan_f32(const float* r, const float* k, const float* v,
                              const float* w, const float* u,
                              const float* state, float* out, float* s_final,
                              int B, int S, int H, int hd, int jc, int R,
                              int rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd < 1 || hd > 128 || jc < 8 || jc > 64 || (jc & (jc - 1)) ||
      rows != ROWS || R < 1 || R * ROWS < hd || jc / COLS * R > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  // STAGES chunk buffers of r, k, w and v, and T rows of out's partials
  const size_t nt = (size_t)jc / COLS * R;
  const size_t smem =
      sizeof(float) * (STAGES * (3 * (size_t)T * R * ROWS + (size_t)T * jc) +
                       (size_t)T * COLS * (nt + 1));
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rwkv6_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Args a{r, k, v, w, u, state, out, s_final, S, H, hd, jc, R,
               hd % 4 == 0 && aligned16(r) && aligned16(k) &&
                   aligned16(v) && aligned16(w) && aligned16(out)};
  const dim3 grid((hd + jc - 1) / jc, H, B);
  rwkv6_kernel<<<grid, (unsigned)nt, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
