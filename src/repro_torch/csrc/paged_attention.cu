// Paged decode attention, split over the sequence axis (flash-decoding), on
// Hopper: the KV-separated read path.
//
// Replaces the Pallas TPU kernel paged_decode_attention_pallas (body
// _paged_kernel) of src/repro/kernels/paged_attention/kernel.py.  One decode
// token per sequence; the `rep = nh / nkv` query heads of a KV head share one
// f32 softmax over the tokens the block table points at:
//   q (B, nh, hd); pool_k/pool_v (B, nblk, bs, nkv, hd); table (B, nblk)
//   logical -> physical; length (B,) valid tokens.  out (B, nh, hd).
// Positions >= length are masked (a length past the pool reads every block
// and no more), and length == 0 gives zeros, as the Pallas kernel does.
//
// Bound: memory.  Each valid K and V element is read once and feeds only
// 2 * rep FLOPs (rep = 3 at the serving shape), far below the H100's ~295
// FLOP/byte ridge, so the floor is (valid K + V bytes) / 3.35 TB/s, and the
// card needs many loads in flight on all 132 SMs to reach it.
//
// Design: two launches, no float atomics, no host sync (the grids depend on
// shapes only, never on `length`).
//  1. paged_split_kernel, one CTA per (split, KV head, sequence).  A split is
//     `bps` consecutive LOGICAL blocks (bps chosen by the wrapper from the
//     block size alone), so at the serving shape (8 sequences, 3 KV heads,
//     32 blocks of 64) the grid is 32 x 3 x 8 = 768 CTAs, all resident at
//     once.  A CTA whose split lies wholly past `length` writes the empty
//     partial (m = -1e30, l = 0) and exits.  Otherwise it reads its table
//     entries itself, copies the valid K/V rows of up to kChunk tokens into
//     shared memory with 16-byte cp.async (every row of the chunk in flight
//     at once), computes the rep x rows scores with a group of lanes per row
//     (16-byte vectors, shuffle reduction), and writes the f32 partial
//     (m, l, acc[rep, hd]) of its tokens to a workspace the wrapper
//     allocated.
//  2. paged_merge_kernel, one CTA per (KV head, sequence), merges that
//     sequence's partials in LOGICAL split order with the log-sum-exp rule
//     (the (m, l) pairs staged in shared memory first); empty partials
//     (l == 0) are skipped, and max(L, 1e-30) turns the all-empty case
//     (length == 0) into zeros.
// The result depends on logical order only, never on where a block lies in
// the pool, so compaction leaves it bit-identical.  Measured slower at the
// serving shapes, and so not taken: a single launch in which the last CTA
// of each sequence merges (found with an atomic counter), and a merge that
// computes the weights in parallel and prefetches table entries and q
// before the length test.
#include <cmath>

#include "common.cuh"

constexpr int kThreads = 128;
constexpr int kChunk = 64;  // tokens staged in shared memory at a time

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Dot product of one 16-byte vector of T with V f32 values.
template <typename T>
__device__ __forceinline__ float dot_vec(const uint4& raw, const float* qv) {
  const T* e = reinterpret_cast<const T*>(&raw);
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) a = fmaf(to_f32(e[i]), qv[i], a);
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                   const T* __restrict__ pool_v, const int* __restrict__ table,
                   const int* __restrict__ length, float* __restrict__ ws_acc,
                   float* __restrict__ ws_ml, int nh, int nkv, int nblk,
                   int bs, int hd, int bps, float scale) {
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int rep = nh / nkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int V = Vec<T>::N;
  const int nvec = hd / V;               // 16-byte vectors per row
  const int ld = hd + V;                 // padded smem row, in elements
  const long long part = ((long long)(b * nkv + g) * nsplit + s) * rep;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);          // kChunk * ld
  T* Vs = Ks + kChunk * ld;                        // kChunk * ld
  float* Qs = reinterpret_cast<float*>(Vs + kChunk * ld);  // rep * hd
  float* Acc = Qs + rep * hd;                      // rep * hd
  float* Ss = Acc + rep * hd;                      // rep * kChunk
  float* M = Ss + rep * kChunk;                    // rep
  float* L = M + rep;                              // rep
  float* Al = L + rep;                             // rep
  int* ok = reinterpret_cast<int*>(Al + rep);      // kChunk: row has a block

  const int len = length[b];
  const int ntok = len <= 0 ? 0 : min(len, nblk * bs);
  const int t0 = s * bps * bs;
  const int t_end = min(t0 + bps * bs, ntok);
  if (t0 >= t_end) {  // the split lies wholly past length
    if (tid < rep) {
      ws_ml[2 * (part + tid)] = NEG_INF;
      ws_ml[2 * (part + tid) + 1] = 0.f;
    }
    return;
  }
  const T* qb = q + ((long long)b * nh + (long long)g * rep) * hd;
  for (int i = tid; i < rep * hd; i += kThreads) {
    Qs[i] = to_f32(qb[i]);
    Acc[i] = 0.f;
  }
  if (tid < rep) {
    M[tid] = NEG_INF;
    L[tid] = 0.f;
  }

  // lanes per row: the smallest power of two >= nvec, at most 32
  int lpr = 1;
  while (lpr < nvec && lpr < 32) lpr <<= 1;
  const int rows_per_pass = kThreads / lpr;
  const int sub = tid % lpr;             // lane within its row group
  const long long row_stride = (long long)nkv * hd;

  for (int c0 = t0; c0 < t_end; c0 += kChunk) {
    const int rows = min(kChunk, t_end - c0);
    // stage the chunk's K/V rows: every 16-byte piece in flight at once
    for (int i = tid; i < rows * nvec; i += kThreads) {
      const int r = i / nvec, c = (i % nvec) * V;
      const int pos = c0 + r;
      const int p = table[(long long)b * nblk + pos / bs];
      T* kd = Ks + r * ld + c;
      T* vd = Vs + r * ld + c;
      if (p >= 0 && p < nblk) {
        const long long src = (((long long)b * nblk + p) * bs + pos % bs) *
                                  row_stride +
                              (long long)g * hd + c;
        cp_async16(kd, pool_k + src);
        cp_async16(vd, pool_v + src);
      } else {  // no block: the row is masked and reads as zeros
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
      if (c == 0) ok[r] = p >= 0 && p < nblk;
    }
    cp_async_wait_all();
    __syncthreads();

    // scores: a group of lpr lanes per row, 16-byte vectors
    for (int r0 = 0; r0 < rows; r0 += rows_per_pass) {
      const int r = r0 + tid / lpr;
      const bool live = r < rows;
      for (int h = 0; h < rep; ++h) {
        float a = 0.f;
        if (live) {
          for (int v = sub; v < nvec; v += lpr) {
            const uint4 raw = *reinterpret_cast<const uint4*>(Ks + r * ld +
                                                              v * V);
            a += dot_vec<T>(raw, Qs + h * hd + v * V);
          }
        }
        for (int o = lpr >> 1; o > 0; o >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        if (live && sub == 0)
          Ss[h * kChunk + r] = ok[r] ? a * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax over the chunk, one warp per query row
    for (int h = warp; h < rep; h += kThreads / 32) {
      float* sr = Ss + h * kChunk;
      float mx = NEG_INF;
      for (int t = lane; t < rows; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(M[h], mx);
      float sum = 0.f;
      for (int t = lane; t < rows; t += 32) {
        const float e = ok[t] ? expf(sr[t] - m_new) : 0.f;
        sr[t] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(M[h] - m_new);
        L[h] = alpha * L[h] + sum;
        M[h] = m_new;
        Al[h] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < rep * hd; i += kThreads) {
      const int h = i / hd, d = i % hd;
      const float* pr = Ss + h * kChunk;
      float a = Acc[i] * Al[h];
#pragma unroll 8
      for (int t = 0; t < rows; ++t) a = fmaf(pr[t], to_f32(Vs[t * ld + d]), a);
      Acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rep * hd; i += kThreads) ws_acc[part * hd + i] = Acc[i];
  if (tid < rep) {
    ws_ml[2 * (part + tid)] = M[tid];
    ws_ml[2 * (part + tid) + 1] = L[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ ws_acc,
                   const float* __restrict__ ws_ml, T* __restrict__ out,
                   int nh, int nkv, int hd, int nsplit) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = nh / nkv;
  const long long base = (long long)(b * nkv + g) * nsplit * rep;
  extern __shared__ float w[];  // nsplit * rep (m, l), then rep sums
  float* den = w + 2 * nsplit * rep;
  for (int i = threadIdx.x; i < 2 * nsplit * rep; i += kThreads)
    w[i] = ws_ml[2 * base + i];
  __syncthreads();
  // turn each (m, l) into the partial's weight exp(m - max m), 0 if empty
  for (int h = threadIdx.x; h < rep; h += kThreads) {
    float m = NEG_INF;
    for (int s = 0; s < nsplit; ++s)
      if (w[2 * (s * rep + h) + 1] > 0.f) m = fmaxf(m, w[2 * (s * rep + h)]);
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s) {  // logical order
      float* ml = w + 2 * (s * rep + h);
      const float ls = ml[1];
      ml[0] = ls > 0.f ? expf(ml[0] - m) : 0.f;
      l = fmaf(ml[0], ls, l);
    }
    den[h] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  T* ob = out + ((long long)b * nh + (long long)g * rep) * hd;
  for (int i = threadIdx.x; i < rep * hd; i += kThreads) {
    const int h = i / hd;
    const float* acc = ws_acc + base * hd + i;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) {  // logical order
      const float ws = w[2 * (s * rep + h)];
      const float x = acc[(long long)s * rep * hd];  // unwritten if empty
      a = ws > 0.f ? fmaf(ws, x, a) : a;
    }
    ob[i] = from_f32<T>(a / den[h]);
  }
}

static size_t split_smem_bytes(int rep, int hd, int elem) {
  return (size_t)2 * kChunk * (hd + 16 / elem) * elem +
         sizeof(float) * (size_t)(2 * rep * hd + rep * kChunk + 3 * rep) +
         sizeof(int) * kChunk;
}

template <typename T>
static void launch(const void* q, const void* pk, const void* pv,
                   const int* table, const int* length, void* out,
                   float* ws_acc, float* ws_ml, int B, int nh, int nkv,
                   int nblk, int bs, int hd, int bps, cudaStream_t stream) {
  const int rep = nh / nkv;
  const int nsplit = (nblk + bps - 1) / bps;
  const size_t smem = split_smem_bytes(rep, hd, (int)sizeof(T));
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    cudaFuncSetAttribute(paged_split_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    configured = smem;
  }
  paged_split_kernel<T><<<dim3(nsplit, nkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), table, length, ws_acc, ws_ml, nh, nkv, nblk,
      bs, hd, bps, (float)std::pow((double)hd, -0.5));
  if (cudaPeekAtLastError() != cudaSuccess) return;
  const size_t merge_smem = sizeof(float) * (size_t)(2 * nsplit + 1) * rep;
  static size_t merge_configured = 48 * 1024;
  if (merge_smem > merge_configured) {
    cudaFuncSetAttribute(paged_merge_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)merge_smem);
    merge_configured = merge_smem;
  }
  paged_merge_kernel<T><<<dim3(nkv, B), kThreads, merge_smem, stream>>>(
      ws_acc, ws_ml, static_cast<T*>(out), nh, nkv, hd, nsplit);
}

// All tensors contiguous, on one device; hd a multiple of 8 and every
// pointer 16-byte aligned (the Python wrapper checks).  ws_acc holds
// B * nkv * nsplit * nh/nkv * hd floats and ws_ml twice B * nkv * nsplit *
// nh/nkv, with nsplit = ceil(nblk / bps).  dtype: 0 f32, 1 bf16.
// Returns cudaGetLastError() after the launches.
extern "C" int paged_decode_attention(const void* q, const void* pool_k,
                                      const void* pool_v, const int* table,
                                      const int* length, void* out,
                                      float* ws_acc, float* ws_ml, int B,
                                      int nh, int nkv, int nblk, int bs,
                                      int hd, int bps, int dtype,
                                      cudaStream_t stream) {
  if (B > 0 && nblk == 0) {  // nothing to attend to: zeros
    cudaMemsetAsync(out, 0,
                    (size_t)B * nh * hd * (dtype == DTYPE_BF16 ? 2 : 4),
                    stream);
  } else if (B > 0) {
    if (dtype == DTYPE_BF16)
      launch<__nv_bfloat16>(q, pool_k, pool_v, table, length, out, ws_acc,
                            ws_ml, B, nh, nkv, nblk, bs, hd, bps, stream);
    else
      launch<float>(q, pool_k, pool_v, table, length, out, ws_acc, ws_ml, B,
                    nh, nkv, nblk, bs, hd, bps, stream);
  }
  return (int)cudaGetLastError();
}
