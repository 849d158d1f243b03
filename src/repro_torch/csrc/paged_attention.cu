// Paged decode attention: the KV-separated read path, on Hopper.
//
// Replaces the Pallas TPU kernel paged_decode_attention_pallas (body
// _paged_kernel) of src/repro/kernels/paged_attention/kernel.py.  One decode
// token per sequence; the `rep = nh / nkv` query heads of a KV head share an
// f32 online softmax over the blocks the table points at:
//   q (B, nh, hd); pool_k/pool_v (B, nblk, bs, nkv, hd); table (B, nblk)
//   logical -> physical; length (B,) valid tokens.  out (B, nh, hd).
// Logical blocks at or past ceil(length / bs) are skipped (the loop is also
// clamped to nblk, so a length past the pool reads every block and no
// more), positions >= length are masked, and length == 0 gives zeros, as
// the Pallas kernel does.
//
// Bound: memory.  Each valid K and V element is read once and feeds only
// 2 * rep FLOPs (rep = 3 at the serving shape), far below the H100's
// ~295 FLOP/byte ridge, so the floor is (valid K + V bytes) / 3.35 TB/s.
// Design: one CUDA block per (b, kv head), looping over its logical blocks in
// order (the TPU grid's sequential axis becomes this loop).  The block loads
// table[b, j] itself, stages the (bs, hd) K and V tiles in shared memory in
// f32 with 16-byte loads, computes the rep x bs scores, updates the running
// max/sum (one warp per query row) and accumulates rep x hd outputs in
// shared memory.  With B * nkv blocks only (24 at the serving shape, for 132
// SMs) this kernel stays well short of its bound; splitting the sequence
// axis over more blocks (flash-decoding) is later work.
#include <cmath>

#include "common.cuh"

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
             const T* __restrict__ pool_v, const int* __restrict__ table,
             const int* __restrict__ length, T* __restrict__ out, int nh,
             int nkv, int nblk, int bs, int hd, float scale) {
  const int b = blockIdx.x / nkv;
  const int g = blockIdx.x % nkv;
  const int rep = nh / nkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;
  const int ks = hd + 1;  // padded K row: scores read K rows bank-free

  extern __shared__ float smem[];
  float* Qs = smem;              // rep * hd
  float* Acc = Qs + rep * hd;    // rep * hd
  float* Ks = Acc + rep * hd;    // bs * (hd + 1)
  float* Vs = Ks + bs * ks;      // bs * hd
  float* Ss = Vs + bs * hd;      // rep * bs
  float* M = Ss + rep * bs;      // rep
  float* L = M + rep;            // rep
  float* Al = L + rep;           // rep

  const int len = length[b];
  const int nvalid = len <= 0 ? 0 : min((len + bs - 1) / bs, nblk);
  const T* qb = q + ((long long)b * nh + (long long)g * rep) * hd;
  for (int i = tid; i < rep * hd; i += kThreads) {
    Qs[i] = to_f32(qb[i]);
    Acc[i] = 0.f;
  }
  if (tid < rep) {
    M[tid] = NEG_INF;
    L[tid] = 0.f;
  }
  __syncthreads();

  constexpr int V = Vec<T>::N;
  const int vpr = hd / V;  // vectors per row
  const long long row_stride = (long long)nkv * hd;
  for (int j = 0; j < nvalid; ++j) {
    const int p = table[(long long)b * nblk + j];
    if (p < 0 || p >= nblk) continue;  // uniform over the block
    const long long base = ((long long)b * nblk + p) * bs * row_stride +
                           (long long)g * hd;
    for (int i = tid; i < bs * vpr; i += kThreads) {
      const int t = i / vpr, c = (i % vpr) * V;
      float buf[V];
      load_vec_f32(pool_k + base + t * row_stride + c, buf);
#pragma unroll
      for (int e = 0; e < V; ++e) Ks[t * ks + c + e] = buf[e];
      load_vec_f32(pool_v + base + t * row_stride + c, buf);
#pragma unroll
      for (int e = 0; e < V; ++e) Vs[t * hd + c + e] = buf[e];
    }
    __syncthreads();

    for (int i = tid; i < rep * bs; i += kThreads) {
      const int r = i / bs, t = i % bs;
      float s = NEG_INF;
      if (j * bs + t < len) {
        const float* qr = Qs + r * hd;
        const float* kr = Ks + t * ks;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc * scale;
      }
      Ss[i] = s;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += nwarps) {
      float* sr = Ss + r * bs;
      float mx = NEG_INF;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(M[r], mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float e = expf(sr[t] - m_new);
        sr[t] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(M[r] - m_new);
        L[r] = alpha * L[r] + sum;
        M[r] = m_new;
        Al[r] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < rep * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const float* pr = Ss + r * bs;
      float a = Acc[i] * Al[r];
      for (int t = 0; t < bs; ++t) a = fmaf(pr[t], Vs[t * hd + d], a);
      Acc[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * nh + (long long)g * rep) * hd;
  for (int i = tid; i < rep * hd; i += kThreads)
    ob[i] = from_f32<T>(Acc[i] / fmaxf(L[i / hd], 1e-30f));
}

static size_t smem_bytes(int rep, int bs, int hd) {
  return sizeof(float) *
         (size_t)(2 * rep * hd + bs * (hd + 1) + bs * hd + rep * bs + 3 * rep);
}

template <typename T>
static void launch(const void* q, const void* pk, const void* pv,
                   const int* table, const int* length, void* out, int B,
                   int nh, int nkv, int nblk, int bs, int hd,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(nh / nkv, bs, hd);
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    cudaFuncSetAttribute(paged_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    configured = smem;
  }
  paged_kernel<T><<<B * nkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), table, length, static_cast<T*>(out), nh, nkv,
      nblk, bs, hd, (float)std::pow((double)hd, -0.5));
}

// All tensors contiguous, on one device; hd a multiple of 8 and every
// pointer 16-byte aligned (the Python wrapper checks).  A block size and
// head_dim whose tiles need more shared memory than a block may have
// (227 KB) fail the launch, and the error is returned.  dtype: 0 f32, 1 bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_attention(const void* q, const void* pool_k,
                                      const void* pool_v, const int* table,
                                      const int* length, void* out, int B,
                                      int nh, int nkv, int nblk, int bs,
                                      int hd, int dtype, cudaStream_t stream) {
  if (B > 0) {
    if (dtype == DTYPE_BF16)
      launch<__nv_bfloat16>(q, pool_k, pool_v, table, length, out, B, nh, nkv,
                            nblk, bs, hd, stream);
    else
      launch<float>(q, pool_k, pool_v, table, length, out, B, nh, nkv, nblk,
                    bs, hd, stream);
  }
  return (int)cudaGetLastError();
}
