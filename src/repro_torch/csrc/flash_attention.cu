// Causal GQA flash attention (forward), used for prefill, on Hopper: the
// CUDA-core route.
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _flash_kernel)
// of src/repro/kernels/flash_attention/kernel.py for f32 inputs (any head
// dim) and bf16 inputs with hd 16 or 256; bf16 with hd 64 or 128 takes the
// tensor-core route of flash_attention_wgmma.cu.  The Python wrapper chooses
// by dtype and head dim alone.  f32 stays here, on f32 FMAs, because the
// tensor cores' TF32 would not hold the f32 result to 2e-5.  It computes:
//   q (B, nh, Sq, hd); k, v (B, nkv, Skv, hd); out (B, nh, Sq, hd) in q's
//   dtype.  Query head h reads KV head h // (nh / nkv); scale hd ** -0.5;
//   softmax in f32; under `causal`, key c is visible to query r iff c <= r
//   (both counted from position 0).
//
// Bound: at the serving shape (S = 2048, hd = 64) each K/V byte feeds ~S
// FLOPs, so the kernel is bound by operations, not bytes.  This kernel runs
// them as f32 FMAs on the CUDA cores (67 TFLOP/s peak).
// Design: one CUDA block per (b * nh + h, 64-row query tile), looping over
// 64-row KV tiles up to the diagonal (the TPU grid's sequential KV axis
// becomes this loop; heavy tiles are scheduled first).  Q, K, V and P tiles
// sit in shared memory in f32; each of the 256 threads owns a 4 x 4 piece of
// the score tile (rows ty + 16 i, columns tx + 16 j) and 4 rows x 4 columns
// per 64 of hd of the output, read with 16-byte shared-memory loads laid out
// so that no two threads of a quarter-warp hit one bank.  Row max and sum
// are reduced across the 16 threads of a row with warp shuffles.  Rows and
// keys past the ends are masked here: no shape needs to divide 64.
#include <cmath>

#include "common.cuh"

constexpr int BQ = 64, BK = 64, NT = 256;

template <int HD>
struct FlashSmem {
  static constexpr int LD = HD + 4;   // padded row, keeps 16-byte alignment
  static constexpr int PLD = BK + 4;
  static constexpr size_t bytes =
      sizeof(float) * (size_t)((BQ + 2 * BK) * LD + BQ * PLD);
};

// Rows [r0, r0 + rows) of a (S, HD) matrix into shared memory as f32 rows of
// stride LD; rows at or past S are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int S) {
  constexpr int V = Vec<T>::N;
  constexpr int VPR = HD / V;
  constexpr int LD = FlashSmem<HD>::LD;
  for (int i = threadIdx.x; i < rows * VPR; i += NT) {
    const int row = i / VPR, c = (i % VPR) * V;
    float buf[V];
    if (r0 + row < S) {
      load_vec_f32(src + (long long)(r0 + row) * HD + c, buf);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) buf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(dst + row * LD + c + e) =
          make_float4(buf[e], buf[e + 1], buf[e + 2], buf[e + 3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int nh, int nkv,
             int Sq, int Skv, int causal, float scale) {
  constexpr int LD = FlashSmem<HD>::LD, PLD = FlashSmem<HD>::PLD;
  constexpr int NCG = (HD + 63) / 64;  // 4-column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / nh, h = bh % nh, g = h / (nh / nkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const T* qb = q + (long long)bh * Sq * HD;
  const T* kb = k + ((long long)b * nkv + g) * Skv * HD;
  const T* vb = v + ((long long)b * nkv + g) * Skv * HD;

  load_tile<T, HD>(Qs, qb, q0, BQ, Sq);

  float m[4], l[4], acc[4][NCG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    load_tile<T, HD>(Ks, kb, k0, BK, Skv);
    load_tile<T, HD>(Vs, vb, k0, BK, Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool ok = c < Skv && (!causal || c <= r);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PLD + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int cg = 0; cg < NCG; ++cg) {
          const int col = 4 * (tx + 16 * cg);
          if (col < HD) {
            const float4 vv =
                *reinterpret_cast<const float4*>(Vs + (c + cc) * LD + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = cc == 0 ? pv[i].x
                            : cc == 1 ? pv[i].y
                            : cc == 2 ? pv[i].z : pv[i].w;
              acc[i][cg][0] = fmaf(p, vv.x, acc[i][cg][0]);
              acc[i][cg][1] = fmaf(p, vv.y, acc[i][cg][1]);
              acc[i][cg][2] = fmaf(p, vv.z, acc[i][cg][2]);
              acc[i][cg][3] = fmaf(p, vv.w, acc[i][cg][3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + ((long long)bh * Sq + r) * HD;
#pragma unroll
    for (int cg = 0; cg < NCG; ++cg) {
      const int col = 4 * (tx + 16 * cg);
      if (col < HD) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          orow[col + e] = from_f32<T>(acc[i][cg][e] / den);
      }
    }
  }
}

template <typename T, int HD>
static void launch(const void* q, const void* k, const void* v, void* out,
                   int B, int nh, int nkv, int Sq, int Skv, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = FlashSmem<HD>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(flash_kernel<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * nh);
  flash_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nh, nkv, Sq, Skv,
      causal, (float)std::pow((double)HD, -0.5));
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* out,
                    int B, int nh, int nkv, int Sq, int Skv, int hd,
                    int causal, cudaStream_t stream) {
  switch (hd) {
    case 16: launch<T, 16>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, stream); break;
    case 64: launch<T, 64>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, stream); break;
    case 128: launch<T, 128>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, stream); break;
    case 256: launch<T, 256>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// All tensors contiguous, on one device, 16-byte aligned; hd one of 16, 64,
// 128, 256 (the Python wrapper checks).  dtype: 0 f32, 1 bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int nh, int nkv, int Sq,
                               int Skv, int hd, int causal, int dtype,
                               cudaStream_t stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, nh, nkv, Sq, Skv, hd,
                                   causal, stream);
  return dispatch<float>(q, k, v, out, B, nh, nkv, Sq, Skv, hd, causal,
                         stream);
}
