// Causal GQA flash attention (forward) for prefill on Hopper, bf16, with
// head dim 64 or 128: the tensor-core ("wgmma") route.
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _flash_kernel)
// of src/repro/kernels/flash_attention/kernel.py for bf16 inputs with
// hd in {64, 128}; every other dtype and head dim takes the CUDA-core route
// of flash_attention.cu (the wrapper chooses by dtype and head dim alone):
//   q (B, nh, Sq, hd); k, v (B, nkv, Skv, hd); out (B, nh, Sq, hd) bf16.
//   Query head h reads KV head h // (nh / nkv); scale hd ** -0.5; m, l and
//   the output accumulator in f32; under `causal`, key c is visible to
//   query r iff c <= r (both counted from position 0).
//
// Bound: operations.  At the serving shape (S = 2048, hd = 64) each K/V byte
// feeds ~S FLOPs, far above the H100's ~295 FLOP/byte ridge, so the floor is
// the bf16 tensor-core rate (989 TFLOP/s dense).
// Design:
//  - One CTA (one warpgroup) per (b * nh + h, 64-row query tile), heaviest
//    (longest causal) tiles first across all heads.  64 rows is one wgmma M:
//    at the serving shape that gives 288 CTAs, three resident per SM at hd
//    64, so the grid is one wave and the causal imbalance evens out; the
//    co-resident CTAs keep an SM's tensor cores busy while one of them is in
//    its softmax.  (128-row tiles would give 144 CTAs for 132 SMs.)
//    Measured slower or no better: a separate producer warp (its registers
//    cost the third resident CTA at hd 64), and at hd 128 two warpgroups
//    per CTA sharing the K/V tiles (within 6 %, at 128 KB of shared
//    memory).
//  - Thread 0 issues TMA loads (3-D tensor maps over (hd, S, heads), boxes
//    64 columns wide with the 128-byte swizzle) of Q once and of the K/V
//    tiles into a ring of ST stages, with mbarrier completion; a stage is
//    refilled once all 128 threads have arrived on its `empty` mbarrier.
//    Rows past Sq or Skv are zero-filled by TMA, and the mask does the rest.
//  - S = Q K^T: wgmma m64n64k16, A (Q) and B (K) from shared memory, both
//    K-major (no transpose).  A bf16 row of hd = 64 is exactly 128 bytes, one
//    swizzle atom wide; hd = 128 is two such column tiles.
//  - Softmax online, in registers, in f32 (base-2 exponent with the scale
//    folded in); the mask is applied only on tiles that cross the diagonal
//    or the end of K.  Each thread owns 2 rows x BK / 4 columns of S; row
//    max and sum need two shuffles.  Software pipeline: S of tile j and
//    P V of tile j - 1 run on the tensor cores while the softmax of tile j
//    runs on the CUDA cores.
//  - O += P V: P is rounded to bf16 and fed from registers as wgmma's A
//    operand (the S accumulator layout is the A fragment layout), V comes
//    from shared memory as an MN-major B operand (the descriptor's transpose
//    bit), one m64n64k16 per 64 columns of hd.
//  - Epilogue: O / l in f32, rounded to bf16, rows past Sq not stored.
#include <cuda.h>
#include <dlfcn.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64;  // query rows per CTA, keys per K/V tile
constexpr int kThreads = 128;  // one warpgroup

// HD: head dim; ST: stages of the K/V ring (3 at hd 64 and 2 at hd 128 keep
// three and two CTAs resident per SM; more stages, 128-key tiles and 32-key
// tiles were all measured slower).  A tile is kept as HD / 64 column tiles
// of rows x 128 bytes (one swizzle atom wide), each written by one TMA box.
template <int HD, int ST>
struct Cfg {
  static constexpr int NSUB = HD / 64;
  static constexpr int kQElems = BQ * 64;      // one Q column tile
  static constexpr int kKVElems = BK * 64;     // one K or V column tile
  static constexpr uint32_t kQBytes = NSUB * kQElems * 2;
  static constexpr uint32_t kStageBytes = 2 * NSUB * kKVElems * 2;
  static constexpr size_t smem =
      1024 + kQBytes + (size_t)ST * kStageBytes + 8 * (1 + 2 * ST);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a tile written by TMA with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), swizzle mode B128.  The
// leading offset is unused by these layouts (one 64-wide atom column per
// operand).  Used K-major for Q and K and MN-major for V.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps the A fragments of an in-flight wgmma in their registers until it
// has been waited for: the compiler sees them consumed at the issue.
template <int K>
__device__ __forceinline__ void fence_pa(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A (4 registers of bf16 pairs) from registers, B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, int ST>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, int nh, int nkv, int Sq,
                   int Skv, int causal, int n_qt, float scale_log2) {
  using C = Cfg<HD, ST>;
  constexpr int NSUB = C::NSUB, QE = C::kQElems, KE = C::kKVElems;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Qs = base;                          // NSUB tiles
  __nv_bfloat16* Ks = Qs + NSUB * QE;                // ST x NSUB tiles
  __nv_bfloat16* Vs = Ks + ST * NSUB * KE;           // ST x NSUB tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * NSUB * KE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int nbh = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / nbh;   // heaviest tiles first
  const int bh = blockIdx.x % nbh;
  const int b = bh / nh, h = bh % nh, g = h / (nh / nkv);
  const int kvh = b * nkv + g;
  const int q0 = qt * BQ;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_kt = (kv_end + BK - 1) / BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // K and V of tile kt into stage kt % ST (thread 0 only)
  auto load_tile = [&](int kt) {
    const int s = kt % ST;
    mbar_expect_tx(&full[s], C::kStageBytes);
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      tma_load_3d(Ks + (s * NSUB + j) * KE, &tm_k, &full[s], 64 * j,
                  kt * BK, kvh);
      tma_load_3d(Vs + (s * NSUB + j) * KE, &tm_v, &full[s], 64 * j,
                  kt * BK, kvh);
    }
  };
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
      tma_load_3d(Qs + j * QE, &tm_q, q_full, 64 * j, q0, bh);
    for (int kt = 0; kt < min(ST, n_kt); ++kt) load_tile(kt);
  }
  __syncthreads();

  const int rA = q0 + 16 * warp + (lane >> 2), rB = rA + 8;
  const int cq = 2 * (lane & 3);  // first of this thread's column pair

  float o[NSUB][32];
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;
  float aA = 1.f, aB = 1.f;  // the latest tile's rescale factors
  float sc[BK / 2];           // S of one tile, then its P in f32
  uint32_t pa[BK / 16][4];   // P in bf16, as the A fragments of P V

  // S = Q K^T of the tile in stage s, issued but not waited for
  auto issue_s = [&](int s) {
    const __nv_bfloat16* Kt = Ks + s * NSUB * KE;
#pragma unroll
    for (int k = 0; k < HD / 16; ++k)
      wgmma_ss(sc, sw128_desc(Qs + (k / 4) * QE + (k % 4) * 16),
               sw128_desc(Kt + (k / 4) * KE + (k % 4) * 16), k > 0);
  };
  // O += P V of the tile in stage s, issued but not waited for
  auto issue_pv = [&](int s) {
    const __nv_bfloat16* Vt = Vs + s * NSUB * KE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
        wgmma_rs(o[j], pa[kk], sw128_desc(Vt + j * KE + kk * 16 * 64));
  };
  // S of the tile at key k0 -> P (f32, in sc) and the running m, l; the
  // rescale factors of O go to aA, aB
  auto softmax = [&](int k0) {
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i & 2) ? rB : rA;
      const int c = k0 + 8 * (i >> 2) + cq + (i & 1);
      const bool ok = !edge || (c < Skv && (!causal || c <= r));
      sc[i] = ok ? sc[i] * scale_log2 : NEG_INF;
    }
    float xA = NEG_INF, xB = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 4) {
      xA = fmaxf(xA, fmaxf(sc[i], sc[i + 1]));
      xB = fmaxf(xB, fmaxf(sc[i + 2], sc[i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, off));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, off));
    }
    // every row sees a valid key in every tile it visits (key k0 <= row),
    // so the new max is finite and a masked score's P is exactly 0
    const float nA = fmaxf(mA, xA), nB = fmaxf(mB, xB);
    aA = ex2(mA - nA);
    aB = ex2(mB - nB);
    mA = nA;
    mB = nB;
    float sA = 0.f, sB = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 4) {
      sc[i] = ex2(sc[i] - nA);
      sc[i + 1] = ex2(sc[i + 1] - nA);
      sc[i + 2] = ex2(sc[i + 2] - nB);
      sc[i + 3] = ex2(sc[i + 3] - nB);
      sA += sc[i] + sc[i + 1];
      sB += sc[i + 2] + sc[i + 3];
    }
    lA = aA * lA + sA;
    lB = aB * lB + sB;
  };
  // P in bf16 as the A fragments of BK / 16 k16 steps: columns 16kk..16kk+15
  // are accumulator groups 2kk and 2kk + 1
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int i0 = 8 * kk, i1 = 8 * kk + 4;
      pa[kk][0] = pack_bf16(sc[i0], sc[i0 + 1]);
      pa[kk][1] = pack_bf16(sc[i0 + 2], sc[i0 + 3]);
      pa[kk][2] = pack_bf16(sc[i1], sc[i1 + 1]);
      pa[kk][3] = pack_bf16(sc[i1 + 2], sc[i1 + 3]);
    }
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int j = 0; j < NSUB; ++j) fence_acc(o[j]);
  };

  // Software pipeline: while the tensor cores run S of tile kt and P V of
  // tile kt - 1, the warpgroup computes the softmax of tile kt.
  mbar_wait(q_full, 0);
  if (n_kt > 0) {
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    softmax(0);
    pack_p();
  }
  for (int kt = 1; kt < n_kt; ++kt) {
    const int s = kt % ST, sp = (kt - 1) % ST;
    mbar_wait(&full[s], (kt / ST) & 1);
    fence_acc(sc);
    fence_o();
    fence_pa(pa);
    wgmma_fence();
    issue_s(s);
    wgmma_commit();
    issue_pv(sp);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile kt is in
    fence_acc(sc);
    softmax(kt * BK);
    wgmma_wait<0>();  // P V of tile kt - 1 is in
    fence_o();
    fence_pa(pa);
    mbar_arrive(&empty[sp]);
    // stage sp is free once every thread's P V of tile kt - 1 is in: refill
    // it with tile kt - 1 + ST
    if (tid == 0 && kt - 1 + ST < n_kt) {
      mbar_wait(&empty[sp], ((kt - 1) / ST) & 1);
      load_tile(kt - 1 + ST);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] *= (i & 2) ? aB : aA;
    pack_p();
  }
  if (n_kt > 0) {
    const int sp = (n_kt - 1) % ST;
    fence_o();
    fence_pa(pa);
    wgmma_fence();
    issue_pv(sp);
    wgmma_commit();
    wgmma_wait<0>();
    fence_o();
    fence_pa(pa);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, off);
    lB += __shfl_xor_sync(0xffffffffu, lB, off);
  }
  const float iA = 1.f / fmaxf(lA, 1e-30f), iB = 1.f / fmaxf(lB, 1e-30f);
  __nv_bfloat16* ob = out + (long long)bh * Sq * HD;
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i & 2) ? rB : rA;
      if (r >= Sq) continue;
      const float inv = (i & 2) ? iB : iA;
      const int c = 64 * j + 8 * (i >> 2) + cq;
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r * HD + c) =
          __floats2bfloat162_rn(o[j][i] * inv, o[j][i + 1] * inv);
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which PyTorch has already
// loaded, so this library needs no link against it.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A (hd, S, heads) bf16 map cut into 64-column boxes of box_rows rows with
// the 128-byte swizzle;
// rows at or past S read as zeros.
bool make_map(CUtensorMap* map, EncodeTiled enc, const void* ptr, int hd,
              int S, int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)S * hd * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int ST>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int nh, int nkv, int Sq, int Skv, int causal, cudaStream_t stream) {
  EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, enc, q, HD, Sq, B * nh, BQ) ||
      !make_map(&mk, enc, k, HD, Skv, B * nkv, BK) ||
      !make_map(&mv, enc, v, HD, Skv, B * nkv, BK))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = Cfg<HD, ST>::smem;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(flash_wgmma_kernel<HD, ST>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    configured = true;
  }
  const int n_qt = (Sq + BQ - 1) / BQ;
  // scale_log2 = hd ** -0.5 * log2(e): the softmax runs in base 2
  flash_wgmma_kernel<HD, ST><<<n_qt * B * nh, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), nh, nkv, Sq, Skv, causal,
      n_qt, (float)(std::pow((double)HD, -0.5) * 1.4426950408889634));
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 tensors, contiguous, on one device, 16-byte aligned; hd 64 or 128
// (the Python wrapper checks).  Returns cudaGetLastError() after the launch,
// or the error that kept it from launching.
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* out, int B, int nh,
                                     int nkv, int Sq, int Skv, int hd,
                                     int causal, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Skv <= 0) {  // nothing to attend to: zeros, as l == 0 gives
    cudaMemsetAsync(out, 0, (size_t)B * nh * Sq * hd * 2, stream);
    return (int)cudaGetLastError();
  }
  switch (hd) {
    case 64:
      return launch<64, 3>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, stream);
    case 128:
      return launch<128, 2>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
