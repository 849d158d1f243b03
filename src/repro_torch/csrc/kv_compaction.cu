// KV-pool compaction: the Nezha GC of the paged KV cache, on Hopper.
//
// Replaces the Pallas TPU kernel compact_kv_pool_pallas (body
// _compact_kernel) of src/repro/kernels/kv_compaction/kernel.py:
//   out[b, i] = pool[b, table[b, i]]      pool: (B, nblk, bs, C) any dtype
// Out of place: the engine keeps the old pool valid until it swaps.
//
// Bound: pure data movement, zero FLOPs: every byte of the pool is read once
// and written once, so the floor is 2 * pool bytes / 3.35 TB/s.
// Design: one CUDA block per (b, i) pair loads table[b, i] itself (the TPU
// kernel's scalar prefetch) and copies the block's bytes with 16-byte vector
// loads and stores, neighbouring threads on neighbouring addresses.  The copy
// works on bytes, so every dtype takes the same kernel and the result is
// bit-exact.  The table is a permutation of [0, nblk) (the wrapper's caller,
// the engine, only builds such tables).
#include "common.cuh"

__global__ void compact_kernel(const uint4* __restrict__ pool,
                               const int* __restrict__ table,
                               uint4* __restrict__ out, int nblk,
                               long long nvec) {
  const long long bi = blockIdx.x;  // b * nblk + i
  const long long b = bi / nblk;
  const uint4* s = pool + (b * nblk + table[bi]) * nvec;
  uint4* dst = out + bi * nvec;
#pragma unroll 4
  for (long long k = threadIdx.x; k < nvec; k += blockDim.x) dst[k] = s[k];
}

// pool/out: B * nblk blocks of block_bytes bytes each, 16-byte aligned, and
// block_bytes a multiple of 16 (the Python wrapper checks); table: (B, nblk)
// int32.  Returns cudaGetLastError() after the launch.
extern "C" int compact_kv_pool(const void* pool, const int* table, void* out,
                               int B, int nblk, long long block_bytes,
                               cudaStream_t stream) {
  if (B > 0 && nblk > 0 && block_bytes > 0)
    compact_kernel<<<(unsigned)((long long)B * nblk), 256, 0, stream>>>(
        static_cast<const uint4*>(pool), table, static_cast<uint4*>(out),
        nblk, block_bytes / 16);
  return (int)cudaGetLastError();
}
