// Shared device code of the assessment scan kernels (the plan-specialized
// scan kernel of scan_spec.cuh and hll_fold.cu): the planes' layout and
// the HyperLogLog hash, rank and register update, defined once so the
// kernels that fold registers cannot drift apart.
//
// Every kernel is compiled by NVRTC (kernels/_build.py), which has no
// standard headers: the fixed-width types are declared here.
#pragma once

namespace scan {

typedef unsigned int uint32_t;
typedef unsigned long long uint64_t;

constexpr int N_PLANES = 13;
constexpr int VALID_PLANE = 3;      // COL_S_FLAGS
constexpr int VALID_BIT = 1 << 3;   // vocab.VALID
// HLL register banks up to this size live in a block's shared memory;
// larger ones are updated in place in the global output.
constexpr int SHARED_BANK_BYTES = 64 * 1024;

// --- HyperLogLog ------------------------------------------------------------
// Per row and sketch: h = HASH_SEED; for each column c, h = hash_step(h, c);
// then h = fmix32(h), in native uint32 arithmetic. bucket = h >> (32 - p);
// rank = clz(h << p) + 1, or 33 - p when h << p is 0. Rows whose s_flags
// plane is 0 (padding) fold nothing; that is not the VALID bit the counters
// use. hll_fold hashes with hash_row; the plan-specialized kernel prints
// the chain as hash_step calls, one per column prefix.

constexpr uint32_t HASH_SEED = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// One column folded into the chain state h.
__device__ __forceinline__ uint32_t hash_step(uint32_t h, uint32_t c) {
  return fmix32(h ^ c) * 5u + 0xE6546B64u;
}

// The hash of one row over n_cols plane columns; `row` may point into
// shared or global memory. Both loops are unrolled to the widest row and
// every word is read before the hash chain starts, so the loads do not
// wait on the chain and can all be in flight at once.
__device__ __forceinline__ uint32_t hash_row(const int* row, const int* cols,
                                             int n_cols) {
  uint32_t v[N_PLANES];
#pragma unroll
  for (int j = 0; j < N_PLANES; ++j)
    if (j < n_cols) v[j] = (uint32_t)row[cols[j]];
  uint32_t h = HASH_SEED;
#pragma unroll
  for (int j = 0; j < N_PLANES; ++j)
    if (j < n_cols) h = hash_step(h, v[j]);
  return fmix32(h);
}

__device__ __forceinline__ int hll_rank(uint32_t h, int p) {
  const int max_rank = 33 - p;
  const uint32_t w = h << p;
  const int rank = w == 0 ? max_rank : __clz((int)w) + 1;
  return rank < max_rank ? rank : max_rank;
}

// register = max(register, rank), skipping the atomic when it would not
// raise the register: registers only grow, so a rank no larger than a
// value once read can never be the final maximum. Most ranks are 1-3.
__device__ __forceinline__ void raise_to(int* reg, int rank, bool shared) {
  if (shared) {
    if (rank > *(volatile int*)reg) atomicMax(reg, rank);
  } else {
    if (rank > __ldcg(reg)) atomicMax(reg, rank);
  }
}

}  // namespace scan
