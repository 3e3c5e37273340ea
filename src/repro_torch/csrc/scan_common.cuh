// Shared device code of the assessment scan kernels (qap_count.cu,
// fused_scan.cu, hll_fold.cu): staging a tile of (rows, 13) int32 planes
// into shared memory, the planner's stack-machine bytecode evaluated over
// it, and the HyperLogLog hash, rank and register update, defined once so
// the kernels that fold registers cannot drift apart.
//
// Layout of the work: a block of THREADS threads walks tiles of TILE_ROWS
// rows in a grid-stride loop. Each thread owns ROWS_PER_THREAD rows of a
// tile (rows tid, tid + THREADS, ...), so the 32 lanes of a warp always
// read 32 neighbouring rows: the shared-memory stride between them is 13
// words, which is odd, so those reads hit 32 distinct banks.
//
// The bytecode is data (an int32 array of (op, a, b) triples in shared
// memory). Every thread runs the same instruction at the same time, so the
// branch on the opcode never diverges within a warp; the cost of decoding
// it is paid once for ROWS_PER_THREAD rows. The evaluation stack lives in
// one 64-bit register: level k holds ROWS_PER_THREAD bits, one per row.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace scan {

constexpr int N_PLANES = 13;
constexpr int VALID_PLANE = 3;      // COL_S_FLAGS
constexpr int VALID_BIT = 1 << 3;   // vocab.VALID
constexpr int THREADS = 128;
constexpr int ROWS_PER_THREAD = 4;
constexpr int TILE_ROWS = THREADS * ROWS_PER_THREAD;    // 512 rows
constexpr int TILE_WORDS = TILE_ROWS * N_PLANES;        // 26,624 bytes
constexpr int MAX_COUNTERS = 128;
constexpr int MAX_STACK = 64 / ROWS_PER_THREAD;         // 16 levels
constexpr unsigned ROW_MASK = (1u << ROWS_PER_THREAD) - 1;
// HLL register banks up to this size live in a block's shared memory;
// larger ones are updated in place in the global output.
constexpr int SHARED_BANK_BYTES = 64 * 1024;

enum Op {
  OP_HASBITS = 0, OP_ANYBITS = 1, OP_LT = 2, OP_LE = 3, OP_GT = 4,
  OP_GE = 5, OP_EQ = 6, OP_NE = 7, OP_AND = 8, OP_OR = 9, OP_NOT = 10,
  OP_EQP = 11, OP_EMIT = 12,
};

// Stage rows [row0, row0 + TILE_ROWS) into `tile`. Rows at or past n_rows
// become zero rows: their flag planes carry no bit, so they count in no
// counter and fold into no register. A tile starts at a multiple of
// TILE_ROWS * 52 bytes, so with a 16-byte-aligned base every thread can
// load 16 bytes at a time.
__device__ __forceinline__ void load_tile(int* __restrict__ tile,
                                          const int* __restrict__ planes,
                                          long long row0, long long n_rows) {
  const long long base = row0 * N_PLANES;
  const long long left = n_rows * N_PLANES - base;       // words in range
  const int words = left < TILE_WORDS ? (int)left : TILE_WORDS;
  if ((reinterpret_cast<uintptr_t>(planes) & 15) == 0) {
    const int4* src = reinterpret_cast<const int4*>(planes + base);
    int4* dst = reinterpret_cast<int4*>(tile);
    const int full = words / 4;
    for (int i = threadIdx.x; i < full; i += THREADS) dst[i] = __ldg(src + i);
    // the ragged end word by word: each word has exactly one writer
    for (int i = full * 4 + threadIdx.x; i < TILE_WORDS; i += THREADS)
      tile[i] = i < words ? __ldg(planes + base + i) : 0;
  } else {
    for (int i = threadIdx.x; i < TILE_WORDS; i += THREADS)
      tile[i] = i < words ? __ldg(planes + base + i) : 0;
  }
}

__device__ __forceinline__ const int* row_ptr(const int* tile, int r) {
  return tile + (r * THREADS + threadIdx.x) * N_PLANES;
}

// One bit per owned row: row r of this thread satisfies PRED(x) where x is
// its plane `a` (and y its plane `b`, for the plane-equality opcode).
#define SCAN_LEAF(PRED)                                          \
  {                                                              \
    _Pragma("unroll") for (int r = 0; r < ROWS_PER_THREAD; ++r) { \
      const int* row = row_ptr(tile, r);                         \
      const int x = row[a];                                      \
      (void)x;                                                   \
      bits |= (unsigned)(PRED) << r;                             \
    }                                                            \
  }

__device__ __forceinline__ unsigned eval_leaf(int op, int a, int b,
                                              const int* tile) {
  unsigned bits = 0;
  switch (op) {
    case OP_HASBITS: SCAN_LEAF((x & b) == b) break;
    case OP_ANYBITS: SCAN_LEAF((x & b) != 0) break;
    case OP_LT: SCAN_LEAF(x < b) break;
    case OP_LE: SCAN_LEAF(x <= b) break;
    case OP_GT: SCAN_LEAF(x > b) break;
    case OP_GE: SCAN_LEAF(x >= b) break;
    case OP_EQ: SCAN_LEAF(x == b) break;
    case OP_NE: SCAN_LEAF(x != b) break;
    case OP_EQP: SCAN_LEAF(x == row[b]) break;
    default: break;
  }
  return bits;
}

#undef SCAN_LEAF

// VALID bits of this thread's rows in the current tile.
__device__ __forceinline__ unsigned valid_bits(const int* tile) {
  unsigned bits = 0;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r)
    bits |= (unsigned)((row_ptr(tile, r)[VALID_PLANE] & VALID_BIT) != 0) << r;
  return bits;
}

// Run the whole program over this thread's rows of the tile and add each
// EMIT's count of true, VALID rows into the block's shared counters. All
// threads of the block must call it (it uses full-warp ballots).
__device__ __forceinline__ void run_program(
    const int* __restrict__ prog, int n_instr, const int* tile,
    unsigned long long* s_counts) {
  const unsigned valid = valid_bits(tile);
  uint64_t stack = 0;  // level k = bits [k*R, (k+1)*R)
  int sp = 0;
  for (int i = 0; i < n_instr; ++i) {
    const int op = prog[3 * i], a = prog[3 * i + 1], b = prog[3 * i + 2];
    if (op == OP_AND || op == OP_OR) {
      --sp;
      const uint64_t y = (stack >> (sp * ROWS_PER_THREAD)) & ROW_MASK;
      stack &= ~((uint64_t)ROW_MASK << (sp * ROWS_PER_THREAD));
      const int top = (sp - 1) * ROWS_PER_THREAD;
      if (op == OP_AND)
        stack &= ~((~y & ROW_MASK) << top);
      else
        stack |= y << top;
    } else if (op == OP_NOT) {
      stack ^= (uint64_t)ROW_MASK << ((sp - 1) * ROWS_PER_THREAD);
    } else if (op == OP_EMIT) {
      --sp;
      const unsigned x =
          (unsigned)(stack >> (sp * ROWS_PER_THREAD)) & ROW_MASK & valid;
      stack &= ~((uint64_t)ROW_MASK << (sp * ROWS_PER_THREAD));
      int total = 0;
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r)
        total += __popc(__ballot_sync(0xFFFFFFFFu, (x >> r) & 1u));
      if ((threadIdx.x & 31) == 0 && total)
        atomicAdd(&s_counts[a], (unsigned long long)total);
    } else {
      stack |= (uint64_t)eval_leaf(op, a, b, tile) << (sp * ROWS_PER_THREAD);
      ++sp;
    }
  }
}

// --- HyperLogLog ------------------------------------------------------------
// Per row and sketch: h = 0x9E3779B9; for each column c,
// h = fmix32(h ^ c); h = h * 5 + 0xE6546B64; then h = fmix32(h), in native
// uint32 arithmetic. bucket = h >> (32 - p); rank = clz(h << p) + 1, or
// 33 - p when h << p is 0. Rows whose s_flags plane is 0 (padding) fold
// nothing; that is not the VALID bit the counters use.

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
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
  uint32_t h = 0x9E3779B9u;
#pragma unroll
  for (int j = 0; j < N_PLANES; ++j) {
    if (j < n_cols) {
      h = fmix32(h ^ v[j]);
      h = h * 5u + 0xE6546B64u;
    }
  }
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

// Dynamic shared memory: [tile | program | (sketch banks)], in int32 words.
__host__ __device__ inline int program_words(int n_instr) {
  return (3 * n_instr + 3) & ~3;  // keep what follows 16-byte aligned
}

// Grid size: enough blocks to fill every SM once, at most one per tile.
inline int grid_blocks(const void* kernel, size_t smem, long long n_tiles,
                       cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess)
    return 0;
  if ((*err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)) != cudaSuccess)
    return 0;
  if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return 0;
  if (per_sm < 1) per_sm = 1;
  const long long want = (long long)sms * per_sm;
  return (int)(n_tiles < want ? n_tiles : want);
}

}  // namespace scan
