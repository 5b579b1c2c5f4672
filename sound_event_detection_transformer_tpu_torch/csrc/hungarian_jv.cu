// Batched linear sum assignment by Jonker-Volgenant shortest augmenting
// paths: three kernels for the three TPU kernels of
// sound_event_detection_transformer_tpu/ops/pallas/hungarian.py.
//
//   jv_warp_kernel<C>  one warp per problem, C columns a lane, nc + 1 <= 32 C:
//                      C = 1 for `_jv_lane_kernel` (nc + 1 <= 32), C = 2, 4, 8
//                      for `_jv_packed_kernel` (nc + 1 <= 256) and for
//                      `_jv_kernel`'s square problems up to n = 126
//   jv_block_kernel    one block per problem, any width     (`_jv_packed_kernel`)
//   jv_square_kernel   one warp per square problem, columns strided over the
//                      lanes, any n                         (`_jv_kernel`)
//
// The first two compute the same function: cost f32 [B, nr, nc] with
// nr <= nc -> row-for-column int32 [B, nc], -1 on the nc - nr columns left
// free.  Only the nr real rows are inserted.  A square problem is the case
// nr = nc; the third kernel takes cost [B, n, n] and returns [B, n].
// Arithmetic is f32 with INF = 1e18 and the lowest-index tie-break of the JAX
// package, so ties resolve the same way in all three and in the plain
// versions: the answers are the same index for index.
//
// Termination does not depend on the costs: the minimum is taken over live
// (real, unused) columns only, so every expansion uses up one more column,
// and a free column always remains because nr <= nc.  A live column's bid
// is clamped to INF, below the +inf of the others, whatever the costs hold.
// A NaN or infinite cost gives a wrong assignment, never a warp that spins.
// All three kernels keep this rule.
#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 1.0e18f;

// ---- jv_warp_kernel --------------------------------------------------------
// One body for three TPU kernels, told apart only by C, the columns a lane:
//   C = 1     replaces `_jv_lane_kernel` (launched by `_lane_packed`, the
//             default of `pallas_hungarian_packed` when nc + 1 <= 32);
//   C = 2..8  replaces `_jv_packed_kernel` (launched by `_sublane_packed`: the
//             dispatch of `pallas_hungarian_packed` when nc + 1 > 32, or when
//             forced) for nc + 1 <= 256, and `_jv_kernel` (`jv_body`, reached
//             through `pallas_hungarian`) for square problems with nr = nc,
//             each with a cost block and state of at most 64 KB.
//
// What bounds it: at the evaluation step's shape [192, 10, 20] a launch moves
// 169 KB, at the long-clip step's [24, 40, 60] 236 KB, and either does a few
// megaflops; its time is the chain of dependent expansions of the longest
// search (about 55 at the first shape, up to 1 + 2 + ... + nr = 820 at the
// second, 1,830 for a square n = 60), so what counts is the number of
// dependent instructions in one expansion and in the work once per row, not
// bytes or operations.
//
// What the design does about that: one warp per problem and no block
// barrier anywhere.  Lane l owns columns l, l + 32, ... (C a lane, a template
// parameter, every loop over them unrolled so that v, minv, way, the column's
// row and the `used` bits stay in registers).  The chain of one expansion is:
//   read u[i0] and the cost row's entries from shared memory (in parallel),
//   two subtractions, a compare-select, the lane's own fold over its C
//   columns (ascending, so the lowest index wins; the body is selects only,
//   since a branch around the cost read parts the lanes and was far slower
//   on the card at C = 2), then two integer warp
//   reductions (`redux.sync` through __reduce_min_sync): the first over an
//   order-preserving unsigned image of the f32 bid, the second, among the
//   lanes that hold that minimum, over (column << 8 | row assigned to it).
// The second reduction hands every lane the next column and its row at once,
// so no read of p[j0] and no shuffle sits on the chain.  Row potentials
// of rows in the tree ride in the registers of the lane that owns the row's
// column and are written back once per inserted row: each is read once, when
// its row enters the tree, so the search writes no shared memory at all.
// The augmenting walk: at C = 1 each lane holds its column's row and `way`,
// so every lane first takes the row of the column it points back to (one
// shuffle), the path is followed by one shuffle a link, and the lanes on it
// keep the row they took: no shared memory and no barrier but the one that
// publishes the row potentials.  At C = 1 a row is inserted after only about
// 5.5 expansions at the evaluation step's shape, so this per-row work counts:
// timed on the card against the shared-memory walk below forced at C = 1,
// the shuffle walk was the faster at each of K1's three shapes on random,
// tie-heavy and BIG-padded costs; so it was against a walk-free variant
// that kept each column's path as a bit mask (one more shuffle an
// expansion) at the 20 x 20 shapes.  At C > 1 the walk is serial pointer
// chasing over shared memory, lane 0's, since a lane holds several columns.
// The arithmetic (f32, the order of the subtractions, INF = 1e18, lowest
// index on ties, -0 bidding as +0) is that of the other kernels, so the
// answers are the same index for index.  The cost block arrives by cp.async.
//
// An unsigned image of an f32 bid whose order is the bids' order: the sign
// bit of a non-negative is set, a negative is complemented (one xor with the
// sign spread over the word); adding +0 first turns -0 into +0, so the two
// tie.  Bids are clamped before they get here, so no NaN does.
__device__ inline unsigned ordered_key(float x) {
  const unsigned bits = __float_as_uint(x + 0.0f);
  return bits ^ (static_cast<unsigned>(static_cast<int>(bits) >> 31) | 0x80000000u);
}

__device__ inline float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ inline void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

template <int C>
__global__ void jv_warp_kernel(const float* __restrict__ cost, int* __restrict__ out,
                               int batch, int nr, int nc) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // warp-uniform: the whole warp leaves

  const int per_problem = nr * nc + (nr + 1) + 2 * (nc + 1);
  float* a = smem + warp * per_problem;               // [nr * nc]
  float* u_s = a + nr * nc;                           // [nr + 1] row potentials
  int* p_s = reinterpret_cast<int*>(u_s + (nr + 1));  // [nc + 1] col -> row
  int* way_s = p_s + (nc + 1);                        // [nc + 1], for the walk

  const float* src = cost + static_cast<long long>(b) * nr * nc;
  for (int k = lane; k < nr * nc; k += 32) copy_async4(a + k, src + k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = lane; k <= nr; k += 32) u_s[k] = 0.0f;
  for (int k = lane; k <= nc; k += 32) p_s[k] = 0;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  const float* a_rows = a - nc;  // cost row of (1-indexed) row i0 at a_rows + i0 nc

  float v[C];     // potentials of columns lane, lane + 32, ...
  int pc[C];      // rows (1-indexed) assigned to them; 0 = free
  bool real[C];   // a column of the problem: not the root, not past nc
  int offset[C];  // where the column sits in a cost row (0 for the others: a legal read)
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = lane + 32 * c;
    v[c] = 0.0f;
    pc[c] = 0;
    real[c] = col >= 1 && col <= nc;
    offset[c] = real[c] ? col - 1 : 0;
  }

  for (int i = 1; i <= nr; ++i) {
    float minv[C];
    int way[C];
    float uval[C];  // potential of the row this column brought into the tree
    int urow[C];    // that row
    bool used[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      minv[c] = kInf;
      way[c] = 0;
      uval[c] = 0.0f;
      urow[c] = 0;
      used[c] = false;
    }
    if (lane == 0) {  // the virtual root holds the row being inserted
      p_s[0] = i;
      pc[0] = i;
    }
    int j0 = 0;
    int i0 = i;
    // Dijkstra: grow the alternating tree until it reaches a free column.
    // j0 and i0 come out of warp reductions, so every lane loops alike; the
    // body is selects only, so the lanes never part ways inside it either.
    do {
      const float u_i0 = u_s[i0];
      const float* row = a_rows + i0 * nc;
      float bm = CUDART_INF_F;  // this lane's best live bid ...
      unsigned bc = UINT_MAX;   // ... as column << 8 | its row
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        const bool enters = col == j0;
        used[c] = used[c] || enters;
        urow[c] = enters ? i0 : urow[c];
        uval[c] = enters ? u_i0 : uval[c];
        const bool live = real[c] && !used[c];
        const float cur = row[offset[c]] - u_i0 - v[c];
        const bool better = live && cur < minv[c];
        minv[c] = better ? cur : minv[c];
        way[c] = better ? j0 : way[c];
        // a live bid is clamped below the +inf of the dead columns
        const float bid = live ? fminf(minv[c], kInf) : CUDART_INF_F;
        // ascending columns: the lowest index wins a tie.  The first column
        // needs no compare: if its bid is +inf and none beats it, the lane's
        // key is above the warp's minimum and bc is never read.
        const bool wins = c == 0 || bid < bm;
        bm = wins ? bid : bm;
        bc = wins ? static_cast<unsigned>(col << 8 | pc[c]) : bc;
      }
      const unsigned key = ordered_key(bm);
      const unsigned key_min = __reduce_min_sync(kFull, key);
      const unsigned best = __reduce_min_sync(kFull, key == key_min ? bc : UINT_MAX);
      const float delta = key_value(key_min);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] -= used[c] ? delta : 0.0f;
        uval[c] += used[c] ? delta : 0.0f;
        minv[c] -= used[c] ? 0.0f : delta;
      }
      j0 = static_cast<int>(best >> 8);
      i0 = static_cast<int>(best & 255u);
    } while (i0 != 0);
    // Augment: walk the path back to the root, shifting assignments.
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (used[c]) u_s[urow[c]] = uval[c];
    }
    if constexpr (C == 1) {
      // p[j] takes p[way[j]] on the path; j0 stays warp-uniform, so does the loop
      const int taken = __shfl_sync(kFull, pc[0], way[0]);
      bool on_path = false;
      do {
        on_path = on_path || lane == j0;
        j0 = __shfl_sync(kFull, way[0], j0);
      } while (j0 != 0);
      pc[0] = on_path ? taken : pc[0];
      __syncwarp();  // the row potentials are written before the next search
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        if (col <= nc) way_s[col] = way[c];
      }
      __syncwarp();
      if (lane == 0) {
        do {
          const int j1 = way_s[j0];
          p_s[j0] = p_s[j1];
          j0 = j1;
        } while (j0 != 0);
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        if (col <= nc) pc[c] = p_s[col];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = lane + 32 * c;
    if (col >= 1 && col <= nc) out[static_cast<long long>(b) * nc + (col - 1)] = pc[c] - 1;
  }
}

// ---- jv_block_kernel ------------------------------------------------------
// The same function for what the warp kernel does not take: more than 255
// columns, or a cost block over 64 KB.
//
// What the design does: one block per problem, thread j holding
// column j (thread 0 the virtual root), so any width up to 1023 columns runs
// with the column state (v, minv, used, way) in registers.  What other
// threads must read lives in shared memory: the cost block, the assignment
// p, the row potentials u, and one (min, argmin) pair per warp.  The minimum
// is a shuffle butterfly inside each warp, then every thread
// folds the per-warp pairs (at most 32) itself, which saves the third
// barrier a second butterfly would need: two __syncthreads per expansion.
// The augmenting walk is serial pointer chasing, so thread 0 does it alone.
// The Pallas kernel's fixed-bound masked loops were forced by its compiler;
// here the loops end when the search does.
__global__ void jv_block_kernel(const float* __restrict__ cost,
                                int* __restrict__ out, int nr, int nc) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = blockIdx.x;

  float* a = smem;                                   // [nr * nc]
  float* u = a + nr * nc;                            // [nr + 1] row potentials
  float* red_m = u + (nr + 1);                       // [32] per-warp minimum
  int* red_j = reinterpret_cast<int*>(red_m + 32);   // [32] per-warp argmin
  int* p = red_j + 32;                               // [nc + 1] col -> row
  int* way = p + (nc + 1);                           // [nc + 1]

  const float* src = cost + static_cast<long long>(b) * nr * nc;
  for (int k = tid; k < nr * nc; k += blockDim.x) a[k] = src[k];
  for (int k = tid; k <= nr; k += blockDim.x) u[k] = 0.0f;
  for (int k = tid; k <= nc; k += blockDim.x) p[k] = 0;
  __syncthreads();

  const bool in_range = tid >= 1 && tid <= nc;  // a real column
  float v = 0.0f;  // column potential of column `tid`

  for (int i = 1; i <= nr; ++i) {
    if (tid == 0) p[0] = i;  // the virtual root holds the row being inserted
    __syncthreads();
    float minv = kInf;
    bool used = false;
    bool row_in_tree = false;  // row `tid` reached by this search
    int my_way = 0;
    int j0 = 0;
    do {
      if (tid == j0) used = true;
      const int i0 = p[j0];
      if (tid == i0) row_in_tree = true;
      const float u_i0 = u[i0];
      const bool live = in_range && !used;
      if (live) {
        const float cur = a[(i0 - 1) * nc + (tid - 1)] - u_i0 - v;
        if (cur < minv) {
          minv = cur;
          my_way = j0;
        }
      }
      // min and argmin over the live columns, lowest index on ties; other
      // threads bid +inf, above any live bid (clamped to INF), so never win
      float m = live ? fminf(minv, kInf) : CUDART_INF_F;
      int j1 = tid;
      for (int off = 16; off > 0; off >>= 1) {
        const float om = __shfl_xor_sync(kFull, m, off);
        const int oj = __shfl_xor_sync(kFull, j1, off);
        if (om < m || (om == m && oj < j1)) {
          m = om;
          j1 = oj;
        }
      }
      if (lane == 0) {
        red_m[warp] = m;
        red_j[warp] = j1;
      }
      __syncthreads();
      m = red_m[0];
      j1 = red_j[0];
      for (int w = 1; w < nwarps; ++w) {  // warps hold ascending columns
        const float om = red_m[w];
        if (om < m) {
          m = om;
          j1 = red_j[w];
        }
      }
      const float delta = m;
      if (row_in_tree) u[tid] += delta;  // thread r owns u[r], 1 <= r <= nr
      if (used) {
        v -= delta;
      } else {
        minv -= delta;
      }
      j0 = j1;
      __syncthreads();  // u is updated and the pairs are read before the next round
    } while (p[j0] != 0);
    // Augment: walk the path back to the root, shifting assignments.
    if (tid <= nc) way[tid] = my_way;
    __syncthreads();
    if (tid == 0) {
      do {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      } while (j0 != 0);
    }
    __syncthreads();
  }
  if (in_range) out[static_cast<long long>(b) * nc + (tid - 1)] = p[tid] - 1;
}

// ---- jv_square_kernel -----------------------------------------------------
// Replaces `_jv_kernel` (`jv_body`, reached through `pallas_hungarian`) for
// the square problems that jv_warp_kernel does not take: n > 126, where the
// cost block and state pass 64 KB.  The reference formulation, one square
// problem at a time with data-dependent loops and all column state in
// arrays, here one warp per problem.
//
// What bounds it: the same chain of dependent expansions, n (n + 1) / 2 at
// most; the cost is read row by row from device memory through the caches
// (each row read is one coalesced pass), so n is not limited by shared
// memory, which holds only the six state arrays of n + 1 entries.
//
// What the design does: lane l owns columns l, l + 32, ...; each expansion is
// one strided pass to relax and find the lane's best column, a shuffle
// butterfly across lanes, and one strided pass to update the potentials.
// Its chain holds two passes over shared memory, a read through the caches
// and two __syncwarp() an expansion, more than jv_warp_kernel's, which is why
// it serves only what that kernel cannot hold.
__global__ void jv_square_kernel(const float* __restrict__ cost,
                                 int* __restrict__ out, int n) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int n1 = n + 1;
  float* u = smem;            // row potentials, rows 1..n
  float* v = u + n1;          // column potentials
  float* minv = v + n1;
  int* p = reinterpret_cast<int*>(minv + n1);  // col -> row (1-indexed)
  int* way = p + n1;
  int* flags = way + n1;      // bit 0: column used, bit 1: row in the tree
  const float* a = cost + static_cast<long long>(b) * n * n;

  for (int j = lane; j < n1; j += 32) {
    u[j] = 0.0f;
    v[j] = 0.0f;
    p[j] = 0;
  }
  __syncwarp();
  for (int i = 1; i <= n; ++i) {
    for (int j = lane; j < n1; j += 32) {
      minv[j] = kInf;
      way[j] = 0;
      flags[j] = 0;
    }
    if (lane == 0) p[0] = i;
    __syncwarp();
    int j0 = 0;
    do {
      const int i0 = p[j0];
      const float u_i0 = u[i0];
      if (lane == 0) {
        flags[j0] |= 1;
        flags[i0] |= 2;
      }
      __syncwarp();
      float m = CUDART_INF_F;  // this lane's best live column
      int j1 = n1;
      for (int j = lane; j < n1; j += 32) {
        if (j >= 1 && !(flags[j] & 1)) {
          const float cur = a[(i0 - 1) * n + (j - 1)] - u_i0 - v[j];
          float mj = minv[j];
          if (cur < mj) {
            mj = cur;
            minv[j] = cur;
            way[j] = j0;
          }
          const float bid = fminf(mj, kInf);  // a live bid is below +inf
          if (bid < m) {  // ascending j: the lowest index wins a tie
            m = bid;
            j1 = j;
          }
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float om = __shfl_xor_sync(kFull, m, off);
        const int oj = __shfl_xor_sync(kFull, j1, off);
        if (om < m || (om == m && oj < j1)) {
          m = om;
          j1 = oj;
        }
      }
      const float delta = m;
      for (int j = lane; j < n1; j += 32) {
        const int f = flags[j];
        if (f & 2) u[j] += delta;
        if (f & 1) {
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
      __syncwarp();
    } while (p[j0] != 0);
    if (lane == 0) {
      do {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      } while (j0 != 0);
    }
    __syncwarp();
  }
  for (int j = lane + 1; j < n1; j += 32) {
    out[static_cast<long long>(b) * n + (j - 1)] = p[j] - 1;
  }
}

constexpr int kMaxSharedBytes = 232448;  // what one block may take on sm_90
constexpr int kMaxWarpsPerBlock = 4;     // problems per block of jv_warp_kernel
int g_sm_count = 132;                    // read by sedt_jv_init

size_t warp_problem_bytes(int nr, int nc) {
  return sizeof(float) * (static_cast<size_t>(nr) * nc + (nr + 1) + 2 * (nc + 1));
}

template <int C>
int launch_warp(const float* cost, int* out, int batch, int nr, int nc,
                cudaStream_t stream) {
  // the second warp minimum packs column << 8 | row: rows up to 255
  if (nr < 0 || nr > nc || nr > 255 || nc + 1 > 32 * C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per_problem = warp_problem_bytes(nr, nc);
  // a problem's time is its own chain, so spread the problems over the SMs
  // first and share a block only when there are more problems than SMs
  int warps = (batch + g_sm_count - 1) / g_sm_count;
  warps = warps < 1 ? 1 : (warps > kMaxWarpsPerBlock ? kMaxWarpsPerBlock : warps);
  while (warps > 1 && warps * per_problem > kMaxSharedBytes) --warps;
  if (per_problem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + warps - 1) / warps;
  jv_warp_kernel<C><<<blocks, 32 * warps, warps * per_problem, stream>>>(cost, out, batch,
                                                                        nr, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Raises the dynamic shared-memory limit of the kernels that may need more
// than 48 KB and reads the SM count, on the current device.  Called once per
// device when the library is loaded, so that a launch is pointer arithmetic
// and the launch itself (and can be captured into a CUDA graph).  Returns the
// first error as an int.
extern "C" int sedt_jv_init() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, device);
  }
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if (err == cudaSuccess) err = cudaFuncSetAttribute(jv_warp_kernel<1>, attr, kMaxSharedBytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(jv_warp_kernel<2>, attr, kMaxSharedBytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(jv_warp_kernel<4>, attr, kMaxSharedBytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(jv_warp_kernel<8>, attr, kMaxSharedBytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(jv_block_kernel, attr, kMaxSharedBytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(jv_square_kernel, attr, kMaxSharedBytes);
  return static_cast<int>(err);
}

// Each launcher runs its kernel on `stream` and returns cudaGetLastError()
// as an int (cudaErrorInvalidValue for a shape its kernel does not take).
//
// cost: device f32 [batch, nr, nc], contiguous; out: device int32 [batch, nc].
// The caller guarantees 0 <= nr <= nc <= 31: one column a lane.
extern "C" int sedt_jv_lane(const float* cost, int* out, int batch, int nr,
                            int nc, void* stream) {
  if (batch <= 0) return 0;
  return launch_warp<1>(cost, out, batch, nr, nc, static_cast<cudaStream_t>(stream));
}

// Same arguments; the caller guarantees 0 <= nr <= nc <= 255 (nr = nc for a
// square problem).  One problem's cost block and state
// (4 (nr nc + nr + 2 nc + 3) bytes) must fit a block's shared memory; the
// wrapper sends only those of at most 64 KB here.
extern "C" int sedt_jv_warp(const float* cost, int* out, int batch, int nr,
                            int nc, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc + 1 <= 64) return launch_warp<2>(cost, out, batch, nr, nc, s);
  if (nc + 1 <= 128) return launch_warp<4>(cost, out, batch, nr, nc, s);
  if (nc + 1 <= 256) return launch_warp<8>(cost, out, batch, nr, nc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Same arguments; the caller guarantees 0 <= nr <= nc <= 1023.  The cost
// block of one problem must fit the 227 KB of shared memory a block can have.
extern "C" int sedt_jv_block(const float* cost, int* out, int batch, int nr,
                             int nc, void* stream) {
  if (batch <= 0) return 0;
  const int threads = ((nc + 1 + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (static_cast<size_t>(nr) * nc + (nr + 1) + 32) +
                      sizeof(int) * (32 + 2 * (nc + 1));
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  jv_block_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, out, nr, nc);
  return static_cast<int>(cudaGetLastError());
}

// cost: device f32 [batch, n, n], contiguous; out: device int32 [batch, n].
extern "C" int sedt_jv_square(const float* cost, int* out, int batch, int n,
                              void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem = 6 * sizeof(float) * (n + 1);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  jv_square_kernel<<<batch, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, out, n);
  return static_cast<int>(cudaGetLastError());
}
