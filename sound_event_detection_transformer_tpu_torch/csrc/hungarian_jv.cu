// Batched rectangular linear sum assignment by Jonker-Volgenant shortest
// augmenting paths, one warp per problem.
//
// Replaces the TPU kernel `_jv_lane_kernel` of
// sound_event_detection_transformer_tpu/ops/pallas/hungarian.py (launched by
// `_lane_packed`, the default of `pallas_hungarian_packed` when nc + 1 <= 32).
// It computes the same function: cost f32 [B, nr, nc] with nr <= nc ->
// row-for-column int32 [B, nc], -1 on the nc - nr columns left free.  Only
// the nr real rows are inserted.
//
// What bounds it: at the evaluation step's shape [192, 10, 20] the problem
// moves 169 KB and does about a megaflop, far below what the card needs a
// microsecond for.  Its time is latency: each problem is a chain of ~55
// dependent Dijkstra expansions, each a relaxation, a minimum over the
// columns and a potential update that must finish before the next starts.
//
// What the design does about that: one warp holds a whole problem, lane j
// holding column j (lane 0 the virtual root), so an expansion is one
// instruction per lane plus a 5-step __shfl_xor_sync butterfly for the
// minimum, with no shared-memory round trip and no block-wide barrier.  The
// column state (v, minv, used, way, p) lives in registers; the row potentials
// u live on lanes 1..nr (nr <= nc < 32), and the cost block sits in shared
// memory.  Problems are independent, so the warps of a block never
// synchronise with each other.  Arithmetic is f32 with INF = 1e18 and the
// lowest-index tie-break of the JAX package, so ties resolve the same way.
//
// Termination does not depend on the costs: the minimum is taken over live
// (real, unused) columns only, so every expansion uses up one more column,
// and a free column always remains because nr <= nc.  A NaN cost gives a
// wrong assignment, never a warp that spins.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 1.0e18f;

__global__ void jv_lane_kernel(const float* __restrict__ cost,
                               int* __restrict__ out, int batch, int nr,
                               int nc) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= batch) return;  // warp-uniform: the whole warp leaves

  const int block_elems = nr * nc;
  float* a = smem + warp * block_elems;
  const float* src = cost + static_cast<long long>(b) * block_elems;
  for (int k = lane; k < block_elems; k += 32) a[k] = src[k];
  __syncwarp();

  const bool in_range = lane >= 1 && lane <= nc;  // a real column
  float v = 0.0f;  // column potential of column `lane`
  float u = 0.0f;  // row potential of row `lane` (rows 1..nr)
  int p = 0;       // row (1-indexed) assigned to column `lane`; 0 = free

  for (int i = 1; i <= nr; ++i) {
    if (lane == 0) p = i;  // the virtual root holds the row being inserted
    float minv = kInf;
    bool used = false;
    bool row_in_tree = false;  // row `lane` reached by this search
    int way = 0;
    int j0 = 0;
    // Dijkstra: grow the alternating tree until it reaches a free column.
    do {
      if (lane == j0) used = true;
      const int i0 = __shfl_sync(kFull, p, j0);
      if (lane == i0) row_in_tree = true;
      const float u_i0 = __shfl_sync(kFull, u, i0);
      const bool live = in_range && !used;
      if (live) {
        const float cur = a[(i0 - 1) * nc + (lane - 1)] - u_i0 - v;
        if (cur < minv) {
          minv = cur;
          way = j0;
        }
      }
      // warp min and argmin over the live columns, lowest index on ties;
      // other lanes bid +inf, above any live minv (<= INF), so never win
      float m = live ? minv : CUDART_INF_F;
      int j1 = lane;
      for (int off = 16; off > 0; off >>= 1) {
        const float om = __shfl_xor_sync(kFull, m, off);
        const int oj = __shfl_xor_sync(kFull, j1, off);
        if (om < m || (om == m && oj < j1)) {
          m = om;
          j1 = oj;
        }
      }
      const float delta = m;
      if (row_in_tree) u += delta;
      if (used) {
        v -= delta;
      } else {
        minv -= delta;
      }
      j0 = j1;
    } while (__shfl_sync(kFull, p, j0) != 0);
    // Augment: walk the path back to the root, shifting assignments.
    do {
      const int j1 = __shfl_sync(kFull, way, j0);
      const int pj1 = __shfl_sync(kFull, p, j1);
      if (lane == j0) p = pj1;
      j0 = j1;
    } while (j0 != 0);
  }
  if (in_range) out[static_cast<long long>(b) * nc + (lane - 1)] = p - 1;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int.
// cost: device f32 [batch, nr, nc], contiguous; out: device int32 [batch, nc].
// The caller guarantees 0 <= nr <= nc <= 31.
extern "C" int sedt_jv_lane(const float* cost, int* out, int batch, int nr,
                            int nc, void* stream) {
  if (batch <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = sizeof(float) * kWarpsPerBlock * nr * nc;
  jv_lane_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, out, batch, nr, nc);
  return static_cast<int>(cudaGetLastError());
}
