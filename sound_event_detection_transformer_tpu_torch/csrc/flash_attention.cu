// Attention forward by blocks with an online softmax: kernel K4.
//
// Replaces the TPU kernel `_flash_kernel` of
// sound_event_detection_transformer_tpu/ops/pallas/flash_attention.py
// (launched by `flash_attention_bh`, reached through `flash_attention`).  It
// computes the same function: out = softmax(q k^T / sqrt(D) + bias) v for
// q [B, H, Sq, D], k and v [B, H, Sk, D] in bf16 or f32, with an additive f32
// bias broadcastable to [B, H, Sq, Sk] (or none), the running maximum, sum,
// probabilities and accumulator in f32, and the output in the input type.
// The [Sq, Sk] scores never reach device memory.
//
// What is not carried over from the TPU kernel: D is not padded to 128, K and
// V are staged a tile at a time instead of whole, the bias is never
// broadcast in memory (the kernels take its pointer and four strides, 0
// where it broadcasts, and a null pointer for no bias), and the ragged last
// tile is masked here instead of padding the inputs.  q, k, v and the output
// are addressed through their batch, head and row strides, so the
// [B, S, H, D] layout the projections produce is read in place.
//
// Two variants live here, both written by hand; the wrapper chooses between
// them from the type, the head dim, the strides and the addresses, and
// counts each.
//
// ---- flash_mma_kernel: bf16 inputs on the tensor cores ---------------------
// What bounds it, at the long clip's encoder shape [8, 8, 752, 32] in bf16:
// q, k, v and the output are 12.3 MB, 3.7 us at 3.35 TB/s; the two products
// are 4.63 GFLOP, 4.7 us at the tensor cores' 989 TFLOP/s (7 us with the
// second product run twice, see below); the 36.2 M scores each need one
// exponential, about 9 us at the special-function units' 16 a clock an SM,
// and some eight f32 and integer instructions around it (scale and bias,
// maximum, exponent, sum, and the hi/lo split).  So the softmax arithmetic,
// not the matrix rate and not the bytes, is the floor, and `mma.sync` is
// enough: `wgmma` would raise a rate that is not the limit at D 32 (at D 128
// it would matter more), and is left alone.  The decoder's cross-attention
// shape (41 query rows against 752 keys) is bound by its 6.3 MB, 1.9 us, and
// by how many SMs its few query rows can keep busy.
//
// What the design does:
//  * Both products are `mma.sync.aligned.m16n8k16` with bf16 operands and f32
//    accumulation.  A warp owns one or two groups of 16 query rows; Q is read
//    once from device memory straight into the A-operand registers.
//    S = Q K^T is exact up to the order of the sums, and 1/sqrt(D) is applied
//    to the f32 scores, not to a rounded q; exp(s - m) is one FMA
//    (s log2 e - m log2 e) and one `ex2`.
//  * The accumulator layout of S is the A-operand layout of P V, so P never
//    leaves registers.  The probabilities stay at f32 accuracy, as the TPU
//    kernel keeps them: P = P_hi + P_lo with P_hi = bf16(P) and
//    P_lo = bf16(P - P_hi), two matrix instructions into one accumulator.
//  * K and V tiles of 64 keys are staged as bf16 with `cp.async` (16-byte
//    chunks) in a ring three deep (two at D 128), one `__syncthreads` a tile,
//    so tile t + 2 loads while tile t is scored.  Rows are padded by 16 bytes:
//    a row pitch of 2 D + 16 bytes puts the eight rows an `ldmatrix` reads
//    on eight different 16-byte bank groups for every D here.  K is read
//    with `ldmatrix`, V with `ldmatrix.trans`.  Copies past the last key are
//    zero-filled, so 0 * garbage cannot appear.
//  * One f32 term per key column is staged with the tile: the key-padding
//    bias (row stride 0), 0 where there is none, and -1e30 past the last key,
//    so that one straight-line pass (s * scale + term) serves the padding
//    bias, no bias and the ragged edge alike.  A full bias is read from
//    device memory in the accumulator's layout first (`float2` where the
//    strides allow).  Branches between the scores would double the
//    instructions of the pass, and the kernel is bound by those.
//  * 64 query rows a block (4 warps of one group) for short query sides, 128
//    beyond: 4 warps of two groups at D 32 and 64, so that every K and V
//    fragment read from shared memory serves 32 rows and the two groups'
//    dependent chains fill each other's waits; 8 warps of one group at D 128.
//    Warps whose rows all lie past Sq stage tiles and skip the arithmetic;
//    rows past Sq are computed on zeroed q and never stored.
//  * Short query sides split the keys: each (batch, head, query tile) gets
//    `n_splits` blocks that each walk `keys_per_split` keys (a multiple of
//    the tile) and write their unnormalised accumulator and (m, l) as f32 to
//    a scratch tensor; `flash_combine_kernel` merges them by the
//    online-softmax rule with the same finite arithmetic, so a range whose
//    keys are all masked weighs nothing beside a live one and an all-masked
//    clip still gives the uniform average.
//  * `ex2.approx.ftz` (relative error 2^-22) is used here and only here: the
//    bf16 output's tolerance is 1e-2.  The build has no --use_fast_math.
// What holds it now: one block alone takes 15 us for its 12 tiles, a chain of
// dependent steps (fragment loads, two levels of products, the maximum's
// shuffles, the exponentials, the split, two more levels of products) that
// only other warps can fill, and registers (96 a thread with one group, 168
// with two) keep 12 to 20 warps on an SM.
//
// ---- flash_kernel: f32 inputs on the f32 cores -----------------------------
// bf16 tensor cores cannot hold f32 q, k, v to 1e-5, so f32 inputs (and bf16
// inputs whose addresses or strides are not multiples of 16 bytes, and D 16)
// take this kernel: one block per (batch, head, 64 query rows), a thread per
// query row (for D 64 and 128, two and four neighbouring threads share a row
// and add their partial scores with shuffles), the scaled row, accumulator,
// maximum and sum in registers, K and V tiles staged as f32 in shared memory
// and read as broadcasts, 8 keys scored per softmax update.  It is bound by
// the f32 cores: 69 us at the encoder shape at 67 TFLOP/s.
//
// Masked keys: the additive mask is -1e9 and the running maximum starts at
// -1e30, both finite, so a row whose keys are all masked gives the plain
// path's uniform average, never a NaN.
//
// ---- flash_bwd_*_kernel: the tensor-core variant's backward -----------------
// Replaces no TPU kernel: the JAX package's gradient recomputes the plain
// attention through a custom_vjp (ops/pallas/flash_attention.py:139), and so
// did the port, writing and reading [B, H, Sq, Sk] f32 scores through some ten
// elementwise passes.  Here the probabilities are recomputed tile by tile from
// the row statistics the forward stores when asked (`stats`: the row maximum m
// and sum l, two f32 a row; one f32 m + log l cannot carry log l where m is the
// -1e9 mask of a clip whose keys are all padded, f32's step there being 64),
// and no [Sq, Sk] tensor reaches device memory.  What bounds it at AST's
// [64, 12, 1214, 64]: five products of 2 B H N^2 D, 0.732 ms at 989 TFLOP/s;
// q, k, v, o, dout read and dq, dk, dv written in bf16, 0.29 ms at 3.35 TB/s;
// the probabilities recomputed twice (once for dK and dV, once for dQ), 2.26 G
// exponentials, about 0.6 ms at 16 a clock an SM.  So the products bound it,
// with the softmax arithmetic close behind, and `mma.sync` is the first design.
// What the design does:
//  * flash_bwd_dot_kernel turns the forward's (m, l) into each row's constants
//    (-m log2 e, 1 / l, D = rowsum(dout * o)) in f32, padded past Sq with
//    values that zero a row's probabilities.  o there is the forward's f32
//    output to 16 bits: the bf16 output plus `o_lo`, the bf16 of what its
//    rounding lost, which the forward stores beside `stats`; with the bf16
//    output alone D misses sum(P dP) by a bf16 rounding, a row's dS no longer
//    sums to 0, and a key projection's bias (exact gradient 0) took
//    lr-sized Adam moves in AST's check steps.
//  * flash_bwd_dkdv_kernel: a block per (batch, head, 64 keys), a warp per 16
//    keys with their K and V rows in registers as A operands; it walks the
//    query tiles, staged as the forward stages K and V (cp.async ring,
//    ldmatrix, 16-byte row padding).  With the keys as the rows of every
//    product, S^T and dP^T land in the accumulator layout that is the A
//    operand of dV += P^T dout and dK += dS^T Q, so P and dS never leave
//    registers; each is rounded to bf16 once.  The forward's per-key term
//    (padding bias, 0, -1e30 past the last key) is one register per row here.
//  * flash_bwd_dq_kernel: the forward's layout (a warp per 16 query rows, Q
//    and dout in registers, K and V tiles staged), S, dP, dS, then dQ += dS K.
//    Seven products in all against five for an f32 atomicAdd of dQ from the
//    dK/dV kernel, but no scratch and the same bits from run to run.
//  * P is recomputed with the forward's own arithmetic (the same fmaf of the
//    score, scale and term, 2^(x log2 e - m log2 e) / l), so a row whose
//    keys are all masked gets the forward's uniform weights back.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kRows = 64;   // query rows per block of flash_kernel
constexpr int kChunk = 8;   // keys scored together between softmax updates
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long q[3], k[3], v[3], o[3];  // batch, head, row; the last dim is dense
  long long bias[4];                 // batch, head, query row, key; 0 = broadcast
};

__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ inline float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ inline void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ inline void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// ===================================================== f32-core variant

// TPR threads share one query row, D / TPR dimensions each.
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kRows * TPR)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ bias,
             T* __restrict__ o, int heads, int sq, int sk, int q_tiles,
             Strides st, float scale) {
  constexpr int DPT = D / TPR;                          // dims per thread
  constexpr int BK = (4096 / D) < 128 ? (4096 / D) : 128;  // keys per tile
  constexpr int kThreads = kRows * TPR;
  static_assert(DPT % 4 == 0 && BK % kChunk == 0, "tile shape");
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];
  __shared__ float bs[BK];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int row = (blockIdx.x % q_tiles) * kRows + tid / TPR;
  const bool has_row = row < sq;

  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    qr[d] = 0.0f;
    acc[d] = 0.0f;
  }
  if (has_row) {
    const T* src = q + b * st.q[0] + h * st.q[1] + row * st.q[2] + part * DPT;
#pragma unroll
    for (int d = 0; d < DPT; d += 4) {
      const float4 t = load4(src + d);
      qr[d] = t.x * scale;
      qr[d + 1] = t.y * scale;
      qr[d + 2] = t.z * scale;
      qr[d + 3] = t.w * scale;
    }
  }
  float m = kNegInf;
  float l = 0.0f;

  const T* kbase = k + b * st.k[0] + h * st.k[1];
  const T* vbase = v + b * st.v[0] + h * st.v[1];
  const float* bias_bh =
      bias != nullptr ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;
  // a bias that differs from row to row is read from device memory in the
  // loop; one shared by the rows (a key-padding mask) is staged with the tile
  const bool bias_per_row = bias != nullptr && st.bias[2] != 0;
  const float* bias_row =
      bias_per_row ? bias_bh + (has_row ? row : 0) * st.bias[2] : nullptr;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    const int len = min(BK, sk - k0);
    __syncthreads();  // the previous tile has been consumed
    for (int e = tid * 4; e < BK * D; e += kThreads * 4) {
      const int kr = e / D;
      const int kd = e % D;
      float4 kk = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 vv = kk;
      if (kr < len) {  // rows past the last key stay zero: 0 * p adds nothing
        kk = load4(kbase + (k0 + kr) * st.k[2] + kd);
        vv = load4(vbase + (k0 + kr) * st.v[2] + kd);
      }
      store4(ks + e, kk);
      store4(vs + e, vv);
    }
    for (int j = tid; j < BK; j += kThreads) {
      bs[j] = (bias != nullptr && !bias_per_row && j < len)
                  ? bias_bh[(k0 + j) * st.bias[3]]
                  : 0.0f;
    }
    __syncthreads();

    for (int kc = 0; kc < len; kc += kChunk) {
      float s[kChunk];
      float chunk_max = kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float* kr = ks + (kc + c) * D + part * DPT;
        float a = 0.0f;
#pragma unroll
        for (int d = 0; d < DPT; d += 4) {
          const float4 t = *reinterpret_cast<const float4*>(kr + d);
          a = fmaf(qr[d], t.x, a);
          a = fmaf(qr[d + 1], t.y, a);
          a = fmaf(qr[d + 2], t.z, a);
          a = fmaf(qr[d + 3], t.w, a);
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1) {
          a += __shfl_xor_sync(kFull, a, off);
        }
        const bool real = kc + c < len;
        float bj = bs[kc + c];
        if (bias_per_row && real) bj = bias_row[(k0 + kc + c) * st.bias[3]];
        s[c] = real ? a + bj : kNegInf;  // the ragged last tile masks itself
        chunk_max = fmaxf(chunk_max, s[c]);
      }
      const float m_new = fmaxf(m, chunk_max);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = expf(s[c] - m_new);
        l += p;
        const float* vr = vs + (kc + c) * D + part * DPT;
#pragma unroll
        for (int d = 0; d < DPT; d += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr + d);
          acc[d] = fmaf(p, t.x, acc[d]);
          acc[d + 1] = fmaf(p, t.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, t.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, t.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (has_row) {
    const float inv = 1.0f / fmaxf(l, 1.0e-30f);
    T* dst = o + b * st.o[0] + h * st.o[1] + row * st.o[2] + part * DPT;
#pragma unroll
    for (int d = 0; d < DPT; d += 4) {
      store4(dst + d, make_float4(acc[d] * inv, acc[d + 1] * inv,
                                  acc[d + 2] * inv, acc[d + 3] * inv));
    }
  }
}

template <typename T, int D, int TPR>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, int batch, int heads, int sq, int sk, const Strides& st,
           cudaStream_t stream) {
  const int q_tiles = (sq + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(batch) * heads * q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<T, D, TPR><<<static_cast<unsigned>(blocks), kRows * TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), heads, sq, sk,
      q_tiles, st, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_dim(int d, const void* q, const void* k, const void* v,
                   const float* bias, void* o, int batch, int heads, int sq,
                   int sk, const Strides& st, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16, 1>(q, k, v, bias, o, batch, heads, sq, sk, st, stream);
    case 32:
      return launch<T, 32, 1>(q, k, v, bias, o, batch, heads, sq, sk, st, stream);
    case 64:
      return launch<T, 64, 2>(q, k, v, bias, o, batch, heads, sq, sk, st, stream);
    case 128:
      return launch<T, 128, 4>(q, k, v, bias, o, batch, heads, sq, sk, st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ================================================== tensor-core variant

using bf16 = __nv_bfloat16;

constexpr int kBN = 64;   // keys per staged tile
constexpr int kPad = 8;   // bf16 of padding per staged row: 16 bytes
constexpr float kLog2e = 1.4426950408889634f;

__device__ inline unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; zero-fills when !valid (the
// source address must still be a legal one).
// (dst is a shared-memory address as smem_u32 gives it).
__device__ inline void cp_async16(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ inline void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i, register i receives it (row lane / 4, columns 2 (lane % 4), +1).
__device__ inline void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ inline void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 accumulation.
__device__ inline void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ inline unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x, the low half, is lo
  return *reinterpret_cast<const unsigned*>(&t);
}

// p0, p1 -> their bf16 roundings (hi) and the bf16 roundings of what the
// first rounding lost (lo): hi + lo carries 16 bits of each f32 probability.
__device__ inline void split_bf16(float p0, float p1, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(p0, p1);
  // a bf16 is the upper half of the f32 of the same value
  lo = pack_bf16(p0 - __uint_as_float(hi << 16), p1 - __uint_as_float(hi & 0xffff0000u));
}

// Keys per softmax update.  A staged tile is scored in two chunks: 32 keys
// keep the scores of two row groups in 32 registers, where 64 cost occupancy.
constexpr int kChunkKeys = 32;

template <int D>
__host__ __device__ constexpr int mma_stages() {
  return D <= 64 ? 3 : 2;
}

template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(mma_stages<D>()) *
         (2 * kBN * (D + kPad) * sizeof(bf16) + kBN * sizeof(float));
}

// One block per (batch, head, tile of BM = 16 MT NWARPS query rows, range of
// keys).  A warp owns MT groups of 16 rows, and every K and V fragment it
// reads from shared memory serves all of them: with MT 2 a score costs half
// the shared-memory traffic, and the two groups' chains of dependent matrix
// and softmax instructions fill each other's waits.
// partial: when n_splits > 1, f32 scratch of n_blocks * BM * D accumulators
// followed by n_blocks * BM pairs (m, l).
template <int D, int NWARPS, int MT>
__global__ void __launch_bounds__(NWARPS * 32)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ o, float* __restrict__ partial, float* __restrict__ stats,
                 bf16* __restrict__ o_lo, int heads, int sq, int sk, int q_tiles, int n_splits,
                 int keys_per_split, Strides st, float scale, int bias_vec2) {
  constexpr int BM = NWARPS * MT * 16;
  constexpr int STAGES = mma_stages<D>();
  constexpr int LD = D + kPad;  // staged row pitch in elements
  constexpr int T = NWARPS * 32;
  constexpr int CPR = D / 8;    // 16-byte chunks per row
  constexpr int CK = kChunkKeys;
  static_assert(D % 32 == 0, "head dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);            // [STAGES][kBN][LD]
  bf16* vs = ks + STAGES * kBN * LD;                        // [STAGES][kBN][LD]
  float* bs = reinterpret_cast<float*>(vs + STAGES * kBN * LD);  // [STAGES][kBN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row of the fragment (and g + 8)
  const int t = lane & 3;   // column pair of the fragment

  int idx = blockIdx.x;
  const int split = idx % n_splits;
  idx /= n_splits;
  const int qt = idx % q_tiles;
  const int bh = idx / q_tiles;
  const int b = bh / heads;
  const int h = bh % heads;

  const int k_begin = split * keys_per_split;
  const int k_end = min(sk, k_begin + keys_per_split);
  const int n_tiles = (k_end - k_begin + kBN - 1) / kBN;

  const bf16* kbase = k + b * st.k[0] + h * st.k[1];
  const bf16* vbase = v + b * st.v[0] + h * st.v[1];
  const float* bias_bh =
      bias != nullptr ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;
  const bool bias_staged = bias != nullptr && st.bias[2] == 0;
  const bool bias_full = bias != nullptr && st.bias[2] != 0;

  // a thread copies the same 16-byte chunk of rows ld_row, ld_row + RSTEP, ...
  // of every tile, so all but the key is worked out once
  constexpr int RSTEP = T / CPR;
  static_assert(T % CPR == 0 && kBN % RSTEP == 0 && T >= kBN, "tile copy");
  const int ld_row = tid / CPR;
  const int ld_col = (tid % CPR) * 8;
  const bf16* k_src = kbase + ld_col;
  const bf16* v_src = vbase + ld_col;
  const unsigned k_dst = smem_u32(ks + ld_row * LD + ld_col);
  const unsigned v_dst = smem_u32(vs + ld_row * LD + ld_col);
  const unsigned b_dst = smem_u32(bs + tid);
  auto load_tile = [&](int tile, int stage) {
    const int k0 = k_begin + tile * kBN;
    const unsigned stage_off = stage * kBN * LD * sizeof(bf16);
#pragma unroll
    for (int i = 0; i < kBN / RSTEP; ++i) {
      const int key = k0 + ld_row + i * RSTEP;
      const bool ok = key < sk;
      const long long row = ok ? key : 0;
      const unsigned off = stage_off + i * RSTEP * LD * sizeof(bf16);
      cp_async16(k_dst + off, k_src + row * st.k[2], ok);
      cp_async16(v_dst + off, v_src + row * st.v[2], ok);
    }
    // what is added to every score of a column: the key-padding bias, 0 where
    // there is none (or a full bias, read later), and -1e30 past the last key,
    // which is how the ragged last tile masks itself
    if (tid < kBN) {
      const bool ok = k0 + tid < sk;
      if (bias_staged && ok) {
        cp_async4(b_dst + stage * kBN * sizeof(float), bias_bh + (k0 + tid) * st.bias[3]);
      } else {
        bs[stage * kBN + tid] = ok ? 0.0f : kNegInf;  // read after the next barrier
      }
    }
  };

  // the ring's first STAGES - 1 tiles go out before anything else
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // group mt of this warp holds rows row_lo[mt] (fragment row g) and + 8
  const int warp_row = qt * BM + warp * (MT * 16);
  const bool warp_live = warp_row < sq;  // warp-uniform
  int row_lo[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) row_lo[mt] = warp_row + mt * 16 + g;

  // Q as the A operand of every key step: a0 (row g, cols 2t, 2t+1),
  // a1 (row g + 8), a2 (row g, cols 2t + 8, +9), a3 (row g + 8, same)
  unsigned qa[MT][D / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = row_lo[mt];
    const int r1 = r0 + 8;
    const bf16* q0 = q + b * st.q[0] + h * st.q[1] + static_cast<long long>(r0) * st.q[2];
    const bf16* q1 = q + b * st.q[0] + h * st.q[1] + static_cast<long long>(r1) * st.q[2];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = kk * 16 + 2 * t;
      qa[mt][kk][0] = r0 < sq ? *reinterpret_cast<const unsigned*>(q0 + col) : 0u;
      qa[mt][kk][1] = r1 < sq ? *reinterpret_cast<const unsigned*>(q1 + col) : 0u;
      qa[mt][kk][2] = r0 < sq ? *reinterpret_cast<const unsigned*>(q0 + col + 8) : 0u;
      qa[mt][kk][3] = r1 < sq ? *reinterpret_cast<const unsigned*>(q1 + col + 8) : 0u;
    }
  }

  float acc[MT][D / 8][4];
  float m_run[MT][2];  // running maxima of rows g and g + 8
  float l_run[MT][2];  // this thread's share of the running sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.0f;
    }
    m_run[mt][0] = m_run[mt][1] = kNegInf;
    l_run[mt][0] = l_run[mt][1] = 0.0f;
  }

  const float column_scale = bias_full ? 1.0f : scale;  // see the score pass

  // ldmatrix row addresses of this lane inside a tile
  const int lm_r = lane & 7;
  const int lm_m = lane >> 3;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile `tile` have landed
    __syncthreads();              // everyone's have, and tile - 1 has been consumed
    if (tile + STAGES - 1 < n_tiles) {
      load_tile(tile + STAGES - 1, (tile + STAGES - 1) % STAGES);
    }
    cp_async_commit();
    if (!warp_live) continue;

    const int stage = tile % STAGES;
    const float* bt = bs + stage * kBN;

    // the tile in chunks of CK keys: one softmax update a chunk
#pragma unroll 1
    for (int c0 = 0; c0 < kBN; c0 += CK) {
      const int k0 = k_begin + tile * kBN + c0;  // first key of the chunk
      if (k0 >= sk) break;                       // uniform: the tile's ragged end
      const bf16* kt = ks + (stage * kBN + c0) * LD;
      const bf16* vt = vs + (stage * kBN + c0) * LD;

      // S = Q K^T: blocks of 8 keys, four at a time so that the two products
      // into one block's accumulator lie apart; a K fragment serves every group
      float s[MT][CK / 8][4];
#pragma unroll
      for (int nb0 = 0; nb0 < CK / 8; nb0 += 4) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[mt][nb0 + i][0] = s[mt][nb0 + i][1] = 0.0f;
            s[mt][nb0 + i][2] = s[mt][nb0 + i][3] = 0.0f;
          }
        }
#pragma unroll
        for (int kc = 0; kc < D / 32; ++kc) {
          unsigned kb[4][4];  // dims kc * 32 + 8 j .. + 7 of keys (nb0 + i) * 8 .. + 7
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ldmatrix_x4(kb[i], kt + ((nb0 + i) * 8 + lm_r) * LD + kc * 32 + lm_m * 8);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              mma_bf16(s[mt][nb0 + i], qa[mt][2 * kc], kb[i][0], kb[i][1]);
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              mma_bf16(s[mt][nb0 + i], qa[mt][2 * kc + 1], kb[i][2], kb[i][3]);
            }
          }
        }
      }

      // scale, bias and the ragged edge: the staged column terms serve a
      // key-padding bias, no bias and the masking alike, so the usual pass is
      // straight-line; a full bias is read from device memory first
      if (bias_full) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* bias_r0 =
              bias_bh + static_cast<long long>(min(row_lo[mt], sq - 1)) * st.bias[2];
          const float* bias_r1 =
              bias_bh + static_cast<long long>(min(row_lo[mt] + 8, sq - 1)) * st.bias[2];
#pragma unroll
          for (int nb = 0; nb < CK / 8; ++nb) {
            const int col = k0 + nb * 8 + 2 * t;
            float b00 = 0.0f, b01 = 0.0f, b10 = 0.0f, b11 = 0.0f;
            if (bias_vec2 && col + 1 < sk) {
              const float2 r0 = __ldg(reinterpret_cast<const float2*>(bias_r0 + col));
              const float2 r1 = __ldg(reinterpret_cast<const float2*>(bias_r1 + col));
              b00 = r0.x;
              b01 = r0.y;
              b10 = r1.x;
              b11 = r1.y;
            } else {
              if (col < sk) {
                b00 = __ldg(bias_r0 + col * st.bias[3]);
                b10 = __ldg(bias_r1 + col * st.bias[3]);
              }
              if (col + 1 < sk) {
                b01 = __ldg(bias_r0 + (col + 1) * st.bias[3]);
                b11 = __ldg(bias_r1 + (col + 1) * st.bias[3]);
              }
            }
            float(&x)[4] = s[mt][nb];  // scaled here, so not again below
            x[0] = fmaf(x[0], scale, b00);
            x[1] = fmaf(x[1], scale, b01);
            x[2] = fmaf(x[2], scale, b10);
            x[3] = fmaf(x[3], scale, b11);
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < CK / 8; ++nb) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + c0 + nb * 8 + 2 * t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float(&x)[4] = s[mt][nb];
          x[0] = fmaf(x[0], column_scale, bb.x);
          x[1] = fmaf(x[1], column_scale, bb.y);
          x[2] = fmaf(x[2], column_scale, bb.x);
          x[3] = fmaf(x[3], column_scale, bb.y);
        }
      }

#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // the chunk's maxima, the rescale of what came before, the probabilities
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int nb = 0; nb < CK / 8; ++nb) {
          const float(&x)[4] = s[mt][nb];
          mx0 = fmaxf(mx0, fmaxf(x[0], x[1]));
          mx1 = fmaxf(mx1, fmaxf(x[2], x[3]));
        }
        // the four lanes of a quad hold one row between them
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
        const float mn0 = fmaxf(m_run[mt][0], mx0);
        const float mn1 = fmaxf(m_run[mt][1], mx1);
        const float alpha0 = ex2((m_run[mt][0] - mn0) * kLog2e);
        const float alpha1 = ex2((m_run[mt][1] - mn1) * kLog2e);
        m_run[mt][0] = mn0;
        m_run[mt][1] = mn1;
        const float ml0 = -mn0 * kLog2e;  // exp(s - m) = 2^(s log2 e - m log2 e): one FMA
        const float ml1 = -mn1 * kLog2e;
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int nb = 0; nb < CK / 8; ++nb) {
          float(&x)[4] = s[mt][nb];
          x[0] = ex2(fmaf(x[0], kLog2e, ml0));
          x[1] = ex2(fmaf(x[1], kLog2e, ml0));
          x[2] = ex2(fmaf(x[2], kLog2e, ml1));
          x[3] = ex2(fmaf(x[3], kLog2e, ml1));
          sum0 += x[0] + x[1];
          sum1 += x[2] + x[3];
        }
        l_run[mt][0] = fmaf(l_run[mt][0], alpha0, sum0);
        l_run[mt][1] = fmaf(l_run[mt][1], alpha1, sum1);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[mt][n][0] *= alpha0;
          acc[mt][n][1] *= alpha0;
          acc[mt][n][2] *= alpha1;
          acc[mt][n][3] *= alpha1;
        }
      }

      // acc += P V in steps of 16 keys; P's two halves and every group share
      // each V fragment, and an accumulator's two products lie apart
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        unsigned ph[MT][4], pl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1], ph[mt][0], pl[mt][0]);
          split_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3], ph[mt][1], pl[mt][1]);
          split_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1], ph[mt][2], pl[mt][2]);
          split_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3], ph[mt][3], pl[mt][3]);
        }
#pragma unroll
        for (int n0 = 0; n0 < D / 16; n0 += 2) {
          unsigned vb[2][4];  // keys kk*16 + 8 (j & 1) .., dims (n0 + i)*16 + 8 (j >> 1) ..
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ldmatrix_x4_trans(vb[i], vt + (kk * 16 + (lm_m & 1) * 8 + lm_r) * LD +
                                         (n0 + i) * 16 + (lm_m >> 1) * 8);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[mt][2 * (n0 + i)], ph[mt], vb[i][0], vb[i][1]);
              mma_bf16(acc[mt][2 * (n0 + i) + 1], ph[mt], vb[i][2], vb[i][3]);
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[mt][2 * (n0 + i)], pl[mt], vb[i][0], vb[i][1]);
              mma_bf16(acc[mt][2 * (n0 + i) + 1], pl[mt], vb[i][2], vb[i][3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l_run[mt][0];
    float l1 = l_run[mt][1];
    l0 += __shfl_xor_sync(kFull, l0, 1);
    l0 += __shfl_xor_sync(kFull, l0, 2);
    l1 += __shfl_xor_sync(kFull, l1, 1);
    l1 += __shfl_xor_sync(kFull, l1, 2);
    const int row0 = row_lo[mt];
    const int row1 = row0 + 8;

    if (n_splits == 1) {
      if (stats != nullptr && t == 0) {  // the rows' (m, l) for the backward
        float* st0 = stats + (static_cast<long long>(bh) * sq + row0) * 2;
        if (row0 < sq) *reinterpret_cast<float2*>(st0) = make_float2(m_run[mt][0], l0);
        if (row1 < sq) *reinterpret_cast<float2*>(st0 + 16) = make_float2(m_run[mt][1], l1);
      }
      const float inv0 = 1.0f / fmaxf(l0, 1.0e-30f);
      const float inv1 = 1.0f / fmaxf(l1, 1.0e-30f);
      const long long off0 = b * st.o[0] + h * st.o[1] + static_cast<long long>(row0) * st.o[2];
      const long long off1 = off0 + 8 * st.o[2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + 2 * t;
        unsigned hi, lo;
        if (row0 < sq) {
          split_bf16(acc[mt][n][0] * inv0, acc[mt][n][1] * inv0, hi, lo);
          *reinterpret_cast<unsigned*>(o + off0 + col) = hi;
          if (o_lo != nullptr) *reinterpret_cast<unsigned*>(o_lo + off0 + col) = lo;
        }
        if (row1 < sq) {
          split_bf16(acc[mt][n][2] * inv1, acc[mt][n][3] * inv1, hi, lo);
          *reinterpret_cast<unsigned*>(o + off1 + col) = hi;
          if (o_lo != nullptr) *reinterpret_cast<unsigned*>(o_lo + off1 + col) = lo;
        }
      }
      continue;
    }

    const long long n_blocks = static_cast<long long>(gridDim.x);
    const long long slot = static_cast<long long>(blockIdx.x) * BM + (row0 - qt * BM);
    float* pa0 = partial + slot * D;
    float* pa1 = partial + (slot + 8) * D;
    float* ml = partial + n_blocks * BM * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (row0 < sq) {
        *reinterpret_cast<float2*>(pa0 + col) = make_float2(acc[mt][n][0], acc[mt][n][1]);
      }
      if (row1 < sq) {
        *reinterpret_cast<float2*>(pa1 + col) = make_float2(acc[mt][n][2], acc[mt][n][3]);
      }
    }
    if (t == 0) {
      if (row0 < sq) *reinterpret_cast<float2*>(ml + slot * 2) = make_float2(m_run[mt][0], l0);
      if (row1 < sq) {
        *reinterpret_cast<float2*>(ml + (slot + 8) * 2) = make_float2(m_run[mt][1], l1);
      }
    }
  }
}

// Merges the n_splits partial (m, l, acc) of every query row by the
// online-softmax rule: m = max m_i, w_i = exp(m_i - m), out = sum w_i acc_i /
// sum w_i l_i.  One thread per (batch, head, row, 4 dims).
template <int D>
__global__ void flash_combine_kernel(const float* __restrict__ partial,
                                     bf16* __restrict__ o, float* __restrict__ stats,
                                     bf16* __restrict__ o_lo, int heads, int sq, int q_tiles,
                                     int n_splits, int bm, long long n_blocks,
                                     Strides st, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d4 = static_cast<int>(idx % (D / 4));
  const int row = static_cast<int>((idx / (D / 4)) % sq);
  const long long bh = idx / (D / 4) / sq;
  const int b = static_cast<int>(bh / heads);
  const int h = static_cast<int>(bh % heads);
  const long long first = (bh * q_tiles + row / bm) * n_splits;  // block of split 0
  const int r = row % bm;
  const float* ml = partial + n_blocks * bm * D;

  float m = kNegInf;
  for (int i = 0; i < n_splits; ++i) m = fmaxf(m, ml[((first + i) * bm + r) * 2]);
  float l = 0.0f;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = 0; i < n_splits; ++i) {
    const long long slot = (first + i) * bm + r;
    const float2 mli = *reinterpret_cast<const float2*>(ml + slot * 2);
    const float w = ex2((mli.x - m) * kLog2e);
    const float4 a = *reinterpret_cast<const float4*>(partial + slot * D + d4 * 4);
    l = fmaf(w, mli.y, l);
    acc.x = fmaf(w, a.x, acc.x);
    acc.y = fmaf(w, a.y, acc.y);
    acc.z = fmaf(w, a.z, acc.z);
    acc.w = fmaf(w, a.w, acc.w);
  }
  if (stats != nullptr && d4 == 0) {
    *reinterpret_cast<float2*>(stats + (bh * sq + row) * 2) = make_float2(m, l);
  }
  const float inv = 1.0f / fmaxf(l, 1.0e-30f);
  const float4 x = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  const long long off = b * st.o[0] + h * st.o[1] + static_cast<long long>(row) * st.o[2] + d4 * 4;
  store4(o + off, x);
  if (o_lo != nullptr) {  // what the bf16 rounding of x lost
    const float4 r = make_float4(x.x - __bfloat162float(__float2bfloat16_rn(x.x)),
                                 x.y - __bfloat162float(__float2bfloat16_rn(x.y)),
                                 x.z - __bfloat162float(__float2bfloat16_rn(x.z)),
                                 x.w - __bfloat162float(__float2bfloat16_rn(x.w)));
    store4(o_lo + off, r);
  }
}

template <int D, int NWARPS, int MT>
int launch_mma(const void* q, const void* k, const void* v, const float* bias, void* o,
               float* partial, float* stats, void* o_lo, int batch, int heads, int sq, int sk,
               int n_splits,
               int keys_per_split, int bias_vec2, const Strides& st, cudaStream_t stream) {
  constexpr int BM = NWARPS * MT * 16;
  const int q_tiles = (sq + BM - 1) / BM;
  const long long blocks = static_cast<long long>(batch) * heads * q_tiles * n_splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_mma_kernel<D, NWARPS, MT>
      <<<static_cast<unsigned>(blocks), NWARPS * 32, mma_smem_bytes<D>(), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), bias, static_cast<bf16*>(o), partial, stats,
          static_cast<bf16*>(o_lo), heads, sq, sk, q_tiles, n_splits, keys_per_split, st, scale,
          bias_vec2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * heads * sq * (D / 4);
  const int threads = 256;
  flash_combine_kernel<D><<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                            stream>>>(partial, static_cast<bf16*>(o), stats,
                                      static_cast<bf16*>(o_lo), heads, sq, q_tiles, n_splits,
                                      BM, blocks, st, total);
  return static_cast<int>(cudaGetLastError());
}

// ===================================================== backward, tensor cores

// Element strides of the backward's tensors: q, k, v, the forward's output o,
// its gradient dout, and the gradients dq, dk, dv (batch, head, row each; the
// last dim is dense), then the bias (4, 0 = broadcast).
struct BwdStrides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
  long long bias[4];
};

constexpr int kBQ = 64;       // query rows per staged tile of flash_bwd_dkdv_kernel
constexpr int kRowPad = 128;  // the row constants are padded to a multiple of this
constexpr int kDkdvWarps = 4;  // warps of 16 keys a block of flash_bwd_dkdv_kernel
constexpr int kDqWarps = 4;    // warps of 16 query rows a block of flash_bwd_dq_kernel

// queries a warp scores at once in flash_bwd_dkdv_kernel: 16 at D 128 keep
// K, V, dK and dV (192 registers there) beside the scores
template <int D>
__host__ __device__ constexpr int bwd_chunk() {
  return D <= 64 ? 32 : 16;
}

template <int D>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  return static_cast<size_t>(mma_stages<D>()) *
         (2 * kBQ * (D + kPad) * sizeof(bf16) + kBQ * sizeof(float4));
}

// One group of D / 8 threads per row of [batch * heads, sq_pad]: the row's
// constants for recomputing its probabilities, (ml, rl, Di) with
// ml = -m log2 e and rl = 1 / l from the forward's (m, l) (the forward's own
// arithmetic: p = 2^(s log2 e + ml) rl), and Di = sum over d of dout * o in
// f32 from the forward's o + o_lo.  Di must equal the sum over
// keys of P dP to well below a bf16 rounding: every dS row then sums to 0 as
// softmax's does, and a key projection's bias, whose exact gradient is 0,
// gets round-off only (from o alone its gradient is o's rounding, which
// Adam's first steps, nearly signs, turn into lr-sized moves).  Rows past sq
// get (-1e30, 0, 0), so that their probabilities and score gradients come
// out 0 whatever their scores.
template <int D>
__global__ void flash_bwd_dot_kernel(const bf16* __restrict__ o, const bf16* __restrict__ o_lo,
                                     const bf16* __restrict__ dout,
                                     const float* __restrict__ stats, float4* __restrict__ rowc,
                                     int heads, int sq, int sq_pad, long long rows,
                                     BwdStrides st) {
  constexpr int CPR = D / 8;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long r = idx / CPR;  // whole row groups per block: the early return is theirs
  if (r >= rows) return;
  const int part = static_cast<int>(idx % CPR);
  const int row = static_cast<int>(r % sq_pad);
  const long long bh = r / sq_pad;
  const int b = static_cast<int>(bh / heads);
  const int h = static_cast<int>(bh % heads);
  float dot = 0.0f;
  if (row < sq) {
    const long long off = b * st.o[0] + h * st.o[1] + static_cast<long long>(row) * st.o[2] +
                          part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 r = *reinterpret_cast<const uint4*>(o_lo + off);
    const uint4 g = *reinterpret_cast<const uint4*>(
        dout + b * st.dout[0] + h * st.dout[1] + static_cast<long long>(row) * st.dout[2] +
        part * 8);
    const unsigned av[4] = {a.x, a.y, a.z, a.w};
    const unsigned rv[4] = {r.x, r.y, r.z, r.w};
    const unsigned gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]));
      const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv[i]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv[i]));
      dot = fmaf(x.x + xr.x, y.x, dot);
      dot = fmaf(x.y + xr.y, y.y, dot);
    }
  }
  const unsigned group = ((1u << CPR) - 1u) << ((threadIdx.x & 31) / CPR * CPR);
#pragma unroll
  for (int off = CPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(group, dot, off, CPR);
  if (part != 0) return;
  float4 c = make_float4(kNegInf, 0.0f, 0.0f, 0.0f);
  if (row < sq) {
    const float2 ml = *reinterpret_cast<const float2*>(stats + (bh * sq + row) * 2);
    c = make_float4(-ml.x * kLog2e, 1.0f / fmaxf(ml.y, 1.0e-30f), dot, 0.0f);
  }
  rowc[r] = c;
}

// dK and dV: one block per (batch, head, tile of 16 NWARPS keys); a warp owns
// 16 keys and holds their K and V rows as A operands in registers, and the
// block walks every query tile, staged (Q, dout and the row constants) in the
// forward's cp.async ring.  Per chunk of CQ queries a warp computes, with its
// keys as the rows of every product:
//   S^T = K Q^T, dP^T = V dout^T                     (two products)
//   P^T = 2^((S^T scale + bias) log2 e + ml) rl       (the forward's arithmetic)
//   dS^T = P^T o (dP^T - D)
//   dV += P^T dout, dK += dS^T Q                      (two products)
// with P^T and dS^T rounded to bf16 once, as A operands straight from the
// accumulators.  dK is scaled once at the end.
template <int D, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      const bf16* __restrict__ dout, const float4* __restrict__ rowc,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq, int sk,
                      int sq_pad, int k_tiles, BwdStrides st, float scale) {
  constexpr int STAGES = mma_stages<D>();
  constexpr int LD = D + kPad;
  constexpr int T = NWARPS * 32;
  constexpr int CPR = D / 8;
  constexpr int CQ = bwd_chunk<D>();
  constexpr int NB = CQ / 8;  // blocks of 8 queries a chunk
  static_assert(D % 32 == 0 && CQ % 16 == 0 && kBQ % CQ == 0, "shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                    // [STAGES][kBQ][LD]
  bf16* os = qs + STAGES * kBQ * LD;                                // [STAGES][kBQ][LD]
  float4* cs = reinterpret_cast<float4*>(os + STAGES * kBQ * LD);  // [STAGES][kBQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kt = blockIdx.x % k_tiles;
  const int bh = blockIdx.x / k_tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int n_q_tiles = (sq + kBQ - 1) / kBQ;

  constexpr int RSTEP = T / CPR;
  static_assert(T % CPR == 0 && kBQ % RSTEP == 0 && T >= kBQ, "tile copy");
  const int ld_row = tid / CPR;
  const int ld_col = (tid % CPR) * 8;
  const bf16* q_src = q + b * st.q[0] + h * st.q[1] + ld_col;
  const bf16* o_src = dout + b * st.dout[0] + h * st.dout[1] + ld_col;
  const float4* c_src = rowc + static_cast<long long>(bh) * sq_pad + tid;
  const unsigned q_dst = smem_u32(qs + ld_row * LD + ld_col);
  const unsigned o_dst = smem_u32(os + ld_row * LD + ld_col);
  const unsigned c_dst = smem_u32(cs + tid);
  auto load_tile = [&](int tile, int stage) {
    const int q0 = tile * kBQ;
    const unsigned stage_off = stage * kBQ * LD * sizeof(bf16);
#pragma unroll
    for (int i = 0; i < kBQ / RSTEP; ++i) {
      const int row = q0 + ld_row + i * RSTEP;
      const bool ok = row < sq;
      const long long r = ok ? row : 0;
      const unsigned off = stage_off + i * RSTEP * LD * sizeof(bf16);
      cp_async16(q_dst + off, q_src + r * st.q[2], ok);
      cp_async16(o_dst + off, o_src + r * st.dout[2], ok);
    }
    // the row constants are padded past sq, so every row of a tile has them
    if (tid < kBQ) cp_async16(c_dst + stage * kBQ * sizeof(float4), c_src + q0, true);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_q_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // this warp's keys: r0 (fragment row g) and r1 = r0 + 8
  const int key_lo = kt * (NWARPS * 16) + warp * 16;
  const bool warp_live = key_lo < sk;  // warp-uniform
  const int r0 = key_lo + g;
  const int r1 = r0 + 8;
  unsigned ka[D / 16][4], va[D / 16][4];
  {
    const bf16* k0 = k + b * st.k[0] + h * st.k[1] + static_cast<long long>(r0) * st.k[2];
    const bf16* k1 = k + b * st.k[0] + h * st.k[1] + static_cast<long long>(r1) * st.k[2];
    const bf16* v0 = v + b * st.v[0] + h * st.v[1] + static_cast<long long>(r0) * st.v[2];
    const bf16* v1 = v + b * st.v[0] + h * st.v[1] + static_cast<long long>(r1) * st.v[2];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = kk * 16 + 2 * t;
      ka[kk][0] = r0 < sk ? *reinterpret_cast<const unsigned*>(k0 + col) : 0u;
      ka[kk][1] = r1 < sk ? *reinterpret_cast<const unsigned*>(k1 + col) : 0u;
      ka[kk][2] = r0 < sk ? *reinterpret_cast<const unsigned*>(k0 + col + 8) : 0u;
      ka[kk][3] = r1 < sk ? *reinterpret_cast<const unsigned*>(k1 + col + 8) : 0u;
      va[kk][0] = r0 < sk ? *reinterpret_cast<const unsigned*>(v0 + col) : 0u;
      va[kk][1] = r1 < sk ? *reinterpret_cast<const unsigned*>(v1 + col) : 0u;
      va[kk][2] = r0 < sk ? *reinterpret_cast<const unsigned*>(v0 + col + 8) : 0u;
      va[kk][3] = r1 < sk ? *reinterpret_cast<const unsigned*>(v1 + col + 8) : 0u;
    }
  }
  // the forward's per-key term, here one per row: the key-padding bias, 0, or
  // -1e30 past the last key; a full bias is read per score below
  const float* bias_bh = bias != nullptr ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;
  const bool bias_full = bias != nullptr && st.bias[2] != 0;
  float term0 = r0 < sk ? 0.0f : kNegInf;
  float term1 = r1 < sk ? 0.0f : kNegInf;
  if (bias != nullptr && !bias_full) {
    if (r0 < sk) term0 = bias_bh[r0 * st.bias[3]];
    if (r1 < sk) term1 = bias_bh[r1 * st.bias[3]];
  }
  const float* bias_k0 = bias_full ? bias_bh + min(r0, sk - 1) * st.bias[3] : nullptr;
  const float* bias_k1 = bias_full ? bias_bh + min(r1, sk - 1) * st.bias[3] : nullptr;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[n][j] = dv_acc[n][j] = 0.0f;
  }
  const int lm_r = lane & 7;
  const int lm_m = lane >> 3;

  for (int tile = 0; tile < n_q_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (tile + STAGES - 1 < n_q_tiles) {
      load_tile(tile + STAGES - 1, (tile + STAGES - 1) % STAGES);
    }
    cp_async_commit();
    if (!warp_live) continue;
    const int stage = tile % STAGES;

#pragma unroll 1
    for (int c0 = 0; c0 < kBQ; c0 += CQ) {
      const int q_first = tile * kBQ + c0;
      if (q_first >= sq) break;  // uniform: the last tile's ragged end
      const bf16* qt = qs + (stage * kBQ + c0) * LD;
      const bf16* ot = os + (stage * kBQ + c0) * LD;
      const float4* ct = cs + stage * kBQ + c0;

      // S^T = K Q^T and dP^T = V dout^T; a fragment of Q or dout serves 16 keys
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nb][j] = dp[nb][j] = 0.0f;
      }
#pragma unroll
      for (int kc = 0; kc < D / 32; ++kc) {
        unsigned fb[NB][4];  // dims kc * 32 + 8 j .. + 7 of queries nb * 8 .. + 7
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          ldmatrix_x4(fb[nb], qt + (nb * 8 + lm_r) * LD + kc * 32 + lm_m * 8);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_bf16(s[nb], ka[2 * kc], fb[nb][0], fb[nb][1]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_bf16(s[nb], ka[2 * kc + 1], fb[nb][2], fb[nb][3]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          ldmatrix_x4(fb[nb], ot + (nb * 8 + lm_r) * LD + kc * 32 + lm_m * 8);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_bf16(dp[nb], va[2 * kc], fb[nb][0], fb[nb][1]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_bf16(dp[nb], va[2 * kc + 1], fb[nb][2], fb[nb][3]);
      }

      // the probabilities and the score gradients; element j of a block is
      // key r0 (j < 2) or r1, query column 2 t + (j & 1)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float4 ca = ct[nb * 8 + 2 * t];
        const float4 cb = ct[nb * 8 + 2 * t + 1];
        float(&x)[4] = s[nb];
        if (bias_full) {
          const long long qa = min(q_first + nb * 8 + 2 * t, sq - 1);
          const long long qb = min(q_first + nb * 8 + 2 * t + 1, sq - 1);
          x[0] = fmaf(x[0], scale, __ldg(bias_k0 + qa * st.bias[2])) + term0;
          x[1] = fmaf(x[1], scale, __ldg(bias_k0 + qb * st.bias[2])) + term0;
          x[2] = fmaf(x[2], scale, __ldg(bias_k1 + qa * st.bias[2])) + term1;
          x[3] = fmaf(x[3], scale, __ldg(bias_k1 + qb * st.bias[2])) + term1;
        } else {
          x[0] = fmaf(x[0], scale, term0);
          x[1] = fmaf(x[1], scale, term0);
          x[2] = fmaf(x[2], scale, term1);
          x[3] = fmaf(x[3], scale, term1);
        }
        x[0] = ex2(fmaf(x[0], kLog2e, ca.x)) * ca.y;
        x[1] = ex2(fmaf(x[1], kLog2e, cb.x)) * cb.y;
        x[2] = ex2(fmaf(x[2], kLog2e, ca.x)) * ca.y;
        x[3] = ex2(fmaf(x[3], kLog2e, cb.x)) * cb.y;
        float(&y)[4] = dp[nb];
        y[0] = x[0] * (y[0] - ca.z);
        y[1] = x[1] * (y[1] - cb.z);
        y[2] = x[2] * (y[2] - ca.z);
        y[3] = x[3] * (y[3] - cb.z);
      }

      // dV += P^T dout and dK += dS^T Q in steps of 16 queries
#pragma unroll
      for (int kk = 0; kk < CQ / 16; ++kk) {
        unsigned pa[4], da[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int n0 = 0; n0 < D / 16; n0 += 2) {
          unsigned fb[2][4];  // queries kk*16 + 8 (j & 1) .., dims (n0 + i)*16 + 8 (j >> 1) ..
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ldmatrix_x4_trans(fb[i], ot + (kk * 16 + (lm_m & 1) * 8 + lm_r) * LD +
                                         (n0 + i) * 16 + (lm_m >> 1) * 8);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(dv_acc[2 * (n0 + i)], pa, fb[i][0], fb[i][1]);
            mma_bf16(dv_acc[2 * (n0 + i) + 1], pa, fb[i][2], fb[i][3]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ldmatrix_x4_trans(fb[i], qt + (kk * 16 + (lm_m & 1) * 8 + lm_r) * LD +
                                         (n0 + i) * 16 + (lm_m >> 1) * 8);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(dk_acc[2 * (n0 + i)], da, fb[i][0], fb[i][1]);
            mma_bf16(dk_acc[2 * (n0 + i) + 1], da, fb[i][2], fb[i][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;

  bf16* dk0 = dk + b * st.dk[0] + h * st.dk[1] + static_cast<long long>(r0) * st.dk[2];
  bf16* dk1 = dk + b * st.dk[0] + h * st.dk[1] + static_cast<long long>(r1) * st.dk[2];
  bf16* dv0 = dv + b * st.dv[0] + h * st.dv[1] + static_cast<long long>(r0) * st.dv[2];
  bf16* dv1 = dv + b * st.dv[0] + h * st.dv[1] + static_cast<long long>(r1) * st.dv[2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < sk) {
      *reinterpret_cast<unsigned*>(dk0 + col) =
          pack_bf16(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      *reinterpret_cast<unsigned*>(dv0 + col) = pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    }
    if (r1 < sk) {
      *reinterpret_cast<unsigned*>(dk1 + col) =
          pack_bf16(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
      *reinterpret_cast<unsigned*>(dv1 + col) = pack_bf16(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// dQ: one block per (batch, head, tile of 16 NWARPS query rows), laid out as
// the forward is: a warp holds its rows of Q and dout as A operands and their
// row constants in registers, and the block walks every key tile, staged (K,
// V and the per-key terms) in the forward's ring.  Per chunk of 32 keys:
//   S = Q K^T, dP = dout V^T, P = 2^((S scale + bias) log2 e + ml) rl,
//   dS = P o (dP - D), dQ += dS K
// dQ is scaled once at the end.  No atomics: every dQ row is one warp's, so
// the result is the same from run to run.
template <int D, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const bf16* __restrict__ dout, const float4* __restrict__ rowc,
                    bf16* __restrict__ dq, int heads, int sq, int sk, int sq_pad, int q_tiles,
                    BwdStrides st, float scale, int bias_vec2) {
  constexpr int BM = NWARPS * 16;
  constexpr int STAGES = mma_stages<D>();
  constexpr int LD = D + kPad;
  constexpr int T = NWARPS * 32;
  constexpr int CPR = D / 8;
  constexpr int CK = kChunkKeys;
  static_assert(D % 32 == 0 && kRowPad % BM == 0, "shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);                  // [STAGES][kBN][LD]
  bf16* vs = ks + STAGES * kBN * LD;                              // [STAGES][kBN][LD]
  float* bs = reinterpret_cast<float*>(vs + STAGES * kBN * LD);  // [STAGES][kBN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qt = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int n_tiles = (sk + kBN - 1) / kBN;

  const bf16* kbase = k + b * st.k[0] + h * st.k[1];
  const bf16* vbase = v + b * st.v[0] + h * st.v[1];
  const float* bias_bh = bias != nullptr ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;
  const bool bias_staged = bias != nullptr && st.bias[2] == 0;
  const bool bias_full = bias != nullptr && st.bias[2] != 0;

  constexpr int RSTEP = T / CPR;
  static_assert(T % CPR == 0 && kBN % RSTEP == 0 && T >= kBN, "tile copy");
  const int ld_row = tid / CPR;
  const int ld_col = (tid % CPR) * 8;
  const bf16* k_src = kbase + ld_col;
  const bf16* v_src = vbase + ld_col;
  const unsigned k_dst = smem_u32(ks + ld_row * LD + ld_col);
  const unsigned v_dst = smem_u32(vs + ld_row * LD + ld_col);
  const unsigned b_dst = smem_u32(bs + tid);
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kBN;
    const unsigned stage_off = stage * kBN * LD * sizeof(bf16);
#pragma unroll
    for (int i = 0; i < kBN / RSTEP; ++i) {
      const int key = k0 + ld_row + i * RSTEP;
      const bool ok = key < sk;
      const long long row = ok ? key : 0;
      const unsigned off = stage_off + i * RSTEP * LD * sizeof(bf16);
      cp_async16(k_dst + off, k_src + row * st.k[2], ok);
      cp_async16(v_dst + off, v_src + row * st.v[2], ok);
    }
    if (tid < kBN) {  // the forward's per-key term
      const bool ok = k0 + tid < sk;
      if (bias_staged && ok) {
        cp_async4(b_dst + stage * kBN * sizeof(float), bias_bh + (k0 + tid) * st.bias[3]);
      } else {
        bs[stage * kBN + tid] = ok ? 0.0f : kNegInf;  // read after the next barrier
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  const int warp_row = qt * BM + warp * 16;
  const bool warp_live = warp_row < sq;  // warp-uniform
  const int r0 = warp_row + g;
  const int r1 = r0 + 8;
  unsigned qa[D / 16][4], oa[D / 16][4];
  {
    const bf16* q0 = q + b * st.q[0] + h * st.q[1] + static_cast<long long>(r0) * st.q[2];
    const bf16* q1 = q + b * st.q[0] + h * st.q[1] + static_cast<long long>(r1) * st.q[2];
    const bf16* o0 =
        dout + b * st.dout[0] + h * st.dout[1] + static_cast<long long>(r0) * st.dout[2];
    const bf16* o1 =
        dout + b * st.dout[0] + h * st.dout[1] + static_cast<long long>(r1) * st.dout[2];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = kk * 16 + 2 * t;
      qa[kk][0] = r0 < sq ? *reinterpret_cast<const unsigned*>(q0 + col) : 0u;
      qa[kk][1] = r1 < sq ? *reinterpret_cast<const unsigned*>(q1 + col) : 0u;
      qa[kk][2] = r0 < sq ? *reinterpret_cast<const unsigned*>(q0 + col + 8) : 0u;
      qa[kk][3] = r1 < sq ? *reinterpret_cast<const unsigned*>(q1 + col + 8) : 0u;
      oa[kk][0] = r0 < sq ? *reinterpret_cast<const unsigned*>(o0 + col) : 0u;
      oa[kk][1] = r1 < sq ? *reinterpret_cast<const unsigned*>(o1 + col) : 0u;
      oa[kk][2] = r0 < sq ? *reinterpret_cast<const unsigned*>(o0 + col + 8) : 0u;
      oa[kk][3] = r1 < sq ? *reinterpret_cast<const unsigned*>(o1 + col + 8) : 0u;
    }
  }
  // rows past sq read their padded constants, which zero their probabilities
  const float4 c0 = rowc[static_cast<long long>(bh) * sq_pad + r0];
  const float4 c1 = rowc[static_cast<long long>(bh) * sq_pad + r1];

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.0f;
  }
  const float column_scale = bias_full ? 1.0f : scale;  // as in the forward
  const int lm_r = lane & 7;
  const int lm_m = lane >> 3;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (tile + STAGES - 1 < n_tiles) {
      load_tile(tile + STAGES - 1, (tile + STAGES - 1) % STAGES);
    }
    cp_async_commit();
    if (!warp_live) continue;
    const int stage = tile % STAGES;
    const float* bt = bs + stage * kBN;

#pragma unroll 1
    for (int cc = 0; cc < kBN; cc += CK) {
      const int k0 = tile * kBN + cc;
      if (k0 >= sk) break;  // uniform: the tile's ragged end
      const bf16* kt = ks + (stage * kBN + cc) * LD;
      const bf16* vt = vs + (stage * kBN + cc) * LD;

      // S = Q K^T and dP = dout V^T; a K or V fragment serves the warp's 16 rows
      float s[CK / 8][4], dp[CK / 8][4];
#pragma unroll
      for (int nb = 0; nb < CK / 8; ++nb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nb][j] = dp[nb][j] = 0.0f;
      }
#pragma unroll
      for (int kc = 0; kc < D / 32; ++kc) {
        unsigned fb[CK / 8][4];  // dims kc * 32 + 8 j .. + 7 of keys nb * 8 .. + 7
#pragma unroll
        for (int nb = 0; nb < CK / 8; ++nb) {
          ldmatrix_x4(fb[nb], kt + (nb * 8 + lm_r) * LD + kc * 32 + lm_m * 8);
        }
#pragma unroll
        for (int nb = 0; nb < CK / 8; ++nb) mma_bf16(s[nb], qa[2 * kc], fb[nb][0], fb[nb][1]);
#pragma unroll
        for (int nb = 0; nb < CK / 8; ++nb) {
          mma_bf16(s[nb], qa[2 * kc + 1], fb[nb][2], fb[nb][3]);
        }
#pragma unroll
        for (int nb = 0; nb < CK / 8; ++nb) {
          ldmatrix_x4(fb[nb], vt + (nb * 8 + lm_r) * LD + kc * 32 + lm_m * 8);
        }
#pragma unroll
        for (int nb = 0; nb < CK / 8; ++nb) mma_bf16(dp[nb], oa[2 * kc], fb[nb][0], fb[nb][1]);
#pragma unroll
        for (int nb = 0; nb < CK / 8; ++nb) {
          mma_bf16(dp[nb], oa[2 * kc + 1], fb[nb][2], fb[nb][3]);
        }
      }

      // scale, bias and the ragged edge as in the forward, then P and dS
      if (bias_full) {
        const float* bias_r0 = bias_bh + static_cast<long long>(min(r0, sq - 1)) * st.bias[2];
        const float* bias_r1 = bias_bh + static_cast<long long>(min(r1, sq - 1)) * st.bias[2];
#pragma unroll
        for (int nb = 0; nb < CK / 8; ++nb) {
          const int col = k0 + nb * 8 + 2 * t;
          float b00 = 0.0f, b01 = 0.0f, b10 = 0.0f, b11 = 0.0f;
          if (bias_vec2 && col + 1 < sk) {
            const float2 x0 = __ldg(reinterpret_cast<const float2*>(bias_r0 + col));
            const float2 x1 = __ldg(reinterpret_cast<const float2*>(bias_r1 + col));
            b00 = x0.x;
            b01 = x0.y;
            b10 = x1.x;
            b11 = x1.y;
          } else {
            if (col < sk) {
              b00 = __ldg(bias_r0 + col * st.bias[3]);
              b10 = __ldg(bias_r1 + col * st.bias[3]);
            }
            if (col + 1 < sk) {
              b01 = __ldg(bias_r0 + (col + 1) * st.bias[3]);
              b11 = __ldg(bias_r1 + (col + 1) * st.bias[3]);
            }
          }
          float(&x)[4] = s[nb];
          x[0] = fmaf(x[0], scale, b00);
          x[1] = fmaf(x[1], scale, b01);
          x[2] = fmaf(x[2], scale, b10);
          x[3] = fmaf(x[3], scale, b11);
        }
      }
#pragma unroll
      for (int nb = 0; nb < CK / 8; ++nb) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + cc + nb * 8 + 2 * t);
        float(&x)[4] = s[nb];
        x[0] = ex2(fmaf(fmaf(x[0], column_scale, bb.x), kLog2e, c0.x)) * c0.y;
        x[1] = ex2(fmaf(fmaf(x[1], column_scale, bb.y), kLog2e, c0.x)) * c0.y;
        x[2] = ex2(fmaf(fmaf(x[2], column_scale, bb.x), kLog2e, c1.x)) * c1.y;
        x[3] = ex2(fmaf(fmaf(x[3], column_scale, bb.y), kLog2e, c1.x)) * c1.y;
        float(&y)[4] = dp[nb];
        y[0] = x[0] * (y[0] - c0.z);
        y[1] = x[1] * (y[1] - c0.z);
        y[2] = x[2] * (y[2] - c1.z);
        y[3] = x[3] * (y[3] - c1.z);
      }

      // dQ += dS K in steps of 16 keys
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        unsigned da[4];
        da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int n0 = 0; n0 < D / 16; n0 += 2) {
          unsigned fb[2][4];  // keys kk*16 + 8 (j & 1) .., dims (n0 + i)*16 + 8 (j >> 1) ..
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ldmatrix_x4_trans(fb[i], kt + (kk * 16 + (lm_m & 1) * 8 + lm_r) * LD +
                                         (n0 + i) * 16 + (lm_m >> 1) * 8);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(dq_acc[2 * (n0 + i)], da, fb[i][0], fb[i][1]);
            mma_bf16(dq_acc[2 * (n0 + i) + 1], da, fb[i][2], fb[i][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;

  bf16* d0 = dq + b * st.dq[0] + h * st.dq[1] + static_cast<long long>(r0) * st.dq[2];
  bf16* d1 = dq + b * st.dq[0] + h * st.dq[1] + static_cast<long long>(r1) * st.dq[2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < sq) {
      *reinterpret_cast<unsigned*>(d0 + col) =
          pack_bf16(dq_acc[n][0] * scale, dq_acc[n][1] * scale);
    }
    if (r1 < sq) {
      *reinterpret_cast<unsigned*>(d1 + col) =
          pack_bf16(dq_acc[n][2] * scale, dq_acc[n][3] * scale);
    }
  }
}

// The three backward kernels in turn on one stream: the row constants, then
// dK and dV, then dQ.
template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const float* bias, const void* o,
               const void* o_lo, const void* dout, const float* stats, float* rowc, void* dq,
               void* dk, void* dv,
               int batch, int heads, int sq, int sk, int sq_pad, int bias_vec2,
               const BwdStrides& st, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const long long bh = static_cast<long long>(batch) * heads;
  const long long rows = bh * sq_pad;
  const int threads = 256;
  const long long dot_blocks = (rows * (D / 8) + threads - 1) / threads;
  const long long k_tiles = (sk + kDkdvWarps * 16 - 1) / (kDkdvWarps * 16);
  const long long q_tiles = (sq + kDqWarps * 16 - 1) / (kDqWarps * 16);
  if (dot_blocks > 0x7fffffffLL || bh * k_tiles > 0x7fffffffLL || bh * q_tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float4* rc = reinterpret_cast<float4*>(rowc);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* gb = static_cast<const bf16*>(dout);
  flash_bwd_dot_kernel<D><<<static_cast<unsigned>(dot_blocks), threads, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(o_lo), gb, stats, rc, heads, sq,
      sq_pad, rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<D, kDkdvWarps>
      <<<static_cast<unsigned>(bh * k_tiles), kDkdvWarps * 32, dkdv_smem_bytes<D>(), stream>>>(
          qb, kb, vb, bias, gb, rc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, sq,
          sk, sq_pad, static_cast<int>(k_tiles), st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D, kDqWarps>
      <<<static_cast<unsigned>(bh * q_tiles), kDqWarps * 32, mma_smem_bytes<D>(), stream>>>(
          qb, kb, vb, bias, gb, rc, static_cast<bf16*>(dq), heads, sq, sk, sq_pad,
          static_cast<int>(q_tiles), st, scale, bias_vec2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
cudaError_t raise_bwd_smem_limits() {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, kDkdvWarps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dkdv_smem_bytes<D>()));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_bwd_dq_kernel<D, kDqWarps>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(mma_smem_bytes<D>()));
}

template <int D, int NWARPS, int MT>
cudaError_t raise_smem_limit() {
  return cudaFuncSetAttribute(flash_mma_kernel<D, NWARPS, MT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(mma_smem_bytes<D>()));
}

// The instances: 64 query rows a block as 4 warps of one group; 128 rows as 4
// warps of two groups at D 32 and 64, and as 8 warps of one group at D 128,
// whose 64 accumulator registers a group leave no room for a second.
#define SEDT_MMA_INSTANCES(X) \
  X(32, 64, 4, 1) X(32, 128, 4, 2) X(64, 64, 4, 1) X(64, 128, 4, 2) X(128, 64, 4, 1) \
  X(128, 128, 8, 1)

}  // namespace

// Raises the dynamic shared-memory limit of every tensor-core instance on the
// current device.  Called once per device when the library is loaded, so that
// the per-call path is pointer arithmetic and the launch (and can be captured
// into a CUDA graph).  Returns the first error as an int.
extern "C" int sedt_flash_init() {
  cudaError_t err = cudaSuccess;
#define SEDT_MMA_RAISE(D, ROWS, W, MT) \
  if (err == cudaSuccess) err = raise_smem_limit<D, W, MT>();
  SEDT_MMA_INSTANCES(SEDT_MMA_RAISE)
#undef SEDT_MMA_RAISE
  if (err == cudaSuccess) err = raise_bwd_smem_limits<32>();
  if (err == cudaSuccess) err = raise_bwd_smem_limits<64>();
  if (err == cudaSuccess) err = raise_bwd_smem_limits<128>();
  return static_cast<int>(err);
}

// Launches the f32-core variant on `stream` and returns cudaGetLastError() as
// an int.
//
// q [batch, heads, sq, d], k and v [batch, heads, sk, d], o like q: device
// pointers of one type (is_bf16 0: f32, 1: bf16), each addressed by the
// element strides of its batch, head and row dims; the last dim is dense and
// every pointer and stride keeps a 4-element vector aligned.  bias: device
// f32 or null, with four element strides, 0 where it broadcasts.  strides is
// a host array of 16: q, k, v, o (3 each), then bias (4).  d is 16, 32, 64
// or 128; sq and sk are at least 1.
extern "C" int sedt_flash_attention(const void* q, const void* k, const void* v,
                                    const float* bias, void* o, int is_bf16,
                                    int batch, int heads, int sq, int sk, int d,
                                    const long long* strides, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  for (int i = 0; i < 4; ++i) st.bias[i] = strides[12 + i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_for_dim<__nv_bfloat16>(d, q, k, v, bias, o, batch, heads, sq, sk, st, s);
  }
  return launch_for_dim<float>(d, q, k, v, bias, o, batch, heads, sq, sk, st, s);
}

// Launches the tensor-core variant (and, when n_splits > 1, the combine
// kernel after it) on `stream`; returns cudaGetLastError() as an int.
//
// q, k, v, o: bf16, as above, but q, k and v at 16-byte-aligned addresses
// with batch, head and row strides that are multiples of 8 elements; o's row
// stride and address keep 4 elements aligned.  d is 32, 64 or 128.  rows is
// 64 or 128: the query rows a block takes.  The keys are cut into n_splits
// ranges of keys_per_split keys (a multiple of 64; every range holds at least
// one key).  partial: f32 scratch of blocks * rows * (d + 2) values where
// blocks = batch * heads * ceil(sq / rows) * n_splits, or null when n_splits
// is 1.  stats: null, or f32 [batch, heads, sq, 2] that receives every row's
// (m, l), the maximum of its scaled and biased scores and the sum of
// exp(s - m), for the backward; o_lo: null, or bf16 laid out as o, which
// receives what rounding the f32 output to o lost (o + o_lo carries 16 bits).
// bias_vec2: nonzero when a full bias may be read as float2 (key
// stride 1, the other strides even, an 8-byte-aligned address).
extern "C" int sedt_flash_attention_mma(const void* q, const void* k, const void* v,
                                        const float* bias, void* o, float* partial,
                                        float* stats, void* o_lo, int batch, int heads, int sq,
                                        int sk, int d,
                                        int rows, int n_splits, int keys_per_split,
                                        int bias_vec2, const long long* strides,
                                        void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || n_splits <= 0 ||
      keys_per_split <= 0 || keys_per_split % kBN != 0 ||
      static_cast<long long>(n_splits - 1) * keys_per_split >= sk ||
      static_cast<long long>(n_splits) * keys_per_split < sk ||
      (n_splits > 1 && partial == nullptr) || (rows != 64 && rows != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  for (int i = 0; i < 4; ++i) st.bias[i] = strides[12 + i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEDT_MMA_CASE(D, ROWS, W, MT)                                                   \
  if (d == D && rows == ROWS) {                                                          \
    return launch_mma<D, W, MT>(q, k, v, bias, o, partial, stats, o_lo, batch, heads, sq, sk, \
                                n_splits, keys_per_split, bias_vec2, st, s);             \
  }
  SEDT_MMA_INSTANCES(SEDT_MMA_CASE)
#undef SEDT_MMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the backward of the tensor-core variant on `stream` (three
// kernels: flash_bwd_dot_kernel, flash_bwd_dkdv_kernel, flash_bwd_dq_kernel)
// and returns the first cudaGetLastError() that is not success, as an int.
//
// q, k, v as for sedt_flash_attention_mma; o, the forward's output, o_lo, what
// its rounding lost, and dout, its gradient, like q, on 16-byte boundaries
// with batch, head and row strides that are multiples of 8 elements (o_lo
// with o's strides); dq, dk, dv like q, k, v with row strides
// and addresses that keep 2 elements aligned.  bias: as for the forward (it
// gets no gradient here).  stats: the forward's f32 [batch, heads, sq, 2]
// (m, l).  rowc: f32 scratch of batch * heads * sq_pad * 4 values on a 16-byte
// boundary, sq_pad sq rounded up to a multiple of kRowPad (any other value is
// refused, so the wrapper's ROW_PAD cannot drift from kRowPad unnoticed).  strides is a host array
// of 28: q, k, v, o, dout, dq, dk, dv (3 each), then the bias (4).  d is 32,
// 64 or 128.
extern "C" int sedt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                        const float* bias, const void* o, const void* o_lo,
                                        const void* dout,
                                        const float* stats, float* rowc, void* dq, void* dk,
                                        void* dv, int batch, int heads, int sq, int sk, int d,
                                        int sq_pad, int bias_vec2, const long long* strides,
                                        void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 ||
      sq_pad != (sq + kRowPad - 1) / kRowPad * kRowPad ||
      o_lo == nullptr || stats == nullptr || rowc == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdStrides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
    st.dout[i] = strides[12 + i];
    st.dq[i] = strides[15 + i];
    st.dk[i] = strides[18 + i];
    st.dv[i] = strides[21 + i];
  }
  for (int i = 0; i < 4; ++i) st.bias[i] = strides[24 + i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_bwd<32>(q, k, v, bias, o, o_lo, dout, stats, rowc, dq, dk, dv, batch, heads,
                            sq, sk, sq_pad, bias_vec2, st, s);
    case 64:
      return launch_bwd<64>(q, k, v, bias, o, o_lo, dout, stats, rowc, dq, dk, dv, batch, heads,
                            sq, sk, sq_pad, bias_vec2, st, s);
    case 128:
      return launch_bwd<128>(q, k, v, bias, o, o_lo, dout, stats, rowc, dq, dk, dv, batch, heads,
                             sq, sk, sq_pad, bias_vec2, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
