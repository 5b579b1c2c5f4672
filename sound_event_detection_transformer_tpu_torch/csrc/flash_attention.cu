// Attention forward by blocks with an online softmax.
//
// Replaces the TPU kernel `_flash_kernel` of
// sound_event_detection_transformer_tpu/ops/pallas/flash_attention.py
// (launched by `flash_attention_bh`, reached through `flash_attention`).  It
// computes the same function: out = softmax(q k^T / sqrt(D) + bias) v for
// q [B, H, Sq, D], k and v [B, H, Sk, D] in bf16 or f32, with an additive f32
// bias broadcastable to [B, H, Sq, Sk] (or none), the running maximum, sum
// and accumulator in f32, and the output in the input type.  The [Sq, Sk]
// scores never reach device memory.
//
// What is not carried over from the TPU kernel: D is not padded to 128, K and
// V are staged a tile at a time instead of whole, the bias is never
// broadcast in memory (the kernel takes its pointer and four strides, 0
// where it broadcasts, and a null pointer for no bias), and the ragged last
// tile is masked here instead of padding the inputs.  q, k, v and the output
// are addressed through their batch, head and row strides, so the
// [B, S, H, D] layout the projections produce is read in place.
//
// What bounds it, at the long clip's encoder shape [8, 8, 752, 32] in bf16:
// q, k, v and the output are 12.3 MB, 3.7 us at 3.35 TB/s; its two products
// are 4.63 GFLOP, 4.7 us at the tensor cores' 989 TFLOP/s in bf16, but 69 us
// at the 67 TFLOP/s of the f32 cores that this first kernel computes on.
// So it is bound by operations on the f32 cores, and the decoder's
// cross-attention shape (41 query rows against 752 keys) by its 6.3 MB,
// 1.9 us.
//
// What the design does about that: one block per (batch, head, 64 query
// rows).  A thread owns one query row (for D 64 and 128, two and four
// neighbouring threads share a row, 32 of its dimensions each, and add their
// partial scores with shuffles), with the scaled row, the accumulator, the
// running maximum and the sum in registers.  The block walks the keys a tile
// at a time: all threads stage the K and V tile in shared memory as f32, then
// every thread scores 8 keys at once (reads of a K or V row are the same
// address across the warp, a broadcast), so the maximum, the rescale of the
// accumulator and the bookkeeping are paid once per 8 keys and the inner
// loops are plain FMAs.  Tensor cores (wgmma), asynchronous copies and a
// split of the keys over blocks for short query sides are left for later.
//
// Masked keys: the additive mask is -1e9 and the running maximum starts at
// -1e30, both finite, so a row whose keys are all masked gives the plain
// path's uniform average, never a NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kRows = 64;   // query rows per block
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

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int.
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
