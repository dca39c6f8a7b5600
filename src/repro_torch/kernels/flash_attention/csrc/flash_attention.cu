// Hopper kernel K3: forward flash attention with causal / sliding-window
// masking and native GQA.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py, _flash_kernel
// (launched by flash_attention_pallas).
//
// Bound on the H100: operations.  At the serving shape of h2o-danube-1.8b
// (B=2, S=8192, H=32, KVH=8, D=80, window 4096) the band holds ~25.2 M (q, k)
// pairs per head; at 4*D FLOP a pair that is 5.15e11 FLOP a layer (0.52 ms at
// the 989 TFLOP/s bf16 tensor-core peak), against ~210 MB of q, k, v and o
// (0.06 ms at 3.35 TB/s).
//
// Design (first version: right first, on the CUDA cores in f32).  One thread
// block of 128 threads takes one (b, h, 64-row q tile) and walks the KV tiles
// in order: this loop takes the place of the Pallas grid's sequential KV axis,
// and the running max, sum and output accumulator stay in registers for the
// whole walk, so scores and probabilities never reach device memory.  KV tiles
// wholly outside the causal band or the window are skipped (they would add
// nothing).  q, k and v are read in place through their (B, S, heads, D)
// strides with 16-/8-byte vector loads and widened to f32 in shared memory; no
// transpose or GQA repeat is materialised (the KV head of head h is
// h / (H / KVH)).  Each thread owns an 8-row x 4-column block of the 64 x 64
// score tile and 8 rows x D/16 columns of the output, so each shared-memory
// load feeds 4-8 FMAs; the 16 threads of a row reduce its max and sum with
// half-warp shuffles.  Any Sq, Skv is taken: rows and keys past the end are
// masked in the kernel.  D is a template parameter (any multiple of 16 up to
// 160; 80 is not padded).  Numerics follow the Pallas kernel: scores, p and
// the PV product in f32, masked entries at -1e30, a block that masks a whole
// row adds nothing, and a row with l == 0 gives 0.  The tensor cores (wgmma)
// are the next step; they are what the bound above assumes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // q rows per block
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 128;     // 8 row groups x 16 column lanes
constexpr int kRM = 8;            // rows per thread
constexpr int kCN = kBK / 16;     // score columns per thread
constexpr int kLdQ = kBQ + 4;     // Qt / Pt row pitch (float4-aligned, skewed banks)
constexpr int kLdK = kBK + 1;     // Kt row pitch (conflict-free transposed stores)
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int smem_floats() {
  return D * kLdQ + D * kLdK + kBK * D + kBK * kLdQ;
}

// four consecutive elements, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Params {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Skv, H, KVH;
  long long q_sb, q_ss, q_sh;  // element strides of q (B, Sq, H, D)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const Params p) {
  static_assert(D % 16 == 0 && D <= 160, "D must be a multiple of 16, at most 160");
  constexpr int kDN = D / 16;  // output columns per thread
  constexpr int kD4 = D / 4;   // float4 chunks per row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                   // [D][kLdQ]   q tile, transposed
  float* Kt = Qt + D * kLdQ;          // [D][kLdK]   k tile, transposed
  float* Vs = Kt + D * kLdK;          // [kBK][D]    v tile
  float* Pt = Vs + kBK * D;           // [kBK][kLdQ] probabilities, transposed

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // heaviest q tiles (most keys under the causal band) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int e = tid; e < kBQ * kD4; e += kThreads) {
    const int r = e / kD4, d = (e % kD4) * 4;
    const float4 x = q0 + r < p.Sq ? load4(qg + (q0 + r) * p.q_ss + d)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    Qt[(d + 0) * kLdQ + r] = x.x; Qt[(d + 1) * kLdQ + r] = x.y;
    Qt[(d + 2) * kLdQ + r] = x.z; Qt[(d + 3) * kLdQ + r] = x.w;
  }

  float m[kRM], l[kRM], acc[kRM][kDN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNegInf; l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDN; ++j) acc[i][j] = 0.f;
  }

  // keys that some row of this tile may see: [k_lo, k_hi)
  int k_hi = p.Skv, k_lo = 0;
  if (p.causal) k_hi = min(p.Skv, q0 + kBQ);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done with Kt, Vs, Pt
    for (int e = tid; e < kBK * kD4; e += kThreads) {
      const int c = e / kD4, d = (e % kD4) * 4;
      const bool in = k0 + c < p.Skv;  // padding keys load 0: p * 0, never p * garbage
      const float4 kx = in ? load4(kg + (k0 + c) * p.k_ss + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 vx = in ? load4(vg + (k0 + c) * p.v_ss + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      Kt[(d + 0) * kLdK + c] = kx.x; Kt[(d + 1) * kLdK + c] = kx.y;
      Kt[(d + 2) * kLdK + c] = kx.z; Kt[(d + 3) * kLdK + c] = kx.w;
      *reinterpret_cast<float4*>(Vs + c * D + d) = vx;
    }
    __syncthreads();

    // S = Q K^T for this thread's 8 x 4 block
    float s[kRM][kCN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * kLdQ + ty * kRM);
      const float4 qb = *reinterpret_cast<const float4*>(Qt + d * kLdQ + ty * kRM + 4);
      const float qv[kRM] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float kv[kCN];
#pragma unroll
      for (int j = 0; j < kCN; ++j) kv[j] = Kt[d * kLdK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kCN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int qpos = q0 + ty * kRM + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                           (p.window <= 0 || kpos > qpos - p.window);
        s[i][j] = valid ? s[i][j] * p.scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      // a row with nothing unmasked so far: exp(0) == 1 would count masked keys
      const bool live = m_new > kNegInf / 2;
      const float alpha = live ? expf(m[i] - m_new) : 0.f;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        s[i][j] = live ? expf(s[i][j] - m_new) : 0.f;
        row_sum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDN; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kCN; ++j) {
      float* dst = Pt + (tx + 16 * j) * kLdQ + ty * kRM;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();

    // O += P V
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + c * kLdQ + ty * kRM);
      const float4 pb = *reinterpret_cast<const float4*>(Pt + c * kLdQ + ty * kRM + 4);
      const float pv[kRM] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[kDN];
#pragma unroll
      for (int j = 0; j < kDN; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kDN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // o is contiguous (B, Sq, H, D)
  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int qpos = q0 + ty * kRM + i;
    if (qpos >= p.Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* row = og + ((static_cast<long long>(b) * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < kDN; ++j) store1(row + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_forward_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_forward_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 160: return launch<T, 160>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Skv, KVH, D) with unit stride on D and the
// other strides given in elements; o contiguous (B, Sq, H, D) of q's type.
// is_bf16 selects bf16 over f32 for all four.  Returns cudaGetLastError().
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, int is_bf16,
                          int B, int Sq, int Skv, int H, int KVH, int D,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          int causal, int window, float scale, void* stream) {
  const Params p{q, k, v, o, B, Sq, Skv, H, KVH, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(D, p, st) : dispatch<float>(D, p, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
