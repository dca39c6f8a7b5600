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
// Two kernels, one per dtype:
//
// bf16 (the serving path): flash_forward_wgmma_kernel, on the tensor cores.
//   * A block of 288 threads takes one (b, h, 128-row q tile), heaviest tiles
//     (most keys under the causal band) first.  Warps 0-7 are two consumer
//     warpgroups of 64 q rows each; warp 8 is the producer.  The producer
//     loads the q tile once and then the K and V tiles of 64 keys that lie in
//     [k_lo, k_hi) (tiles wholly outside the band or the window are skipped)
//     with TMA into a 4-stage ring of shared memory, each stage guarded by a
//     "full" mbarrier (TMA bytes) and an "empty" one (one arrive per consumer
//     warp).  The KV tile walk takes the place of the Pallas grid's
//     sequential KV axis; the running max, sum and output stay in registers
//     for the whole walk.
//   * Each consumer warpgroup reads its 64 q rows once into registers
//     (ldmatrix), as the A fragments of S = Q K^T: wgmma m64n64k16 with B = K
//     from shared memory, K-major, D/16 steps.  bf16 x bf16 products are
//     exact in f32, so S differs from the plain version only in the order of
//     its sums.
//   * The online softmax runs on the accumulator fragment in registers, on
//     the raw scores' running max m: p = exp2(s c - m c) with c =
//     log2(e)/sqrt(D), one FFMA and one ex2 on the SFU a score; row max and
//     sum are quad shuffles (the 4 threads of a quad share a row); the mask
//     is evaluated only on tiles that cross the diagonal, the window edge or
//     Skv.  Masked scores are -1e30; a row with nothing unmasked so far adds
//     nothing ("live"), and a row with l == 0 gives 0, as in the Pallas kernel.
//   * O += P V is wgmma m64n{D}k16 with A = P from registers (the f32
//     accumulator fragment of S is, pair by pair, the bf16 A fragment of the
//     next product) and B = V from shared memory, MN-major (transpose bit).
//     P is split into hi = bf16(p) and lo = bf16(p - hi), and both go
//     through the tensor cores: O += P_hi V + P_lo V.  The Pallas kernel and
//     the plain version keep p in f32 (v is cast to f32 before the product),
//     and the port holds bf16 outputs to them at 1e-5 + 1e-2|ref|, one bf16
//     ulp.  p rounded once to bf16 (8 bits) misses that limit at the serving
//     geometry; hi + lo carries 16 bits, within 2^-17 |p| of p.  On the CPU,
//     tests/test_torch_flash_attention.py emulates this arithmetic: P rounded
//     once exceeds the 1e-5 allowed beyond 1e-2|ref| by 2.0e-3 at D = 80,
//     2048 tokens, window 1024; hi + lo by 4.0e-7.  The second PV product
//     makes the tensor-core FLOP 1.5x those of one.
//   * Tile i issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} back to back, waits
//     for S_i only, and runs the softmax of S_i while the PV product is in
//     flight; O is rescaled after it lands.
//   * Shared-memory layout: the non-swizzled ("interleave") core-matrix
//     layout.  A tile of R rows is stored as D/8 slabs of (R x 8) bf16, one
//     16-byte row segment after another, so each 8x8 core matrix is 128
//     contiguous bytes.  Each slab is one TMA box {8, R} of a 4-D tensor map
//     over (D, S, heads, B) built from the tensor's strides, so any D that
//     is a multiple of 8 works.  That is how head_dim 80 (160-byte rows, no
//     swizzle atom fits them) is taken without padding to 128 columns or a
//     second box shape; the cost is D/8 TMA issues per tile (spread over the
//     producer warp's lanes).  On the card, dropping the K/V loads altogether
//     saved only ~3 % of the kernel's time, so the layout is not what bounds it.
//   * Rows and keys past Sq/Skv are filled with zeros by the TMA (out of
//     bounds) and masked; o is stored from registers as bf16 pairs.
//   * D is a template parameter: 16, 32, 64, 80, 128, 160.  The block is
//     compiled for at most 168 registers a thread (288 threads round up to
//     384 in the register allocation); chip_smoke.py reports each instance's
//     registers and spills.
//   * What bounds it on the card (PERF.md): the CUDA-core work per score
//     (FFMA, ex2, max, sum, the hi/lo split) and its latency with two
//     consumer warpgroups, more than the tensor cores.
//
// f32 (not on the serving path; the parity cases hold it at 2e-5):
//   flash_forward_f32_kernel, on the CUDA cores.  The tensor cores have no
//   f32 product (TF32 keeps ~10 mantissa bits), so f32 inputs stay on FMAs.
//   One block of 128 threads takes one (b, h, 64-row q tile) and walks the
//   KV tiles in order; q, k and v are read in place through their strides
//   with 16-byte vector loads into shared memory, transposed where the FMA
//   loops want it.  Each thread owns an 8-row x 4-column block of the 64 x 64
//   score tile and 8 rows x D/16 columns of the output; the 16 threads of a
//   row reduce its max and sum with half-warp shuffles.  Numerics as above,
//   with exp in f32 and p kept in f32.
//
// The TMA descriptors are encoded on the host by cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (no -lcuda), and passed to the
// kernel as __grid_constant__ parameters.

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// --------------------------------------------------------------------------
// f32: CUDA-core kernel
// --------------------------------------------------------------------------

constexpr int kBQ = 64;           // q rows per block
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 128;     // 8 row groups x 16 column lanes
constexpr int kRM = 8;            // rows per thread
constexpr int kCN = kBK / 16;     // score columns per thread
constexpr int kLdQ = kBQ + 4;     // Qt / Pt row pitch (float4-aligned, skewed banks)
constexpr int kLdK = kBK + 1;     // Kt row pitch (conflict-free transposed stores)

template <int D>
constexpr int smem_floats() {
  return D * kLdQ + D * kLdK + kBK * D + kBK * kLdQ;
}

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

// fa_forward's arguments
struct Params {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Skv, H, KVH;
  long long q_sb, q_ss, q_sh;  // element strides of q (B, Sq, H, D)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_forward_f32_kernel(const Params p) {
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

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < kBQ * kD4; e += kThreads) {
    const int r = e / kD4, d = (e % kD4) * 4;
    const float4 x = q0 + r < p.Sq ? *reinterpret_cast<const float4*>(qg + (q0 + r) * p.q_ss + d)
                                   : zero4;
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
      const float4 kx = in ? *reinterpret_cast<const float4*>(kg + (k0 + c) * p.k_ss + d) : zero4;
      const float4 vx = in ? *reinterpret_cast<const float4*>(vg + (k0 + c) * p.v_ss + d) : zero4;
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
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int qpos = q0 + ty * kRM + i;
    if (qpos >= p.Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* row =
        static_cast<float*>(p.o) + ((static_cast<long long>(b) * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < kDN; ++j) row[tx + 16 * j] = acc[i][j] / denom;
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_forward_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_forward_f32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// bf16: tensor-core kernel (wgmma + TMA)
// --------------------------------------------------------------------------

constexpr int kTcConsumers = 2;                    // consumer warpgroups
constexpr int kTcBQ = 64 * kTcConsumers;           // q rows per block
constexpr int kTcStages = 4;                       // depth of the K/V ring
constexpr int kTcThreads = 128 * kTcConsumers + 32;  // + one producer warp
constexpr int kTcBK = 64;                          // keys per KV tile

struct TcParams {
  CUtensorMap q_map, k_map, v_map;  // (D, S, heads, B) bf16, boxes {8, rows, 1, 1}
  __nv_bfloat16* o;                 // contiguous (B, Sq, H, D)
  int Sq, Skv, H, KVH;
  int causal, window;
  float scale_log2;                 // log2(e) / sqrt(D)
};

// Byte offsets in dynamic shared memory: the q tile, the K and V stages
// (each D/8 slabs of rows x 16 bytes), then the mbarriers.
template <int D>
struct TcSmem {
  static constexpr int kQBytes = kTcBQ * D * 2;
  static constexpr int kKVBytes = kTcBK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kTcStages * kKVBytes;
  static constexpr int kBars = kV + kTcStages * kKVBytes;  // full[], empty[], q
  static constexpr int kBytes = kBars + (2 * kTcStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 128;  // slack to align the base to 128 B
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the barrier's phase differs from ``parity``; trap (a launch
// error, not a hang) if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) asm volatile("trap;");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one {8, rows} box of a (D, S, heads, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int d0, int s0, int head, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0), "r"(s0), "r"(head),
      "r"(b)
      : "memory");
}

// wgmma matrix descriptor, non-swizzled layout: start address, the byte
// distance between core matrices along K (lbo) and along M/N (sbo)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers that an asynchronous wgmma reads or writes: keep the compiler
// from moving their other uses across the issue and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x N, f32) += A (64 x 16 bf16, registers) B (16 x N bf16, shared memory
// through a descriptor; TransB = 1: MN-major).  N = 64 keys for S = Q K^T
// (K-major), N = D for O += P V (MN-major).
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[80], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, %86;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TransB));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// 2^x on the SFU (relative error ~2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_forward_wgmma_kernel(const __grid_constant__ TcParams p) {
  static_assert(D % 16 == 0 && D <= 256, "D must be a multiple of 16, at most 256");
  using L = TcSmem<D>;
  constexpr int kSlabQ = kTcBQ * 16, kSlabKV = kTcBK * 16;  // bytes per 8-column slab
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kTcStages;
  uint64_t* q_bar = empty + kTcStages;

  // heaviest q tiles (most keys under the causal band) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  // keys that some row of this tile may see: [k_lo, k_hi), in whole KV tiles
  int k_hi = p.Skv, k_lo = 0;
  if (p.causal) k_hi = min(p.Skv, q0 + kTcBQ);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / kTcBK;
  const int n_tiles = max(0, (k_hi + kTcBK - 1) / kTcBK - t_lo);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kTcConsumers);  // one arrive per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kTcConsumers) {
    // producer: the q tile once, then the K/V ring; lane j issues slab j
    if (lane == 0) mbar_expect_tx(q_bar, L::kQBytes);
    __syncwarp();
    for (int j = lane; j < D / 8; j += 32)
      tma_load(smem + L::kQ + j * kSlabQ, &p.q_map, q_bar, 8 * j, q0, h, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kTcStages;
      if (i >= kTcStages) mbar_wait(&empty[s], ((i / kTcStages) - 1) & 1);
      if (lane == 0) mbar_expect_tx(&full[s], 2 * L::kKVBytes);
      __syncwarp();
      const int k0 = (t_lo + i) * kTcBK;
      uint8_t* ks = smem + L::kK + s * L::kKVBytes;
      uint8_t* vs = smem + L::kV + s * L::kKVBytes;
      for (int j = lane; j < D / 8; j += 32) {
        tma_load(ks + j * kSlabKV, &p.k_map, &full[s], 8 * j, k0, kvh, b);
        tma_load(vs + j * kSlabKV, &p.v_map, &full[s], 8 * j, k0, kvh, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64); in the
  // accumulator fragment, thread (w, g = lane / 4, c = lane % 4) holds rows
  // 16 w + g and 16 w + g + 8, columns 8 n + 2 c and 8 n + 2 c + 1 of every
  // 8-column group n
  const int wg = warp / 4, w = warp % 4, g = lane / 4, c = lane % 4;
  const int wg_q0 = q0 + 64 * wg;
  const int row0 = wg_q0 + 16 * w + g;

  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores of both rows
  float l[2] = {0.f, 0.f};          // running sum of P of both rows
  float sc[kTcBK / 2];              // S, then P, of the current tile
  uint32_t p_hi[kTcBK / 16][4], p_lo[kTcBK / 16][4];  // P of the previous tile

  // the registers the asynchronous PV product reads and writes
  auto fence_pv_regs = [&] {
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
  };
  // O += P_hi V + P_lo V for the V tile at v_addr: MN-major, each k16 step
  // two 8-key core matrices further on
  auto issue_pv = [&](uint32_t v_addr) {
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint64_t dv = make_desc(v_addr + 2 * kk * 128, 128, kSlabKV);
      wgmma_rs<1>(o, p_hi[kk], dv);
      wgmma_rs<1>(o, p_lo[kk], dv);
    }
    wgmma_commit();
  };

  // Tile i issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} together; the
  // softmax of S_i runs on the CUDA cores while the PV product is in flight,
  // and O is rescaled only after it lands.
  mbar_wait(q_bar, 0);
  // this warpgroup's 64 q rows, once, as the A fragments of the D/16 k16 steps
  uint32_t q_frag[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int mi = lane / 8, rr = lane % 8;
    const uint32_t addr = smem_u32(smem + L::kQ) + (2 * kk + (mi >> 1)) * kSlabQ +
                          (64 * wg + 16 * w + (mi & 1) * 8 + rr) * 16;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(q_frag[kk][0]), "=r"(q_frag[kk][1]), "=r"(q_frag[kk][2]),
                   "=r"(q_frag[kk][3])
                 : "r"(addr));
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kTcStages, s_prev = (i + kTcStages - 1) % kTcStages;
    const int k0 = (t_lo + i) * kTcBK;
    const uint32_t k_addr = smem_u32(smem + L::kK + s * L::kKVBytes);
    const uint32_t v_prev = smem_u32(smem + L::kV + s_prev * L::kKVBytes);
    mbar_wait(&full[s], (i / kTcStages) & 1);

#pragma unroll
    for (int j = 0; j < kTcBK / 2; ++j) sc[j] = 0.f;  // the products accumulate
    fence_regs(sc);
    fence_pv_regs();
    wgmma_fence();
    // S = Q K^T: D/16 steps of k16, each two 8-column slabs further on
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs<0>(sc, q_frag[kk], make_desc(k_addr + 2 * kk * kSlabKV, kSlabKV, 128));
    wgmma_commit();
    if (i > 0) {
      issue_pv(v_prev);
      wgmma_wait<1>();  // S has landed; the PV product may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sc);

    // mask where the tile crosses the diagonal, the window edge or Skv, then
    // the online softmax of both rows, in the log2 domain
    const bool need_mask = k0 + kTcBK > p.Skv || (p.causal && k0 + kTcBK - 1 > wg_q0) ||
                           (p.window > 0 && k0 <= wg_q0 + 63 - p.window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kTcBK / 2; ++j) {
        const int kpos = k0 + 8 * (j / 4) + 2 * c + (j & 1);
        const int qpos = row0 + 8 * ((j / 2) & 1);
        const bool valid = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                           (p.window <= 0 || kpos > qpos - p.window);
        if (!valid) sc[j] = kNegInf;
      }
    }
    float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kTcBK / 2; ++j) row_max[(j / 2) & 1] = fmaxf(row_max[(j / 2) & 1], sc[j]);
    float alpha[2], neg_max[2], row_sum[2] = {0.f, 0.f};
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(row_max[r]));
      // a row with nothing unmasked so far: exp(0) == 1 would count masked keys
      live[r] = m_new > kNegInf / 2;
      alpha[r] = live[r] ? fast_exp2((m[r] - m_new) * p.scale_log2) : 0.f;
      // a dead row's scores are all -1e30: with 0 for its max they give p = 0
      neg_max[r] = live[r] ? -m_new * p.scale_log2 : 0.f;
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kTcBK / 2; ++j) {
      const int r = (j / 2) & 1;
      sc[j] = fast_exp2(fmaf(sc[j], p.scale_log2, neg_max[r]));
      row_sum[r] += sc[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(row_sum[r]);

    if (i > 0) {
      wgmma_wait<0>();
      fence_pv_regs();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s_prev]);  // this warp is done with tile i-1
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j / 2) & 1];
    // P = hi + lo in bf16, laid out as the A fragments of the k16 steps
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = sc[8 * kk + 2 * e], x1 = sc[8 * kk + 2 * e + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[kk][e] = pack_bf16(hi);
        p_lo[kk][e] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }
  }
  if (n_tiles > 0) {  // the last tile's PV product
    fence_pv_regs();
    wgmma_fence();
    issue_pv(smem_u32(smem + L::kV + ((n_tiles - 1) % kTcStages) * L::kKVBytes));
    wgmma_wait<0>();
    fence_pv_regs();
  }

  // o / l as bf16 pairs; o is contiguous (B, Sq, H, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos >= p.Sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* row = p.o + ((static_cast<long long>(b) * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * c) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] / denom, o[4 * n + 2 * r + 1] / denom);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, S, heads, D) bf16 tensor with unit stride on D, as a 4-D map over
// (D, S, heads, B) whose box is one 8-column slab of ``rows`` rows.
bool encode_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D,
                long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {8, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 launch's grid: one CTA per (128-row q tile, head, batch row).
dim3 tc_grid(int Sq, int H, int B) { return dim3((Sq + kTcBQ - 1) / kTcBQ, H, B); }

template <int D>
cudaError_t launch_bf16(const Params& a, cudaStream_t stream) {
  TcParams p;
  if (!encode_map(&p.q_map, a.q, a.B, a.Sq, a.H, D, a.q_sb, a.q_ss, a.q_sh, kTcBQ) ||
      !encode_map(&p.k_map, a.k, a.B, a.Skv, a.KVH, D, a.k_sb, a.k_ss, a.k_sh, kTcBK) ||
      !encode_map(&p.v_map, a.v, a.B, a.Skv, a.KVH, D, a.v_sb, a.v_ss, a.v_sh, kTcBK))
    return cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.Sq = a.Sq; p.Skv = a.Skv; p.H = a.H; p.KVH = a.KVH;
  p.causal = a.causal; p.window = a.window;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  const int smem = TcSmem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_forward_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_forward_wgmma_kernel<D><<<tc_grid(a.Sq, a.H, a.B), kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// launch_bf16's configuration for trace capture: out[0..2] the grid, out[3]
// threads a CTA, out[4] dynamic shared memory bytes, out[5] the CTAs an SM
// holds at that shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <int D>
cudaError_t launch_config_bf16(int B, int Sq, int H, int* out) {
  const int smem = TcSmem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_forward_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_forward_wgmma_kernel<D>,
                                                      kTcThreads, smem);
  const dim3 grid = tc_grid(Sq, H, B);
  out[0] = static_cast<int>(grid.x); out[1] = static_cast<int>(grid.y);
  out[2] = static_cast<int>(grid.z); out[3] = kTcThreads; out[4] = smem; out[5] = per_sm;
  return err;
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Skv, KVH, D) with unit stride on D and the
// other strides given in elements (multiples of 8 for bf16, of 4 for f32);
// o contiguous (B, Sq, H, D) of q's type.  is_bf16 selects bf16 over f32 for
// all four.  Returns cudaGetLastError() (cudaErrorInvalidValue for a head_dim
// without an instance or a tensor the TMA cannot describe).
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, int is_bf16,
                          int B, int Sq, int Skv, int H, int KVH, int D,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p{q, k, v, o, B, Sq, Skv, H, KVH, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, causal, window, scale};
  if (!is_bf16) {
    switch (D) {
      case 16: return static_cast<int>(launch_f32<16>(p, st));
      case 32: return static_cast<int>(launch_f32<32>(p, st));
      case 64: return static_cast<int>(launch_f32<64>(p, st));
      case 80: return static_cast<int>(launch_f32<80>(p, st));
      case 128: return static_cast<int>(launch_f32<128>(p, st));
      case 160: return static_cast<int>(launch_f32<160>(p, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (Skv == 0)  // no key: every row is 0 (and a TMA map needs a non-empty extent)
    return static_cast<int>(cudaMemsetAsync(o, 0, 2ull * B * Sq * H * D, st));
  switch (D) {
    case 16: return static_cast<int>(launch_bf16<16>(p, st));
    case 32: return static_cast<int>(launch_bf16<32>(p, st));
    case 64: return static_cast<int>(launch_bf16<64>(p, st));
    case 80: return static_cast<int>(launch_bf16<80>(p, st));
    case 128: return static_cast<int>(launch_bf16<128>(p, st));
    case 160: return static_cast<int>(launch_bf16<160>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch fa_forward makes for bf16 q (B, Sq, H, D), as launch_config_bf16
// gives it.  Returns cudaErrorInvalidValue for a head_dim without an instance.
extern "C" int fa_forward_bf16_launch(int B, int Sq, int H, int D, int* out) {
  switch (D) {
    case 16: return static_cast<int>(launch_config_bf16<16>(B, Sq, H, out));
    case 32: return static_cast<int>(launch_config_bf16<32>(B, Sq, H, out));
    case 64: return static_cast<int>(launch_config_bf16<64>(B, Sq, H, out));
    case 80: return static_cast<int>(launch_config_bf16<80>(B, Sq, H, out));
    case 128: return static_cast<int>(launch_config_bf16<128>(B, Sq, H, out));
    case 160: return static_cast<int>(launch_config_bf16<160>(B, Sq, H, out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
