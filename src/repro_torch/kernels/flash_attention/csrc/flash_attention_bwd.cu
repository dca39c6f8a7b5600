// Hopper kernel K5: the backward of training flash attention, with causal /
// sliding-window masking and native GQA.
//
// Replaces: no Pallas kernel.  K3's Pallas kernel (src/repro/kernels/
// flash_attention/flash_attention.py, _flash_kernel) is forward-only, and JAX
// differentiates the plain attention (repro.models.nn.attention) in
// training, as the port did (models/nn.py::attention: f32 products on the CUDA
// cores over materialised S x S score chunks, their softmax, masks and
// repeated K/V in device memory).  K5, with the training instance of K3
// (flash_attention.cu: flash_train_forward_kernel, which also stores each
// row's log-sum-exp), takes that plain path's place for bf16 training on the
// card (kernels/flash_attention/ops.py::flash_attention_train).
//
//   P = exp(S scale - lse),  S = Q K^T          (recomputed from the forward's lse)
//   delta_i = sum_d dO_id O_id                   (f32)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),  dQ = scale dS K,  dK = scale dS^T Q
//
// Bound on the H100: operations.  At danube's training layer (B=2, S=4096,
// H=32, KVH=8, D=80, window 4096) the causal band holds S(S+1)/2 = 8.39 M
// (q, k) pairs per (b, h); one product over it is 2*D FLOP a pair, 8.59e10
// FLOP a layer.  K5 issues ten (the dq kernel S, dP and dS K as hi + lo; the
// dk/dv kernel S, dP, P^T dO and dS^T Q, each of the last two as hi + lo):
// 8.59e11 FLOP, 0.87 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// ~0.2 GB of q, k, v, o, dO, lse, delta, dq, dk and dv (0.06 ms at 3.35 TB/s).
//
// Design.
//   * Two kernels, no atomics, so the gradients are the same bit for bit from
//     run to run.  flash_backward_dq_kernel: one block per (64-row q tile, q
//     head, batch row) walks the 64-key tiles of its band, as K3 does, and
//     accumulates dQ in registers; it first computes delta for its rows (from
//     o and dO) and stores it for the second kernel.  flash_backward_dkdv_kernel:
//     one block per (64-key tile, kv head, batch row) walks, for each q head
//     of its GQA group, the q tiles whose rows see its keys, and accumulates
//     dK and dV of the group in registers: no repeated K/V and no atomics on
//     dK/dV, each written once.  dQ from a second kernel (rather than f32
//     atomics into a scratch buffer) recomputes S and dP once more, four of
//     the ten products, and is deterministic; the atomics would add a scratch
//     buffer, its conversion pass and run-to-run differences in dq.
//   * Tiles wholly outside the causal band or the window are not visited; the
//     mask is evaluated only on tiles that cross the diagonal, the window edge,
//     Sq or Skv.  The mask is causal (kpos <= qpos) with kpos > qpos - window,
//     as K3's and models/nn.py::_attn_chunk_masked's.
//   * Products on the tensor cores with mma.sync m16n8k16 (bf16 operands, f32
//     accumulators); four warps a block, each owning 16 rows of the block's
//     tile (q rows in the dq kernel, keys in the dk/dv kernel).  Operands are
//     read from shared memory with ldmatrix (.trans where the product wants
//     the tile's columns as its K dimension), rows padded by 16 bytes so that
//     the eight rows of an 8x8 matrix fall in different banks.  The tiles that
//     the block walks are double-buffered with cp.async (16-byte copies, rows
//     past Sq or Skv zero-filled).  A first version: wgmma (as K3) is the next
//     step (PERF.md).
//   * Precision: the same work, never fewer bits.  q, k, v and dO enter as the
//     bf16 values they are; bf16 x bf16 products are exact in f32, and every
//     sum is f32.  P enters the dV product, and dS the dQ and dK products, as a
//     pair hi = bf16(x), lo = bf16(x - hi): 16 bits, within 2^-17 |x| (the
//     plain path rounds P once to bf16 and keeps dS in f32).  P uses the SFU's
//     ex2.approx, as K3's forward does.  dq, dk and dv are rounded once to bf16.
//   * D is a template parameter: 64, 80, 128.  Operands are (B, S, heads, D)
//     with unit stride on D and the other strides multiples of 8 elements;
//     lse and delta are contiguous (B, H, Sq) f32; dq (B, Sq, H, D), dk and dv
//     (B, Skv, KVH, D) are contiguous bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // q rows and keys per tile
constexpr int kWarps = 4;                 // each owns 16 rows of the block's tile
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// row pitch of a tile in shared memory: D + 8 elements (16 bytes of padding)
template <int D>
__host__ __device__ constexpr int pitch() { return D + 8; }
template <int D>
__host__ __device__ constexpr int tile_elems() { return kTile * pitch<D>(); }
// both kernels: six bf16 tiles and two pairs of 64 floats (lse and delta)
template <int D>
__host__ __device__ constexpr int smem_bytes() { return 6 * tile_elems<D>() * 2 + 4 * kTile * 4; }

struct BwdParams {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;   // (B, H, Sq), natural log
  float* delta;       // (B, H, Sq)
  __nv_bfloat16 *dq, *dk, *dv;
  int B, Sq, Skv, H, KVH;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, d_sb, d_ss, d_sh;
  int causal, window;
  float scale, scale_log2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 (or, for a float, 4) bytes from global to shared memory; zeros where !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [s0, s0 + 64) of one (batch row, head) of a (B, S, heads, D) tensor
// into a tile of shared memory; rows at or past S read as zeros
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long ss, int s0, int S) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool in = s0 + r < S;
    const __nv_bfloat16* src = in ? base + static_cast<long long>(s0 + r) * ss + 8 * c : base;
    cp_async16(smem_u32(dst + r * pitch<D>() + 8 * c), src, in);
  }
}

// 64 floats of a (B, H, S) row from s0 into shared memory, by threads
// [first, first + 64); zeros at or past S
__device__ __forceinline__ void load_row(float* dst, const float* row, int s0, int S,
                                         int first) {
  const int r = threadIdx.x - first;
  if (r >= 0 && r < kTile) {
    const bool in = s0 + r < S;
    cp_async4(smem_u32(dst + r), in ? row + s0 + r : row, in);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU, as K3's forward takes it (relative error ~2^-22)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// (x0, x1) as hi = bf16(x), lo = bf16(x - hi), each a packed pair
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// In an accumulator (C) fragment of 16 rows x 8n columns, thread (g = lane / 4,
// t = lane % 4) holds acc[n][e]: row g + 8 (e / 2), column 8 n + 2 t + e % 2.

// acc (16 x 64) += A B^T: A the 16 rows of a tile at a_addr (row-major,
// D columns), B the 64 rows of the tile at b_addr (its rows are the columns)
template <int D>
__device__ __forceinline__ void rows_by_rows(float (&acc)[8][4], uint32_t a_addr,
                                             uint32_t b_addr, int lane) {
  constexpr int kPitch = 2 * pitch<D>();  // bytes
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_addr + (lane & 15) * kPitch + (16 * kk + 8 * (lane >> 4)) * 2);
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, b_addr + (16 * n2 + (lane & 7) + 8 * (lane >> 4)) * kPitch +
                     (16 * kk + 8 * ((lane >> 3) & 1)) * 2);
      mma_bf16(acc[2 * n2], a, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += X T: X (16 x 64) an accumulator fragment, entering the
// tensor cores as hi + lo; T the 64 x D tile at t_addr (row-major)
template <int D>
__device__ __forceinline__ void frag_by_tile(float (&acc)[D / 8][4], const float (&x)[8][4],
                                             uint32_t t_addr, int lane) {
  constexpr int kPitch = 2 * pitch<D>();
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    // the accumulator fragment of columns [16 kb, 16 kb + 16) is, pair by
    // pair, the A fragment of the k16 step over them
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * kb][0], x[2 * kb][1], hi[0], lo[0]);
    split_bf16(x[2 * kb][2], x[2 * kb][3], hi[1], lo[1]);
    split_bf16(x[2 * kb + 1][0], x[2 * kb + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * kb + 1][2], x[2 * kb + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      ldsm_x4_trans(b, t_addr + (16 * kb + (lane & 15)) * kPitch + (16 * n2 + 8 * (lane >> 4)) * 2);
      mma_bf16(acc[2 * n2], hi, b[0], b[1]);
      mma_bf16(acc[2 * n2], lo, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * n2 + 1], lo, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ bool kept(const BwdParams& p, int qpos, int kpos) {
  return qpos < p.Sq && kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// ---------------------------------------------------------------------------
// dQ (and delta)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_backward_dq_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* dOs = Qs + tile_elems<D>();
  __nv_bfloat16* Ks = dOs + tile_elems<D>();      // two stages
  __nv_bfloat16* Vs = Ks + 2 * tile_elems<D>();   // two stages
  float* lse2 = reinterpret_cast<float*>(Vs + 2 * tile_elems<D>());  // lse log2(e) of each row
  float* dlt = lse2 + kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // heaviest q tiles (most keys under the causal band) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* dg = p.dout + b * p.d_sb + h * p.d_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + kvh * p.v_sh;
  const long long row_off = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // keys that some row of this tile may see: [k_lo, k_hi), in whole tiles
  int k_hi = p.Skv, k_lo = 0;
  if (p.causal) k_hi = min(p.Skv, q0 + kTile);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / kTile;
  const int n_tiles = max(0, (k_hi + kTile - 1) / kTile - t_lo);

  load_tile<D>(Qs, qg, p.q_ss, q0, p.Sq);
  load_tile<D>(dOs, dg, p.d_ss, q0, p.Sq);
  if (n_tiles > 0) {
    load_tile<D>(Ks, kg, p.k_ss, t_lo * kTile, p.Skv);
    load_tile<D>(Vs, vg, p.v_ss, t_lo * kTile, p.Skv);
  }
  cp_async_commit();

  // delta = rowsum(dO o O) in f32, two threads a row, and lse in the log2
  // domain, while the tiles load
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2, qpos = q0 + r;
    float acc = 0.f;
    if (qpos < p.Sq) {
      const __nv_bfloat16* orow = og + static_cast<long long>(qpos) * p.o_ss;
      const __nv_bfloat16* drow = dg + static_cast<long long>(qpos) * p.d_ss;
      for (int c = half; c < D / 8; c += 2) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + 8 * c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 of = __bfloat1622float2(o2[j]), df = __bfloat1622float2(d2[j]);
          acc = fmaf(of.x, df.x, acc);
          acc = fmaf(of.y, df.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dlt[r] = acc;
      lse2[r] = qpos < p.Sq ? p.lse[row_off + qpos] * kLog2e : 0.f;
      if (qpos < p.Sq) p.delta[row_off + qpos] = acc;
    }
  }
  __syncthreads();
  const int ra = 16 * warp + g;  // this thread's rows in the tile: ra and ra + 8
  const float row_lse2[2] = {lse2[ra], lse2[ra + 8]};
  const float row_dlt[2] = {dlt[ra], dlt[ra + 8]};
  const uint32_t q_addr = smem_u32(Qs + 16 * warp * pitch<D>());
  const uint32_t do_addr = smem_u32(dOs + 16 * warp * pitch<D>());

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    if (i + 1 < n_tiles) {
      load_tile<D>(Ks + (st ^ 1) * tile_elems<D>(), kg, p.k_ss, (t_lo + i + 1) * kTile, p.Skv);
      load_tile<D>(Vs + (st ^ 1) * tile_elems<D>(), vg, p.v_ss, (t_lo + i + 1) * kTile, p.Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = (t_lo + i) * kTile;
    const uint32_t k_addr = smem_u32(Ks + st * tile_elems<D>());
    const uint32_t v_addr = smem_u32(Vs + st * tile_elems<D>());

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    rows_by_rows<D>(s, q_addr, k_addr, lane);    // S = Q K^T
    rows_by_rows<D>(dp, do_addr, v_addr, lane);  // dP = dO V^T

    const bool need_mask = q0 + kTile > p.Sq || k0 + kTile > p.Skv ||
                           (p.causal && k0 + kTile - 1 > q0) ||
                           (p.window > 0 && k0 <= q0 + kTile - 1 - p.window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = fast_exp2(fmaf(s[n][e], p.scale_log2, -row_lse2[e >> 1]));
        if (need_mask && !kept(p, q0 + ra + 8 * (e >> 1), k0 + 8 * n + 2 * t + (e & 1))) pr = 0.f;
        s[n][e] = pr * (dp[n][e] - row_dlt[e >> 1]);  // dS
      }
    frag_by_tile<D>(dq, s, k_addr, lane);  // dQ += dS K
    __syncthreads();  // every warp is done with stage st before it is loaded again
  }
  if (n_tiles == 0) cp_async_wait<0>();

  // dq = scale dQ as bf16 pairs; dq is contiguous (B, Sq, H, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + ra + 8 * r;
    if (qpos >= p.Sq) continue;
    __nv_bfloat16* row = p.dq + ((static_cast<long long>(b) * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// dK and dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_backward_dkdv_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Vs = Ks + tile_elems<D>();
  __nv_bfloat16* Qs = Vs + tile_elems<D>();        // two stages
  __nv_bfloat16* dOs = Qs + 2 * tile_elems<D>();   // two stages
  float* lses = reinterpret_cast<float*>(dOs + 2 * tile_elems<D>());  // two stages of 64
  float* dlts = lses + 2 * kTile;                                     // two stages of 64

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // the first key tile (the most q rows under the causal band) first
  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KVH;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + kvh * p.v_sh;

  // q rows that see some key of this tile: [q_lo, q_hi), in whole tiles
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k0 + kTile - 1 + p.window) : p.Sq;
  const int tq_lo = q_lo / kTile;
  const int n_q = max(0, (q_hi + kTile - 1) / kTile - tq_lo);
  const int n_iters = group * n_q;  // each q head of the group, each q tile

  // iteration it: q head kvh * group + it / n_q, q tile tq_lo + it % n_q
  auto load_iter = [&](int it, int st) {
    const int h = kvh * group + it / n_q, q0 = (tq_lo + it % n_q) * kTile;
    const long long row_off = (static_cast<long long>(b) * p.H + h) * p.Sq;
    load_tile<D>(Qs + st * tile_elems<D>(), p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq);
    load_tile<D>(dOs + st * tile_elems<D>(), p.dout + b * p.d_sb + h * p.d_sh, p.d_ss, q0, p.Sq);
    load_row(lses + st * kTile, p.lse + row_off, q0, p.Sq, 0);
    load_row(dlts + st * kTile, p.delta + row_off, q0, p.Sq, kTile);
  };

  load_tile<D>(Ks, kg, p.k_ss, k0, p.Skv);
  load_tile<D>(Vs, vg, p.v_ss, k0, p.Skv);
  if (n_iters > 0) load_iter(0, 0);
  cp_async_commit();

  const int ra = 16 * warp + g;  // this thread's keys in the tile: ra and ra + 8
  const uint32_t k_addr = smem_u32(Ks + 16 * warp * pitch<D>());
  const uint32_t v_addr = smem_u32(Vs + 16 * warp * pitch<D>());
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_iters; ++it) {
    const int st = it & 1;
    if (it + 1 < n_iters) {
      load_iter(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (tq_lo + it % n_q) * kTile;
    const uint32_t q_addr = smem_u32(Qs + st * tile_elems<D>());
    const uint32_t do_addr = smem_u32(dOs + st * tile_elems<D>());
    const float* lse = lses + st * kTile;
    const float* dlt = dlts + st * kTile;

    // transposed: rows are this warp's keys, columns the tile's q rows
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    rows_by_rows<D>(s, k_addr, q_addr, lane);    // S^T = K Q^T
    rows_by_rows<D>(dp, v_addr, do_addr, lane);  // dP^T = V dO^T

    const bool need_mask = q0 + kTile > p.Sq || k0 + kTile > p.Skv ||
                           (p.causal && q0 < k0 + kTile - 1) ||
                           (p.window > 0 && q0 + kTile - 1 - p.window >= k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1);
        float pr = fast_exp2(fmaf(s[n][e], p.scale_log2, -lse[qc] * kLog2e));
        if (need_mask && !kept(p, q0 + qc, k0 + ra + 8 * (e >> 1))) pr = 0.f;
        dp[n][e] = pr * (dp[n][e] - dlt[qc]);  // dS^T
        s[n][e] = pr;                          // P^T
      }
    frag_by_tile<D>(dv, s, do_addr, lane);  // dV += P^T dO
    frag_by_tile<D>(dk, dp, q_addr, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with stage st before it is loaded again
  }
  if (n_iters == 0) cp_async_wait<0>();

  // dk = scale dK, dv as bf16 pairs; both contiguous (B, Skv, KVH, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + ra + 8 * r;
    if (kpos >= p.Skv) continue;
    const long long off = ((static_cast<long long>(b) * p.Skv + kpos) * p.KVH + kvh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_backward_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
  flash_backward_dq_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_backward_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Skv + kTile - 1) / kTile, p.KVH, p.B);
  flash_backward_dkdv_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, int Sq, int Skv, int H, int KVH, const long long* st,
                      int causal, int window, float scale) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse; p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KVH = KVH;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
  p.d_sb = st[12]; p.d_ss = st[13]; p.d_sh = st[14];
  p.causal = causal; p.window = window;
  p.scale = scale; p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Skv, KVH, D), o and dout (B, Sq, H, D), all
// bf16 with unit stride on D; ``strides`` holds the other three strides of
// q, k, v, o and dout in that order (elements, multiples of 8).  lse (B, H,
// Sq) f32 from the training forward.  The dq kernel writes delta (B, H, Sq)
// f32 and dq (B, Sq, H, D); the dk/dv kernel reads delta and writes dk and dv
// (B, Skv, KVH, D), all contiguous.  Each returns cudaGetLastError()
// (cudaErrorInvalidValue for a head_dim without an instance).
#define FA_BWD_ARGS                                                                         \
  const void *q, const void *k, const void *v, const void *o, const void *dout,             \
      const float *lse, float *delta, void *dq, void *dk, void *dv, int B, int Sq, int Skv, \
      int H, int KVH, int D, const long long *strides, int causal, int window, float scale, \
      void *stream
#define FA_BWD_PARAMS \
  make_params(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, strides, causal, \
              window, scale)

extern "C" int fa_backward_dq(FA_BWD_ARGS) {
  const BwdParams p = FA_BWD_PARAMS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(launch_dq<64>(p, st));
    case 80: return static_cast<int>(launch_dq<80>(p, st));
    case 128: return static_cast<int>(launch_dq<128>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fa_backward_dkdv(FA_BWD_ARGS) {
  const BwdParams p = FA_BWD_PARAMS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(launch_dkdv<64>(p, st));
    case 80: return static_cast<int>(launch_dkdv<80>(p, st));
    case 128: return static_cast<int>(launch_dkdv<128>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
