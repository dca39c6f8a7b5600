// Hopper kernel K4: the Mamba1 selective scan.
//
// Replaces: src/repro/kernels/mamba_scan/mamba_scan.py, _scan_kernel
// (launched by selective_scan_pallas).
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t     h: (D, N) per batch row, h_{-1} = 0
//   y_t = sum_n h_t[:, n] * C_t[n]
//
// dt (B, S, D) f32, x (B, S, D) f32 or bf16, A (D, N) f32, B and C (B, S, N)
// f32, all contiguous; out y (B, S, D) f32 and h_last (B, D, N) f32.  The
// D-skip and the gating belong to the caller, as with the Pallas kernel.
//
// What bounds it on the H100.  At the serving shape of falcon-mamba-7b (B=2,
// S=8192, D=8192, N=16) there are B*S*D*N = 2.15e9 state updates.
//   - Bytes: dt f32 + x bf16 + y f32 is 10 B per (b, s, d), 1.35e9 B in all
//     (B, C, A and h_last add under 0.1 %): 0.402 ms at 3.35 TB/s.  This is
//     the roofline bound.
//   - exp: one per update.  The SFU returns 16 a clock per SM, so 2.15e9 of
//     them take ~0.51 ms at 1.98 GHz (~0.58 ms at 1.755 GHz) on 132 SMs: a
//     floor above the byte bound, reported beside it.
//   - Instruction issue: an update is an FMUL, a MUFU.EX2, an FMUL and two
//     FFMAs, five issue slots of a scheduler's one a clock, ~0.6 ms on 528
//     schedulers before any shared-memory read or loop overhead.  With every
//     state of the sequence carried in a register, B*D = 16,384 channels fill
//     only ~2 warps a scheduler, so latency is hidden by instruction-level
//     parallelism, not by other warps.  tools/k4_ablation.py measures which
//     of these sets the pace (PERF.md).
//
// Design, against each of those.
//   - A channel's N states live in registers from t = 0 to S - 1: the Pallas
//     grid's sequential chunk axis becomes a loop in the block, and the
//     (S, D, N) discretised tensors never exist.  A channel spans kLanes = 2
//     neighbouring lanes of N/2 states each (one thread a channel gave one
//     warp a scheduler and was slower; tools/k4_ablation.py times both).  Each
//     lane sums its half of y_t in order in registers, and one shuffle adds
//     the halves.  dt_t and x_t are read once per lane and step, B_t and C_t
//     as 16-byte broadcast reads of shared memory.  A block is 64 channels of
//     one batch row (128 threads); the serving shape is 256 blocks, two to an
//     SM, one wave.
//   - exp on the SFU directly: A * log2(e) is formed once per (channel, n),
//     and da = 2^(dt * A') is one FMUL and one ex2.approx.ftz.f32 (MUFU.EX2;
//     2 ulp, results below 2^-126 flushed to 0).  Only this kernel calls
//     ex2.approx: the build keeps IEEE arithmetic (no --use_fast_math) for the
//     others.
//   - A software pipeline in the step loop: step r + 1's exps and its B, C
//     and x reads issue before step r's FMA chains, and dt two steps ahead,
//     so in-order issue seldom waits on the SFU or on shared memory.
//   - An asynchronous staging ring: dt, x, B and C for kT = 64 steps at a time
//     go into a ring of kStages = 3 stages in shared memory by cp.async,
//     issued two chunks ahead of their use, as 16-byte vectors over the
//     block's channels (4-byte copies where D or a pointer is not aligned for
//     them), so no HBM round trip sits on the recurrence's path.  One
//     __syncthreads per chunk both publishes a landed stage and frees the one
//     read last.  y goes out directly, one coalesced row segment per warp and
//     step; h_last as 16-byte vectors.
// Any S and D are taken: steps and channels past the end are zero-filled by
// the copies and masked on store (a masked channel has dt = 0, so h stays 0).
// N is a template parameter: 4, 8 or 16.  dt*x is rounded once before the
// product with B, as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 4 warps
// tools/k4_ablation.py and tests/test_torch_mamba_scan.py read the next
// line as it stands: change it in all three together
constexpr int kLanes = 2;               // lanes per channel: 1, 2 or 4
constexpr int kCB = kThreads / kLanes;  // channels per block
constexpr int kT = 64;                  // time steps per stage
constexpr int kStages = 3;              // ring depth
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 2^v on the SFU: one MUFU.EX2.
__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 (or 4) bytes to shared memory asynchronously; zero-fill if !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// dst[0, K) = src[0, K), in 16-byte (or 8-, or 4-byte) shared-memory reads.
template <int K>
__device__ __forceinline__ void load_row(float (&dst)[K], const float* src) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + j);
      dst[j] = v.x, dst[j + 1] = v.y, dst[j + 2] = v.z, dst[j + 3] = v.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      const float2 v = *reinterpret_cast<const float2*>(src + j);
      dst[j] = v.x, dst[j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) dst[j] = src[j];
  }
}

// One stage of the ring: kT steps of the block's channels, and of B and C.
template <typename TX, int N>
struct alignas(16) Stage {
  float dt[kT + 2][kCB];  // two rows past the chunk: the pipeline reads ahead (zeroed)
  TX x[kT + 2][kCB];
  float b[kT + 2][N];
  float c[kT + 2][N];
};

struct Args {
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const void* x;
  float* y;
  float* h_last;
  int S, D;
  bool vec;  // D and every pointer aligned for 16-byte copies
};

// Calls f(e) for e = threadIdx.x + i * kThreads < kTotal, i a compile-time
// count: the copy loops unroll into straight-line code.  threadIdx.x is read
// by an asm the compiler may not hoist, so the copies' addresses are
// recomputed per chunk (a few integer operations) rather than held across
// the chunk loop in ~180 more registers.
template <int kTotal, typename F>
__device__ __forceinline__ void for_each_slot(F&& f) {
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
#pragma unroll
  for (int i = 0; i < (kTotal + kThreads - 1) / kThreads; ++i) {
    const int e = tid + i * kThreads;
    if (kTotal % kThreads == 0 || e < kTotal) f(e);
  }
}

// Issue the copies of steps [t0, t0 + kT) into ``st`` (all threads).
template <typename TX, int N>
__device__ __forceinline__ void stage_in(Stage<TX, N>& st, const Args& p, long long row0, int t0,
                                         int c0) {
  const TX* x = static_cast<const TX*>(p.x);
  const float* dt_row = p.dt + (row0 + t0) * p.D + c0;  // (t0, c0)
  const TX* x_row = x + (row0 + t0) * p.D + c0;
  const float* b_row = p.Bm + (row0 + t0) * N;
  const float* c_row = p.Cm + (row0 + t0) * N;
  const int rows = min(kT, p.S - t0), cols = min(kCB, p.D - c0);
  if (p.vec) {
    constexpr int kDtVec = kCB / 4;        // 16-byte vectors in a dt row
    constexpr int kXEl = 16 / sizeof(TX);  // x elements in a vector
    constexpr int kXVec = kCB / kXEl;
    for_each_slot<kT * kDtVec>([&](int e) {
      const int r = e / kDtVec, v = (e % kDtVec) * 4;
      const bool in = r < rows && v < cols;
      cp_async16(&st.dt[r][v], in ? dt_row + static_cast<long long>(r) * p.D + v : p.dt, in);
    });
    for_each_slot<kT * kXVec>([&](int e) {
      const int r = e / kXVec, v = (e % kXVec) * kXEl;
      const bool in = r < rows && v < cols;
      cp_async16(&st.x[r][v], in ? x_row + static_cast<long long>(r) * p.D + v : x, in);
    });
    for_each_slot<kT * N / 4>([&](int e) {
      const int r = e / (N / 4), v = (e % (N / 4)) * 4;
      const bool in = r < rows;
      cp_async16(&st.b[r][v], in ? b_row + r * N + v : p.Bm, in);
      cp_async16(&st.c[r][v], in ? c_row + r * N + v : p.Cm, in);
    });
  } else {
    for_each_slot<kT * kCB>([&](int e) {
      const int r = e / kCB, v = e % kCB;
      const bool in = r < rows && v < cols;
      const long long i = static_cast<long long>(r) * p.D + v;
      cp_async4(&st.dt[r][v], in ? dt_row + i : p.dt, in);
      if constexpr (sizeof(TX) == 4) {
        cp_async4(&st.x[r][v], in ? x_row + i : x, in);
      } else {  // a bf16 pair may straddle 4 bytes: load it through a register
        st.x[r][v] = in ? x_row[i] : __float2bfloat16(0.f);
      }
    });
    for_each_slot<kT * N>([&](int e) {
      const int r = e / N, j = e % N;
      const bool in = r < rows;
      cp_async4(&st.b[r][j], in ? b_row + r * N + j : p.Bm, in);
      cp_async4(&st.c[r][j], in ? c_row + r * N + j : p.Cm, in);
    });
  }
}

template <typename TX, int N>
__global__ void __launch_bounds__(kThreads) scan_kernel(const __grid_constant__ Args p) {
  static_assert(N == 4 || N == 8 || N == 16, "N must be 4, 8 or 16");
  static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4, "a channel spans 1, 2 or 4 lanes");
  static_assert(N >= kLanes, "every lane holds a state");
  constexpr int kNL = N / kLanes;  // states held by one lane
  extern __shared__ __align__(16) unsigned char smem[];
  auto* ring = reinterpret_cast<Stage<TX, N>*>(smem);

  const int tid = threadIdx.x;
  const int cl = tid / kLanes;           // this lane's channel in the block
  const int n0 = (tid % kLanes) * kNL;   // and its first state
  const int c0 = blockIdx.x * kCB;
  const int c = c0 + cl;
  const bool live = c < p.D;
  const long long row0 = static_cast<long long>(blockIdx.y) * p.S;  // (b, t=0) row

  float a2[kNL], h[kNL];
#pragma unroll
  for (int j = 0; j < kNL; ++j) {
    a2[j] = live ? p.A[static_cast<long long>(c) * N + n0 + j] * kLog2e : 0.f;
    h[j] = 0.f;
  }

  // The step loop reads up to two rows past a chunk into values it never
  // uses.  No copy writes those rows, so they are zeroed once, before the
  // first __syncthreads, rather than left uninitialised.
  for (int e = tid; e < kStages * 2 * kCB; e += kThreads) {
    Stage<TX, N>& st = ring[e / (2 * kCB)];
    const int r = kT + e / kCB % 2, v = e % kCB;
    st.dt[r][v] = 0.f;
    st.x[r][v] = static_cast<TX>(0.f);
  }
  for (int e = tid; e < kStages * 2 * N; e += kThreads) {
    Stage<TX, N>& st = ring[e / (2 * N)];
    const int r = kT + e / N % 2, j = e % N;
    st.b[r][j] = st.c[r][j] = 0.f;
  }

  const int chunks = (p.S + kT - 1) / kT;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) stage_in<TX, N>(ring[s], p, row0, s * kT, c0);
    cp_async_commit();
  }
  float* yp = p.y + row0 * p.D + c;
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk k landed
    __syncthreads();               // everyone's did, and chunk k - 1 is read
    const int kn = k + kStages - 1;
    if (kn < chunks) stage_in<TX, N>(ring[kn % kStages], p, row0, kn * kT, c0);
    cp_async_commit();

    const Stage<TX, N>& st = ring[k % kStages];
    const int tn = min(kT, p.S - k * kT);
    // Software pipeline: step r + 1's exps and its B, C and x reads issue
    // before step r's FMA chains, and dt is read two steps ahead, so neither
    // the SFU's nor shared memory's latency sits on the in-order issue path.
    float da[kNL], bv[kNL], cv[kNL];
    float d1 = st.dt[1][cl];
    float dx = st.dt[0][cl] * to_f32(st.x[0][cl]);
    load_row<kNL>(bv, &st.b[0][n0]);
    load_row<kNL>(cv, &st.c[0][n0]);
#pragma unroll
    for (int j = 0; j < kNL; ++j) da[j] = fast_exp2(st.dt[0][cl] * a2[j]);
#pragma unroll 4
    for (int r = 0; r < tn; ++r) {
      const float d2 = st.dt[r + 2][cl];
      const float dx_n = d1 * to_f32(st.x[r + 1][cl]);
      float da_n[kNL], bv_n[kNL], cv_n[kNL];
      load_row<kNL>(bv_n, &st.b[r + 1][n0]);
      load_row<kNL>(cv_n, &st.c[r + 1][n0]);
#pragma unroll
      for (int j = 0; j < kNL; ++j) da_n[j] = fast_exp2(d1 * a2[j]);

      float yv = 0.f;
#pragma unroll
      for (int j = 0; j < kNL; ++j) {
        h[j] = fmaf(da[j], h[j], dx * bv[j]);
        yv = fmaf(h[j], cv[j], yv);
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1) yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (live && n0 == 0) *yp = yv;
      yp += p.D;

      d1 = d2;
      dx = dx_n;
#pragma unroll
      for (int j = 0; j < kNL; ++j) da[j] = da_n[j], bv[j] = bv_n[j], cv[j] = cv_n[j];
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block (the last ones are empty)

  if (!live) return;
  float* hp = p.h_last + (static_cast<long long>(blockIdx.y) * p.D + c) * N + n0;
  if (p.vec && kNL % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kNL; j += 4)
      *reinterpret_cast<float4*>(hp + j) = make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kNL; ++j) hp[j] = h[j];
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// One block per (64-channel block, batch row); the ring's shared memory.
dim3 scan_grid(int D, int B) { return dim3((D + kCB - 1) / kCB, B); }
template <typename TX, int N>
constexpr int scan_smem() { return kStages * static_cast<int>(sizeof(Stage<TX, N>)); }

template <typename TX, int N>
cudaError_t launch(Args p, int B, cudaStream_t stream) {
  p.vec = p.D % (16 / static_cast<int>(sizeof(TX))) == 0 && aligned16(p.dt) && aligned16(p.x) &&
          aligned16(p.Bm) && aligned16(p.Cm) && aligned16(p.h_last);
  constexpr int smem = scan_smem<TX, N>();
  const cudaError_t err =
      cudaFuncSetAttribute(scan_kernel<TX, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  scan_kernel<TX, N><<<scan_grid(p.D, B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// launch's configuration for trace capture: out[0..2] the grid, out[3]
// threads a block, out[4] dynamic shared memory bytes, out[5] the blocks an
// SM holds at that shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <typename TX, int N>
cudaError_t launch_config(int B, int D, int* out) {
  constexpr int smem = scan_smem<TX, N>();
  cudaError_t err =
      cudaFuncSetAttribute(scan_kernel<TX, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel<TX, N>, kThreads, smem);
  const dim3 grid = scan_grid(D, B);
  out[0] = static_cast<int>(grid.x); out[1] = static_cast<int>(grid.y);
  out[2] = static_cast<int>(grid.z); out[3] = kThreads; out[4] = smem; out[5] = per_sm;
  return err;
}

template <typename TX>
cudaError_t dispatch_config(int N, int B, int D, int* out) {
  switch (N) {
    case 4: return launch_config<TX, 4>(B, D, out);
    case 8: return launch_config<TX, 8>(B, D, out);
    case 16: return launch_config<TX, 16>(B, D, out);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t dispatch(int N, const Args& p, int B, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<TX, 4>(p, B, stream);
    case 8: return launch<TX, 8>(p, B, stream);
    case 16: return launch<TX, 16>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous: dt, x (B, S, D); A (D, N); Bm, Cm (B, S, N); y
// (B, S, D); h_last (B, D, N).  x_is_bf16 selects bf16 over f32 for x; the
// rest are f32.  Returns the first CUDA error of the launch, or cudaSuccess.
extern "C" int ms_forward(const void* dt, const void* A, const void* Bm, const void* Cm,
                          const void* x, int x_is_bf16, void* y, void* h_last,
                          int B, int S, int D, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args p{static_cast<const float*>(dt), static_cast<const float*>(A),
               static_cast<const float*>(Bm), static_cast<const float*>(Cm), x,
               static_cast<float*>(y), static_cast<float*>(h_last), S, D, false};
  const cudaError_t err = x_is_bf16 ? dispatch<__nv_bfloat16>(N, p, B, st)
                                    : dispatch<float>(N, p, B, st);
  return static_cast<int>(err);
}

// The launch ms_forward makes for (B, D, N) and x's type, as launch_config
// gives it.  Returns cudaErrorInvalidValue for an N without an instance.
extern "C" int ms_forward_launch(int x_is_bf16, int B, int D, int N, int* out) {
  return static_cast<int>(x_is_bf16 ? dispatch_config<__nv_bfloat16>(N, B, D, out)
                                    : dispatch_config<float>(N, B, D, out));
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
