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
// Bound on the H100.  At the serving shape of falcon-mamba-7b (B=2, S=8192,
// D=8192, N=16) there are B*S*D*N = 2.15e9 state updates.  Bytes: dt f32 +
// x bf16 + y f32 is 10 B per (b, s, d), 1.34 GB, 0.40 ms at 3.35 TB/s; B, C, A
// and h_last add under 0.1 %.  Operations: 8 per update (the Pallas shim's
// count), 1.7e10, 0.26 ms at 67 TFLOP/s f32.  So the roofline bound is the
// bytes; one exp per update (2.15e9 at the SFU's 16 a clock per SM, ~0.5 ms
// at 1.98 GHz) sits just above it and may be the real floor.
//
// Design (first version: right and simple).  The Pallas grid's sequential
// chunk axis becomes a loop inside the block: every state is carried in a
// register from t = 0 to S - 1, so the (S, D, N) discretised tensors never
// exist anywhere.  One lane holds one (channel, state) pair: a warp holds
// 32 / N channels x N states, a 256-thread block 256 / N channels of one batch
// row, which at the serving shape is 262,144 lanes, ~62 warps an SM.  y_t is a
// shuffle reduction over the N lanes of a channel.  dt, dt*x, B and C are
// staged a chunk of kT steps at a time through shared memory (coalesced
// loads, each read once), y_t goes back through shared memory and out a chunk
// at a time.  Any S and D are taken: steps and channels past the end are
// masked in the kernel (a masked channel has dt = dt*x = 0, so its h stays 0).
// N is a template parameter: 4, 8 or 16.  Numerics follow the Pallas kernel
// and the plain version: f32 throughout, dt*x rounded once before the
// product with B, accurate expf (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kT = 32;         // time steps staged per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TX, int N>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            const TX* __restrict__ x, float* __restrict__ y, float* __restrict__ h_last,
            int S, int D) {
  static_assert(N == 4 || N == 8 || N == 16, "N must be 4, 8 or 16");
  constexpr int kCB = kThreads / N;  // channels per block
  __shared__ float dt_s[kT][kCB];
  __shared__ float dtx_s[kT][kCB];
  __shared__ float y_s[kT][kCB];
  __shared__ float b_s[kT][N];
  __shared__ float c_s[kT][N];

  const int tid = threadIdx.x;
  const int cl = tid / N;  // this lane's channel in the block
  const int n = tid % N;   // and its state
  const int c0 = blockIdx.x * kCB;
  const int b = blockIdx.y;
  const int c = c0 + cl;
  const float a = c < D ? A[static_cast<long long>(c) * N + n] : 0.f;
  const long long row0 = static_cast<long long>(b) * S;  // (b, t=0) row of (B, S, *)

  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kT) {
    const int tn = min(kT, S - t0);
    __syncthreads();  // the previous chunk's y_s is written out
    for (int e = tid; e < kT * kCB; e += kThreads) {
      const int r = e / kCB, cc = e % kCB;
      float d = 0.f, dx = 0.f;
      if (r < tn && c0 + cc < D) {
        const long long i = (row0 + t0 + r) * D + c0 + cc;
        d = dt[i];
        dx = d * to_f32(x[i]);
      }
      dt_s[r][cc] = d;
      dtx_s[r][cc] = dx;
    }
    for (int e = tid; e < kT * N; e += kThreads) {
      const int r = e / N, j = e % N;
      const bool in = r < tn;
      const long long i = (row0 + t0 + r) * N + j;
      b_s[r][j] = in ? Bm[i] : 0.f;
      c_s[r][j] = in ? Cm[i] : 0.f;
    }
    __syncthreads();

    for (int r = 0; r < tn; ++r) {
      const float da = expf(dt_s[r][cl] * a);
      h = da * h + dtx_s[r][cl] * b_s[r][n];
      float yv = h * c_s[r][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (n == 0) y_s[r][cl] = yv;
    }
    __syncthreads();

    for (int e = tid; e < kT * kCB; e += kThreads) {
      const int r = e / kCB, cc = e % kCB;
      if (r < tn && c0 + cc < D) y[(row0 + t0 + r) * D + c0 + cc] = y_s[r][cc];
    }
  }
  if (c < D) h_last[(static_cast<long long>(b) * D + c) * N + n] = h;
}

template <typename TX, int N>
cudaError_t launch(const float* dt, const float* A, const float* Bm, const float* Cm,
                   const void* x, float* y, float* h_last, int B, int S, int D,
                   cudaStream_t stream) {
  constexpr int kCB = kThreads / N;
  const dim3 grid((D + kCB - 1) / kCB, B);
  scan_kernel<TX, N><<<grid, kThreads, 0, stream>>>(
      dt, A, Bm, Cm, static_cast<const TX*>(x), y, h_last, S, D);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch(int N, const float* dt, const float* A, const float* Bm, const float* Cm,
                     const void* x, float* y, float* h_last, int B, int S, int D,
                     cudaStream_t stream) {
  switch (N) {
    case 4: return launch<TX, 4>(dt, A, Bm, Cm, x, y, h_last, B, S, D, stream);
    case 8: return launch<TX, 8>(dt, A, Bm, Cm, x, y, h_last, B, S, D, stream);
    case 16: return launch<TX, 16>(dt, A, Bm, Cm, x, y, h_last, B, S, D, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous: dt, x (B, S, D); A (D, N); Bm, Cm (B, S, N); y
// (B, S, D); h_last (B, D, N).  x_is_bf16 selects bf16 over f32 for x; the
// rest are f32.  Returns cudaGetLastError().
extern "C" int ms_forward(const void* dt, const void* A, const void* Bm, const void* Cm,
                          const void* x, int x_is_bf16, void* y, void* h_last,
                          int B, int S, int D, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  const cudaError_t err =
      x_is_bf16 ? dispatch<__nv_bfloat16>(N, dtf, af, bf, cf, x, yf, hf, B, S, D, st)
                : dispatch<float>(N, dtf, af, bf, cf, x, yf, hf, B, S, D, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
