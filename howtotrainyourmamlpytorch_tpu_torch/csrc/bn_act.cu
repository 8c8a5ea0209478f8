// Fused batch-statistics batch norm + per-column affine + activation, for
// Hopper (sm_90a), behind a plain C interface loaded with ctypes
// (ops/bn_act.py builds and binds it).
//
// Replaces the TPU kernel howtotrainyourmamlpytorch_tpu/ops/pallas_fused.py
// § _kernel (launched by _fused_call; public entry fused_bn_relu). Same
// function, not the same block structure:
//
//   x is a C-contiguous (R, P) matrix whose columns are independent
//   channels (the port folds the task axis into the channels, P = T*C,
//   R = N*H*W of a channels_last activation). Per column:
//     mean  = sum(x) / R,  var = max(sum(x^2)/R - mean^2, 0)   (f32)
//     scale = gamma * 1/sqrt(var+eps)          rounded to x's dtype
//     shift = beta - mean * inv * gamma        rounded to x's dtype
//     y     = act(round(round(x*scale) + shift))   in x's dtype
//   act: y > 0 ? y : y*slope (slope 0 = relu, 0.1 = leaky, 1 = none).
//
// A TPU grid runs in order, so the Pallas kernel carries its sums in
// scratch from one grid step to the next. Hopper blocks run in no order,
// so the work is three launches, with no float atomics (the result is
// bitwise the same from run to run, which the serving cache relies on):
//   1. stats_partial: each block sums a chunk of rows for 32 columns and
//      writes per-chunk partial sum / sum of squares to scratch;
//   2. finalize: one thread per column folds the partials in a fixed
//      order and writes mean, var and the rounded scale/shift;
//   3. normalize_act: elementwise pass with 16-byte loads and stores.
//
// Rounding: the multiply and the add round to x's dtype separately
// (__fmul_rn / __fadd_rn, never a contracted FMA), as the reference's
// `x * scale + shift` does in bf16.
//
// Bound: the function must read x once and write y once, 2*R*P*sizeof(T)
// bytes, against the card's HBM bandwidth (H100 SXM: 3.35 TB/s). This
// three-pass design reads x twice, about 1.5x that traffic; a single-pass
// design that keeps x on chip between the passes is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to T's precision and back.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

constexpr int kStatCols = 32;  // columns per stats block (threadIdx.x)
constexpr int kStatRows = 8;   // row lanes per stats block (threadIdx.y)

template <typename T>
__global__ void stats_partial(const T* __restrict__ x,
                              float* __restrict__ psum,
                              float* __restrict__ psq, int64_t rows,
                              int cols, int chunk_rows) {
  const int col = blockIdx.x * kStatCols + threadIdx.x;
  const int chunk = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(chunk) * chunk_rows;
  const int64_t r1 = r0 + chunk_rows < rows ? r0 + chunk_rows : rows;
  float s = 0.f, q = 0.f;
  if (col < cols) {
    for (int64_t r = r0 + threadIdx.y; r < r1; r += kStatRows) {
      const float v = to_float<T>(x[r * cols + col]);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  __shared__ float sh_s[kStatRows][kStatCols];
  __shared__ float sh_q[kStatRows][kStatCols];
  sh_s[threadIdx.y][threadIdx.x] = s;
  sh_q[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    for (int k = 1; k < kStatRows; ++k) {
      s += sh_s[k][threadIdx.x];
      q += sh_q[k][threadIdx.x];
    }
    psum[static_cast<int64_t>(chunk) * cols + col] = s;
    psq[static_cast<int64_t>(chunk) * cols + col] = q;
  }
}

template <typename T>
__global__ void finalize(const float* __restrict__ psum,
                         const float* __restrict__ psq, int n_chunks,
                         int cols, float count, float eps,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ mean_out,
                         float* __restrict__ var_out,
                         float* __restrict__ scale_out,
                         float* __restrict__ shift_out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float s = 0.f, q = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    s += psum[static_cast<int64_t>(c) * cols + col];
    q += psq[static_cast<int64_t>(c) * cols + col];
  }
  const float mean = __fdiv_rn(s, count);
  const float mean_sq = __fdiv_rn(q, count);
  const float var = fmaxf(__fsub_rn(mean_sq, __fmul_rn(mean, mean)), 0.f);
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  const float g = gamma[col];
  mean_out[col] = mean;
  var_out[col] = var;
  scale_out[col] = round_to<T>(__fmul_rn(inv, g));
  shift_out[col] = round_to<T>(__fsub_rn(beta[col],
                                         __fmul_rn(__fmul_rn(mean, inv), g)));
}

template <typename T>
__device__ __forceinline__ T affine_act(T xv, float scale, float shift,
                                        float slope) {
  const float t = round_to<T>(__fmul_rn(to_float<T>(xv), scale));
  float o = round_to<T>(__fadd_rn(t, shift));
  if (slope != 1.f && !(o > 0.f)) o = round_to<T>(__fmul_rn(o, slope));
  return from_float<T>(o);
}

// VEC elements per thread per iteration: 16 bytes when VEC*sizeof(T) == 16
// (requires cols % VEC == 0 and 16-byte aligned pointers), else VEC == 1.
template <typename T, int VEC>
__global__ void normalize_act(const T* __restrict__ x, T* __restrict__ y,
                              const float* __restrict__ scale,
                              const float* __restrict__ shift,
                              int64_t n_vec, int cols, float slope) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       v < n_vec; v += stride) {
    const int col0 = static_cast<int>((v * VEC) % cols);
    if constexpr (VEC == 1) {
      y[v] = affine_act<T>(x[v], __ldg(scale + col0), __ldg(shift + col0),
                           slope);
    } else {
      static_assert(VEC * sizeof(T) == 16, "vector path moves 16 bytes");
      const uint4 raw_in = reinterpret_cast<const uint4*>(x)[v];
      const T* in = reinterpret_cast<const T*>(&raw_in);
      uint4 raw_out;
      T* out = reinterpret_cast<T*>(&raw_out);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        out[k] = affine_act<T>(in[k], __ldg(scale + col0 + k),
                               __ldg(shift + col0 + k), slope);
      }
      reinterpret_cast<uint4*>(y)[v] = raw_out;
    }
  }
}

template <typename T>
int launch_all(const void* x, void* y, const float* gamma, const float* beta,
               float* mean, float* var, float* partial, float* coef,
               int64_t rows, int cols, int chunk_rows, float eps, float slope,
               cudaStream_t stream) {
  const int n_chunks = static_cast<int>((rows + chunk_rows - 1) / chunk_rows);
  float* psum = partial;
  float* psq = partial + static_cast<int64_t>(n_chunks) * cols;
  float* scale = coef;
  float* shift = coef + cols;
  cudaError_t err;

  dim3 sblock(kStatCols, kStatRows);
  dim3 sgrid((cols + kStatCols - 1) / kStatCols, n_chunks);
  stats_partial<T><<<sgrid, sblock, 0, stream>>>(
      static_cast<const T*>(x), psum, psq, rows, cols, chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  finalize<T><<<(cols + 255) / 256, 256, 0, stream>>>(
      psum, psq, n_chunks, cols, static_cast<float>(rows), eps, gamma, beta,
      mean, var, scale, shift);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  constexpr int kVec = 16 / sizeof(T);
  const bool vec_ok = cols % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int64_t total = rows * cols;
  const int64_t n_vec = vec_ok ? total / kVec : total;
  const int64_t want = (n_vec + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (blocks > 0) {
    if (vec_ok) {
      normalize_act<T, kVec><<<blocks, 256, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y), scale, shift, n_vec,
          cols, slope);
    } else {
      normalize_act<T, 1><<<blocks, 256, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y), scale, shift, n_vec,
          cols, slope);
    }
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. gamma/beta/mean/var are (cols,) f32;
// partial is (2, ceil(rows/chunk_rows), cols) f32 scratch; coef is
// (2, cols) f32 scratch (scale, shift). Returns 0 or the CUDA error code of
// the first launch that failed; never synchronises.
extern "C" int bn_act_forward(const void* x, void* y, const void* gamma,
                              const void* beta, void* mean, void* var,
                              void* partial, void* coef, long long rows,
                              int cols, int chunk_rows, int dtype, float eps,
                              float slope, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto b = static_cast<const float*>(beta);
  auto m = static_cast<float*>(mean);
  auto v = static_cast<float*>(var);
  auto p = static_cast<float*>(partial);
  auto c = static_cast<float*>(coef);
  if (dtype == 0)
    return launch_all<float>(x, y, g, b, m, v, p, c, rows, cols, chunk_rows,
                             eps, slope, s);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(x, y, g, b, m, v, p, c, rows, cols,
                                     chunk_rows, eps, slope, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
