// Fused batch-statistics batch norm + per-column affine + activation, for
// Hopper (sm_90a), behind a plain C interface loaded with ctypes
// (ops/bn_act.py plans, builds and binds it).
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
//   act: y > 0 ? y : y*slope, slope rounded to x's dtype (0 = relu,
//   0.1 = leaky, 1 = none).
//
// Bound: the function must read x once and write y once, 2*R*P*sizeof(T)
// bytes, against the card's HBM bandwidth (H100 SXM: 3.35 TB/s); its f32
// arithmetic (8 operations per element) is ten times below that. On the
// serving path x is 1.9-135 MB: at the small stages launches and the
// dependencies between passes cost more than the bytes, at the large ones
// the second read of x does.
//
// Design: ONE persistent cooperative launch per call, one block of 384
// threads per SM, the sums in the exact order of the three-pass kernel
// this one replaced (so its outputs are bitwise those of that kernel):
// per column, chunks of max(256, ceil(R/65535)) rows; in a chunk, lane l
// of 8 sums rows l, l+8, ... in order and the chunk's partial is lane 0 +
// lane 1 + ... + lane 7; the column's sum is 0 + chunk 0 + chunk 1 + ...
//   1. Statistics. A task is one chunk x 4 column groups of 16 bytes (one
//      warp: 4 groups x 8 lanes); the tasks are spread evenly over the
//      blocks, so even 10 chunks (R = 2500) keep every SM busy. A block
//      streams its tasks, twelve at a time, through a ring of two 128-row
//      pieces in shared memory, each piece read as whole rows with
//      cp.async while the other is summed. Partials go to scratch,
//      column-major. Grid barrier.
//   2. Finalize: one warp per column, spread over all SMs, pulls its chunk
//      partials into shared memory in one burst and adds them in order;
//      mean, var and the rounded scale/shift. Grid barrier.
//   3. Normalize over balanced row slabs, from the slab's end backwards
//      (the rows this block loaded last, the likeliest still in L2), each
//      128-row piece one TMA bulk copy into the ring; the first piece is
//      requested before the barriers. bf16 takes packed bf16x2 arithmetic,
//      rounding exactly as the f32 path; y is stored evict-first.
// No float atomics anywhere, so two runs are bitwise equal (the serving
// cache relies on it). A P that is not a multiple of the 16-byte vector,
// or an unaligned pointer, takes the same kernel with scalar loads and no
// staging.
//
// Rounding: the multiply and the add round to x's dtype separately
// (__fmul_rn / __fadd_rn, never a contracted FMA), as the reference's
// `x * scale + shift` does in bf16.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 384;   // 12 warps per block, one block per SM
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;       // row lanes of a chunk: part of the sum order
constexpr int kQuad = 4;        // column groups per warp task (4 x 8 lanes)
constexpr int kPiece = 128;     // rows of a piece of x staged at once
constexpr int kStages = 2;      // pieces in the ring
// A staged row of the statistics pass holds the 12 warps' tasks side by
// side, padded by one 16-byte slot so that a warp's 8 row lanes hit
// distinct banks. kStages such pieces form the ring both passes stream x
// through.
constexpr int kRowStride = kWarps * kQuad + 1;
constexpr int kSlotVecs = kPiece * kRowStride;   // 16-byte slots a piece
constexpr int kBarBytes = 16;   // the ring's mbarriers, first in shared memory
static_assert(kStages * 8 <= kBarBytes, "one 8-byte mbarrier a ring slot");
constexpr int kLoads = 8;       // loads in flight per thread (scalar path)
constexpr int kStores = 8;      // rows per step of the normalize loop
constexpr int kMaxDevices = 64;

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

// VEC consecutive elements of one row, moved as one access (16 bytes when
// VEC * sizeof(T) == 16).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const Pack<T, VEC>* src) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    Pack<T, VEC> out;
    memcpy(&out, &raw, 16);
    return out;
  } else {
    return *src;
  }
}

// Store of y, evict-first in L2 so that it does not push out the x that
// the normalize pass is about to read again.
template <typename T, int VEC>
__device__ __forceinline__ void store_y(Pack<T, VEC>* dst,
                                        const Pack<T, VEC>& v) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    uint4 raw;
    memcpy(&raw, &v, 16);
    __stcs(reinterpret_cast<uint4*>(dst), raw);
  } else {
    *dst = v;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const Pack<T, VEC>& v,
                                           float (&s)[VEC], float (&q)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float f = to_float<T>(v.v[k]);
    s[k] += f;
    q[k] = fmaf(f, f, q[k]);
  }
}

struct Params {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  float* mean;   // scratch layout (floats): mean | var | scale | shift |
  float* var;    //   psum (P x n_chunks) | psq (P x n_chunks)
  float* scale;
  float* shift;
  float* psum;    // column-major: column col's chunk partials at
  float* psq;     //   col * n_chunks + c
  long long rows;
  int cols;
  int groups;      // cols / VEC
  int chunk_rows;  // rows per chunk (part of the sum order)
  int n_chunks;
  float eps;
  float slope;
};

template <typename T>
__device__ __forceinline__ T affine_act(T xv, float scale, float shift,
                                        float slope) {
  const float t = round_to<T>(__fmul_rn(to_float<T>(xv), scale));
  float o = round_to<T>(__fadd_rn(t, shift));
  if (slope != 1.f && !(o > 0.f)) o = round_to<T>(__fmul_rn(o, slope));
  return from_float<T>(o);
}

// bf16, two at a time: the product of two bf16 values is exact in f32, and
// their sum is either exact in f32 or its smaller term lies below half a
// bf16 ulp of the larger, so mul.rn/add.rn.bf16x2 round exactly as the f32
// operation rounded to bf16 does (affine_act), at a quarter of the
// instructions.
template <int VEC>
__device__ __forceinline__ Pack<__nv_bfloat16, VEC> affine_act_bf16x2(
    const Pack<__nv_bfloat16, VEC>& v, const __nv_bfloat162 (&sc)[VEC / 2],
    const __nv_bfloat162 (&sh)[VEC / 2], __nv_bfloat162 slope2, bool act) {
  Pack<__nv_bfloat16, VEC> out;
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    __nv_bfloat162 o =
        __hadd2_rn(__hmul2_rn(__halves2bfloat162(v.v[2 * i], v.v[2 * i + 1]),
                              sc[i]),
                   sh[i]);
    if (act) {
      // y > 0 ? y : y * slope, per half (NaN takes the product, as
      // !(y > 0) does).
      const __nv_bfloat162 neg = __hmul2_rn(o, slope2);
      const unsigned keep = __hgt2_mask(o, __float2bfloat162_rn(0.f));
      unsigned ou, nu;
      memcpy(&ou, &o, 4);
      memcpy(&nu, &neg, 4);
      ou = (ou & keep) | (nu & ~keep);
      memcpy(&o, &ou, 4);
    }
    out.v[2 * i] = __low2bfloat16(o);
    out.v[2 * i + 1] = __high2bfloat16(o);
  }
  return out;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    bn_act_persistent(const Params p) {
  using Vec = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = gridDim.x;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int w = t / 32;
  const int wl = t % 32;
  const int cols = p.cols;
  const int64_t groups = p.groups;
  const int64_t rows = p.rows;
  const Vec* x = static_cast<const Vec*>(p.x);   // row r, group g at
  Vec* y = static_cast<Vec*>(p.y);               //   r * groups + g
  // Shared memory: the ring's mbarriers, each warp's lane-fold area, then
  // (vector path) the ring of kStages pieces.
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* fold = reinterpret_cast<float*>(smem + kBarBytes) + w * 32 * 2 * VEC;
  Vec* ring = reinterpret_cast<Vec*>(smem + kBarBytes + kWarps * 32 * 2 * VEC * 4);
  constexpr bool kVector = sizeof(Vec) == 16;
  auto copy16 = [](Vec* dst, const Vec* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::: "memory"); };

  // 1. Statistics. A task is one chunk x kQuad column groups; warp slot
  // `slot` takes one group, and its thread `lane` sums rows lane, lane+8,
  // ... of the chunk in order. The chunk's partial is then lane 0 + lane
  // 1 + ... + lane 7. Block b takes tasks [n*b/nb, n*(b+1)/nb), twelve at
  // a time (a round, one task a warp), so every SM has work even when the
  // chunks are few.
  const int slot = wl / kLanes;
  const int lane8 = wl % kLanes;
  const int64_t quads = (groups + kQuad - 1) / kQuad;
  const int64_t n_tasks = quads * p.n_chunks;
  const int64_t lo = n_tasks * b / nb;
  const int64_t hi = n_tasks * (b + 1) / nb;
  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.f;
  // Fold the 8 lanes in lane order: thread (slot, j) takes values j, j+8,
  // ... of the 2*VEC (sums, then squares); partials are column-major.
  auto fold_task = [&](int64_t task) {
    const int64_t c = task / quads;
    const int64_t g = task % quads * kQuad + slot;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      fold[wl * 2 * VEC + k] = s[k];
      fold[wl * 2 * VEC + VEC + k] = q[k];
      s[k] = q[k] = 0.f;
    }
    __syncwarp();
    if (g < groups) {
      for (int v = lane8; v < 2 * VEC; v += kLanes) {
        const float* src = fold + slot * kLanes * 2 * VEC + v;
        float a = src[0];
#pragma unroll
        for (int l = 1; l < kLanes; ++l) a += src[l * 2 * VEC];
        float* out = v < VEC ? p.psum : p.psq;
        out[(g * VEC + v % VEC) * p.n_chunks + c] = a;
      }
    }
    __syncwarp();
  };
  if constexpr (kVector) {
    // The block streams its rounds through the ring, kPiece rows at a
    // time, the next pieces in flight while this one is summed. Thread t
    // always copies slot t % 48 of a row (one column group of task
    // t % 48 / 4 of the round), so consecutive tasks read whole rows.
    const int pieces = (p.chunk_rows + kPiece - 1) / kPiece;
    const int64_t steps = (hi - lo + kWarps - 1) / kWarps * pieces;
    const int j = t % (kWarps * kQuad);
    constexpr int kRowStep = kThreads / (kWarps * kQuad);
    // Issue side: the source of this thread's column group for the next
    // piece, and the rows its task's chunk has left from there; set once a
    // round, stepped once a piece.
    int i_piece = 0;
    int64_t i_round = 0, i_left = 0;
    const Vec* i_src = x;
    auto issue = [&](int64_t step) {
      if (step < steps) {
        if (i_piece == 0) {
          const int64_t task = lo + i_round * kWarps + j / kQuad;
          const int64_t c0 = task / quads * p.chunk_rows;
          const int64_t g = task % quads * kQuad + j % kQuad;
          i_src = x + c0 * groups + g;
          i_left = task < hi && g < groups ? min(c0 + p.chunk_rows, rows) - c0 : 0;
        }
        const int n = static_cast<int>(min(static_cast<int64_t>(kPiece), i_left));
        Vec* dst = ring + step % kStages * kSlotVecs + j;
        const Vec* src = i_src;
        for (int row = t / (kWarps * kQuad); row < n; row += kRowStep)
          copy16(dst + row * kRowStride, src + row * groups);
        i_src += kPiece * groups;
        i_left -= kPiece;
        if (++i_piece == pieces) {
          i_piece = 0;
          ++i_round;
        }
      }
      commit();
    };
    // Compute side: this warp's task, and the rows its chunk has left.
    int c_piece = 0;
    int64_t task = lo + w, c_left = 0;
    for (int k = 0; k < kStages - 1; ++k) issue(k);
    for (int64_t step = 0; step < steps; ++step) {
      issue(step + kStages - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
      __syncthreads();
      if (c_piece == 0) {
        const int64_t c0 = task / quads * p.chunk_rows;
        c_left = min(c0 + p.chunk_rows, rows) - c0;
      }
      if (task < hi) {
        const int n = static_cast<int>(min(static_cast<int64_t>(kPiece), c_left));
        const Vec* src = ring + step % kStages * kSlotVecs + w * kQuad + slot;
#pragma unroll 4
        for (int r = lane8; r < n; r += kLanes)
          accumulate<T, VEC>(load(src + r * kRowStride), s, q);
        if (c_piece == pieces - 1) fold_task(task);
      }
      c_left -= kPiece;
      if (++c_piece == pieces) {
        c_piece = 0;
        task += kWarps;
      }
      __syncthreads();
    }
  } else {
    for (int64_t task = lo + w; task < hi; task += kWarps) {
      const int64_t g = task % quads * kQuad + slot;
      const int64_t cr0 = task / quads * p.chunk_rows;
      const int64_t cr1 = min(cr0 + p.chunk_rows, rows);
      if (g < groups) {
        for (int64_t r = cr0 + lane8; r < cr1; r += kLanes * kLoads) {
          Vec v[kLoads];
#pragma unroll
          for (int u = 0; u < kLoads; ++u)
            if (r + u * kLanes < cr1) v[u] = x[(r + u * kLanes) * groups + g];
#pragma unroll
          for (int u = 0; u < kLoads; ++u)
            if (r + u * kLanes < cr1) accumulate<T, VEC>(v[u], s, q);
        }
      }
      fold_task(task);
    }
  }

  // The normalize pass walks balanced slabs of rows, [R*b/nb, R*(b+1)/nb)
  // — about the rows this block summed — from the last row down, so that
  // x comes back from L2 where it fits, the last-loaded first. Its first
  // pieces are requested now, to arrive during the barriers.
  const int64_t r0 = rows * b / nb;
  const int64_t r1 = rows * (b + 1) / nb;
  const int64_t prow = min(static_cast<int64_t>(kPiece), kSlotVecs / groups);
  const bool staged = kVector && prow > 0;
  const int64_t n_pieces = staged ? (r1 - r0 + prow - 1) / prow : 0;
  // A piece is one contiguous range of x: one TMA bulk copy, issued by
  // thread 0, completing on the slot's mbarrier.
  auto bar_addr = [&](int i) {
    return static_cast<unsigned>(__cvta_generic_to_shared(bars + i));
  };
  auto issue3 = [&](int64_t k) {
    if (t == 0 && k < n_pieces) {
      const int64_t a = max(r0, r1 - (k + 1) * prow);
      const int64_t e = r1 - k * prow;
      const unsigned bytes = static_cast<unsigned>((e - a) * groups * 16);
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(ring + k % kStages * kSlotVecs));
      // Order the slot's earlier reads (generic proxy) before the
      // async-proxy write.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar_addr(k % kStages)),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(dst),
          "l"(x + a * groups), "r"(bytes), "r"(bar_addr(k % kStages))
          : "memory");
    }
  };
  auto wait3 = [&](int64_t k) {
    const unsigned parity = static_cast<unsigned>(k / kStages) & 1u;
    unsigned done = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar_addr(k % kStages)), "r"(parity)
          : "memory");
    } while (!done);
  };
  if (staged) {
    if (t == 0) {
      for (int i = 0; i < kStages; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr(i))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    issue3(0);   // slot 1 stays free for the finalize
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();

  // 2. Finalize: one warp per column adds the column's chunk partials in
  // chunk order. They are contiguous: the warp copies them, a batch at a
  // time, to its share of ring slot 1 (its fold area on the scalar path)
  // with one burst of cp.async, then every lane walks them.
  {
    const int n = p.n_chunks;
    constexpr int pairs = kVector ? kSlotVecs * 4 / kWarps / 2 : 32 * VEC;
    float* area = kVector
        ? reinterpret_cast<float*>(ring + kSlotVecs) + w * 2 * pairs
        : reinterpret_cast<float*>(smem + kBarBytes) + w * 2 * pairs;
    // Warp-major, so that the columns spread over every SM (each warp's
    // chain is issued by the whole warp).
    for (int col = w * nb + b; col < cols; col += nb * kWarps) {
      const float* src_s = p.psum + static_cast<int64_t>(col) * n;
      const float* src_q = p.psq + static_cast<int64_t>(col) * n;
      float sum = 0.f, sq = 0.f;
      for (int k0 = 0; k0 < n; k0 += pairs) {
        const int m = min(pairs, n - k0);
        __syncwarp();
        for (int i = wl; i < m; i += 32) {
          const unsigned ds =
              static_cast<unsigned>(__cvta_generic_to_shared(area + i));
          const unsigned dq = static_cast<unsigned>(
              __cvta_generic_to_shared(area + pairs + i));
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(ds),
                       "l"(src_s + k0 + i)
                       : "memory");
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dq),
                       "l"(src_q + k0 + i)
                       : "memory");
        }
        commit();
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncwarp();
#pragma unroll 8
        for (int i = 0; i < m; ++i) {
          sum += area[i];
          sq += area[pairs + i];
        }
      }
      if (wl == 0) {
        const float count = static_cast<float>(p.rows);
        const float mean = __fdiv_rn(sum, count);
        const float mean_sq = __fdiv_rn(sq, count);
        const float var =
            fmaxf(__fsub_rn(mean_sq, __fmul_rn(mean, mean)), 0.f);
        const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps)));
        const float gm = p.gamma[col];
        p.mean[col] = mean;
        p.var[col] = var;
        p.scale[col] = round_to<T>(__fmul_rn(inv, gm));
        p.shift[col] = round_to<T>(
            __fsub_rn(p.beta[col], __fmul_rn(__fmul_rn(mean, inv), gm)));
      }
    }
  }
  grid.sync();
  if (staged) issue3(1);

  // 3. Normalize + activation.
  const int gthreads = static_cast<int>(min(groups, static_cast<int64_t>(kThreads)));
  const int lanes = kThreads / gthreads;
  const int gi = t % gthreads;
  const int lane = t / gthreads;
  const float slope = round_to<T>(p.slope);
  constexpr bool kPacked = std::is_same<T, __nv_bfloat16>::value && VEC % 2 == 0;
  auto apply = [&](const Vec& v, const float (&sc)[VEC],
                   const float (&sh)[VEC]) {
    if constexpr (kPacked) {
      __nv_bfloat162 sc2[VEC / 2], sh2[VEC / 2];
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        sc2[i] = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
        sh2[i] = __floats2bfloat162_rn(sh[2 * i], sh[2 * i + 1]);
      }
      return affine_act_bf16x2<VEC>(v, sc2, sh2,
                                    __float2bfloat162_rn(slope), slope != 1.f);
    } else {
      Vec o;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o.v[k] = affine_act<T>(v.v[k], sc[k], sh[k], slope);
      return o;
    }
  };
  // Plain loads of scale/shift: every warp of the SM reads the same ones,
  // so L1 (invalidated by the grid barrier) serves all but the first.
  auto coef = [&](int64_t g, float (&sc)[VEC], float (&sh)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sc[k] = p.scale[g * VEC + k];
      sh[k] = p.shift[g * VEC + k];
    }
  };
  if (staged) {
    // The ring, pieces of prow rows from the end of the slab backwards.
    for (int64_t k = 0; k < n_pieces; ++k) {
      wait3(k);
      const int64_t a = max(r0, r1 - (k + 1) * prow);
      const int64_t e = r1 - k * prow;
      const Vec* src = ring + k % kStages * kSlotVecs;
      if (lane < lanes) {
        for (int64_t g = gi; g < groups; g += gthreads) {
          float sc[VEC], sh[VEC];
          coef(g, sc, sh);
#pragma unroll 4
          for (int64_t r = lane; r < e - a; r += lanes)
            store_y(y + (a + r) * groups + g, apply(load(src + r * groups + g), sc, sh));
        }
      }
      __syncthreads();
      issue3(k + kStages);
    }
  } else if (lane < lanes && r1 - r0 > lane) {
    for (int64_t g = gi; g < groups; g += gthreads) {
      float sc[VEC], sh[VEC];
      coef(g, sc, sh);
      const int64_t last = r1 - 1 - (r1 - 1 - r0 - lane) % lanes;
      for (int64_t r = last; r >= r0 + lane; r -= kStores * lanes) {
        Vec v[kStores];
#pragma unroll
        for (int u = 0; u < kStores; ++u)
          if (r - u * lanes >= r0) v[u] = load(x + (r - u * lanes) * groups + g);
#pragma unroll
        for (int u = 0; u < kStores; ++u)
          if (r - u * lanes >= r0)
            store_y(y + (r - u * lanes) * groups + g, apply(v[u], sc, sh));
      }
    }
  }
}

template <typename T, int VEC>
int launch(Params p, int blocks, int smem_bytes, cudaStream_t stream) {
  auto fn = bn_act_persistent<T, VEC>;
  // Dynamic shared memory above 48 KB needs an opt-in, once per device.
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) {
      cudaGetLastError();  // leave no sticky error for the next caller
      return static_cast<int>(err);
    }
    opted_in[dev] = true;
  }
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                    dim3(blocks), dim3(kThreads), args,
                                    static_cast<size_t>(smem_bytes), stream);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// x: (rows, cols) C-contiguous, dtype 0 = float32, 1 = bfloat16; y: the
// same. gamma/beta: (cols,) f32. scratch: 4*cols + 2*n_chunks*cols f32
// (mean | var | scale | shift | per-chunk partial sums | partial squares,
// both column-major).
// The launch plan (ops/bn_act.py § plan): vec elements per access (1, or
// 16 bytes' worth, which needs cols % vec == 0 and 16-byte aligned x and
// y); blocks co-resident blocks of 384 threads; chunks of chunk_rows rows,
// n_chunks of them; smem_bytes of dynamic shared memory: 16 bytes of
// mbarriers, 12 x 32 x 2*vec floats, plus a ring of 2 x 128 x 49 16-byte
// slots for the vector path. Returns 0 or the CUDA error code of the
// refused launch; never synchronises.
extern "C" int bn_act_forward(const void* x, void* y, const void* gamma,
                              const void* beta, void* scratch, long long rows,
                              int cols, int dtype, float eps, float slope,
                              int vec, int blocks, int chunk_rows,
                              int n_chunks, int smem_bytes, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const int wide = 16 / itemsize;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // Shared memory: the 12 warps' lane folds (32 x 2*vec floats each) and,
  // for the vector path, kPiece staged rows of kRowStride 16-byte slots.
  const int want_smem = kBarBytes + kWarps * 32 * 2 * vec * 4 +
                        (vec == 1 ? 0 : kStages * kSlotVecs * 16);
  if ((dtype != 0 && dtype != 1) || rows < 1 || cols < 1 || blocks < 1 ||
      (vec != 1 && (vec != wide || cols % vec != 0 || !aligned)) ||
      chunk_rows < 1 || n_chunks < 1 ||
      static_cast<long long>(n_chunks - 1) * chunk_rows >= rows ||
      static_cast<long long>(n_chunks) * chunk_rows < rows ||
      smem_bytes != want_smem)
    return static_cast<int>(cudaErrorInvalidValue);
  float* f = static_cast<float*>(scratch);
  Params p;
  p.x = x;
  p.y = y;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.mean = f;
  p.var = f + cols;
  p.scale = f + 2 * static_cast<int64_t>(cols);
  p.shift = f + 3 * static_cast<int64_t>(cols);
  p.psum = f + 4 * static_cast<int64_t>(cols);
  p.psq = p.psum + static_cast<int64_t>(n_chunks) * cols;
  p.rows = rows;
  p.cols = cols;
  p.groups = cols / vec;
  p.chunk_rows = chunk_rows;
  p.n_chunks = n_chunks;
  p.eps = eps;
  p.slope = slope;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec == 1 ? launch<float, 1>(p, blocks, smem_bytes, s)
                    : launch<float, 4>(p, blocks, smem_bytes, s);
  return vec == 1 ? launch<__nv_bfloat16, 1>(p, blocks, smem_bytes, s)
                  : launch<__nv_bfloat16, 8>(p, blocks, smem_bytes, s);
}
