// K1: fused masked softmax dice + cross-entropy over one or two regions,
// forward and backward, for Hopper.
//
// Replaces chap_tpu/ops/fused_losses.py::masked_seg_stats -> _stats_kernel
// (the Pallas kernel, :36-72, launched at :119) and its XLA custom-VJP
// backward ``_bwd`` (:159-179), together with the two calls of it that
// chap_tpu/losses/mix.py makes on ``mask`` and ``1 - mask`` over the same
// logits.
//
// What it computes, for logits [B, C, HW] (the spatial axes flattened;
// fp32, bf16 or fp16), p = softmax over C and R in {1, 2} regions: region
// r has labels l_r [B, HW] (uint8, int32 or int64, both regions one type)
// and weight w_r, w_1 = mask (fp32 {0, 1}, or 1 everywhere when there is
// no mask, R = 1 only) and w_2 = 1 - mask; t_r = one_hot(l_r), a label
// outside [0, C) matching no class:
//   I_rc = sum w_r p_c t_rc,  Z_rc = sum w_r p_c^2,  Y_rc = sum w_r t_rc,
//   CE_rc = sum w_r t_rc (-log p_c),
//   dice_r = mean_c 1 - (2 I_rc + s) / (Z_rc + Y_rc + s),
//   ce_r = sum_c CE_rc / (sum_c Y_rc + eps);
// the statistics go out as [R, 4, C_PAD] fp32 (zeros past C) followed by
// [R, 2] (dice, ce). The backward writes d/dlogits of
// sum_r g_dice_r dice_r + g_ce_r ce_r in the logits' dtype, from the saved
// statistics and the incoming grads (device pointers), also where a label
// lies outside [0, C): such a pixel has no CE term, so it gets no CE
// gradient (chap_tpu's ``_bwd`` keeps m p / (sum Y + eps) there).
//
// What bounds it on the H100: bytes. Tens of flops a pixel against 3-18
// bytes (bf16 logits of 2 classes and uint8 labels: 5 bytes). At the LA
// patch [1, 2, 112, 112, 80] with R = 2, int32 labels and an fp32 mask, a
// forward reads 16.1 MB at bf16 logits (4.8 us at 3.35 TB/s); the
// supervised callers' BraTS batch [4, 2, 96^3], bf16 logits, uint8 labels
// and no mask, 17.7 MB (5.3 us). The Triton K1 this file replaces ran
// its bf16 build at 15-24% of that bound (PERF.md §6); the design:
//   * the grid is (chunk of the spatial plane, batch row): a block takes
//     one base pointer per class plane and walks its chunk with no
//     division (the Triton kernel split a flat pixel index into row and
//     plane offset with a 64-bit division a tile);
//   * each thread reads 16 bytes of every class plane at once (4 fp32 or 8
//     bf16 / fp16 pixels) and the same pixels' labels and mask as one to
//     four vector loads, and the backward stores its gradient as 16-byte
//     stores; a plane length that is not a multiple of those pixels, or a
//     pointer not aligned to them (a view at an odd storage offset), takes
//     a scalar path, pixel by pixel;
//   * the labels are read in the caller's dtype (a template parameter) and
//     the mask may be absent (R = 1), so no widened copy and no all-ones
//     mask is made for the kernel;
//   * forward, two launches: each block of k1_stats reduces its chunk in
//     registers, then with warp shuffles and in shared memory into one
//     column of partial sums (at most 256 blocks); k1_total, one block,
//     sums the columns in a fixed order and composes dice and ce on the
//     device. No float atomics and no state kept between calls, so two
//     calls are bit-identical; zero rows launch one block that sums
//     nothing, so the statistics are zeros. (A last-block pass behind an
//     atomic ticket took as long as the second kernel, 2-4 us, and a failed
//     launch would leave its ticket wrong for every later call.) R and the
//     mask's presence are compile-time in k1_stats: past 16-byte loads, the
//     per-pixel instructions bound a bf16 forward of two classes;
//   * backward, one launch for any R, one vector a thread: each thread
//     forms every region's per-class coefficients from the statistics and
//     grads in registers (cached loads, no barrier), recomputes p and
//     writes one gradient, the sum over the regions;
//   * C = 2 and C = 4 (the configs' classes) are compile-time, their
//     probabilities and sums in registers; any other C takes a general
//     kernel that loops over the classes with scalar loads;
//   * no tensor cores: there is no matrix product.
// Measured by tools/time_k1.py on an H100 80GB HBM3 at 700 W: the bf16
// rows at 0.97-1.84x their bound but the ACAL forward (2.35x: the forward's
// fixed cost, about 5.5 us), the Triton kernel's at 4.2-7.0x (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 512;        // a forward block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2;   // resident forward blocks an SM
constexpr int kMaxRows = 256;        // forward blocks: the last block's lanes read 8 rows
constexpr int kGradThreads = 256;    // a backward block: one vector a thread
constexpr int kMaxVec = 8;           // pixels in 16 bytes of the narrowest logits

struct Geom {
  int hw;          // pixels of one class plane
  int chunk;       // pixels a block walks (a multiple of the vector width)
  int regions;     // R
  int nc;          // C
  int c_pad;       // the statistics' class stride
  int ncol;        // partial sums a block writes: R * 4 * C
  int vec;         // 16-byte loads and stores allowed
  int has_mask;
  int stream;      // the backward's loads evict-first: its traffic outgrows L2
  float smooth, eps;
};

// a read-only load, or with kStream one marked evict-first (__ldcs). The
// backward reads its inputs once: where its inputs and gradient together
// pass 3/4 of L2 (48-85 MB on the H100's 50 MB), evict-first leaves L2 to
// the gradient it writes (1.4-2.1 us faster a launch at BraTS and the 2D
// zoo); below it (17-38 MB) the inputs a caller just read are kept
// (evict-first cost 0.9-2.1 us at ACAL and LA; tools/k1_variants.py)
template <bool kStream, typename V>
__device__ __forceinline__ V read(const V* p) {
  if constexpr (kStream) return __ldcs(p);
  else return __ldg(p);
}

// n 32-bit words read as one to four 16-byte loads, or one 8- or 4-byte load
template <int N>
struct Words {
  unsigned w[N];
  template <bool kStream = false>
  __device__ __forceinline__ void load(const void* p) {
    if constexpr (N >= 4) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        const uint4 q = read<kStream>(static_cast<const uint4*>(p) + k);
        w[4 * k] = q.x; w[4 * k + 1] = q.y; w[4 * k + 2] = q.z; w[4 * k + 3] = q.w;
      }
    } else if constexpr (N == 2) {
      const uint2 q = read<kStream>(static_cast<const uint2*>(p));
      w[0] = q.x; w[1] = q.y;
    } else {
      w[0] = read<kStream>(static_cast<const unsigned*>(p));
    }
  }
};

// How K1 reads and writes one logits type: kV pixels in 16 bytes.
template <typename T>
struct Logit;

template <>
struct Logit<float> {
  static constexpr int kV = 4;
  static __device__ __forceinline__ float one(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float at(const Words<4>& u, int j) {
    return __uint_as_float(u.w[j]);
  }
  static __device__ __forceinline__ void put(float* p, float g) { *p = g; }
  static __device__ __forceinline__ void put_vec(float* p, const float (&g)[kV]) {
    *reinterpret_cast<float4*>(p) = make_float4(g[0], g[1], g[2], g[3]);
  }
};

template <>
struct Logit<__nv_bfloat16> {
  static constexpr int kV = 8;
  static __device__ __forceinline__ float one(const __nv_bfloat16* p) {
    return __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ float at(const Words<4>& u, int j) {
    const unsigned w = u.w[j >> 1];
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ unsigned bits(float g) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(g));
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float g) {
    *p = __float2bfloat16_rn(g);
  }
  static __device__ __forceinline__ void put_vec(__nv_bfloat16* p, const float (&g)[kV]) {
    uint4 q;
    q.x = bits(g[0]) | (bits(g[1]) << 16); q.y = bits(g[2]) | (bits(g[3]) << 16);
    q.z = bits(g[4]) | (bits(g[5]) << 16); q.w = bits(g[6]) | (bits(g[7]) << 16);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <>
struct Logit<__half> {
  static constexpr int kV = 8;
  static __device__ __forceinline__ float one(const __half* p) { return __half2float(p[0]); }
  static __device__ __forceinline__ float at(const Words<4>& u, int j) {
    const unsigned w = u.w[j >> 1];
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>((j & 1) ? (w >> 16) : (w & 0xffffu))));
  }
  static __device__ __forceinline__ unsigned bits(float g) {
    return __half_as_ushort(__float2half_rn(g));
  }
  static __device__ __forceinline__ void put(__half* p, float g) { *p = __float2half_rn(g); }
  static __device__ __forceinline__ void put_vec(__half* p, const float (&g)[kV]) {
    uint4 q;
    q.x = bits(g[0]) | (bits(g[1]) << 16); q.y = bits(g[2]) | (bits(g[3]) << 16);
    q.z = bits(g[4]) | (bits(g[5]) << 16); q.w = bits(g[6]) | (bits(g[7]) << 16);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// A label as a class index in [0, nc), or -1 when it lies outside
template <typename L>
__device__ __forceinline__ int to_class(L v, int nc) {
  if constexpr (static_cast<L>(-1) < static_cast<L>(0))
    return v >= 0 && static_cast<long long>(v) < nc ? static_cast<int>(v) : -1;
  else
    return static_cast<unsigned long long>(v) < static_cast<unsigned long long>(nc)
               ? static_cast<int>(v) : -1;
}

// pixel j's label from kV labels of type L read as words
template <typename L, int N>
__device__ __forceinline__ int label_at(const Words<N>& u, int j, int nc) {
  if constexpr (sizeof(L) == 1) {
    return to_class<uint8_t>(static_cast<uint8_t>(u.w[j >> 2] >> (8 * (j & 3))), nc);
  } else if constexpr (sizeof(L) == 4) {
    return to_class<int>(static_cast<int>(u.w[j]), nc);
  } else {
    const unsigned long long v =
        (static_cast<unsigned long long>(u.w[2 * j + 1]) << 32) | u.w[2 * j];
    return to_class<long long>(static_cast<long long>(v), nc);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// p and log p of one pixel's C logits
template <int C>
__device__ __forceinline__ void softmax(const float (&x)[C], float (&p)[C], float (&logp)[C]) {
  float mx = x[0];
#pragma unroll
  for (int c = 1; c < C; ++c) mx = fmaxf(mx, x[c]);
  float den = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    logp[c] = x[c] - mx;
    p[c] = __expf(logp[c]);
    den += p[c];
  }
  const float inv = __fdividef(1.0f, den), lden = __logf(den);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    p[c] *= inv;
    logp[c] -= lden;
  }
}

// I, Z, Y, CE per class of each region, in registers
template <int C>
struct Sums {
  float v[2][4][C];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c) v[r][q][c] = 0.0f;
  }
  __device__ __forceinline__ void add(int r, const float (&p)[C], const float (&logp)[C],
                                      int l, float w) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wt = l == c ? w : 0.0f;
      v[r][0][c] = fmaf(wt, p[c], v[r][0][c]);
      v[r][1][c] = fmaf(w * p[c], p[c], v[r][1][c]);
      v[r][2][c] += wt;
      v[r][3][c] = fmaf(-wt, logp[c], v[r][3][c]);
    }
  }
};

// The partial columns (part is column-major, [R * 4 * C][rows], so a warp
// reads a column's rows in whole lines) summed in a fixed order into out's
// [R, 4, c_pad] statistics (a warp a column, each lane a fixed set of rows,
// then the warp's fixed butterfly); then warp r composes region r's (dice,
// ce) after them, a lane a class. One block.
__device__ void total(const float* part, int rows, const Geom& g, float* out) {
  __shared__ float tot[kThreads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_stats = g.regions * 4 * g.c_pad;
  for (int col = warp; col < n_stats; col += kWarps) {
    const int c = col % g.c_pad;
    float s = 0.0f;
    if (c < g.nc) {
      const float* src = part + static_cast<size_t>((col / g.c_pad) * g.nc + c) * rows;
#pragma unroll 8
      for (int row = lane; row < rows; row += 32) s += __ldcg(src + row);
      s = warp_sum(s);
    }
    if (lane == 0) {
      out[col] = s;
      if (n_stats <= kThreads) tot[col] = s;
    }
  }
  __syncthreads();
  if (warp < g.regions) {
    const float* st = (n_stats <= kThreads ? tot : out) + warp * 4 * g.c_pad;
    float dice = 0.0f, ce = 0.0f, y = 0.0f;
    for (int c = lane; c < g.nc; c += 32) {
      const float yc = st[2 * g.c_pad + c];
      dice += 1.0f - (2.0f * st[c] + g.smooth) / (st[g.c_pad + c] + yc + g.smooth);
      ce += st[3 * g.c_pad + c];
      y += yc;
    }
    dice = warp_sum(dice);
    ce = warp_sum(ce);
    y = warp_sum(y);
    if (lane == 0) {
      out[n_stats + 2 * warp] = dice / g.nc;
      out[n_stats + 2 * warp + 1] = ce / (y + g.eps);
    }
  }
}

// the forward's second kernel: one block sums the first's partial columns
__global__ void __launch_bounds__(kThreads)
k1_total(const float* __restrict__ part, int rows, float* __restrict__ out, const Geom g) {
  total(part, rows, g, out);
}

// grid (chunks, B), block kThreads; part: [R * 4 * C, chunks * B] scratch.
// R and the mask's presence are compile-time here: the per-pixel work is
// what bounds a bf16 forward of two classes once its loads are 16 bytes.
template <typename T, typename L, int C, int R, bool MASK>
__global__ void __launch_bounds__(kThreads)
k1_stats(const T* __restrict__ logits, const L* __restrict__ lab1,
         const L* __restrict__ lab2, const float* __restrict__ mask,
         float* __restrict__ part, const Geom g) {
  constexpr int V = Logit<T>::kV;
  const size_t row = static_cast<size_t>(blockIdx.y) * g.hw;
  const T* lg = logits + row * C;
  const int start = blockIdx.x * g.chunk, end = min(start + g.chunk, g.hw);
  constexpr bool two = R == 2;
  Sums<C> s;
  s.zero();
  float x[C], p[C], logp[C];
  if (g.vec) {
    for (int i = start + threadIdx.x * V; i < end; i += kThreads * V) {
      Words<4> xv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) xv[c].load(lg + static_cast<size_t>(c) * g.hw + i);
      Words<V * sizeof(L) / 4> l1, l2;
      Words<V> m;
      l1.load(lab1 + row + i);
      if (two) l2.load(lab2 + row + i);
      if (MASK) m.load(mask + row + i);
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int c = 0; c < C; ++c) x[c] = Logit<T>::at(xv[c], j);
        softmax<C>(x, p, logp);
        const float w = MASK ? __uint_as_float(m.w[j]) : 1.0f;
        s.add(0, p, logp, label_at<L>(l1, j, C), w);
        if (two) s.add(1, p, logp, label_at<L>(l2, j, C), 1.0f - w);
      }
    }
  } else {
    for (int i = start + threadIdx.x; i < end; i += kThreads) {
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = Logit<T>::one(lg + static_cast<size_t>(c) * g.hw + i);
      softmax<C>(x, p, logp);
      const float w = MASK ? mask[row + i] : 1.0f;
      s.add(0, p, logp, to_class<L>(lab1[row + i], C), w);
      if (two) s.add(1, p, logp, to_class<L>(lab2[row + i], C), 1.0f - w);
    }
  }
  // this block's row of partial sums: warps, then shared memory, in order
  __shared__ float red[kWarps][2 * 4 * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r >= R) break;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = warp_sum(s.v[r][q][c]);
        if (lane == 0) red[warp][(r * 4 + q) * C + c] = v;
      }
  }
  __syncthreads();
  const size_t prow = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x < g.ncol) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][threadIdx.x];
    part[threadIdx.x * gridDim.x * gridDim.y + prow] = t;
  }
}

// Any other C: one class at a time, scalar loads, each pixel's softmax
// taken again for every class.
template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
k1_stats_any(const T* __restrict__ logits, const L* __restrict__ lab1,
             const L* __restrict__ lab2, const float* __restrict__ mask,
             float* __restrict__ part, const Geom g) {
  const size_t row = static_cast<size_t>(blockIdx.y) * g.hw;
  const T* lg = logits + row * g.nc;
  const int start = blockIdx.x * g.chunk, end = min(start + g.chunk, g.hw);
  const bool two = g.regions == 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t prow = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  __shared__ float red[kWarps][8];
  for (int c = 0; c < g.nc; ++c) {
    float a[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int i = start + threadIdx.x; i < end; i += kThreads) {
      float mx = -INFINITY;
      for (int k = 0; k < g.nc; ++k)
        mx = fmaxf(mx, Logit<T>::one(lg + static_cast<size_t>(k) * g.hw + i));
      float den = 0.0f;
      for (int k = 0; k < g.nc; ++k)
        den += __expf(Logit<T>::one(lg + static_cast<size_t>(k) * g.hw + i) - mx);
      const float xc = Logit<T>::one(lg + static_cast<size_t>(c) * g.hw + i) - mx;
      const float p = __expf(xc) * __fdividef(1.0f, den), logp = xc - __logf(den);
      const float w = g.has_mask ? mask[row + i] : 1.0f;
      const int l[2] = {to_class<L>(lab1[row + i], g.nc),
                        two ? to_class<L>(lab2[row + i], g.nc) : -1};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float wr = r == 0 ? w : (two ? 1.0f - w : 0.0f);
        const float wt = l[r] == c ? wr : 0.0f;
        a[r][0] = fmaf(wt, p, a[r][0]);
        a[r][1] = fmaf(wr * p, p, a[r][1]);
        a[r][2] += wt;
        a[r][3] = fmaf(-wt, logp, a[r][3]);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v = warp_sum(a[k / 4][k % 4]);
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < 4 * g.regions) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][threadIdx.x];
      part[(threadIdx.x * g.nc + c) * gridDim.x * gridDim.y + prow] = t;
    }
    __syncthreads();
  }
}

// d/dlogits of one pixel into g[C]: dl/dp = sum_r w_r (a_r t_r + b_r p),
// g = p (dl/dp - <dl/dp, p>) + sum_r k_r w_r [l_r in range] (p - t_r)
template <int C>
__device__ __forceinline__ void pixel_grad(const float (&x)[C], const float (&a)[2][C],
                                           const float (&b)[2][C], const float (&k)[2],
                                           int l1, int l2, float w, bool two,
                                           float (&g)[C]) {
  float p[C], logp[C];
  softmax<C>(x, p, logp);
  const float k1 = l1 >= 0 ? k[0] * w : 0.0f;
  const float w2 = 1.0f - w, k2 = two && l2 >= 0 ? k[1] * w2 : 0.0f;
  float inner = 0.0f, dce[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float dl = w * fmaf(b[0][c], p[c], l1 == c ? a[0][c] : 0.0f);
    dce[c] = k1 * (p[c] - (l1 == c ? 1.0f : 0.0f));
    if (two) {
      dl = fmaf(w2, fmaf(b[1][c], p[c], l2 == c ? a[1][c] : 0.0f), dl);
      dce[c] = fmaf(k2, p[c] - (l2 == c ? 1.0f : 0.0f), dce[c]);
    }
    g[c] = dl;
    inner = fmaf(dl, p[c], inner);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = fmaf(p[c], g[c] - inner, dce[c]);
}

// Region r's dL/dI (a) and dL/dp coefficient of p (b) for class c, from its
// statistics st = stats + r * 4 * c_pad and its incoming dice grad (gd, the
// grad times 2 / C): dice_r = mean_c 1 - (2 I_c + s) / (Z_c + Y_c + s).
__device__ __forceinline__ void class_coef(const float* st, float gd, const Geom& g, int c,
                                           float& a, float& b) {
  const float inv =
      __fdividef(1.0f, __ldg(st + g.c_pad + c) + __ldg(st + 2 * g.c_pad + c) + g.smooth);
  a = -gd * inv;
  b = gd * (2.0f * __ldg(st + c) + g.smooth) * inv * inv;
}

// Region r's CE scale over its nc classes: g_ce / (sum_c Y_c + eps).
__device__ __forceinline__ float ce_scale(const float* st, const float* g_ce, const Geom& g,
                                          int nc) {
  float y = 0.0f;
#pragma unroll
  for (int c = 0; c < nc; ++c) y += __ldg(st + 2 * g.c_pad + c);
  return __fdividef(__ldg(g_ce), y + g.eps);
}

// Region r's coefficients in this thread's registers: the statistics and
// grads are a few cached loads a thread, so no block waits on a barrier for
// them.
template <int C>
__device__ __forceinline__ void coefs(const float* stats, const float* g_dice,
                                      const float* g_ce, const Geom& g, int r,
                                      float (&a)[C], float (&b)[C], float& k) {
  const float* st = stats + r * 4 * g.c_pad;
  const float gd = __ldg(g_dice) * (2.0f / C);
#pragma unroll
  for (int c = 0; c < C; ++c) class_coef(st, gd, g, c, a[c], b[c]);
  k = ce_scale(st, g_ce, g, C);
}

// grid (hw / (kGradThreads * V), B), block kGradThreads: one vector of V
// pixels a thread (one pixel on the scalar path). The coefficients come
// first: their loads, cached after a block's first warp, return ahead of the
// pixels' (formed after them, they cost 0.4-1.3 us more a launch on the
// H100 at the small shapes, tools/k1_variants.py)
template <typename T, typename L, int C>
__global__ void __launch_bounds__(kGradThreads)
k1_grad(const T* __restrict__ logits, const L* __restrict__ lab1,
        const L* __restrict__ lab2, const float* __restrict__ mask,
        const float* __restrict__ stats, const float* __restrict__ gd1,
        const float* __restrict__ gc1, const float* __restrict__ gd2,
        const float* __restrict__ gc2, T* __restrict__ grad, const Geom g) {
  constexpr int V = Logit<T>::kV;
  const int i = blockIdx.x * g.chunk + threadIdx.x * (g.vec ? V : 1);
  if (i >= g.hw) return;
  const bool two = g.regions == 2;
  const size_t row = static_cast<size_t>(blockIdx.y) * g.hw;
  const T* lg = logits + row * C;
  T* gr = grad + row * C;
  float a[2][C], b[2][C], k[2], d[C];
  coefs<C>(stats, gd1, gc1, g, 0, a[0], b[0], k[0]);
  if (two) {
    coefs<C>(stats, gd2, gc2, g, 1, a[1], b[1], k[1]);
  } else {
    k[1] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) a[1][c] = b[1][c] = 0.0f;
  }
  Words<4> xv[C];
  Words<V * sizeof(L) / 4> l1, l2;
  Words<V> m;
  float x[C], w = 1.0f;
  int c1 = -1, c2 = -1;
  auto load = [&](auto stream) {
    constexpr bool kStream = decltype(stream)::value;
#pragma unroll
    for (int c = 0; c < C; ++c)
      xv[c].template load<kStream>(lg + static_cast<size_t>(c) * g.hw + i);
    l1.template load<kStream>(lab1 + row + i);
    if (two) l2.template load<kStream>(lab2 + row + i);
    if (g.has_mask) m.template load<kStream>(mask + row + i);
  };
  if (g.vec && g.stream) {
    load(std::true_type{});
  } else if (g.vec) {
    load(std::false_type{});
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = Logit<T>::one(lg + static_cast<size_t>(c) * g.hw + i);
    c1 = to_class<L>(lab1[row + i], C);
    if (two) c2 = to_class<L>(lab2[row + i], C);
    if (g.has_mask) w = mask[row + i];
  }
  if (g.vec) {
    float out[C][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = Logit<T>::at(xv[c], j);
      pixel_grad<C>(x, a, b, k, label_at<L>(l1, j, C), two ? label_at<L>(l2, j, C) : -1,
                    g.has_mask ? __uint_as_float(m.w[j]) : 1.0f, two, d);
#pragma unroll
      for (int c = 0; c < C; ++c) out[c][j] = d[c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) Logit<T>::put_vec(gr + static_cast<size_t>(c) * g.hw + i, out[c]);
  } else {
    pixel_grad<C>(x, a, b, k, c1, c2, w, two, d);
#pragma unroll
    for (int c = 0; c < C; ++c) Logit<T>::put(gr + static_cast<size_t>(c) * g.hw + i, d[c]);
  }
}

// Any other C: three passes over the classes a pixel, scalar loads, each
// class's coefficients formed where they are used.
template <typename T, typename L>
__global__ void __launch_bounds__(kGradThreads)
k1_grad_any(const T* __restrict__ logits, const L* __restrict__ lab1,
            const L* __restrict__ lab2, const float* __restrict__ mask,
            const float* __restrict__ stats, const float* __restrict__ gd1,
            const float* __restrict__ gc1, const float* __restrict__ gd2,
            const float* __restrict__ gc2, T* __restrict__ grad, const Geom g) {
  const int i = blockIdx.x * g.chunk + threadIdx.x;
  if (i >= g.hw) return;
  const bool two = g.regions == 2;
  const size_t row = static_cast<size_t>(blockIdx.y) * g.hw;
  const T* lg = logits + row * g.nc;
  T* gr = grad + row * g.nc;
  const float* st2 = stats + 4 * g.c_pad;
  const float gda = __ldg(gd1) * (2.0f / g.nc), gdb = two ? __ldg(gd2) * (2.0f / g.nc) : 0.0f;
  float mx = -INFINITY;
  for (int c = 0; c < g.nc; ++c)
    mx = fmaxf(mx, Logit<T>::one(lg + static_cast<size_t>(c) * g.hw + i));
  float den = 0.0f;
  for (int c = 0; c < g.nc; ++c)
    den += __expf(Logit<T>::one(lg + static_cast<size_t>(c) * g.hw + i) - mx);
  const float inv = __fdividef(1.0f, den);
  const float w = g.has_mask ? mask[row + i] : 1.0f, w2 = two ? 1.0f - w : 0.0f;
  const int l1 = to_class<L>(lab1[row + i], g.nc);
  const int l2 = two ? to_class<L>(lab2[row + i], g.nc) : -1;
  const float k1 = l1 >= 0 ? ce_scale(stats, gc1, g, g.nc) * w : 0.0f;
  const float k2 = l2 >= 0 ? ce_scale(st2, gc2, g, g.nc) * w2 : 0.0f;
  float inner = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int c = 0; c < g.nc; ++c) {
      const float p = __expf(Logit<T>::one(lg + static_cast<size_t>(c) * g.hw + i) - mx) * inv;
      float a1, b1, a2 = 0.0f, b2 = 0.0f;
      class_coef(stats, gda, g, c, a1, b1);
      if (two) class_coef(st2, gdb, g, c, a2, b2);
      const float dl = fmaf(w2, fmaf(b2, p, l2 == c ? a2 : 0.0f),
                            w * fmaf(b1, p, l1 == c ? a1 : 0.0f));
      if (pass == 0) {
        inner = fmaf(dl, p, inner);
      } else {
        const float dce = fmaf(k2, p - (l2 == c ? 1.0f : 0.0f),
                               k1 * (p - (l1 == c ? 1.0f : 0.0f)));
        Logit<T>::put(gr + static_cast<size_t>(c) * g.hw + i, fmaf(p, dl - inner, dce));
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// the chunk a forward block walks: about target_blocks blocks in all, each
// thread at least one vector, a multiple of the vector width
int chunk_for(int batch, int hw, int v, int target_blocks) {
  if (hw <= 0) return v;
  int per_row = std::max(1, target_blocks / std::max(batch, 1));
  per_row = std::min(per_row, (hw + kThreads * v - 1) / (kThreads * v));
  const int chunk = (hw + per_row - 1) / per_row;
  return (chunk + v - 1) / v * v;
}

// resident blocks of `kernel` on one SM, at most kMaxBlocksPerSm; asked of
// the runtime once per kernel (slot: one of a template's kernels)
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int* slot) {
  if (*slot == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) != cudaSuccess)
      n = 1;
    *slot = std::max(1, std::min(n, kMaxBlocksPerSm));
  }
  return *slot;
}

int kernel_slot(int nc) { return nc == 2 ? 0 : nc == 4 ? 1 : 2; }

// the forward kernel of C classes for R regions, with or without a mask
template <typename T, typename L, int C>
auto stats_kernel(int regions, bool mask) {
  return regions == 2 ? k1_stats<T, L, C, 2, true>
                      : mask ? k1_stats<T, L, C, 1, true> : k1_stats<T, L, C, 1, false>;
}

// Check the shape, fill the geometry; false when K1 cannot take it.
template <typename T, typename L>
bool geometry(const void* logits, const void* lab1, const void* lab2, const float* mask,
              const void* grad, int batch, int nc, int c_pad, int hw, int regions,
              float smooth, float eps, Geom* g) {
  // an empty tensor's pointer is null: region 2's labels and mask are
  // required only where there are pixels
  if (batch < 0 || batch > 65535 || nc < 1 || c_pad < nc || hw < 0 ||
      hw > INT_MAX - kThreads * kMaxVec || (regions != 1 && regions != 2) ||
      (regions == 2 && batch > 0 && hw > 0 && (lab2 == nullptr || mask == nullptr)))
    return false;
  constexpr int V = Logit<T>::kV;
  const int lab_align = std::min(16, V * static_cast<int>(sizeof(L)));
  g->hw = batch == 0 ? 0 : hw;
  g->regions = regions;
  g->nc = nc;
  g->c_pad = c_pad;
  g->ncol = regions * 4 * nc;
  g->has_mask = mask != nullptr;
  g->vec = (nc == 2 || nc == 4) && hw % V == 0 && aligned(logits, 16) &&
           aligned(lab1, lab_align) && (regions == 1 || aligned(lab2, lab_align)) &&
           (mask == nullptr || aligned(mask, std::min(16, 4 * V))) &&
           (grad == nullptr || aligned(grad, 16));
  g->stream = 0;
  g->smooth = smooth;
  g->eps = eps;
  return true;
}

// the L2 cache of the current device, in bytes (asked once)
double l2_bytes() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, dev) != cudaSuccess)
      bytes = 50 << 20;   // the H100's
  }
  return bytes;
}

template <typename T, typename L>
int forward(const void* logits, const void* lab1, const void* lab2, const float* mask,
            float* part, float* out, int batch, int nc, int c_pad, int hw,
            int regions, int sms, int max_rows, float smooth, float eps, cudaStream_t s) {
  Geom g;
  if (!geometry<T, L>(logits, lab1, lab2, mask, nullptr, batch, nc, c_pad, hw, regions,
                      smooth, eps, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* lg = static_cast<const T*>(logits);
  const L* l1 = static_cast<const L*>(lab1);
  const L* l2 = static_cast<const L*>(lab2);
  auto kernel = nc == 2   ? stats_kernel<T, L, 2>(regions, g.has_mask)
                : nc == 4 ? stats_kernel<T, L, 4>(regions, g.has_mask)
                          : k1_stats_any<T, L>;
  static int occupancy[9] = {};
  const int slot = kernel_slot(nc) * 3 + (regions == 2 ? 2 : g.has_mask);
  const int v = g.vec ? Logit<T>::kV : 1;
  const int target = std::min(kMaxRows, sms * blocks_per_sm(kernel, &occupancy[slot]));
  g.chunk = chunk_for(batch, g.hw, v, target);
  const dim3 grid(g.hw == 0 ? 1 : (g.hw + g.chunk - 1) / g.chunk, std::max(batch, 1));
  if (static_cast<long long>(grid.x) * grid.y > max_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kThreads, 0, s>>>(lg, l1, l2, mask, part, g);
  k1_total<<<1, kThreads, 0, s>>>(part, static_cast<int>(grid.x * grid.y), out, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename L>
int backward(const void* logits, const void* lab1, const void* lab2, const float* mask,
             const float* stats, const float* gd1, const float* gc1, const float* gd2,
             const float* gc2, void* grad, int batch, int nc, int c_pad, int hw, int regions,
             float smooth, float eps, cudaStream_t s) {
  Geom g;
  if (!geometry<T, L>(logits, lab1, lab2, mask, grad, batch, nc, c_pad, hw, regions, smooth,
                      eps, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || hw == 0) return static_cast<int>(cudaSuccess);
  const T* lg = static_cast<const T*>(logits);
  const L* l1 = static_cast<const L*>(lab1);
  const L* l2 = static_cast<const L*>(lab2);
  T* gr = static_cast<T*>(grad);
  auto kernel = nc == 2 ? k1_grad<T, L, 2> : nc == 4 ? k1_grad<T, L, 4> : k1_grad_any<T, L>;
  g.chunk = kGradThreads * (g.vec ? Logit<T>::kV : 1);
  // the logits and gradient, labels and mask the backward moves
  const double bytes = static_cast<double>(batch) * hw *
                       (2.0 * nc * sizeof(T) + regions * sizeof(L) + (mask ? 4 : 0));
  g.stream = bytes > 0.75 * l2_bytes();
  const dim3 grid((hw + g.chunk - 1) / g.chunk, batch);
  kernel<<<grid, kGradThreads, 0, s>>>(lg, l1, l2, mask, stats, gd1, gc1, gd2, gc2, gr, g);
  return static_cast<int>(cudaGetLastError());
}

// The logits' type (0 fp32, 1 bf16, 2 fp16) and the labels' (0 uint8, 1
// int32, 2 int64) pick the instantiation.
template <template <typename, typename> class Op, typename... A>
int dispatch(int logit_type, int label_type, A... args) {
  switch (logit_type * 3 + label_type) {
    case 0: return Op<float, uint8_t>::run(args...);
    case 1: return Op<float, int32_t>::run(args...);
    case 2: return Op<float, int64_t>::run(args...);
    case 3: return Op<__nv_bfloat16, uint8_t>::run(args...);
    case 4: return Op<__nv_bfloat16, int32_t>::run(args...);
    case 5: return Op<__nv_bfloat16, int64_t>::run(args...);
    case 6: return Op<__half, uint8_t>::run(args...);
    case 7: return Op<__half, int32_t>::run(args...);
    case 8: return Op<__half, int64_t>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename L>
struct Forward {
  template <typename... A>
  static int run(A... args) { return forward<T, L>(args...); }
};

template <typename T, typename L>
struct Backward {
  template <typename... A>
  static int run(A... args) { return backward<T, L>(args...); }
};

}  // namespace

// The most blocks (partial-sum columns) a forward over at most that many
// rows launches: the wrapper sizes part with max(batch, this).
extern "C" int chap_k1_max_rows() { return kMaxRows; }

// K1 forward. logits: [batch, num_classes, hw] of logit_type; labels,
// labels2: [batch, hw] of label_type (labels2 null when regions is 1);
// mask: [batch, hw] fp32, or null for a weight of 1 everywhere (regions 1
// only); part: scratch of max_rows * regions * 4 * num_classes fp32, max_rows
// at least max(batch, chap_k1_max_rows()); out: regions * 4 * c_pad + 2 *
// regions fp32,
// the statistics then (dice, ce) per region. Two launches on `stream`;
// allocates nothing, does not synchronise. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape K1 does not take.
extern "C" int chap_k1_forward(const void* logits, const void* labels, const void* labels2,
                               const float* mask, float* part, float* out, int batch,
                               int num_classes, int c_pad, int hw, int regions, int logit_type,
                               int label_type, int sms, int max_rows, float smooth, float eps,
                               void* stream) {
  return dispatch<Forward>(logit_type, label_type, logits, labels, labels2, mask, part, out,
                           batch, num_classes, c_pad, hw, regions, sms, max_rows, smooth, eps,
                           static_cast<cudaStream_t>(stream));
}

// K1 backward: grad [batch, num_classes, hw] of logit_type from the
// forward's statistics stats [regions, 4, c_pad] and the incoming grads
// g_dice1, g_ce1, g_dice2, g_ce2 (fp32 scalars on the device; the second
// pair unread when regions is 1). Zero pixels launch nothing.
extern "C" int chap_k1_backward(const void* logits, const void* labels, const void* labels2,
                                const float* mask, const float* stats, const float* g_dice1,
                                const float* g_ce1, const float* g_dice2, const float* g_ce2,
                                void* grad, int batch, int num_classes, int c_pad, int hw,
                                int regions, int logit_type, int label_type, float smooth,
                                float eps, void* stream) {
  return dispatch<Backward>(logit_type, label_type, logits, labels, labels2, mask, stats,
                            g_dice1, g_ce1, g_dice2, g_ce2, grad, batch, num_classes, c_pad, hw,
                            regions, smooth, eps, static_cast<cudaStream_t>(stream));
}
