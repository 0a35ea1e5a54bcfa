// Flash-attention forward and backward kernels for NVIDIA Hopper (sm_90a).
//
// Replaces, in paddle_tpu/ops/pallas_ops.py:
//   K1 _flash_fwd_kernel      (launched by _flash_fwd_call)
//   K2 _flash_bwd_dq_kernel   (launched by _flash_flat_bwd)
//   K3 _flash_bwd_dkv_kernel  (launched by _flash_flat_bwd)
// For every batch row b, head n and query row i over the T keys j of the
// same (b, n), with s_ij = scale * q_i . k_j (and s_ij = -inf where causal
// masking drops j > i):
//   K1  out_i = sum_j softmax_j(s_ij) v_j,  lse_i = m_i + log(max(l_i, 1e-30))
//   K2  dq_i  = scale * sum_j p_ij (do_i . v_j - delta_i) k_j
//   K3  dv_j  = sum_i p_ij do_i,  dk_j = scale * sum_i p_ij (do_i . v_j -
//       delta_i) q_i
// where p_ij = exp(s_ij - lse_i) is recomputed from the forward's lse and
// delta_i = rowsum(do_i * out_i) comes in from the caller, computed from the
// output rounded to the input type, as in the TPU kernel's backward.
//
// Layout: q, k, v and do are [B, T, N, H] with any element strides over B,
// T and N and a contiguous head dimension, so the per-head views that
// unbind() cuts out of a fused QKV projection go in without a copy. The
// outputs (out, dq, dk, dv) are contiguous [B, T, N, H]; lse and delta are
// contiguous float32 [B, N, T].
//
// What bounds it: operations. At the GPT pretraining step's shape (B*N =
// 128, T = 2048, H = 64, bf16, causal) K1 does 2 products of 2*T*T/2*H
// FLOPs per (b, n) and moves about 135 MB, about 500 FLOPs per byte, above
// the H100's ridge of about 295 in bf16. Bounds at that shape against 989
// TFLOP/s: K1 0.070 ms, K2 0.104 ms, K3 0.139 ms. Nothing of the [T, T]
// score matrix reaches device memory.
//
// Two designs, chosen in launch() by dtype and H (the same for all three
// kernels):
//
// (a) Hopper design: K1, K2 and K3 in bf16 at H = 64 and 128 (every
//     head_dim a preset uses: gpt2-* and gpt3-1.3B have 64, gpt3-6.7B 128).
//   * Warp specialised. Warpgroup 0 is the producer: it drops to 40 (K1,
//     K2) or 24 (K3) registers with setmaxnreg, and one of its threads
//     issues TMA loads (cp.async.bulk.tensor, 4-D maps over the strided
//     views, boxes of 64 columns in 128-byte swizzle) into a ring of
//     shared-memory stages, each with a full and an empty mbarrier. The
//     consumer warpgroups take 232 registers and run every product on
//     wgmma with float32 accumulators in registers; nothing is accumulated
//     in shared memory.
//   * K1: a block of 384 threads owns 128 query rows of one (b, n), 64 per
//     consumer warpgroup, with Q resident; K and V tiles of 128 keys go
//     through a ring of 3 stages (H = 64) or 2 (H = 128). S = Q K^T is a
//     wgmma with both operands in shared memory; the online softmax runs
//     on the registers, in units of log2 (scale * log2(e) folded into one
//     FMA before ex2), a row's max and sum over the four threads of a quad
//     with two shuffles each; P goes to bf16 in registers and is the
//     register A operand of O += P V, V read with wgmma's transpose bit.
//   * K2: K1's skeleton with one product more. A block of 384 threads owns
//     128 query rows of one (b, n), 64 per consumer warpgroup; Q and dO
//     (TMA) and the rows' lse and delta (1-D bulk copies) are resident; K
//     and V tiles of 64 keys go through a ring of 4 stages (H = 64) or 3
//     (H = 128). S = Q K^T and dP = dO V^T are wgmmas with both operands in
//     shared memory; P = exp2(S scale log2(e) - lse log2(e)) and
//     dS = P (dP - delta) form in registers, and dS in bf16 is the register
//     A operand of dQ += dS K, K read with the transpose bit. dQ stays in
//     registers until the epilogue scales and stores it. A key tile wholly
//     above a warpgroup's rows is skipped by that warpgroup. 100 KB (H =
//     64) or 162 KB (H = 128) of shared memory, one block per SM.
//   * K3: a block of 256 threads owns 64 keys of one (b, n), K and V
//     resident, one consumer warpgroup; tiles of BQ queries (64 at H = 64,
//     32 at H = 128) of Q and dO, with their lse and delta (1-D bulk
//     copies), go through a ring of 3 stages. S^T = K Q^T and dP^T = V dO^T
//     put one key row in each thread's registers, so P^T and
//     dS^T = P^T (dP^T - delta) form in registers and are the register A
//     operands of dV += P^T dO and dK += dS^T Q, with dO and Q read through
//     the transpose bit. 68 KB (H = 64) or 84 KB (H = 128) of shared
//     memory: two blocks per SM.
//   * Causal work only where it exists: tiles above the diagonal are never
//     loaded, the mask is applied only on tiles that cross it, and the
//     heaviest tiles are issued first (the last query tiles for K1 and K2,
//     the first key tiles for K3).
//   * The tensor maps are encoded on the host per call through
//     cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled"), so the
//     library needs no -lcuda, and reach the kernel as __grid_constant__.
//
// (b) WMMA design: float32 at every H (so its results stay exact float32,
//     which wgmma's TF32 would not), and bf16 at H = 96 and 256 (no preset
//     uses them).
//   * One 128-thread block per (b*n, tile of BLK rows): query tiles for K1
//     and K2, key tiles for K3. The TPU kernel's sequential grid axis over
//     the other side becomes a loop inside the block, and the running
//     softmax state (m, l) and every accumulator live in shared memory as
//     float32 instead of VMEM scratch.
//   * Each step loads one tile of the other side with 16-byte loads, forms
//     the score tile in shared memory, applies the row-wise update with one
//     warp per row, and accumulates the next product (WMMA bf16 m16n16k16,
//     or float32 FMA for float32 inputs).
//
// Both designs:
//   * dQ and dK/dV stay split across K2 and K3 as on the TPU, so no block
//     ever adds into another block's output and no atomics are needed; the
//     results do not change from run to run.
//   * Causal bounds are the TPU kernel's: K1 and K2 stop at the key tile
//     that holds the query tile's last row; K3 starts at the query tile
//     that holds its first key.
//   * Masked scores are -inf and their probabilities are set to 0 without
//     evaluating exp(-inf - -inf); l is floored at 1e-30 as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Launches per kernel (0 K1, 1 K2, 2 K3) and dtype (0 float32, 1 bf16),
// counted on the card by the first thread of block (0, 0): a launch
// replayed from a CUDA graph counts too, where a count kept on the host
// moves only at capture. Slot 2 x kernel + dtype.
constexpr int kTallies = 6;
__device__ unsigned long long g_launch_tally[kTallies];

__device__ __forceinline__ void count_launch(int kernel, int bf16) {
  if ((blockIdx.x | blockIdx.y) == 0 && threadIdx.x == 0)
    atomicAdd(&g_launch_tally[2 * kernel + bf16], 1ull);
}

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float from_float(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Tile geometry. Square tiles of BLK rows (64, or 32 where a row of H
// elements takes more than 256 bytes, so that every kernel's shared memory
// stays under the 227 KB a block may use). Rows of a tile in shared memory
// are padded by 16 bytes, which keeps WMMA's 32-byte alignment and spreads
// the rows over the banks.
template <typename T, int H>
struct Cfg {
  static constexpr int BLK = H * int(sizeof(T)) <= 256 ? 64 : 32;
  static constexpr int PAD = 16 / int(sizeof(T));
  static constexpr int LDH = H + PAD;    // [rows][H] tile of T
  static constexpr int LDB = BLK + PAD;  // [rows][BLK] tile of T
  static constexpr int LDFB = BLK + 4;   // [rows][BLK] tile of float
  static constexpr int LDFH = H + 4;     // [rows][H] tile of float
  static constexpr int TILE_H = BLK * LDH * int(sizeof(T));
  static constexpr int TILE_B = BLK * LDB * int(sizeof(T));
  static constexpr int TILE_FB = BLK * LDFB * 4;
  static constexpr int TILE_FH = BLK * LDFH * 4;
  static constexpr int ROWS = BLK * 4;
  // dynamic shared memory of each kernel, in the order the kernels carve it
  static constexpr int FWD = 3 * TILE_H + TILE_FB + TILE_B + TILE_FH +
                             2 * ROWS;
  static constexpr int DQ = 4 * TILE_H + 2 * TILE_FB + TILE_B + TILE_FH +
                            2 * ROWS;
  static constexpr int DKV = 4 * TILE_H + 2 * TILE_FB + 2 * TILE_B +
                             2 * TILE_FH + 2 * ROWS;
  static_assert(FWD <= 232448 && DQ <= 232448 && DKV <= 232448,
                "tile does not fit in shared memory");
};

template <typename P>
__device__ P* carve(unsigned char*& p, int bytes) {
  P* out = reinterpret_cast<P*>(p);
  p += (bytes + 127) / 128 * 128;
  return out;
}

// element strides of a [B, T, N, H] tensor over B, T and N
struct View {
  long long sb, st, sn;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  View vq, vk, vv, vdo;
  int N, T;
  float scale;
  int causal;
};

// rows x H elements from global memory (row stride in elements) into a
// shared tile with row stride ld, 16 bytes per load
template <typename T, int H>
__device__ void load_rows(T* dst, int ld, const T* src, long long row_stride,
                          int rows) {
  constexpr int VEC = 16 / int(sizeof(T));
  constexpr int CPR = H / VEC;
  for (int i = threadIdx.x; i < rows * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = (i % CPR) * VEC;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        __ldg(reinterpret_cast<const uint4*>(src + r * row_stride + c));
  }
}

// rows x H float32 accumulators, times a factor, into a contiguous
// [B, T, N, H] output whose row stride is N * H
template <typename T, int H>
__device__ void store_rows(T* dst, long long row_stride, const float* src,
                           int ld, int rows, float factor) {
  for (int i = threadIdx.x; i < rows * H; i += kThreads) {
    const int r = i / H;
    const int c = i % H;
    dst[r * row_stride + c] = Elem<T>::from_float(src[r * ld + c] * factor);
  }
}

__device__ void fill(float* p, int n, float value) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = value;
}

__device__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// C[M][N] (float32, row stride ldc) = or += op(A)[M][K] . op(B)[K][N], all
// in shared memory. A_T: A is stored [K][M]; B_T: B is stored [N][K].
// bf16 operands run on the tensor cores, one 16x16 output fragment per warp
// at a time; float32 operands run on FMA, one output element per thread at
// a time. The caller synchronises before and after.
template <typename T, int M, int N, int K, bool A_T, bool B_T>
__device__ void mm(float* C, int ldc, const T* A, int lda, const T* B,
                   int ldb, bool accumulate) {
  if constexpr (std::is_same<T, float>::value) {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int i = idx / N;
      const int j = idx % N;
      float acc = accumulate ? C[i * ldc + j] : 0.f;
#pragma unroll 8
      for (int kk = 0; kk < K; ++kk) {
        const float a = A_T ? A[kk * lda + i] : A[i * lda + kk];
        const float b = B_T ? B[j * ldb + kk] : B[kk * ldb + j];
        acc = fmaf(a, b, acc);
      }
      C[i * ldc + j] = acc;
    }
  } else {
    using ALayout =
        typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
    using BLayout =
        typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
    constexpr int FN = N / 16;
    const int warp = threadIdx.x / 32;
    for (int f = warp; f < (M / 16) * FN; f += kWarps) {
      const int mi = (f / FN) * 16;
      const int ni = (f % FN) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate)
        wmma::load_matrix_sync(c, C + mi * ldc + ni, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
        wmma::load_matrix_sync(a, A_T ? A + kk * lda + mi : A + mi * lda + kk,
                               lda);
        wmma::load_matrix_sync(b, B_T ? B + ni * ldb + kk : B + kk * ldb + ni,
                               ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + mi * ldc + ni, c, ldc, wmma::mem_row_major);
    }
  }
}

// ------------------------------------------------------------------ K1 --
template <typename T, int H>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  count_launch(0, sizeof(T) == 2);
  using C = Cfg<T, H>;
  constexpr int BLK = C::BLK;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* cur = smem;
  T* Qs = carve<T>(cur, C::TILE_H);
  T* Ks = carve<T>(cur, C::TILE_H);
  T* Vs = carve<T>(cur, C::TILE_H);
  float* S = carve<float>(cur, C::TILE_FB);
  T* Ps = carve<T>(cur, C::TILE_B);
  float* O = carve<float>(cur, C::TILE_FH);
  float* Ms = carve<float>(cur, C::ROWS);
  float* Ls = carve<float>(cur, C::ROWS);

  const int T_len = p.T;
  const int n_tiles = T_len / BLK;
  const int bn = blockIdx.x;
  // causal query tiles are issued longest-first
  const int qb = p.causal ? n_tiles - 1 - int(blockIdx.y) : int(blockIdx.y);
  const int b = bn / p.N;
  const int n = bn % p.N;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* q = static_cast<const T*>(p.q) + b * p.vq.sb + n * p.vq.sn +
               (long long)qb * BLK * p.vq.st;
  const T* k = static_cast<const T*>(p.k) + b * p.vk.sb + n * p.vk.sn;
  const T* v = static_cast<const T*>(p.v) + b * p.vv.sb + n * p.vv.sn;

  load_rows<T, H>(Qs, C::LDH, q, p.vq.st, BLK);
  fill(O, BLK * C::LDFH, 0.f);
  fill(Ms, BLK, -INFINITY);
  fill(Ls, BLK, 0.f);

  const int hi = p.causal ? min((qb * BLK + BLK + BLK - 1) / BLK, n_tiles)
                          : n_tiles;
  for (int j = 0; j < hi; ++j) {
    __syncthreads();  // the last step's readers of Ks, Vs and Ps are done
    load_rows<T, H>(Ks, C::LDH, k + (long long)j * BLK * p.vk.st, p.vk.st,
                    BLK);
    load_rows<T, H>(Vs, C::LDH, v + (long long)j * BLK * p.vv.st, p.vv.st,
                    BLK);
    __syncthreads();
    mm<T, BLK, BLK, H, false, true>(S, C::LDFB, Qs, C::LDH, Ks, C::LDH,
                                    false);
    __syncthreads();
    for (int r = warp; r < BLK; r += kWarps) {
      const int qpos = qb * BLK + r;
      float* srow = S + r * C::LDFB;
      float mx = -INFINITY;
      for (int c = lane; c < BLK; c += 32) {
        const bool keep = !p.causal || qpos >= j * BLK + c;
        const float s = keep ? srow[c] * p.scale : -INFINITY;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      // m_old = -inf (first tile) gives corr = 0; a row still all masked
      // keeps m = -inf, l = 0 and takes no exp of -inf - -inf
      const float corr = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
      float sum = 0.f;
      for (int c = lane; c < BLK; c += 32) {
        const float s = srow[c];
        const float pv = s == -INFINITY ? 0.f : expf(s - m_new);
        sum += pv;
        Ps[r * C::LDB + c] = Elem<T>::from_float(pv);
      }
      sum = warp_sum(sum);
      for (int c = lane; c < H; c += 32) O[r * C::LDFH + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + sum;
      }
    }
    __syncthreads();
    mm<T, BLK, H, BLK, false, false>(O, C::LDFH, Ps, C::LDB, Vs, C::LDH,
                                     true);
  }
  __syncthreads();

  const long long out_row = (long long)p.N * H;
  T* out = static_cast<T*>(p.out) +
           ((long long)b * T_len + (long long)qb * BLK) * out_row +
           (long long)n * H;
  for (int i = threadIdx.x; i < BLK * H; i += kThreads) {
    const int r = i / H;
    const int c = i % H;
    out[r * out_row + c] =
        Elem<T>::from_float(O[r * C::LDFH + c] / fmaxf(Ls[r], 1e-30f));
  }
  float* lse = p.lse + (long long)bn * T_len + (long long)qb * BLK;
  for (int r = threadIdx.x; r < BLK; r += kThreads)
    lse[r] = Ms[r] + logf(fmaxf(Ls[r], 1e-30f));
}

// ------------------------------------------------------------------ K2 --
template <typename T, int H>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  count_launch(1, sizeof(T) == 2);
  using C = Cfg<T, H>;
  constexpr int BLK = C::BLK;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* cur = smem;
  T* Qs = carve<T>(cur, C::TILE_H);
  T* DOs = carve<T>(cur, C::TILE_H);
  T* Ks = carve<T>(cur, C::TILE_H);
  T* Vs = carve<T>(cur, C::TILE_H);
  float* S = carve<float>(cur, C::TILE_FB);
  float* DP = carve<float>(cur, C::TILE_FB);
  T* DS = carve<T>(cur, C::TILE_B);
  float* DQ = carve<float>(cur, C::TILE_FH);
  float* LSE = carve<float>(cur, C::ROWS);
  float* DEL = carve<float>(cur, C::ROWS);

  const int T_len = p.T;
  const int n_tiles = T_len / BLK;
  const int bn = blockIdx.x;
  const int qb = p.causal ? n_tiles - 1 - int(blockIdx.y) : int(blockIdx.y);
  const int b = bn / p.N;
  const int n = bn % p.N;

  const T* q = static_cast<const T*>(p.q) + b * p.vq.sb + n * p.vq.sn +
               (long long)qb * BLK * p.vq.st;
  const T* dout = static_cast<const T*>(p.dout) + b * p.vdo.sb +
                  n * p.vdo.sn + (long long)qb * BLK * p.vdo.st;
  const T* k = static_cast<const T*>(p.k) + b * p.vk.sb + n * p.vk.sn;
  const T* v = static_cast<const T*>(p.v) + b * p.vv.sb + n * p.vv.sn;
  const long long row0 = (long long)bn * T_len + (long long)qb * BLK;

  load_rows<T, H>(Qs, C::LDH, q, p.vq.st, BLK);
  load_rows<T, H>(DOs, C::LDH, dout, p.vdo.st, BLK);
  for (int r = threadIdx.x; r < BLK; r += kThreads) {
    LSE[r] = p.lse_in[row0 + r];
    DEL[r] = p.delta[row0 + r];
  }
  fill(DQ, BLK * C::LDFH, 0.f);

  const int hi = p.causal ? min((qb * BLK + BLK + BLK - 1) / BLK, n_tiles)
                          : n_tiles;
  for (int j = 0; j < hi; ++j) {
    __syncthreads();
    load_rows<T, H>(Ks, C::LDH, k + (long long)j * BLK * p.vk.st, p.vk.st,
                    BLK);
    load_rows<T, H>(Vs, C::LDH, v + (long long)j * BLK * p.vv.st, p.vv.st,
                    BLK);
    __syncthreads();
    mm<T, BLK, BLK, H, false, true>(S, C::LDFB, Qs, C::LDH, Ks, C::LDH,
                                    false);
    mm<T, BLK, BLK, H, false, true>(DP, C::LDFB, DOs, C::LDH, Vs, C::LDH,
                                    false);
    __syncthreads();
    for (int i = threadIdx.x; i < BLK * BLK; i += kThreads) {
      const int r = i / BLK;
      const int c = i % BLK;
      const bool keep = !p.causal || qb * BLK + r >= j * BLK + c;
      const float pr =
          keep ? expf(S[r * C::LDFB + c] * p.scale - LSE[r]) : 0.f;
      DS[r * C::LDB + c] =
          Elem<T>::from_float(pr * (DP[r * C::LDFB + c] - DEL[r]));
    }
    __syncthreads();
    mm<T, BLK, H, BLK, false, false>(DQ, C::LDFH, DS, C::LDB, Ks, C::LDH,
                                     true);
  }
  __syncthreads();
  const long long out_row = (long long)p.N * H;
  T* dq = static_cast<T*>(p.dq) +
          ((long long)b * T_len + (long long)qb * BLK) * out_row +
          (long long)n * H;
  store_rows<T, H>(dq, out_row, DQ, C::LDFH, BLK, p.scale);
}

// ------------------------------------------------------------------ K3 --
template <typename T, int H>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  count_launch(2, sizeof(T) == 2);
  using C = Cfg<T, H>;
  constexpr int BLK = C::BLK;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* cur = smem;
  T* Ks = carve<T>(cur, C::TILE_H);
  T* Vs = carve<T>(cur, C::TILE_H);
  T* Qs = carve<T>(cur, C::TILE_H);
  T* DOs = carve<T>(cur, C::TILE_H);
  float* S = carve<float>(cur, C::TILE_FB);
  float* DP = carve<float>(cur, C::TILE_FB);
  T* Ps = carve<T>(cur, C::TILE_B);
  T* DS = carve<T>(cur, C::TILE_B);
  float* DK = carve<float>(cur, C::TILE_FH);
  float* DV = carve<float>(cur, C::TILE_FH);
  float* LSE = carve<float>(cur, C::ROWS);
  float* DEL = carve<float>(cur, C::ROWS);

  const int T_len = p.T;
  const int n_tiles = T_len / BLK;
  const int bn = blockIdx.x;
  const int kb = blockIdx.y;  // low key tiles see the most query tiles
  const int b = bn / p.N;
  const int n = bn % p.N;

  const T* k = static_cast<const T*>(p.k) + b * p.vk.sb + n * p.vk.sn +
               (long long)kb * BLK * p.vk.st;
  const T* v = static_cast<const T*>(p.v) + b * p.vv.sb + n * p.vv.sn +
               (long long)kb * BLK * p.vv.st;
  const T* q = static_cast<const T*>(p.q) + b * p.vq.sb + n * p.vq.sn;
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.vdo.sb + n * p.vdo.sn;

  load_rows<T, H>(Ks, C::LDH, k, p.vk.st, BLK);
  load_rows<T, H>(Vs, C::LDH, v, p.vv.st, BLK);
  fill(DK, BLK * C::LDFH, 0.f);
  fill(DV, BLK * C::LDFH, 0.f);

  const int lo = p.causal ? (kb * BLK) / BLK : 0;
  for (int i = lo; i < n_tiles; ++i) {
    __syncthreads();
    load_rows<T, H>(Qs, C::LDH, q + (long long)i * BLK * p.vq.st, p.vq.st,
                    BLK);
    load_rows<T, H>(DOs, C::LDH, dout + (long long)i * BLK * p.vdo.st,
                    p.vdo.st, BLK);
    const long long row0 = (long long)bn * T_len + (long long)i * BLK;
    for (int r = threadIdx.x; r < BLK; r += kThreads) {
      LSE[r] = p.lse_in[row0 + r];
      DEL[r] = p.delta[row0 + r];
    }
    __syncthreads();
    mm<T, BLK, BLK, H, false, true>(S, C::LDFB, Qs, C::LDH, Ks, C::LDH,
                                    false);
    mm<T, BLK, BLK, H, false, true>(DP, C::LDFB, DOs, C::LDH, Vs, C::LDH,
                                    false);
    __syncthreads();
    for (int e = threadIdx.x; e < BLK * BLK; e += kThreads) {
      const int r = e / BLK;
      const int c = e % BLK;
      const bool keep = !p.causal || i * BLK + r >= kb * BLK + c;
      const float pr =
          keep ? expf(S[r * C::LDFB + c] * p.scale - LSE[r]) : 0.f;
      Ps[r * C::LDB + c] = Elem<T>::from_float(pr);
      DS[r * C::LDB + c] =
          Elem<T>::from_float(pr * (DP[r * C::LDFB + c] - DEL[r]));
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: both A operands read transposed
    mm<T, BLK, H, BLK, true, false>(DV, C::LDFH, Ps, C::LDB, DOs, C::LDH,
                                    true);
    mm<T, BLK, H, BLK, true, false>(DK, C::LDFH, DS, C::LDB, Qs, C::LDH,
                                    true);
  }
  __syncthreads();
  const long long out_row = (long long)p.N * H;
  const long long out_off =
      ((long long)b * T_len + (long long)kb * BLK) * out_row +
      (long long)n * H;
  store_rows<T, H>(static_cast<T*>(p.dk) + out_off, out_row, DK, C::LDFH,
                   BLK, p.scale);
  store_rows<T, H>(static_cast<T*>(p.dv) + out_off, out_row, DV, C::LDFH,
                   BLK, 1.f);
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// ------------------------------------------- K1-K3 for Hopper, bf16 --
// The redesign for this card (bf16, H = 64 and 128). The kernels are warp
// specialised: warpgroup 0 is the producer, whose one working thread keeps
// TMA loads in flight into a ring of shared-memory stages guarded by
// full/empty mbarriers (it gives its registers up with setmaxnreg); the
// consumer warpgroups run every product on wgmma with the accumulators in
// registers. The tensor maps cover the strided [B, T, N, H] views as 4-D
// (H, N, T, B) boxes of 64 columns in 128-byte swizzle.

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Maps {
  CUtensorMap q, k, v, dout;
};

struct HopperArgs {
  Maps m;
  Params p;
};

// K1: a block owns BM = 128 query rows of one (b, n), 64 per consumer
// warpgroup, and walks key tiles of BN = 128 through the ring.
template <int H>
struct FwdCfg {
  static constexpr int BM = 128, BN = 128, CH = H / 64;
  static constexpr int STAGES = H == 64 ? 3 : 2;
  static constexpr int THREADS = 384;
  static constexpr int Q_BYTES = BM * H * 2;
  static constexpr int KV_BYTES = BN * H * 2;  // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 128;
};

// K2: a block owns BM = 128 query rows of one (b, n), 64 per consumer
// warpgroup, with Q, dO, lse and delta resident, and walks key tiles of
// BN = 64 (K and V) through the ring. BN = 64 keeps S, dP, dQ and the dS
// fragments (32 + 32 + H / 2 + 16 values a thread) within 232 registers.
template <int H>
struct DqCfg {
  static constexpr int BM = 128, BN = 64, CH = H / 64;
  static constexpr int STAGES = H == 64 ? 4 : 3;
  static constexpr int THREADS = 384;
  static constexpr int Q_BYTES = BM * H * 2;   // Q or dO
  static constexpr int KV_BYTES = BN * H * 2;  // one K or V tile
  static constexpr int ROW_BYTES = BM * 4;     // lse or delta
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES +
                              2 * ROW_BYTES + 128;
};

// K3: a block owns 64 keys of one (b, n), K and V resident, one consumer
// warpgroup; query tiles of BQ rows (with their lse and delta) go through
// the ring. BQ is 64 at H = 64 and 32 at H = 128, which keeps dK, dV, S^T
// and dP^T in the consumer's 232 registers.
template <int H>
struct DkvCfg {
  static constexpr int BK = 64, BQ = H == 64 ? 64 : 32, CH = H / 64;
  static constexpr int STAGES = 3;
  static constexpr int THREADS = 256;
  static constexpr int KV_BYTES = BK * H * 2;
  static constexpr int Q_BYTES = BQ * H * 2;  // one Q or dO tile
  static constexpr int ROW_BYTES = BQ * 4;    // one lse or delta tile
  static constexpr int SMEM = 1024 + 2 * KV_BYTES +
                              STAGES * (2 * Q_BYTES + 2 * ROW_BYTES) + 128;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = hopper::smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows of a 64 x (2 * N) register accumulator, as four bf16x2 A fragments
// per 16-deep step: step kk holds columns 16 kk .. 16 kk + 15
template <int STEPS, int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[STEPS][4],
                                           const float (&d)[N]) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      a[kk][f] = hopper::pack_bf16(d[8 * kk + 2 * f], d[8 * kk + 2 * f + 1]);
}

// ------------------------------------------------------------ K1, Hopper --
template <int H>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ HopperArgs args) {
  count_launch(0, 1);
  using namespace hopper;
  using C = FwdCfg<H>;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CH, STAGES = C::STAGES;
  const Params& p = args.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* Qs = base;
  unsigned char* Ks = Qs + C::Q_BYTES;
  unsigned char* Vs = Ks + STAGES * C::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + STAGES * C::KV_BYTES);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int T_len = p.T;
  const int n_q = T_len / BM;
  const int bn = blockIdx.x;
  // causal query tiles are issued longest-first
  const int qb = p.causal ? n_q - 1 - int(blockIdx.y) : int(blockIdx.y);
  const int b = bn / p.N;
  const int n = bn % p.N;
  // the reference's bound: key tiles up to the one holding the last row
  const int hi = p.causal ? min((qb * BM + BM + BN - 1) / BN, T_len / BN)
                          : T_len / BN;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer --
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, C::Q_BYTES);
      for (int c = 0; c < CH; ++c)
        tma_load_4d(Qs + c * BM * 128, &args.m.q, full_q, c * 64, n, qb * BM,
                    b);
      for (int j = 0; j < hi; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        unsigned char* kt = Ks + s * C::KV_BYTES;
        unsigned char* vt = Vs + s * C::KV_BYTES;
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(kt + c * BN * 128, &args.m.k, &full[s], c * 64, n,
                      j * BN, b);
          tma_load_4d(vt + c * BN * 128, &args.m.v, &full[s], c * 64, n,
                      j * BN, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers --
    setmaxnreg_inc<232>();
    const int w = wg - 1;  // rows 64 w .. 64 w + 63 of the block
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    const int row0 = qb * BM + 64 * w + 16 * warp + g;  // and row0 + 8
    const float sl2 = p.scale * kLog2e;

    float o[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_u32(Qs) + 64 * w * 128;
    mbar_wait(full_q, 0);

    for (int j = 0; j < hi; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const uint32_t k_addr = smem_u32(Ks + s * C::KV_BYTES);
      const uint32_t v_addr = smem_u32(Vs + s * C::KV_BYTES);

      // S = Q K^T: 64 x BN in registers
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const uint32_t in_row = (kk % 4) * 32;
        wgmma_ss<BN, 0>(sc, desc_sw128(q_addr + (kk / 4) * BM * 128 + in_row),
                        desc_sw128(k_addr + (kk / 4) * BN * 128 + in_row),
                        kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // the mask, only on tiles that reach past this warpgroup's first row
      if (p.causal && (j + 1) * BN > qb * BM + 64 * w + 1) {
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * BN + 8 * jj + 2 * t + (e & 1);
            if (key > row0 + 8 * (e >> 1)) sc[4 * jj + e] = -INFINITY;
          }
      }

      // online softmax in registers, in units of log2: a row lives in the
      // four threads of a quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
          mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * r], sc[4 * jj + 2 * r + 1]) *
                             sl2);
        mx = quad_max(mx);
        // a row with every score masked so far keeps m = -inf and l = 0
        // and takes no exp of -inf - -inf
        const float m_use = mx == -INFINITY ? 0.f : mx;
        const float corr = ex2(m[r] - m_use);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float pv = ex2(fmaf(sc[4 * jj + 2 * r + c], sl2, -m_use));
            sc[4 * jj + 2 * r + c] = pv;
            sum += pv;
          }
        l[r] = l[r] * corr + sum;
#pragma unroll
        for (int jj = 0; jj < H / 8; ++jj) {
          o[4 * jj + 2 * r] *= corr;
          o[4 * jj + 2 * r + 1] *= corr;
        }
      }

      // O += P V, P in bf16 registers as the A operand
      uint32_t pa[BN / 16][4];
      to_a_frags(pa, sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<H, 1>(o, pa[kk], desc_sw128(v_addr + kk * 2048, BN * 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(&empty[s]);
    }

    const long long out_row = (long long)p.N * H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = fmaxf(quad_sum(l[r]), 1e-30f);
      const float inv = 1.f / lt;
      const int row = row0 + 8 * r;
      bf16* out = static_cast<bf16*>(p.out) +
                  ((long long)b * T_len + row) * out_row + (long long)n * H;
#pragma unroll
      for (int jj = 0; jj < H / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj + 2 * t) =
            __floats2bfloat162_rn(o[4 * jj + 2 * r] * inv,
                                  o[4 * jj + 2 * r + 1] * inv);
      if (t == 0)
        p.lse[(long long)bn * T_len + row] = m[r] * kLn2 + logf(lt);
    }
  }
}

// ------------------------------------------------------------ K2, Hopper --
template <int H>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_kernel_sm90(const __grid_constant__ HopperArgs args) {
  count_launch(1, 1);
  using namespace hopper;
  using C = DqCfg<H>;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CH, STAGES = C::STAGES;
  const Params& p = args.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* Qs = base;
  unsigned char* DOs = Qs + C::Q_BYTES;
  unsigned char* Ks = DOs + C::Q_BYTES;
  unsigned char* Vs = Ks + STAGES * C::KV_BYTES;
  float* LSEs = reinterpret_cast<float*>(Vs + STAGES * C::KV_BYTES);
  float* DELs = LSEs + BM;
  uint64_t* bars = reinterpret_cast<uint64_t*>(DELs + BM);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int T_len = p.T;
  const int n_q = T_len / BM;
  const int bn = blockIdx.x;
  // causal query tiles are issued longest-first
  const int qb = p.causal ? n_q - 1 - int(blockIdx.y) : int(blockIdx.y);
  const int b = bn / p.N;
  const int n = bn % p.N;
  // the reference's bound: key tiles up to the one holding the last row
  const int hi = p.causal ? min((qb * BM + BM + BN - 1) / BN, T_len / BN)
                          : T_len / BN;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer --
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, 2 * C::Q_BYTES + 2 * C::ROW_BYTES);
      for (int c = 0; c < CH; ++c) {
        tma_load_4d(Qs + c * BM * 128, &args.m.q, full_q, c * 64, n, qb * BM,
                    b);
        tma_load_4d(DOs + c * BM * 128, &args.m.dout, full_q, c * 64, n,
                    qb * BM, b);
      }
      const long long row = (long long)bn * T_len + (long long)qb * BM;
      bulk_load(LSEs, p.lse_in + row, C::ROW_BYTES, full_q);
      bulk_load(DELs, p.delta + row, C::ROW_BYTES, full_q);
      for (int j = 0; j < hi; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        unsigned char* kt = Ks + s * C::KV_BYTES;
        unsigned char* vt = Vs + s * C::KV_BYTES;
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(kt + c * BN * 128, &args.m.k, &full[s], c * 64, n,
                      j * BN, b);
          tma_load_4d(vt + c * BN * 128, &args.m.v, &full[s], c * 64, n,
                      j * BN, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers --
    setmaxnreg_inc<232>();
    const int w = wg - 1;  // rows 64 w .. 64 w + 63 of the block
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    const int first = qb * BM + 64 * w;          // this warpgroup's rows
    const int row0 = first + 16 * warp + g;      // and row0 + 8
    const float sl2 = p.scale * kLog2e;

    float dq[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) dq[i] = 0.f;
    const uint32_t q_addr = smem_u32(Qs) + 64 * w * 128;
    const uint32_t do_addr = smem_u32(DOs) + 64 * w * 128;
    mbar_wait(full_q, 0);
    float lse2[2], del[2];  // lse in units of log2, and delta, per row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = LSEs[row0 + 8 * r - qb * BM] * kLog2e;
      del[r] = DELs[row0 + 8 * r - qb * BM];
    }

    for (int j = 0; j < hi; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      // a key tile wholly above this warpgroup's rows adds nothing to dQ
      if (!p.causal || j * BN <= first + 63) {
        const uint32_t k_addr = smem_u32(Ks + s * C::KV_BYTES);
        const uint32_t v_addr = smem_u32(Vs + s * C::KV_BYTES);

        // S = Q K^T and dP = dO V^T: 64 x BN each, in registers
        float sc[BN / 2], dp[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk) {
          const uint32_t qa = (kk / 4) * BM * 128 + (kk % 4) * 32;
          const uint32_t ka = (kk / 4) * BN * 128 + (kk % 4) * 32;
          wgmma_ss<BN, 0>(sc, desc_sw128(q_addr + qa), desc_sw128(k_addr + ka),
                          kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk) {
          const uint32_t qa = (kk / 4) * BM * 128 + (kk % 4) * 32;
          const uint32_t ka = (kk / 4) * BN * 128 + (kk % 4) * 32;
          wgmma_ss<BN, 0>(dp, desc_sw128(do_addr + qa),
                          desc_sw128(v_addr + ka), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        // P = exp(scale s - lse) and dS = P (dP - delta); the mask only on
        // tiles that reach past this warpgroup's first row
        const bool masked = p.causal && (j + 1) * BN > first + 1;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int key = j * BN + 8 * jj + 2 * t + (e & 1);
            const float pv =
                !masked || key <= row0 + 8 * r
                    ? ex2(fmaf(sc[4 * jj + e], sl2, -lse2[r]))
                    : 0.f;
            dp[4 * jj + e] = pv * (dp[4 * jj + e] - del[r]);
          }

        // dQ += dS K: dS in bf16 registers as the A operand, K read
        // through wgmma's transpose bit
        uint32_t da[BN / 16][4];
        to_a_frags(da, dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<H, 1>(dq, da[kk], desc_sw128(k_addr + kk * 2048, BN * 128));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
      }
      mbar_arrive(&empty[s]);
    }

    const long long out_row = (long long)p.N * H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* out = static_cast<bf16*>(p.dq) +
                  ((long long)b * T_len + row0 + 8 * r) * out_row +
                  (long long)n * H;
#pragma unroll
      for (int jj = 0; jj < H / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj + 2 * t) =
            __floats2bfloat162_rn(dq[4 * jj + 2 * r] * p.scale,
                                  dq[4 * jj + 2 * r + 1] * p.scale);
    }
  }
}

// ------------------------------------------------------------ K3, Hopper --
template <int H>
__global__ void __launch_bounds__(256, 2)
    flash_bwd_dkv_kernel_sm90(const __grid_constant__ HopperArgs args) {
  count_launch(2, 1);
  using namespace hopper;
  using C = DkvCfg<H>;
  constexpr int BK = C::BK, BQ = C::BQ, CH = C::CH, STAGES = C::STAGES;
  const Params& p = args.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* Ks = base;
  unsigned char* Vs = Ks + C::KV_BYTES;
  unsigned char* Qs = Vs + C::KV_BYTES;
  unsigned char* DOs = Qs + STAGES * C::Q_BYTES;
  float* LSEs = reinterpret_cast<float*>(DOs + STAGES * C::Q_BYTES);
  float* DELs = LSEs + STAGES * BQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(DELs + STAGES * BQ);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int T_len = p.T;
  const int bn = blockIdx.x;
  const int kb = blockIdx.y;  // low key tiles see the most query tiles
  const int b = bn / p.N;
  const int n = bn % p.N;
  // the reference's bound: query tiles from the one holding the first key
  const int lo = p.causal ? (kb * BK) / BQ : 0;
  const int n_q = T_len / BQ;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer --
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, 2 * C::KV_BYTES);
      for (int c = 0; c < CH; ++c) {
        tma_load_4d(Ks + c * BK * 128, &args.m.k, full_kv, c * 64, n,
                    kb * BK, b);
        tma_load_4d(Vs + c * BK * 128, &args.m.v, full_kv, c * 64, n,
                    kb * BK, b);
      }
      for (int i = lo; i < n_q; ++i) {
        const int it = i - lo, s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::Q_BYTES + 2 * C::ROW_BYTES);
        unsigned char* qt = Qs + s * C::Q_BYTES;
        unsigned char* dot = DOs + s * C::Q_BYTES;
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(qt + c * BQ * 128, &args.m.q, &full[s], c * 64, n,
                      i * BQ, b);
          tma_load_4d(dot + c * BQ * 128, &args.m.dout, &full[s], c * 64, n,
                      i * BQ, b);
        }
        const long long row = (long long)bn * T_len + (long long)i * BQ;
        bulk_load(LSEs + s * BQ, p.lse_in + row, C::ROW_BYTES, &full[s]);
        bulk_load(DELs + s * BQ, p.delta + row, C::ROW_BYTES, &full[s]);
      }
    }
  } else {
    // -------------------------------------------------------- consumer --
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    const int key0 = kb * BK + 16 * warp + g;  // and key0 + 8
    const float sl2 = p.scale * kLog2e;

    float dk[H / 2], dv[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
    mbar_wait(full_kv, 0);

    for (int i = lo; i < n_q; ++i) {
      const int it = i - lo, s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t q_addr = smem_u32(Qs + s * C::Q_BYTES);
      const uint32_t do_addr = smem_u32(DOs + s * C::Q_BYTES);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries in registers
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const uint32_t ka = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const uint32_t qa = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        wgmma_ss<BQ, 0>(st, desc_sw128(k_addr + ka), desc_sw128(q_addr + qa),
                        kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const uint32_t ka = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const uint32_t qa = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        wgmma_ss<BQ, 0>(dpt, desc_sw128(v_addr + ka),
                        desc_sw128(do_addr + qa), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp(scale s - lse) and dS^T = P^T (dP^T - delta), per query
      // column; the mask only on query tiles that start before the last key
      const float* lse_t = LSEs + s * BQ;
      const float* del_t = DELs + s * BQ;
      const bool masked = p.causal && i * BQ < kb * BK + BK - 1;
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        const float2 ls = *reinterpret_cast<const float2*>(lse_t + 8 * jj +
                                                           2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(del_t + 8 * jj +
                                                           2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          const int query = i * BQ + 8 * jj + 2 * t + c;
          const bool keep = !masked || query >= key0 + 8 * (e >> 1);
          const float pv =
              keep ? ex2(fmaf(st[4 * jj + e], sl2,
                              -(c ? ls.y : ls.x) * kLog2e))
                   : 0.f;
          st[4 * jj + e] = pv;
          dpt[4 * jj + e] = pv * (dpt[4 * jj + e] - (c ? dl.y : dl.x));
        }
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T in bf16 registers as
      // the A operands, dO and Q read through wgmma's transpose bit
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_a_frags(pa, st);
      to_a_frags(da, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<H, 1>(dv, pa[kk], desc_sw128(do_addr + kk * 2048, BQ * 128));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<H, 1>(dk, da[kk], desc_sw128(q_addr + kk * 2048, BQ * 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(&empty[s]);
    }

    const long long out_row = (long long)p.N * H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long off = ((long long)b * T_len + key0 + 8 * r) * out_row +
                            (long long)n * H;
      bf16* dkp = static_cast<bf16*>(p.dk) + off;
      bf16* dvp = static_cast<bf16*>(p.dv) + off;
#pragma unroll
      for (int jj = 0; jj < H / 8; ++jj) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + 8 * jj + 2 * t) =
            __floats2bfloat162_rn(dk[4 * jj + 2 * r] * p.scale,
                                  dk[4 * jj + 2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + 8 * jj + 2 * t) =
            __floats2bfloat162_rn(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// a [B, T, N, H] bf16 view with element strides v as a 4-D (H, N, T, B)
// tensor map whose box is 64 columns x `rows` rows of one (b, n)
bool encode_view(CUtensorMap* map, const void* ptr, const View& v, int B,
                 int N, int T, int H, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(H), cuuint64_t(N), cuuint64_t(T),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(v.sn) * 2, cuuint64_t(v.st) * 2,
                                 cuuint64_t(v.sb) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 at H = 64 and 128 takes the Hopper design; float32, and bf16 at
// H = 96 and 256, the WMMA design
template <typename T, int H>
constexpr bool kSm90 = std::is_same<T, __nv_bfloat16>::value &&
                       (H == 64 || H == 128);

// dynamic shared memory that a launch of this kernel instance requests
template <typename T, int H>
int smem_bytes(int kind) {
  if constexpr (kSm90<T, H>) {
    if (kind == kFwd) return FwdCfg<H>::SMEM;
    if (kind == kDkv) return DkvCfg<H>::SMEM;
    return DqCfg<H>::SMEM;
  }
  using C = Cfg<T, H>;
  // the carve rounds every buffer up to 128 bytes
  return (kind == kFwd ? C::FWD : kind == kDq ? C::DQ : C::DKV) + 12 * 128;
}

template <int H>
cudaError_t launch_sm90(int kind, const Params& p, int B,
                        cudaStream_t stream) {
  HopperArgs a{};
  a.p = p;
  const int BN = B * p.N;
  void (*fn)(HopperArgs);
  const int smem = smem_bytes<__nv_bfloat16, H>(kind);
  int threads, tile;
  bool ok;
  if (kind == kFwd) {
    using C = FwdCfg<H>;
    fn = flash_fwd_kernel_sm90<H>;
    threads = C::THREADS;
    tile = C::BM;
    ok = encode_view(&a.m.q, p.q, p.vq, B, p.N, p.T, H, C::BM) &&
         encode_view(&a.m.k, p.k, p.vk, B, p.N, p.T, H, C::BN) &&
         encode_view(&a.m.v, p.v, p.vv, B, p.N, p.T, H, C::BN);
  } else if (kind == kDq) {
    using C = DqCfg<H>;
    fn = flash_bwd_dq_kernel_sm90<H>;
    threads = C::THREADS;
    tile = C::BM;
    ok = encode_view(&a.m.q, p.q, p.vq, B, p.N, p.T, H, C::BM) &&
         encode_view(&a.m.dout, p.dout, p.vdo, B, p.N, p.T, H, C::BM) &&
         encode_view(&a.m.k, p.k, p.vk, B, p.N, p.T, H, C::BN) &&
         encode_view(&a.m.v, p.v, p.vv, B, p.N, p.T, H, C::BN);
  } else {
    using C = DkvCfg<H>;
    fn = flash_bwd_dkv_kernel_sm90<H>;
    threads = C::THREADS;
    tile = C::BK;
    ok = encode_view(&a.m.q, p.q, p.vq, B, p.N, p.T, H, C::BQ) &&
         encode_view(&a.m.dout, p.dout, p.vdo, B, p.N, p.T, H, C::BQ) &&
         encode_view(&a.m.k, p.k, p.vk, B, p.N, p.T, H, C::BK) &&
         encode_view(&a.m.v, p.v, p.vv, B, p.N, p.T, H, C::BK);
  }
  if (!ok) return cudaErrorInvalidValue;
  if (p.T % 128 != 0 || p.T / tile > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BN, p.T / tile);
  fn<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t launch(int kind, const Params& p, int B, cudaStream_t stream) {
  if constexpr (kSm90<T, H>) {
    return launch_sm90<H>(kind, p, B, stream);
  } else {
    void (*fn)(Params) = kind == kFwd  ? flash_fwd_kernel<T, H>
                         : kind == kDq ? flash_bwd_dq_kernel<T, H>
                                       : flash_bwd_dkv_kernel<T, H>;
    using C = Cfg<T, H>;
    const int smem = smem_bytes<T, H>(kind);
    if (p.T % C::BLK != 0 || p.T / C::BLK > 65535)
      return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(B * p.N, p.T / C::BLK);
    fn<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_h(int kind, const Params& p, int B, int H,
                     cudaStream_t stream) {
  switch (H) {
    case 64:
      return launch<T, 64>(kind, p, B, stream);
    case 96:
      return launch<T, 96>(kind, p, B, stream);
    case 128:
      return launch<T, 128>(kind, p, B, stream);
    case 256:
      return launch<T, 256>(kind, p, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int smem_h(int kind, int H) {
  switch (H) {
    case 64:
      return smem_bytes<T, 64>(kind);
    case 96:
      return smem_bytes<T, 96>(kind);
    case 128:
      return smem_bytes<T, 128>(kind);
    case 256:
      return smem_bytes<T, 256>(kind);
    default:
      return -1;
  }
}

int run(int kind, Params& p, const long long* strides, int n_views, int B,
        int H, int dtype, void* stream) {
  if (B < 1 || p.N < 1 || p.T < 1) return int(cudaErrorInvalidValue);
  View* views[4] = {&p.vq, &p.vk, &p.vv, &p.vdo};
  for (int i = 0; i < n_views; ++i)
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_h<float>(kind, p, B, H, st);
  else if (dtype == 1)
    err = launch_h<__nv_bfloat16>(kind, p, B, H, st);
  return int(err);
}

}  // namespace

// q, k, v (and do) are [B, T, N, H] with element strides given in
// `strides`, a host array of (batch, seq, head) strides per tensor in
// argument order; the head dimension is contiguous. Outputs are contiguous
// [B, T, N, H]; lse and delta are contiguous float32 [B, N, T]. Every
// pointer and every stride times the element size is a multiple of 16
// bytes. dtype: 0 float32, 1 bfloat16. Each returns a cudaError_t; the
// caller raises on anything but cudaSuccess.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   const long long* strides, int B, int N,
                                   int T, int H, int dtype, float scale,
                                   int causal, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.N = N;
  p.T = T;
  p.scale = scale;
  p.causal = causal;
  return run(kFwd, p, strides, 3, B, H, dtype, stream);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, const long long* strides,
                                      int B, int N, int T, int H, int dtype,
                                      float scale, int causal, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.dq = dq;
  p.N = N;
  p.T = T;
  p.scale = scale;
  p.causal = causal;
  return run(kDq, p, strides, 4, B, H, dtype, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv,
                                       const long long* strides, int B, int N,
                                       int T, int H, int dtype, float scale,
                                       int causal, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  p.N = N;
  p.T = T;
  p.scale = scale;
  p.causal = causal;
  return run(kDkv, p, strides, 4, B, H, dtype, stream);
}

// bytes of dynamic shared memory a launch of kernel `kind` (0 K1, 1 K2,
// 2 K3) requests for `dtype` and head_dim H, or -1 for an instance that
// does not exist
extern "C" int flash_attention_smem(int kind, int dtype, int H) {
  if (kind < kFwd || kind > kDkv) return -1;
  if (dtype == 0) return smem_h<float>(kind, H);
  if (dtype == 1) return smem_h<__nv_bfloat16>(kind, H);
  return -1;
}

// The launch tally (g_launch_tally): its number of slots, a copy of the
// counts into out[kTallies] and a reset to zero; the last two wait for the
// card first and return a cudaError_t.
extern "C" int flash_attention_tally_slots() { return kTallies; }

extern "C" int flash_attention_launch_tally(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return int(err);
  return int(cudaMemcpyFromSymbol(out, g_launch_tally,
                                  sizeof(g_launch_tally)));
}

extern "C" int flash_attention_reset_tally() {
  const unsigned long long zero[kTallies] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return int(err);
  return int(cudaMemcpyToSymbol(g_launch_tally, zero, sizeof(zero)));
}
