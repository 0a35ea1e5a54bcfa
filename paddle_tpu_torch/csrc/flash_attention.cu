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
// the H100's ridge of about 295 in bf16. So the products run on the tensor
// cores (WMMA bf16 m16n16k16 with float32 accumulation) and nothing of the
// [T, T] score matrix reaches device memory. float32 inputs take the same
// structure with float32 FMA products, so their results stay exact float32.
//
// Design (a simple, correct first version):
//   * One 128-thread block per (b*n, tile of BLK rows): query tiles for K1
//     and K2, key tiles for K3. The TPU kernel's sequential grid axis over
//     the other side becomes a loop inside the block, and the running
//     softmax state (m, l) and every accumulator live in shared memory as
//     float32 instead of VMEM scratch.
//   * Each step loads one tile of the other side with 16-byte loads, forms
//     the score tile in shared memory, applies the row-wise update with one
//     warp per row, and accumulates the next product.
//   * dQ and dK/dV stay split across K2 and K3 as on the TPU, so no block
//     ever adds into another block's output and no atomics are needed.
//   * Causal bounds are the TPU kernel's: K1 and K2 stop at
//     hi = min(ceil((q_blk + 1) * BLK / BLK), T / BLK); K3 starts at
//     lo = k_blk * BLK / BLK. Query tiles are issued longest-first.
//   * Masked scores are -inf and their probabilities are set to 0 without
//     evaluating exp(-inf - -inf); l is floored at 1e-30 as on the TPU.
// Later work: wgmma with TMA-fed tile rings, warp specialisation, and
// accumulators kept in registers instead of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

template <typename T, int H>
cudaError_t launch(int kind, const Params& p, int BN, cudaStream_t stream) {
  using C = Cfg<T, H>;
  void (*fn)(Params);
  int smem;
  if (kind == kFwd) {
    fn = flash_fwd_kernel<T, H>;
    smem = C::FWD;
  } else if (kind == kDq) {
    fn = flash_bwd_dq_kernel<T, H>;
    smem = C::DQ;
  } else {
    fn = flash_bwd_dkv_kernel<T, H>;
    smem = C::DKV;
  }
  // the carve rounds every buffer up to 128 bytes
  smem += 12 * 128;
  if (p.T % C::BLK != 0 || p.T / C::BLK > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BN, p.T / C::BLK);
  fn<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(int kind, const Params& p, int BN, int H,
                     cudaStream_t stream) {
  switch (H) {
    case 64:
      return launch<T, 64>(kind, p, BN, stream);
    case 96:
      return launch<T, 96>(kind, p, BN, stream);
    case 128:
      return launch<T, 128>(kind, p, BN, stream);
    case 256:
      return launch<T, 256>(kind, p, BN, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(int kind, Params& p, const long long* strides, int n_views, int B,
        int H, int dtype, void* stream) {
  if (B < 1 || p.N < 1 || p.T < 1) return int(cudaErrorInvalidValue);
  View* views[4] = {&p.vq, &p.vk, &p.vv, &p.vdo};
  for (int i = 0; i < n_views; ++i)
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BN = B * p.N;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_h<float>(kind, p, BN, H, st);
  else if (dtype == 1)
    err = launch_h<__nv_bfloat16>(kind, p, BN, H, st);
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
