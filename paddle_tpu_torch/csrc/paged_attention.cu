// Paged-attention kernel for NVIDIA Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas_ops.py::_paged_attn_kernel (launched by
// _paged_attention_fused). For every slot b, span row t < T and head h:
//
//   out[b,t,h,:] = sum_j softmax_j(scale * q[b,t,h,:] . K_j) V_j
//
// over the slot's logical key positions j. Position j lives at pool row
// block_tables[b, j / bs] * bs + j % bs, and key j is valid for row t iff
// j <= q_offsets[b] + t and j < seq_lens[b]. T is 1 for decode and K+1 for
// a speculative verify span; the position mask alone makes the span causal.
//
// What bounds it: device-memory bytes. A call reads each live K/V row once,
// live rows x H x Dh x 2 (K and V) x sizeof(dtype) bytes, and does about 4
// floating-point operations per element read — far below the ridge of an
// H100 SXM at its 700 W data-sheet rates (about 295 operations per byte in
// bf16, about 20 in float32 outside the tensor cores). So the design spends
// nothing on tensor cores and everything on keeping loads in flight on
// every SM (split-KV, or flash-decoding):
//   * Split pass, grid (head, slot, split). Split s walks the slot's logical
//     key positions [s C, (s + 1) C), C = kSplitKeys = 256, up to the live
//     length min(q_offsets + T, seq_lens). The number of splits, S =
//     ceil(M bs / C) for a table of M blocks of bs rows, comes from shapes
//     alone, so the caller sizes the float32 workspace without reading
//     seq_lens back to the host (paged_attention_workspace_floats gives the
//     size, paged_attention_split_keys the chunk: both live here alone). A
//     split that starts at or past the live
//     length writes m = -inf, l = 0 and returns; a few long slots still
//     give H x B x (live splits) busy blocks instead of H x B.
//   * Inside a split, a group of Dh/VEC neighbouring lanes reads one key
//     row (Dh contiguous elements; rows of one head are H x Dh elements
//     apart, which suits 16-byte vector loads better than TMA tiles). Each
//     group reads UNROLL keys per fetch, and the loop keeps two fetches in
//     registers: the next fetch's 2 x UNROLL 16-byte loads are issued
//     before the current fetch's dot products, shuffles and exps, so loads
//     stay in flight through the arithmetic (a register double buffer).
//   * The block reads its own block-table entries (Hopper has no scalar
//     prefetch); dead table entries are never read. The TPU kernel clamps
//     them to the last live block instead.
//   * The groups of a block merge their partial softmax states (m, l,
//     acc[Dh]) through shared memory, and the block writes the split's
//     float32 partial for each span row to the workspace.
//   * Combine pass, grid (head, slot): for each row it merges the splits'
//     partials in split order, skipping splits with m = -inf, with l
//     floored at 1e-30 as in the TPU kernel. The order is fixed and no
//     atomic touches a result (the one atomic is the launch tally), so two
//     launches on the same inputs give the same bits.
// Routes: every instance takes this design: float32 and bf16, Dh 64 and
// 128, T = 1 (decode) or 2 to 8 (a verify span, one instance sized for 8
// rows), any block size.
// A slot's keys end at the table's M bs rows even where seq_lens says more
// (a verify span at the cache ceiling), as in the plain version's view.
// Inactive lanes (zeroed table row, seq_len 1, cursor 0) read block 0 and
// give a finite result. A group or a split whose keys are all masked for a
// row keeps m = -inf and l = 0 and is skipped at the merge, so
// exp(-inf - -inf) is never evaluated. An out-of-range table entry reads
// block 0 instead of memory outside the pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// keys of one split
constexpr int kSplitKeys = 256;

int64_t num_splits(int M, int bs) {
  return (int64_t(M) * bs + kSplitKeys - 1) / kSplitKeys;
}

// Launches of the split pass per instance, counted on the card by the
// first thread of block (0, 0, 0): a launch replayed from a CUDA graph
// counts too, where a count kept on the host moves only at capture.
// Slot of an instance: 4 x dtype (0 float32, 1 bf16) + 2 x (Dh == 128) +
// (an 8-row span instance).
constexpr int kTallies = 8;
__device__ unsigned long long g_launch_tally[kTallies];

__host__ __device__ constexpr int tally_index(int dtype, int dh, int max_t) {
  return 4 * dtype + 2 * (dh == 128) + (max_t == 8);
}

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static void unpack(const uint4& raw, float* out) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = f[i];
  }
  __device__ static float pack(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 pack(float x) {
    return __float2bfloat16_rn(x);
  }
};

// The workspace holds, for every (slot b, head h, split s, span row t),
// m and l ([B, H, S, T] each, one after the other) and then acc
// ([B, H, S, T, Dh]), all float32.
struct Partials {
  float* m;
  float* l;
  float* acc;
};

__device__ __forceinline__ Partials partials(float* ws, int b, int h, int s,
                                             int B, int H, int S,
                                             int n_rows, int dh) {
  const int64_t all = int64_t(B) * H * S * n_rows;
  const int64_t at = ((int64_t(b) * H + h) * S + s) * n_rows;
  return {ws + at, ws + all + at, ws + 2 * all + at * dh};
}

// ------------------------------------------------------------ split pass --
template <typename T, int DH, int MAX_T>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ seq_lens,
                             const int* __restrict__ q_offsets,
                             float* __restrict__ ws, int n_rows, int H,
                             int bs, int M, int num_blocks, float scale) {
  constexpr int VEC = Elem<T>::kVec;
  constexpr int TPR = DH / VEC;      // lanes that read one key row
  constexpr int RPW = 32 / TPR;      // key rows one warp reads at once
  constexpr int NG = kWarps * RPW;   // lane groups in the block
  constexpr int UNROLL = MAX_T == 1 ? 4 : 2;
  constexpr int STEP = NG * UNROLL;  // keys of one fetch of the block

  __shared__ float sm_m[NG][MAX_T];
  __shared__ float sm_l[NG][MAX_T];
  __shared__ float sm_acc[NG][MAX_T][DH];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  if ((h | b | s) == 0 && threadIdx.x == 0) {
    constexpr int kTally = tally_index(sizeof(T) == 2, DH, MAX_T);
    atomicAdd(&g_launch_tally[kTally], 1ull);
  }
  const Partials part = partials(ws, b, h, s, gridDim.y, H, gridDim.z,
                                 n_rows, DH);

  const int sl = seq_lens[b];
  const int qo = q_offsets[b];
  // keys past this serve no row; a table holds M bs of them (a verify
  // span at the cache ceiling passes seq_lens past that)
  const int limit = min(min(qo + n_rows, sl), M * bs);
  const int lo = s * kSplitKeys;
  const int hi = min(lo + kSplitKeys, limit);
  if (lo >= hi) {  // the split starts at or past the live length
    for (int t = threadIdx.x; t < n_rows; t += kThreads) {
      part.m[t] = -INFINITY;
      part.l[t] = 0.f;
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int g = (threadIdx.x >> 5) * RPW + lane / TPR;
  const int d0 = (lane % TPR) * VEC;

  float qv[MAX_T][VEC];
  float m[MAX_T], l[MAX_T], acc[MAX_T][VEC];
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    m[t] = -INFINITY;
    l[t] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qv[t][e] = 0.f;
      acc[t][e] = 0.f;
    }
    if (t < n_rows) {
      const int64_t off = ((int64_t(b) * n_rows + t) * H + h) * DH + d0;
      Elem<T>::unpack(__ldg(reinterpret_cast<const uint4*>(q + off)), qv[t]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[t][e] *= scale;
    }
  }

  const int64_t row_stride = int64_t(H) * DH;  // elements between pool rows
  const int* bt = block_tables + int64_t(b) * M;

  // this group's keys base + u NG + g, u < UNROLL, into registers
  auto fetch = [&](uint4 (&kr)[UNROLL], uint4 (&vr)[UNROLL], int base) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * NG + g;
      if (j < hi) {
        int phys = __ldg(bt + j / bs);
        // memory safety only: an out-of-range table entry reads the
        // reserved garbage block instead of memory outside the pool
        if (unsigned(phys) >= unsigned(num_blocks)) phys = 0;
        const int64_t off =
            (int64_t(phys) * bs + j % bs) * row_stride + int64_t(h) * DH + d0;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  // folds the fetched keys into every row's online-softmax state
  auto consume = [&](const uint4 (&kr)[UNROLL], const uint4 (&vr)[UNROLL],
                     int base) {
    float sc[UNROLL][MAX_T];
    float vf[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      Elem<T>::unpack(kr[u], kf);
      Elem<T>::unpack(vr[u], vf[u]);
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qv[t][e], kf[e], d);
        sc[u][t] = d;
      }
    }
    // sum each partial dot product over the TPR lanes of its group; the
    // groups are aligned runs of lanes, so xor offsets < TPR stay inside
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t < n_rows) {
#pragma unroll
          for (int o = TPR / 2; o > 0; o >>= 1)
            sc[u][t] += __shfl_xor_sync(0xffffffffu, sc[u][t], o);
        }
      }
    }

#pragma unroll
    for (int t = 0; t < MAX_T; ++t) {
      if (t >= n_rows) continue;
      bool valid[UNROLL];
      float tile_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = base + u * NG + g;
        valid[u] = j < hi && j <= qo + t;
        if (valid[u]) tile_max = fmaxf(tile_max, sc[u][t]);
      }
      if (tile_max == -INFINITY) continue;  // nothing this group may read
      const float m_new = fmaxf(m[t], tile_max);
      const float corr = expf(m[t] - m_new);  // exp(-inf) = 0 on first use
      float psum = 0.f;
      float pv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) pv[e] = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = valid[u] ? expf(sc[u][t] - m_new) : 0.f;
        psum += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) pv[e] = fmaf(p, vf[u][e], pv[e]);
      }
      l[t] = l[t] * corr + psum;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[t][e] = fmaf(acc[t][e], corr, pv[e]);
      m[t] = m_new;
    }
  };

  // two fetches in registers: the next one's loads are in flight while the
  // current one is folded in
  uint4 ka[UNROLL], va[UNROLL], kb[UNROLL], vb[UNROLL];
  fetch(ka, va, lo);
  for (int base = lo; base < hi; base += 2 * STEP) {
    fetch(kb, vb, base + STEP);
    consume(ka, va, base);
    fetch(ka, va, base + 2 * STEP);
    consume(kb, vb, base + STEP);
  }

  // merge the groups' partial states (each a softmax over a disjoint subset
  // of the split's keys) into the split's partial
#pragma unroll
  for (int t = 0; t < MAX_T; ++t) {
    if (t >= n_rows) continue;
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[g][t][d0 + e] = acc[t][e];
    if (d0 == 0) {
      sm_m[g][t] = m[t];
      sm_l[g][t] = l[t];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * DH; i += kThreads) {
    const int t = i / DH;
    const int d = i % DH;
    float mx = -INFINITY;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) mx = fmaxf(mx, sm_m[gg][t]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      const float mg = sm_m[gg][t];
      if (mg != -INFINITY) {
        const float w = expf(mg - mx);
        den = fmaf(w, sm_l[gg][t], den);
        num = fmaf(w, sm_acc[gg][t][d], num);
      }
    }
    // a row no key of this split serves keeps m = -inf, l = 0
    part.acc[t * DH + d] = num;
    if (d == 0) {
      part.m[t] = mx;
      part.l[t] = den;
    }
  }
}

// ---------------------------------------------------------- combine pass --
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(float* __restrict__ ws, T* __restrict__ out,
                               int n_rows, int H, int S) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const Partials part = partials(ws, b, h, 0, gridDim.y, H, S, n_rows, DH);
  for (int i = threadIdx.x; i < n_rows * DH; i += kThreads) {
    const int t = i / DH;
    const int d = i % DH;
    float mx = -INFINITY;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, part.m[s * n_rows + t]);
    float den = 0.f, num = 0.f;
    for (int s = 0; s < S; ++s) {  // in split order
      const float ms = part.m[s * n_rows + t];
      if (ms == -INFINITY) continue;  // no key of split s serves row t
      const float w = expf(ms - mx);
      den = fmaf(w, part.l[s * n_rows + t], den);
      num = fmaf(w, part.acc[(int64_t(s) * n_rows + t) * DH + d], num);
    }
    const int64_t off = ((int64_t(b) * n_rows + t) * H + h) * DH + d;
    out[off] = Elem<T>::pack(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int DH, int MAX_T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* block_tables, const int* seq_lens,
                   const int* q_offsets, void* out, float* ws, int B,
                   int n_rows, int H, int bs, int M, int num_blocks,
                   float scale, cudaStream_t stream) {
  const int64_t S = num_splits(M, bs);
  if (S > 65535) return cudaErrorInvalidValue;
  paged_attention_split_kernel<T, DH, MAX_T>
      <<<dim3(H, B, unsigned(S)), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool), block_tables, seq_lens, q_offsets,
          ws, n_rows, H, bs, M, num_blocks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_attention_combine_kernel<T, DH><<<dim3(H, B), kThreads, 0, stream>>>(
      ws, static_cast<T*>(out), n_rows, H, int(S));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_rows(const void* q, const void* k_pool, const void* v_pool,
                        const int* block_tables, const int* seq_lens,
                        const int* q_offsets, void* out, float* ws, int B,
                        int n_rows, int H, int bs, int M, int num_blocks,
                        float scale, cudaStream_t stream) {
  if (n_rows == 1)
    return launch<T, DH, 1>(q, k_pool, v_pool, block_tables, seq_lens,
                            q_offsets, out, ws, B, n_rows, H, bs, M,
                            num_blocks, scale, stream);
  return launch<T, DH, 8>(q, k_pool, v_pool, block_tables, seq_lens,
                          q_offsets, out, ws, B, n_rows, H, bs, M,
                          num_blocks, scale, stream);
}

}  // namespace

// Keys of one split (C above): the tests put live lengths on its edges.
extern "C" int paged_attention_split_keys() { return kSplitKeys; }

// float32 values of the workspace paged_attention_forward needs for these
// shapes: B x H x S x n_rows x (Dh + 2), S = ceil(M bs / C) (the layout of
// Partials). Shapes alone, so a caller allocates it without reading
// seq_lens back from the card.
extern "C" int64_t paged_attention_workspace_floats(int B, int n_rows, int H,
                                                    int Dh, int M, int bs) {
  return int64_t(B) * H * num_splits(M, bs) * n_rows * (Dh + 2);
}

// The launch tally (g_launch_tally): its number of slots; the slot of the
// instance that serves (dtype, Dh, n_rows); a copy of the counts into
// out[kTallies] and a reset to zero, which wait for the card first and
// return a cudaError_t.
extern "C" int paged_attention_tally_slots() { return kTallies; }

extern "C" int paged_attention_tally_index(int dtype, int Dh, int n_rows) {
  return tally_index(dtype, Dh, n_rows == 1 ? 1 : 8);
}

extern "C" int paged_attention_launch_tally(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return int(err);
  return int(cudaMemcpyFromSymbol(out, g_launch_tally,
                                  sizeof(g_launch_tally)));
}

extern "C" int paged_attention_reset_tally() {
  const unsigned long long zero[kTallies] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return int(err);
  return int(cudaMemcpyToSymbol(g_launch_tally, zero, sizeof(zero)));
}

// q [B, T, H, Dh]; k_pool, v_pool [num_blocks, bs, H, Dh]; block_tables
// [B, M] int32; seq_lens, q_offsets [B] int32; out [B, T, H, Dh];
// workspace float32 of paged_attention_workspace_floats(B, T, H, Dh, M, bs)
// values, written and read by the launch and by nothing else. All
// contiguous on one device, 16-byte aligned. dtype: 0 float32,
// 1 bfloat16. Returns a cudaError_t; the caller raises on anything but
// cudaSuccess.
extern "C" int paged_attention_forward(
    const void* q, const void* k_pool, const void* v_pool,
    const int* block_tables, const int* seq_lens, const int* q_offsets,
    void* out, float* workspace, int B, int n_rows, int H, int Dh, int bs,
    int M, int num_blocks, int dtype, float scale, void* stream) {
  if (B < 1 || B > 65535 || n_rows < 1 || n_rows > 8 || H < 1 || bs < 1 ||
      M < 1 || num_blocks < 1 || workspace == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 64)
    err = launch_rows<float, 64>(q, k_pool, v_pool, block_tables, seq_lens,
                                 q_offsets, out, workspace, B, n_rows, H, bs,
                                 M, num_blocks, scale, st);
  else if (dtype == 0 && Dh == 128)
    err = launch_rows<float, 128>(q, k_pool, v_pool, block_tables, seq_lens,
                                  q_offsets, out, workspace, B, n_rows, H,
                                  bs, M, num_blocks, scale, st);
  else if (dtype == 1 && Dh == 64)
    err = launch_rows<__nv_bfloat16, 64>(q, k_pool, v_pool, block_tables,
                                         seq_lens, q_offsets, out, workspace,
                                         B, n_rows, H, bs, M, num_blocks,
                                         scale, st);
  else if (dtype == 1 && Dh == 128)
    err = launch_rows<__nv_bfloat16, 128>(q, k_pool, v_pool, block_tables,
                                          seq_lens, q_offsets, out,
                                          workspace, B, n_rows, H, bs, M,
                                          num_blocks, scale, st);
  return int(err);
}
