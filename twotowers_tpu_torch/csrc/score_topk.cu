// Fused dot-product scoring + top-k for Hopper (sm_90a).
//
// Replaces twotowers_tpu/kernels/pallas_topk.py:_kernel (entry
// score_topk_pallas). For each query it keeps the top-k of q . doc^T
// without writing the (Q, N) score matrix. Rows at or past n_docs score
// -1e30 (score_topk_xla's mask), results come best first, and equal scores
// go to the lower doc index (lax.top_k's order).
//
// What bounds it on an H100 SXM (67 TFLOP/s f32 outside the tensor cores,
// 3.35 TB/s): at Q=256, N=1M, D=128 in f32 it is compute,
// 2*256*1e6*128 = 6.55e10 FLOP / 67 TFLOP/s = 0.98 ms against
// 512 MB / 3.35 TB/s = 0.15 ms of doc reads. At Q=1, and for bf16 docs once
// they run on the tensor cores, it is bytes. This version sums f32 FMAs on
// the CUDA cores in a fixed order over D (bf16 docs are widened on load; no
// TF32, which would break exact indices). A later change can run bf16 docs
// through wgmma.
//
// Design: two passes, both launched by score_topk_launch.
//  1. Grid (query block x doc split). A block stages a depth chunk of its
//     queries and of a tile of TN doc rows in shared memory, each thread
//     sums an R x 4 patch of scores in registers, then every score that
//     beats its query's current k-th best (the prune of the TPU kernel's
//     run_kth) is queued, and one thread per query insertion-sorts the
//     queue into that query's running top-k in shared memory. Splits are
//     many enough that Q=1 at N=1M still fills the card; each block writes
//     its k best of the split to scratch, padded with (-inf, INT_MAX).
//  2. One block per query merges the splits' sorted lists, k rounds of a
//     block-wide arg-best over the list heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;             // doc rows per tile (4 per lane of a warp)
constexpr int DK = 32;              // depth of one staged chunk
constexpr int DK_PAD = DK + 1;      // doc-tile row stride: lanes hit distinct banks
constexpr int THREADS1 = 128;       // pass 1: 4 warps, warp w owns queries w*R..w*R+R-1
constexpr int THREADS2 = 256;       // pass 2
constexpr int MAX_SPLITS = 1024;
constexpr float MASKED = -1e30f;
constexpr int NO_INDEX = 0x7fffffff;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// The result order: score descending, then index ascending.
__device__ __forceinline__ bool ranks_before(float as, int ai, float bs, int bi) {
    return as > bs || (as == bs && ai < bi);
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS1)
score_topk_splits(const T* __restrict__ docs, const T* __restrict__ queries,
                  long long n, int n_queries, int dim, int k, long long n_docs,
                  long long split_len, float* __restrict__ cand_v,
                  int* __restrict__ cand_i) {
    constexpr int QB = 4 * R;
    extern __shared__ float smem[];
    float* q_s = smem;                                  // [QB][DK]
    float* d_s = q_s + QB * DK;                         // [TN][DK_PAD]
    float* top_v = d_s + TN * DK_PAD;                   // [QB][k], sorted
    float* queue_v = top_v + QB * k;                    // [QB][TN]
    int* top_i = reinterpret_cast<int*>(queue_v + QB * TN);  // [QB][k]
    int* queue_i = top_i + QB * k;                      // [QB][TN]
    int* queue_n = queue_i + QB * TN;                   // [QB]
    int* filled = queue_n + QB;                         // [QB]

    const int tid = threadIdx.x;
    const int lane = tid & 31;      // docs lane, lane+32, lane+64, lane+96 of a tile
    const int warp = tid >> 5;      // queries warp*R .. warp*R+R-1 of the block
    const int q0 = blockIdx.x * QB;
    const int split = blockIdx.y;
    const long long begin = (long long)split * split_len;
    const long long end = min(begin + split_len, n);

    if (tid < QB) {
        queue_n[tid] = 0;
        filled[tid] = 0;
    }
    __syncthreads();

    for (long long t0 = begin; t0 < end; t0 += TN) {
        float acc[R][4];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

        for (int d0 = 0; d0 < dim; d0 += DK) {
            for (int e = tid; e < QB * DK; e += THREADS1) {
                const int r = e / DK, c = e % DK;
                q_s[e] = (q0 + r < n_queries && d0 + c < dim)
                             ? widen(queries[(long long)(q0 + r) * dim + d0 + c]) : 0.f;
            }
            for (int e = tid; e < TN * DK; e += THREADS1) {
                const int r = e / DK, c = e % DK;
                const long long row = t0 + r;
                d_s[r * DK_PAD + c] = (row < end && d0 + c < dim)
                                          ? widen(docs[row * dim + d0 + c]) : 0.f;
            }
            __syncthreads();
            const int depth = min(DK, dim - d0);
            for (int kk = 0; kk < depth; ++kk) {
                float qv[R], dv[4];
#pragma unroll
                for (int i = 0; i < R; ++i) qv[i] = q_s[(warp * R + i) * DK + kk];
#pragma unroll
                for (int j = 0; j < 4; ++j) dv[j] = d_s[(lane + 32 * j) * DK_PAD + kk];
#pragma unroll
                for (int i = 0; i < R; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], dv[j], acc[i][j]);
            }
            __syncthreads();
        }

        // queue every score that beats its query's current k-th best
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int ql = warp * R + i;
            if (q0 + ql >= n_queries) continue;
            const bool full = filled[ql] == k;
            const float kth_v = full ? top_v[ql * k + k - 1] : 0.f;
            const int kth_i = full ? top_i[ql * k + k - 1] : 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const long long doc = t0 + lane + 32 * j;
                if (doc >= end) continue;
                const float s = doc < n_docs ? acc[i][j] : MASKED;
                if (!full || ranks_before(s, (int)doc, kth_v, kth_i)) {
                    const int p = atomicAdd(&queue_n[ql], 1);
                    queue_v[ql * TN + p] = s;
                    queue_i[ql * TN + p] = (int)doc;
                }
            }
        }
        __syncthreads();

        // one thread per query insertion-sorts its queue into the top-k
        if (tid < QB) {
            float* tv = top_v + tid * k;
            int* ti = top_i + tid * k;
            int f = filled[tid];
            const int m = queue_n[tid];
            for (int c = 0; c < m; ++c) {
                const float s = queue_v[tid * TN + c];
                const int idx = queue_i[tid * TN + c];
                if (f == k && !ranks_before(s, idx, tv[k - 1], ti[k - 1])) continue;
                int p = f < k ? f : k - 1;
                while (p > 0 && ranks_before(s, idx, tv[p - 1], ti[p - 1])) {
                    tv[p] = tv[p - 1];
                    ti[p] = ti[p - 1];
                    --p;
                }
                tv[p] = s;
                ti[p] = idx;
                if (f < k) ++f;
            }
            filled[tid] = f;
            queue_n[tid] = 0;
        }
        __syncthreads();
    }

    for (int e = tid; e < QB * k; e += THREADS1) {
        const int ql = e / k, r = e % k;
        if (q0 + ql >= n_queries) continue;
        const long long o = ((long long)(q0 + ql) * gridDim.y + split) * k + r;
        const bool real = r < filled[ql];
        cand_v[o] = real ? top_v[e] : -INFINITY;
        cand_i[o] = real ? top_i[e] : NO_INDEX;
    }
}

__global__ void __launch_bounds__(THREADS2)
score_topk_merge(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                 int n_splits, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
    constexpr int WARPS = THREADS2 / 32;
    __shared__ int head[MAX_SPLITS];
    __shared__ float warp_v[WARPS];
    __shared__ int warp_i[WARPS];
    __shared__ int warp_s[WARPS];

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const long long q = blockIdx.x;
    const float* cv = cand_v + q * n_splits * k;
    const int* ci = cand_i + q * n_splits * k;
    for (int s = tid; s < n_splits; s += THREADS2) head[s] = 0;
    __syncthreads();

    for (int r = 0; r < k; ++r) {
        float bv = -INFINITY;
        int bi = NO_INDEX, bs = -1;
        for (int s = tid; s < n_splits; s += THREADS2) {
            const int h = head[s];
            if (h >= k) continue;
            const float v = cv[s * k + h];
            const int i = ci[s * k + h];
            if (bs < 0 || ranks_before(v, i, bv, bi)) { bv = v; bi = i; bs = s; }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, bv, off);
            const int oi = __shfl_down_sync(0xffffffffu, bi, off);
            const int os = __shfl_down_sync(0xffffffffu, bs, off);
            if (os >= 0 && (bs < 0 || ranks_before(ov, oi, bv, bi))) { bv = ov; bi = oi; bs = os; }
        }
        if (lane == 0) { warp_v[warp] = bv; warp_i[warp] = bi; warp_s[warp] = bs; }
        __syncthreads();
        if (tid == 0) {
            for (int w = 1; w < WARPS; ++w) {
                if (warp_s[w] >= 0 && (bs < 0 || ranks_before(warp_v[w], warp_i[w], bv, bi))) {
                    bv = warp_v[w]; bi = warp_i[w]; bs = warp_s[w];
                }
            }
            out_v[q * k + r] = bv;
            out_i[q * k + r] = bi;
            if (bs >= 0) head[bs] += 1;
        }
        __syncthreads();
    }
}

template <typename T, int R>
cudaError_t launch(const void* docs, const void* queries, long long n, int n_queries,
                   int dim, int k, long long n_docs, int n_splits, long long split_len,
                   float* cand_v, int* cand_i, float* out_v, int* out_i,
                   cudaStream_t stream) {
    constexpr int QB = 4 * R;
    const size_t smem = sizeof(float) * (QB * DK + TN * DK_PAD + QB * k + QB * TN)
                      + sizeof(int) * (QB * k + QB * TN + 2 * QB);
    cudaError_t err = cudaFuncSetAttribute(score_topk_splits<T, R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((n_queries + QB - 1) / QB, n_splits);
    score_topk_splits<T, R><<<grid, THREADS1, smem, stream>>>(
        static_cast<const T*>(docs), static_cast<const T*>(queries), n, n_queries,
        dim, k, n_docs, split_len, cand_v, cand_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    score_topk_merge<<<n_queries, THREADS2, 0, stream>>>(cand_v, cand_i, n_splits, k,
                                                         out_v, out_i);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// docs (n, dim) and queries (n_queries, dim), both row-major and of one type
// (float32, or bfloat16 when docs_bf16 != 0); cand_v/cand_i are
// (n_queries, n_splits, k) scratch; out_v/out_i are (n_queries, k).
// rows_per_thread picks the query block: 1 (4 queries) or 8 (32 queries).
// Returns the cudaError_t of the launches (0 on success).
int score_topk_launch(const void* docs, const void* queries, int docs_bf16,
                      long long n, int n_queries, int dim, int k, long long n_docs,
                      int n_splits, long long split_len, int rows_per_thread,
                      float* cand_v, int* cand_i, float* out_v, int* out_i,
                      void* stream) {
    if (n_splits < 1 || n_splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (docs_bf16) {
        if (rows_per_thread == 1)
            return (int)launch<__nv_bfloat16, 1>(docs, queries, n, n_queries, dim, k, n_docs,
                                                 n_splits, split_len, cand_v, cand_i,
                                                 out_v, out_i, s);
        return (int)launch<__nv_bfloat16, 8>(docs, queries, n, n_queries, dim, k, n_docs,
                                             n_splits, split_len, cand_v, cand_i,
                                             out_v, out_i, s);
    }
    if (rows_per_thread == 1)
        return (int)launch<float, 1>(docs, queries, n, n_queries, dim, k, n_docs, n_splits,
                                     split_len, cand_v, cand_i, out_v, out_i, s);
    return (int)launch<float, 8>(docs, queries, n, n_queries, dim, k, n_docs, n_splits,
                                 split_len, cand_v, cand_i, out_v, out_i, s);
}

}  // extern "C"
