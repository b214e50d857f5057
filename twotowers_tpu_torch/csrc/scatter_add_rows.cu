// Deterministic row scatter-add for Hopper (sm_90a): the embedding-table
// gradient out = zeros((V, D)).at[ids].add(g), summed in float32.
//
// Replaces twotowers_tpu/kernels/pallas_scatter_add.py:scatter_add_rows
// (its _kernel, reached by _take_bwd). The TPU kernel walks the id tiles in
// a sequential grid and read-modify-writes one VMEM accumulator row per id,
// so each row sums its g rows in original index order. Hopper's blocks run
// in no order and share no accumulator, so this does not copy that loop.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. At the main path's
// shape (N = 1,048,576 rows of bf16 g, D = 64, V = 32,768) it must read
// 134 MB of g and 4 MB of ids and write 8 MB of table: 0.044 ms. It does
// one addition per element read, far below any compute limit.
//
// Design: the wrapper sorts the ids stably once (torch.sort, the ids'
// preparation), keeping each sorted position's original row (perm). Equal
// ids then form runs whose rows are in original index order.
//  1. scatter_chunks: the sorted positions are cut into fixed chunks of
//     `chunk` rows, one warp per chunk, lanes across 64 columns (blockIdx.y
//     walks wider rows). The warp sums each run's rows in order in f32
//     registers. A run wholly inside the chunk is written straight to its
//     table row; the piece of a run that crosses the chunk's start goes to
//     part[c][0], the piece that crosses its end to part[c][1].
//  2. scatter_spans: for each run that crosses a chunk boundary, one block
//     of 32 warps adds its pieces: warp w takes pieces w, w + 32, ... in
//     order, then warp 0 adds the 32 partial sums in warp order. A Zipf head
//     id or an all-equal input (runs of 1e5-1e6 rows) so spreads over 32
//     warps instead of one, and the order of every sum is fixed by the
//     shapes alone: the result is the same in every run. No float atomics.
// Every touched row is written once; the wrapper zeroes the table first, so
// untouched rows are zero. Ids outside [0, V) are dropped, as JAX's scatter
// drops them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 64;            // columns of one warp: lane and lane + 32
constexpr int WARPS1 = 8;           // pass 1: chunks per block
constexpr int WARPS2 = 32;          // pass 2: warps adding one run's pieces
constexpr int UNROLL = 4;           // g rows loaded ahead of their additions
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ long long min_ll(long long a, long long b) { return a < b ? a : b; }

template <typename TG, typename TO>
__global__ void __launch_bounds__(WARPS1 * 32)
scatter_chunks(const TG* __restrict__ g, const int* __restrict__ sid,
               const long long* __restrict__ perm, long long n, int dim, long long vocab,
               int chunk, long long n_chunks, TO* __restrict__ out,
               float* __restrict__ part) {
    const int lane = threadIdx.x & 31;
    const long long c = (long long)blockIdx.x * WARPS1 + (threadIdx.x >> 5);
    if (c >= n_chunks) return;
    const int ca = blockIdx.y * COLS + lane, cb = ca + 32;
    const bool ha = ca < dim, hb = cb < dim;
    const long long lo = c * chunk, hi = min_ll(lo + chunk, n);
    const bool cont_before = lo > 0 && sid[lo - 1] == sid[lo];
    const bool cont_after = hi < n && sid[hi] == sid[hi - 1];

    float a0 = 0.f, a1 = 0.f;
    bool first_seg = true;
    for (long long j0 = lo; j0 < hi; j0 += 32) {
        // each lane fetches one sorted position's id and row; the warp then
        // walks them in order through shuffles
        const int cnt = (int)min_ll(32, hi - j0);
        const long long jl = j0 + lane;
        const int my_id = lane < cnt ? sid[jl] : 0;
        const long long my_row = lane < cnt ? perm[jl] : 0;
        const bool my_last = lane < cnt && (jl + 1 == hi || sid[jl + 1] != my_id);
        const unsigned last_mask = __ballot_sync(FULL, my_last);
        for (int t0 = 0; t0 < cnt; t0 += UNROLL) {
            float va[UNROLL], vb[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int t = t0 + u;
                const long long row = __shfl_sync(FULL, my_row, t & 31);
                const TG* gr = g + row * dim;
                va[u] = (t < cnt && ha) ? widen(gr[ca]) : 0.f;
                vb[u] = (t < cnt && hb) ? widen(gr[cb]) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int t = t0 + u;
                if (t < cnt) {
                    a0 += va[u];
                    a1 += vb[u];
                    if ((last_mask >> t) & 1u) {  // the same for every lane
                        const int id = __shfl_sync(FULL, my_id, t);
                        const bool last_seg = j0 + t + 1 == hi;
                        float* dst = nullptr;
                        if (first_seg && cont_before) dst = part + (c * 2) * dim;
                        else if (last_seg && cont_after) dst = part + (c * 2 + 1) * dim;
                        if (dst != nullptr) {
                            if (ha) dst[ca] = a0;
                            if (hb) dst[cb] = a1;
                        } else if (id >= 0 && id < vocab) {
                            TO* o = out + (long long)id * dim;
                            if (ha) o[ca] = narrow<TO>(a0);
                            if (hb) o[cb] = narrow<TO>(a1);
                        }
                        a0 = 0.f;
                        a1 = 0.f;
                        first_seg = false;
                    }
                }
            }
        }
    }
}

template <typename TO>
__global__ void __launch_bounds__(WARPS2 * 32)
scatter_spans(const int* __restrict__ sid, long long n, int dim, long long vocab, int chunk,
              const float* __restrict__ part, TO* __restrict__ out) {
    const long long c = blockIdx.x;
    const long long lo = c * chunk, hi = min_ll(lo + chunk, n);
    const int id = sid[hi - 1];
    // only the chunk where a crossing run starts adds it up
    if (!(hi < n && sid[hi] == id) || (lo > 0 && sid[lo - 1] == id)) return;
    long long a = hi, b = n;  // the run's end: the first position past id
    while (a < b) {
        const long long m = (a + b) >> 1;
        if (sid[m] <= id) a = m + 1; else b = m;
    }
    const long long pieces = (a - 1) / chunk - c + 1;  // chunk c's part[1], then part[0]s
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int ca = blockIdx.y * COLS + lane, cb = ca + 32;
    const bool ha = ca < dim, hb = cb < dim;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (long long i = warp; i < pieces; i += WARPS2) {
        const float* p = part + ((c + i) * 2 + (i == 0 ? 1 : 0)) * (long long)dim;
        a0 += ha ? p[ca] : 0.f;
        a1 += hb ? p[cb] : 0.f;
    }
    __shared__ float s0[WARPS2][32], s1[WARPS2][32];
    s0[warp][lane] = a0;
    s1[warp][lane] = a1;
    __syncthreads();
    if (warp == 0 && id >= 0 && id < vocab) {
        float t0 = 0.f, t1 = 0.f;
        for (int w = 0; w < WARPS2; ++w) {
            t0 += s0[w][lane];
            t1 += s1[w][lane];
        }
        TO* o = out + (long long)id * dim;
        if (ha) o[ca] = narrow<TO>(t0);
        if (hb) o[cb] = narrow<TO>(t1);
    }
}

template <typename TG, typename TO>
cudaError_t launch(const void* g, const int* sid, const long long* perm, long long n, int dim,
                   long long vocab, int chunk, void* out, float* part, cudaStream_t stream) {
    const long long n_chunks = (n + chunk - 1) / chunk;
    const unsigned col_blocks = (dim + COLS - 1) / COLS;
    const dim3 grid1((unsigned)((n_chunks + WARPS1 - 1) / WARPS1), col_blocks);
    scatter_chunks<TG, TO><<<grid1, WARPS1 * 32, 0, stream>>>(
        static_cast<const TG*>(g), sid, perm, n, dim, vocab, chunk, n_chunks,
        static_cast<TO*>(out), part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid2((unsigned)n_chunks, col_blocks);
    scatter_spans<TO><<<grid2, WARPS2 * 32, 0, stream>>>(sid, n, dim, vocab, chunk, part,
                                                         static_cast<TO*>(out));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// g (n_g, dim) row-major, float32 or bfloat16 (g_bf16 != 0); sid (n,) the
// ids sorted ascending by a stable sort, perm (n,) int64 the row of g at each
// sorted position; out (vocab, dim) zero-filled, float32 or bfloat16
// (out_bf16 != 0); part (ceil(n / chunk), 2, dim) float32 scratch.
// Returns the cudaError_t of the launches (0 on success).
int scatter_add_rows_launch(const void* g, int g_bf16, const int* sid, const long long* perm,
                            long long n, int dim, long long vocab, int chunk, void* out,
                            int out_bf16, float* part, void* stream) {
    if (n < 1 || dim < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (g_bf16) {
        if (out_bf16)
            return (int)launch<__nv_bfloat16, __nv_bfloat16>(g, sid, perm, n, dim, vocab, chunk,
                                                             out, part, s);
        return (int)launch<__nv_bfloat16, float>(g, sid, perm, n, dim, vocab, chunk, out, part, s);
    }
    if (out_bf16)
        return (int)launch<float, __nv_bfloat16>(g, sid, perm, n, dim, vocab, chunk, out, part, s);
    return (int)launch<float, float>(g, sid, perm, n, dim, vocab, chunk, out, part, s);
}

}  // extern "C"
