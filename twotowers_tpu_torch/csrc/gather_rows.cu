// Row gather with the cast fused in, for Hopper (sm_90a):
// out[j, :] = table[ids[j], :] converted to the compute dtype.
//
// Replaces the TPU row-gather kernels tools/exp_pallas_embed.py:pallas_gather
// and tools/exp_pallas_embed2.py:pallas_gather / pallas_gather_take, and is
// the forward of the port's word-scale embedding lookup (the JAX package's
// _take_scatter_grad forward, jnp.take(table.astype(dtype), ids)).
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. At the main path's
// shape (N = 1,048,576 ids, D = 64, an 8 MB f32 table, bf16 out) it must
// read 4 MB of ids and the table once and write 134 MB: 0.044 ms. The
// table is small enough to stay in the 50 MB L2, so its rows are re-read
// from there, not from memory.
//
// Design: one thread per VEC consecutive columns of one output row, so
// neighbouring threads read neighbouring columns of one table row with one
// 16-byte load each (VEC = 4 f32 or 8 bf16) where D and the pointers allow,
// else one element each (VEC = 1). The cast to the output type happens in
// registers. Ids outside [0, V) read as the zero padding row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
    T v[N];
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename TI, typename TO, int VEC>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const TI* __restrict__ table, const int* __restrict__ ids, long long n,
                   int dim, long long vocab, TO* __restrict__ out) {
    const int per_row = dim / VEC;
    const long long total = n * per_row;
    for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < total;
         t += (long long)gridDim.x * THREADS) {
        const long long j = t / per_row;
        const int col = (int)(t - j * per_row) * VEC;
        const int id = ids[j];
        Vec<TO, VEC> o;
        if (id >= 0 && id < vocab) {
            const Vec<TI, VEC> x =
                *reinterpret_cast<const Vec<TI, VEC>*>(table + (long long)id * dim + col);
#pragma unroll
            for (int u = 0; u < VEC; ++u) o.v[u] = narrow<TO>(widen(x.v[u]));
        } else {
#pragma unroll
            for (int u = 0; u < VEC; ++u) o.v[u] = narrow<TO>(0.f);
        }
        *reinterpret_cast<Vec<TO, VEC>*>(out + j * dim + col) = o;
    }
}

template <typename TI, typename TO, int VEC>
cudaError_t launch(const void* table, const int* ids, long long n, int dim, long long vocab,
                   void* out, cudaStream_t stream) {
    const long long total = n * (dim / VEC);
    const long long blocks = (total + THREADS - 1) / THREADS;
    const unsigned grid = (unsigned)(blocks < 1048576 ? blocks : 1048576);
    gather_rows_kernel<TI, TO, VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const TI*>(table), ids, n, dim, vocab, static_cast<TO*>(out));
    return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_vec(const void* table, const int* ids, long long n, int dim,
                       long long vocab, void* out, int vectorize, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(TI);
    if (vectorize) return launch<TI, TO, VEC>(table, ids, n, dim, vocab, out, stream);
    return launch<TI, TO, 1>(table, ids, n, dim, vocab, out, stream);
}

}  // namespace

extern "C" {

// table (vocab, dim) row-major, float32 or bfloat16 (table_bf16 != 0); ids
// (n,) int32; out (n, dim), float32 or bfloat16 (out_bf16 != 0). vectorize
// != 0 asks for 16-byte table loads: the caller checks that dim is a
// multiple of 16 bytes' worth of table elements and that both pointers are
// 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
int gather_rows_launch(const void* table, int table_bf16, const int* ids, long long n, int dim,
                       long long vocab, void* out, int out_bf16, int vectorize, void* stream) {
    if (n < 1 || dim < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (table_bf16) {
        if (out_bf16)
            return (int)launch_vec<__nv_bfloat16, __nv_bfloat16>(table, ids, n, dim, vocab, out,
                                                                 vectorize, s);
        return (int)launch_vec<__nv_bfloat16, float>(table, ids, n, dim, vocab, out, vectorize, s);
    }
    if (out_bf16)
        return (int)launch_vec<float, __nv_bfloat16>(table, ids, n, dim, vocab, out, vectorize, s);
    return (int)launch_vec<float, float>(table, ids, n, dim, vocab, out, vectorize, s);
}

}  // extern "C"
