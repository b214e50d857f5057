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
// 134 MB of g, 4 MB of sorted ids and 8 MB of int64 positions, and write
// 8 MB of table: 0.046 ms. It does one addition per element read, far below
// any compute limit. So the design is about keeping enough g bytes in flight
// that the memory, and not a chain of dependent loads, sets the time.
//
// The wrapper sorts the ids stably once (torch.sort, the ids' preparation),
// keeping each sorted position's original row (perm). Equal ids then form
// runs whose rows are in original index order. The sorted positions are cut
// into chunks of `chunk` rows.
//  1. scatter_chunks: a team of lanes owns one chunk, each lane one 16-byte
//     slab of the row (8 bf16 or 4 f32 columns, widened into f32 registers):
//     8 lanes a team for a 128-byte row, 32 and column blocks in blockIdx.y
//     for rows wider than 512 bytes. A warp first copies the sids and perms
//     of all its teams' chunks into shared memory, so no g load waits behind
//     an id. Each team then walks its chunk U = 4 rows at a time, loading
//     the next group's rows (uint4 through the read-only path) before adding
//     the current group: 4 to 8 rows a team in flight. A row whose
//     bytes are not a multiple of 16, or a g that is not 16-byte aligned,
//     takes the same loop with scalar loads (VECTOR = false). A run wholly
//     inside the chunk is written straight to its table row; the piece of a
//     run that crosses the chunk's start goes to part[c][0], the piece that
//     crosses its end to part[c][1]. The team where a crossing run starts
//     appends its chunk to a compact list (integer atomicAdd on a counter
//     the wrapper zeroes).
//  2. scatter_spans: a fixed grid (a full SM of threads each) walks that
//     list, whose length it reads on the device, so the host never waits on
//     the card. Design (a) of two: a list and a second launch, rather than
//     "the last piece's block adds the run", because that would need a
//     __threadfence and a per-run arrival counter in every pass-1 team and
//     would sum a Zipf head run of ~1,000 pieces in one warp. Here a block
//     (16 warps on the main path; the plan's span_warps) takes one run at a
//     time: it counts the run's pieces from the first id of each later chunk
//     while each warp loads its first piece, warp w adds pieces w, w + W, ...
//     in order, then warp 0 adds the W partial sums in warp order. The
//     list's length and next entry are read ahead, so a run costs about one
//     dependent round trip beyond its own pieces. Entries of the list write
//     different table rows, so the list's order does not matter.
// Summation order: within a run, each chunk's rows in sorted (= original
// index) order; the pieces of a crossing run strided over W warps in piece
// order, then the warps in order. It is fixed by the ids and the shapes
// alone, so every run gives the same bits; no float atomics. Every touched
// row is written once; the wrapper zeroes the table first, so untouched rows
// are zero. Ids outside [0, V) are dropped, as JAX's scatter drops them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS1 = 8;     // pass 1: warps per block, at most
constexpr int SLABS = 32;         // pass 1: 16-byte slabs of a row per column block
constexpr int SMEM_LIMIT = 48 * 1024;
constexpr int U = 4;              // pass 1: rows a team loads per group
constexpr int MAX_WARPS2 = 32;    // pass 2: warps adding one run's pieces, at most
constexpr int COLS2 = 64;         // pass 2: columns of a block (lane and lane + 32)

template <typename T> struct Vec;  // elements in 16 bytes
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

// element e of a 16-byte slab, widened to f32 (exact, as __bfloat162float)
template <typename T> __device__ __forceinline__ float widen(const uint4& r, int e);
template <> __device__ __forceinline__ float widen<float>(const uint4& r, int e) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
    return __uint_as_float(w[e]);
}
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(const uint4& r, int e) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
    const unsigned x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
}

// the slab at columns [col0, col0 + N) of one row, element by element,
// zero past dim: the fallback for rows or pointers off 16-byte alignment
template <typename T>
__device__ __forceinline__ uint4 load_scalar(const T* row, int col0, int dim) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < Vec<T>::N; ++e) {
        if (col0 + e < dim) {
            if constexpr (sizeof(T) == 4)
                w[e] = __ldg(reinterpret_cast<const unsigned*>(row) + col0 + e);
            else
                w[e >> 1] |= (unsigned)__ldg(reinterpret_cast<const unsigned short*>(row) +
                                             col0 + e) << ((e & 1) * 16);
        }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ long long min_ll(long long a, long long b) { return a < b ? a : b; }

// shared ints of one pass-1 warp: sid[wlo - 1 .. wlo + span] and the rows
// of perm[wlo .. wlo + span)
__host__ __device__ __forceinline__ long long warp_smem_ints(long long span) {
    return 2 * span + 2;
}

template <typename TG, typename TO, bool VECTOR>
__global__ void __launch_bounds__(MAX_WARPS1 * 32)
scatter_chunks(const TG* __restrict__ g, const int* __restrict__ sid,
               const long long* __restrict__ perm, long long n, int dim, long long vocab,
               int chunk, long long n_chunks, int team_lanes, TO* __restrict__ out,
               float* __restrict__ part, int* __restrict__ spans) {
    constexpr int VEC = Vec<TG>::N;
    extern __shared__ int smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int teams = 32 / team_lanes, span = teams * chunk;
    const long long c0 = ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * teams;
    if (c0 >= n_chunks) return;
    const long long wlo = c0 * chunk;
    int* s_sid = smem + warp * warp_smem_ints(span);
    int* s_row = s_sid + span + 2;
    // the ids first: every sid and row of the warp's chunks, before any g load
#pragma unroll 8
    for (int i = lane; i < span + 2; i += 32) {
        const long long j = wlo - 1 + i;
        s_sid[i] = j >= 0 && j < n ? __ldg(sid + j) : 0;
        if (i < span) s_row[i] = j + 1 < n ? (int)__ldg(perm + j + 1) : 0;
    }
    __syncwarp();

    const int team = lane / team_lanes, tl = lane % team_lanes;
    const long long c = c0 + team;
    if (c >= n_chunks) return;  // no warp-wide step follows
    const long long lo = c * chunk;
    const int cnt = (int)min_ll(chunk, n - lo);
    const int* ts = s_sid + team * chunk + 1;  // ts[t] = sid[lo + t], for t in [-1, cnt]
    const int* tr = s_row + team * chunk;
    const bool cont_before = lo > 0 && ts[-1] == ts[0];
    const bool cont_after = lo + cnt < n && ts[cnt] == ts[cnt - 1];
    if (cont_after && blockIdx.y == 0 && tl == 0 && !(cont_before && ts[0] == ts[cnt - 1])) {
        const int id = ts[cnt - 1];  // a crossing run starts here
        if (id >= 0 && id < vocab) spans[1 + atomicAdd(spans, 1)] = (int)c;
    }

    const int slab = blockIdx.y * SLABS + tl;
    const bool has = slab * VEC < dim;
    const int col0 = slab * VEC;
    auto load = [&](int t) -> uint4 {
        if (t >= cnt || !has) return make_uint4(0u, 0u, 0u, 0u);
        const TG* row = g + (long long)tr[t] * dim;
        if constexpr (VECTOR) return __ldg(reinterpret_cast<const uint4*>(row + col0));
        else return load_scalar(row, col0, dim);
    };

    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    bool first_seg = true;
    uint4 cur[U], nxt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = load(u);
    for (int t0 = 0; t0 < cnt; t0 += U) {
#pragma unroll
        for (int u = 0; u < U; ++u) nxt[u] = load(t0 + U + u);  // before these adds
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int t = t0 + u;
            if (t >= cnt) break;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] += widen<TG>(cur[u], e);
            if (t + 1 < cnt && ts[t + 1] == ts[t]) continue;
            // a run ends at t: its sum goes to part or to its table row
            float* dst = nullptr;
            if (first_seg && cont_before) dst = part + c * 2 * dim;
            else if (t + 1 == cnt && cont_after) dst = part + (c * 2 + 1) * dim;
            const int id = ts[t];
            if (has && dst != nullptr) {
                if constexpr (VECTOR) {  // dim % VEC == 0: 16-byte aligned
#pragma unroll
                    for (int q = 0; q < VEC / 4; ++q)
                        reinterpret_cast<float4*>(dst + col0)[q] = make_float4(
                            acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
                } else {
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                        if (col0 + e < dim) dst[col0 + e] = acc[e];
                }
            } else if (has && id >= 0 && id < vocab) {
                TO* o = out + (long long)id * dim + col0;
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    if (VECTOR || col0 + e < dim) o[e] = narrow<TO>(acc[e]);
            }
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
            first_seg = false;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
}

template <typename TO>
__global__ void __launch_bounds__(MAX_WARPS2 * 32, 2)
scatter_spans(const int* __restrict__ sid, long long n, int dim, long long vocab, int chunk,
              long long n_chunks, const int* __restrict__ spans,
              const float* __restrict__ part, TO* __restrict__ out) {
    __shared__ float s0[MAX_WARPS2][32], s1[MAX_WARPS2][32];
    const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int ca = blockIdx.y * COLS2 + lane, cb = ca + 32;
    const bool ha = ca < dim, hb = cb < dim;
    // the list's length (written by pass 1) and this block's first entry,
    // read together: gridDim.x < n_chunks, so the entry is in the buffer,
    // and one past the length is never used
    const int count = spans[0];
    int next = spans[1 + blockIdx.x];
    for (int e = blockIdx.x; e < count; e += gridDim.x) {
        const long long c = next;
        if (e + gridDim.x < count) next = spans[1 + e + gridDim.x];
        const int id = sid[min_ll((c + 1) * chunk, n) - 1];
        // piece `warp` is loaded while the pieces are counted (part holds
        // every chunk's; one past the run is not added): chunk c's part[1],
        // then part[0] of every later chunk that starts with id (they follow
        // c: the ids are sorted)
        const float* p0 = part + ((c + warp) * 2 + (warp == 0 ? 1 : 0)) * (long long)dim;
        const bool in = c + warp < n_chunks;
        float a0 = in && ha ? p0[ca] : 0.f, a1 = in && hb ? p0[cb] : 0.f;
        long long pieces = 1;
        for (long long base = c + 1;; base += blockDim.x) {
            const long long cc = base + threadIdx.x;
            const int same = __syncthreads_count(cc < n_chunks && sid[cc * chunk] == id);
            pieces += same;
            if (same < (int)blockDim.x) break;
        }
        if (warp >= pieces) a0 = a1 = 0.f;
#pragma unroll 8
        for (long long i = warp + warps; i < pieces; i += warps) {
            const float* p = part + (c + i) * 2 * (long long)dim;
            a0 += ha ? p[ca] : 0.f;
            a1 += hb ? p[cb] : 0.f;
        }
        s0[warp][lane] = a0;
        s1[warp][lane] = a1;
        __syncthreads();
        if (warp == 0) {
            float t0 = 0.f, t1 = 0.f;
            for (int w = 0; w < warps; ++w) {
                t0 += s0[w][lane];
                t1 += s1[w][lane];
            }
            TO* o = out + (long long)id * dim;
            if (ha) o[ca] = narrow<TO>(t0);
            if (hb) o[cb] = narrow<TO>(t1);
        }
        __syncthreads();  // s0/s1 are reused by the next entry
    }
}

struct Args {
    const void* g;
    const int* sid;
    const long long* perm;
    long long n;
    int dim;
    long long vocab;
    int chunk;
    long long n_chunks;
    int team_lanes;
    void* out;
    float* part;
    int* spans;
};

template <typename TG, typename TO, bool VECTOR>
struct Pass1 {
    static const void* kernel() {
        return reinterpret_cast<const void*>(&scatter_chunks<TG, TO, VECTOR>);
    }
    static void launch(dim3 grid, int threads, size_t smem, cudaStream_t s, const Args& a) {
        scatter_chunks<TG, TO, VECTOR><<<grid, threads, smem, s>>>(
            static_cast<const TG*>(a.g), a.sid, a.perm, a.n, a.dim, a.vocab, a.chunk,
            a.n_chunks, a.team_lanes, static_cast<TO*>(a.out), a.part, a.spans);
    }
};

template <typename TG, typename TO, typename F>
void visit_loads(int vector, F&& f) {
    if (vector) f(Pass1<TG, TO, true>{});
    else f(Pass1<TG, TO, false>{});
}

// calls f with the Pass1 instantiation of these types and loads
template <typename F>
void visit_pass1(int g_bf16, int out_bf16, int vector, F&& f) {
    using bf16 = __nv_bfloat16;
    if (g_bf16) {
        if (out_bf16) visit_loads<bf16, bf16>(vector, f);
        else visit_loads<bf16, float>(vector, f);
    } else {
        if (out_bf16) visit_loads<float, bf16>(vector, f);
        else visit_loads<float, float>(vector, f);
    }
}

const void* pass2_kernel(int out_bf16) {
    return out_bf16 ? reinterpret_cast<const void*>(&scatter_spans<__nv_bfloat16>)
                    : reinterpret_cast<const void*>(&scatter_spans<float>);
}

}  // namespace

extern "C" {

// g (n, dim) row-major, float32 or bfloat16 (g_bf16 != 0); sid (n,) the ids
// sorted ascending by a stable sort, perm (n,) int64 the row of g at each
// sorted position; out (vocab, dim) zero-filled, float32 or bfloat16
// (out_bf16 != 0); part (ceil(n / chunk), 2, dim) float32 scratch; spans
// (1 + ceil(n / chunk),) int32 scratch whose first entry is zero.
// The plan (kernels/scatter_add.py:plan): team_lanes lanes a row (a power of
// two, at least the row's 16-byte slabs up to 32), `warps` warps a pass-1
// block, vector != 0 for 16-byte loads (g 16-byte
// aligned and dim a multiple of 16 bytes), span_blocks pass-2 blocks of
// span_warps warps (0 blocks: no pass 2; else fewer than the chunks).
// Returns the cudaError_t of the launches (0 on success).
int scatter_add_rows_launch(const void* g, int g_bf16, const int* sid, const long long* perm,
                            long long n, int dim, long long vocab, int chunk, int team_lanes,
                            int warps, int vector, void* out, int out_bf16,
                            float* part, int* spans, int span_blocks, int span_warps,
                            void* stream) {
    const int vec = g_bf16 ? 8 : 4;
    const int slabs = (dim + vec - 1) / vec;
    if (n < 1 || dim < 1 || chunk < 1 || team_lanes < 1 || team_lanes > 32 ||
        (team_lanes & (team_lanes - 1)) != 0 || team_lanes < (slabs < SLABS ? slabs : SLABS) ||
        warps < 1 || warps > MAX_WARPS1 || span_warps < 1 || span_warps > MAX_WARPS2)
        return (int)cudaErrorInvalidValue;
    const long long n_chunks = (n + chunk - 1) / chunk;
    if (span_blocks < 0 || (span_blocks > 0 && span_blocks >= n_chunks))
        return (int)cudaErrorInvalidValue;
    if (vector && (dim % vec != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0))
        return (int)cudaErrorInvalidValue;
    const long long teams = 32 / team_lanes;
    const long long smem = warps * warp_smem_ints(teams * chunk) * (long long)sizeof(int);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid1((unsigned)((n_chunks + teams * warps - 1) / (teams * warps)),
                     (unsigned)((slabs + SLABS - 1) / SLABS));
    const Args a{g, sid, perm, n, dim, vocab, chunk, n_chunks, team_lanes, out, part, spans};
    visit_pass1(g_bf16, out_bf16, vector, [&](auto pass1) {
        decltype(pass1)::launch(grid1, warps * 32, (size_t)smem, s, a);
    });
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || span_blocks == 0) return (int)err;
    const dim3 grid2((unsigned)span_blocks, (unsigned)((dim + COLS2 - 1) / COLS2));
    if (out_bf16)
        scatter_spans<__nv_bfloat16><<<grid2, span_warps * 32, 0, s>>>(
            sid, n, dim, vocab, chunk, n_chunks, spans, part, static_cast<__nv_bfloat16*>(out));
    else
        scatter_spans<float><<<grid2, span_warps * 32, 0, s>>>(
            sid, n, dim, vocab, chunk, n_chunks, spans, part, static_cast<float*>(out));
    return (int)cudaGetLastError();
}

// Blocks of each pass that fit on one SM of the current device, as the CUDA
// runtime reports them for this plan (registers and shared memory count).
// Returns the cudaError_t (0 on success).
int scatter_add_rows_occupancy(int g_bf16, int out_bf16, int vector, int warps, int smem_bytes,
                               int span_warps, int* pass1_blocks, int* pass2_blocks) {
    const void* k1 = nullptr;
    visit_pass1(g_bf16, out_bf16, vector, [&](auto pass1) { k1 = decltype(pass1)::kernel(); });
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(pass1_blocks, k1, warps * 32,
                                                                    (size_t)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(pass2_blocks,
                                                              pass2_kernel(out_bf16),
                                                              span_warps * 32, 0);
}

}  // extern "C"
