// Row gather with the cast fused in, for Hopper (sm_90a):
// out[j, :] = table[ids[j], :] converted to the output's dtype.
//
// Replaces the TPU row-gather kernels tools/exp_pallas_embed.py:pallas_gather
// and tools/exp_pallas_embed2.py:pallas_gather / pallas_gather_take, and is
// the forward of the port's word-scale embedding lookup (the JAX package's
// _take_scatter_grad forward, jnp.take(table.astype(dtype), ids)).
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. At the word train
// step's shape (N = 1,048,576 ids, D = 64, an 8 MB f32 table, bf16 out) it
// must read 4 MB of ids and the table once and write 134 MB: 0.044 ms, and
// the output is 91% of those bytes. The table stays in the 50 MB L2, so
// its rows are re-read from there, not from memory.
//
// There is no product, so no tensor-core path, and no tile to stage: each
// row is read once and written once, so TMA would only add a trip through
// shared memory. The design is about the bytes in flight and the
// instructions per byte:
// - a team of `lanes` lanes (a power of 2, up to 32) takes a row; each
//   lane moves slabs of E columns, where E makes a store 16 bytes (f32 ->
//   bf16: two 16-byte loads into one 16-byte store; f32 -> f32 and bf16 ->
//   bf16: one load, one store; bf16 -> f32: one load, two stores). Where
//   the row or a pointer is off that width, E halves (8-, 4-byte vectors)
//   down to one element. Rows wider than the team loop over column blocks;
// - a warp takes a tile of (32 / lanes) * R rows: one coalesced load of
//   the tile's ids, handed to the teams by shuffle. Each lane issues the
//   loads of its R rows (and of 4 / R column blocks of each) before it
//   stores any. No division or 64-bit multiply per element: the team and
//   tile arithmetic is shifts on 32-bit counters, the addresses (size_t)id
//   * dim and (size_t)row * dim;
// - the output is written with streaming stores (st.global.cs), so that it
//   does not evict the table from L2; the table's loads take the read-only
//   path (LDG.CONSTANT) through const __restrict__ alone;
// - a grid of as many blocks of 8 warps as fit on the card (the launch
//   bound's 4 an SM), striding over the tiles.
// f32 -> bf16 rounds to nearest even (__float2bfloat16, as torch's
// .to(torch.bfloat16)); every other pair moves bits. Ids outside [0, V)
// write a zero row and read nothing: the row-sharded lookup hands each
// shard the ids other shards own. The plan (E, lanes, R, grid) is made by
// gather.plan in kernels/gather.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // 8 warps a block
constexpr int BLOCKS_PER_SM = 4;  // the launch bound: at most 64 registers a thread
constexpr int SLOTS = 4;          // slabs a lane keeps in flight: R rows x G column blocks

// the element type of a slab: the dtype's bits
template <typename T> struct Bits;
template <> struct Bits<float> { using T = float; };
template <> struct Bits<__nv_bfloat16> { using T = unsigned short; };

// an unsigned type of B bytes, the widest access of a slab
template <int B> struct Word;
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// E elements of T: one lane's columns of one row, moved as words of up to
// 16 bytes
template <typename T, int E>
union Slab {
    static constexpr int BYTES = E * (int)sizeof(typename Bits<T>::T);
    static constexpr int WORD = BYTES < 16 ? BYTES : 16;
    static constexpr int WORDS = BYTES / WORD;
    using W = typename Word<WORD>::T;
    typename Bits<T>::T e[E];
    W w[WORDS];
};

template <typename TI, typename TO, int E>
__device__ __forceinline__ void convert(const Slab<TI, E>& x, Slab<TO, E>& y) {
    if constexpr (sizeof(TI) == sizeof(TO)) {
#pragma unroll
        for (int k = 0; k < Slab<TI, E>::WORDS; ++k) y.w[k] = x.w[k];
    } else if constexpr (sizeof(TI) == 4) {  // f32 -> bf16, to nearest even
#pragma unroll
        for (int u = 0; u < E; ++u) y.e[u] = __bfloat16_as_ushort(__float2bfloat16(x.e[u]));
    } else {  // bf16 -> f32: exact
#pragma unroll
        for (int u = 0; u < E; ++u) y.e[u] = __uint_as_float((unsigned)x.e[u] << 16);
    }
}

template <typename TI, typename TO, int E, int R, int G = SLOTS / R>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gather_rows_kernel(const TI* __restrict__ table, const int* __restrict__ ids, int n, int dim,
                   long long vocab, TO* __restrict__ out, int lane_shift) {
    using In = Slab<TI, E>;
    using Out = Slab<TO, E>;
    constexpr int ROW_SHIFT = R == 4 ? 2 : R == 2 ? 1 : 0;
    const int lane = threadIdx.x & 31;
    const int lanes = 1 << lane_shift;  // a team's, a power of 2: shifts, no division
    const int teams = 32 >> lane_shift;
    const int team = lane >> lane_shift;
    // a tile: row r of team t is the tile's row r * teams + t, whose id
    // lane r * teams + t loads (R <= lanes, so a tile has at most 32 rows)
    const int tile_shift = 5 - lane_shift + ROW_SHIFT;
    const unsigned tile_rows = 1u << tile_shift;
    const unsigned tiles = ((unsigned)n + tile_rows - 1) >> tile_shift;
    const unsigned warps = gridDim.x * (THREADS / 32);
    const auto* tab = reinterpret_cast<const typename Bits<TI>::T*>(table);
    auto* dst = reinterpret_cast<typename Bits<TO>::T*>(out);
    for (unsigned tile = blockIdx.x * (THREADS / 32) + threadIdx.x / 32; tile < tiles;
         tile += warps) {
        const unsigned base = tile * tile_rows;
        const int mine =
            (unsigned)lane < tile_rows && base + lane < (unsigned)n ? ids[base + lane] : -1;
        int id[R];
        bool live[R], owned[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            id[r] = __shfl_sync(0xffffffffu, mine, r * teams + team);
            live[r] = base + (unsigned)(r * teams + team) < (unsigned)n;
            owned[r] = live[r] && id[r] >= 0 && id[r] < vocab;
        }
        // G column blocks of each of the R rows a round: their loads, then
        // their stores
        const int stride = lanes * E;
        for (int c0 = (lane - team * lanes) * E; c0 < dim; c0 += G * stride) {
            In x[R][G];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const auto* row = tab + (size_t)(owned[r] ? id[r] : 0) * dim;
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const int c = c0 + g * stride;
                    const auto* p = reinterpret_cast<const typename In::W*>(row + c);
#pragma unroll
                    for (int k = 0; k < In::WORDS; ++k)
                        x[r][g].w[k] = (owned[r] && c < dim) ? p[k] : typename In::W{};
                }
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (!live[r]) continue;
                auto* row = dst + (size_t)(base + (unsigned)(r * teams + team)) * dim;
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const int c = c0 + g * stride;
                    if (c >= dim) break;
                    Out y;
                    convert<TI, TO, E>(x[r][g], y);
                    auto* q = reinterpret_cast<typename Out::W*>(row + c);
#pragma unroll
                    for (int k = 0; k < Out::WORDS; ++k) __stcs(q + k, y.w[k]);
                }
            }
        }
    }
}

template <typename TI, typename TO>
using Kernel = void (*)(const TI*, const int*, int, int, long long, TO*, int);

template <typename TI, typename TO, int E>
Kernel<TI, TO> by_rows(int rows) {
    if (rows == 1) return gather_rows_kernel<TI, TO, E, 1>;
    if (rows == 2) return gather_rows_kernel<TI, TO, E, 2>;
    if (rows == 4) return gather_rows_kernel<TI, TO, E, 4>;
    return nullptr;
}

// the kernel of a plan's elements a lane and rows in flight; null for a
// pair the kernel does not take
template <typename TI, typename TO>
Kernel<TI, TO> pick(int elems, int rows) {
    constexpr int EMAX = 16 / (sizeof(TI) < sizeof(TO) ? sizeof(TI) : sizeof(TO));
    switch (elems) {
        case 8:
            if constexpr (EMAX >= 8) return by_rows<TI, TO, 8>(rows);
            return nullptr;
        case 4: return by_rows<TI, TO, 4>(rows);
        case 2: return by_rows<TI, TO, 2>(rows);
        case 1: return by_rows<TI, TO, 1>(rows);
        default: return nullptr;
    }
}

template <typename TI, typename TO>
cudaError_t launch(const void* table, const int* ids, void* out, int n, int dim, long long vocab,
                   int elems, int lane_shift, int rows, int blocks, cudaStream_t stream) {
    const Kernel<TI, TO> kernel = pick<TI, TO>(elems, rows);
    // every access of a slab is aligned: its words are at most 16 bytes
    const uintptr_t in_word = elems * sizeof(TI) < 16 ? elems * sizeof(TI) : 16;
    const uintptr_t out_word = elems * sizeof(TO) < 16 ? elems * sizeof(TO) : 16;
    if (kernel == nullptr || rows > (1 << lane_shift) || dim % elems != 0 ||
        (uintptr_t)table % in_word != 0 || (uintptr_t)out % out_word != 0)
        return cudaErrorInvalidValue;
    kernel<<<blocks, THREADS, 0, stream>>>(static_cast<const TI*>(table), ids, n, dim, vocab,
                                           static_cast<TO*>(out), lane_shift);
    return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t occupancy(int elems, int rows, int* blocks_per_sm) {
    const Kernel<TI, TO> kernel = pick<TI, TO>(elems, rows);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS, 0);
}

}  // namespace

extern "C" {

// table (vocab, dim) row-major, float32 or bfloat16; ids (n,) int32, 1 <= n
// < 2**31; out (n, dim), float32 or bfloat16; the three pointers and the
// stream as 64-bit integers, which ctypes converts faster than pointers
// (the call is most of a small lookup's time). code packs the plan
// (gather.plan) and the dtypes, so that a launch converts few arguments:
// bits 0-3 elems, the columns a lane moves at a time (dim a multiple of it,
// both pointers aligned to its accesses); bits 4-7 log2 of the lanes a row
// (0 to 5); bits 8-11 rows a lane keeps in flight (1, 2 or 4, at most the
// lanes; 4 / rows column blocks of each in flight beside them); bit 16 a
// bfloat16 table; bit 17 a bfloat16 output. blocks is the grid, of 8 warps
// a block. Returns the cudaError_t of the launch (0 on success).
int gather_rows_launch(long long table, long long ids, long long out, long long n, int dim,
                       long long vocab, int code, int blocks, long long stream) {
    const int elems = code & 15, lane_shift = (code >> 4) & 15, rows = (code >> 8) & 15;
    if (n < 1 || n >= (1LL << 31) || dim < 1 || blocks < 1 || lane_shift > 5)
        return (int)cudaErrorInvalidValue;
    const void* t = reinterpret_cast<const void*>(table);
    const int* i = reinterpret_cast<const int*>(ids);
    void* o = reinterpret_cast<void*>(out);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int m = (int)n;
    if (code & (1 << 16)) {
        if (code & (1 << 17))
            return (int)launch<__nv_bfloat16, __nv_bfloat16>(t, i, o, m, dim, vocab, elems,
                                                             lane_shift, rows, blocks, s);
        return (int)launch<__nv_bfloat16, float>(t, i, o, m, dim, vocab, elems, lane_shift,
                                                 rows, blocks, s);
    }
    if (code & (1 << 17))
        return (int)launch<float, __nv_bfloat16>(t, i, o, m, dim, vocab, elems, lane_shift,
                                                 rows, blocks, s);
    return (int)launch<float, float>(t, i, o, m, dim, vocab, elems, lane_shift, rows, blocks,
                                     s);
}

// Blocks of the kernel of (elems, rows) for this pair of dtypes that fit on
// one SM, as the CUDA runtime reports them.
int gather_rows_occupancy(int table_bf16, int out_bf16, int elems, int rows, int* blocks_per_sm) {
    if (table_bf16)
        return (int)(out_bf16 ? occupancy<__nv_bfloat16, __nv_bfloat16>(elems, rows, blocks_per_sm)
                              : occupancy<__nv_bfloat16, float>(elems, rows, blocks_per_sm));
    return (int)(out_bf16 ? occupancy<float, __nv_bfloat16>(elems, rows, blocks_per_sm)
                          : occupancy<float, float>(elems, rows, blocks_per_sm));
}

}  // extern "C"
