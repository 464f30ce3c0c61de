// Segmented reduce for the aggregation device bank, for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
// (siddhi_tpu/kernels/bank_scatter.py, _build via segmented_reduce):
//
//   in : rows [n] int32, vals [n] float32 or int32, identity of the op
//   out: out [r_pad], out[r] = identity (+) { vals[e] : rows[e] == r }
//
// with (+) one of sum (count is a sum of ones), min or max.  n is a power
// of two >= 256 and r_pad a multiple of 256, as the bank pads them; an
// event whose row lies outside [0, r_pad) contributes nothing, as in the
// one-hot reference.
//
// The Pallas kernel compares every event with every row (O(n r) work, so a
// hot key costs the same as a cold one).  Here the work is O(n) and a hot
// key still does not serialise:
//
// - A block owns a tile of up to kRowTile rows and a chunk of up to kChunk
//   events; each of its 8 warps keeps a private copy of the tile's
//   accumulators in shared memory (8 x 4352 x 4 B = 139,264 B).
// - A warp walks its events 32 at a time, in order.  Lanes whose events
//   share a row find each other with __match_any_sync; the lowest lane of
//   each group combines the group's values in lane order and updates the
//   warp's copy of that row.  When all 32 lanes share one row (the hot-key
//   case) the warp combines them with a fixed xor butterfly instead.  No
//   global atomics: 32,768 events on one row cost each warp one combine
//   per 32 events.
// - The block combines its warps' copies in warp order into its chunk's
//   partial row.  The last block of a row tile to finish (counted on a
//   per-tile arrival counter, which it resets for the next launch)
//   combines the chunks' partials in chunk order into the output, so a
//   call is one launch.  With a single chunk the block writes the output
//   directly.
//
// Every combine happens in an order fixed by the shapes alone, so the same
// input gives the same bits on every launch.  Integer lanes and min/max are
// order-free and therefore bit-identical to the reference; float sums
// associate differently from it (within n * 2^-24 * sum|v| for a row of n
// events, the reference's own contract).
//
// Semantics of the reference (jnp.minimum/maximum, XLA's scatter): float
// min/max propagate NaN and order -0.0 below +0.0; int32 sums wrap.  fminf
// and fmaxf drop NaN, so the float combines are written as selects.
//
// Bound: bytes.  At n = 32,768, r_pad = 4,352 the kernel reads 262,144 B
// and writes 17,408 B (0.08 us at 3.35 TB/s); launch cost dominates.  A
// simple correct kernel first: the tile initialisation and warp combine in
// shared memory cost about as much as a chunk of events.
// Build without --use_fast_math: the adds and compares must stay IEEE.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowTile = 4352;  // rows a block owns: the bank's default r_pad
constexpr int kChunk = 4096;    // events a block reduces
constexpr int kBatch = 8;       // chunk partials loaded at once in the combine
constexpr unsigned kFull = 0xffffffffu;

enum { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ float min_ref(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    if (a < b) return a;
    if (b < a) return b;
    // equal: only +0.0 / -0.0 differ in bits; -0.0 is the smaller
    return __int_as_float(__float_as_int(a) | __float_as_int(b));
}

__device__ __forceinline__ float max_ref(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    if (a > b) return a;
    if (b > a) return b;
    return __int_as_float(__float_as_int(a) & __float_as_int(b));
}

template <int OP>
__device__ __forceinline__ float comb(float a, float b) {
    if (OP == kSum) return a + b;
    if (OP == kMin) return min_ref(a, b);
    return max_ref(a, b);
}

template <int OP>
__device__ __forceinline__ int32_t comb(int32_t a, int32_t b) {
    if (OP == kSum) return (int32_t)((uint32_t)a + (uint32_t)b);  // wraps
    if (OP == kMin) return a < b ? a : b;
    return a > b ? a : b;
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int32_t> { using type = int4; };

template <int OP, typename V>
__device__ __forceinline__ V comb4(V a, V b) {
    return V{comb<OP>(a.x, b.x), comb<OP>(a.y, b.y), comb<OP>(a.z, b.z),
             comb<OP>(a.w, b.w)};
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) bank_scatter_kernel(
    const int32_t* __restrict__ rows, const T* __restrict__ vals,
    T* __restrict__ out, T* __restrict__ partial,
    unsigned* __restrict__ arrivals, int r_pad, int chunk, T ident) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tile_lo = blockIdx.x * kRowTile;
    const int tile_rows = min(kRowTile, r_pad - tile_lo);
    T* acc = reinterpret_cast<T*>(smem);   // [kWarps][tile_rows]
    T* stage = acc + kWarps * tile_rows;   // [kWarps][32]
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    for (int k = threadIdx.x; k < kWarps * tile_rows; k += kThreads)
        acc[k] = ident;
    __syncthreads();

    T* mine = acc + warp * tile_rows;
    T* st = stage + warp * 32;
    const int per_warp = chunk / kWarps;  // a multiple of 32
    const int64_t e_lo = (int64_t)blockIdx.y * chunk + warp * per_warp;
    for (int64_t e0 = e_lo; e0 < e_lo + per_warp; e0 += 32) {
        const int r = rows[e0 + lane] - tile_lo;
        const T v = vals[e0 + lane];
        const bool in = r >= 0 && r < tile_rows;
        const unsigned active = __ballot_sync(kFull, in);
        if (!active) continue;  // uniform across the warp
        const unsigned peers = __match_any_sync(kFull, in ? r : -1);
        if (__all_sync(kFull, in && peers == kFull)) {
            // every lane on one row: a fixed butterfly over the warp
            T x = v;
            for (int o = 16; o > 0; o >>= 1)
                x = comb<OP>(x, __shfl_xor_sync(kFull, x, o));
            if (lane == 0) mine[r] = comb<OP>(mine[r], x);
            continue;
        }
        st[lane] = v;
        __syncwarp();
        if (in && (peers & ((1u << lane) - 1u)) == 0u) {
            // lowest lane of its group: combine the group in lane order
            T x = v;
            for (unsigned rest = peers & (peers - 1u); rest;
                 rest &= rest - 1u)
                x = comb<OP>(x, st[__ffs(rest) - 1]);
            mine[r] = comb<OP>(mine[r], x);
        }
        __syncwarp();  // the next tile overwrites st
    }
    __syncthreads();

    const int n_chunks = gridDim.y;
    T* dst = n_chunks > 1 ? partial + (int64_t)blockIdx.y * r_pad + tile_lo
                          : out + tile_lo;
    for (int k = threadIdx.x; k < tile_rows; k += kThreads) {
        T x = acc[k];
        for (int w = 1; w < kWarps; ++w) x = comb<OP>(x, acc[w * tile_rows + k]);
        dst[k] = x;
    }
    if (n_chunks == 1) return;

    // The tile's last block to arrive combines every chunk, in chunk order.
    __shared__ bool last;
    __threadfence();  // this block's partial is visible before it counts
    __syncthreads();
    if (threadIdx.x == 0)
        last = atomicAdd(&arrivals[blockIdx.x], 1u) == (unsigned)n_chunks - 1u;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // Four rows a thread (tile_lo, tile_rows and r_pad are multiples of
    // 256), kBatch chunks' loads issued together before they combine.
    using V = typename Vec4<T>::type;
    const V* src = reinterpret_cast<const V*>(partial + tile_lo);
    V* dst4 = reinterpret_cast<V*>(out + tile_lo);
    const int pitch = r_pad / 4;
    for (int k = threadIdx.x; k < tile_rows / 4; k += kThreads) {
        V x = __ldcg(src + k);  // from L2: other blocks wrote it
        for (int c0 = 1; c0 < n_chunks; c0 += kBatch) {
            V y[kBatch];
#pragma unroll
            for (int j = 0; j < kBatch; ++j)
                if (c0 + j < n_chunks)
                    y[j] = __ldcg(src + (int64_t)(c0 + j) * pitch + k);
#pragma unroll
            for (int j = 0; j < kBatch; ++j)
                if (c0 + j < n_chunks) x = comb4<OP>(x, y[j]);
        }
        dst4[k] = x;
    }
    if (threadIdx.x == 0) arrivals[blockIdx.x] = 0u;  // ready for the next launch
}

template <typename T, int OP>
int launch(const void* rows, const void* vals, void* out, void* partial,
           void* arrivals, int n, int r_pad, T ident, cudaStream_t stream) {
    const int chunk = n < kChunk ? n : kChunk;
    const int n_chunks = n / chunk;
    const int tiles = (r_pad + kRowTile - 1) / kRowTile;
    const int tile_rows = r_pad < kRowTile ? r_pad : kRowTile;
    const size_t smem = sizeof(T) * (size_t)kWarps * (tile_rows + 32);
    static bool attr_set = false;  // one per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            bank_scatter_kernel<T, OP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(sizeof(T) * kWarps * (kRowTile + 32)));
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    bank_scatter_kernel<T, OP><<<dim3(tiles, n_chunks), kThreads, smem,
                                 stream>>>(
        (const int32_t*)rows, (const T*)vals, (T*)out, (T*)partial,
        (unsigned*)arrivals, r_pad, chunk, ident);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int op, const void* rows, const void* vals, void* out,
             void* partial, void* arrivals, int n, int r_pad, T ident,
             cudaStream_t stream) {
    switch (op) {
        case kSum:
            return launch<T, kSum>(rows, vals, out, partial, arrivals, n,
                                   r_pad, ident, stream);
        case kMin:
            return launch<T, kMin>(rows, vals, out, partial, arrivals, n,
                                   r_pad, ident, stream);
        case kMax:
            return launch<T, kMax>(rows, vals, out, partial, arrivals, n,
                                   r_pad, ident, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Number of event chunks a launch of n events reduces separately: the
// caller passes a [chunks, r_pad] scratch `partial` when this is above 1.
extern "C" int bank_scatter_chunks(int n) {
    return n < kChunk ? 1 : n / kChunk;
}

// Number of row tiles of r_pad rows: the caller passes `arrivals`, that
// many uint32 counters, zero before the first launch; each launch leaves
// them zero again.  Launches that share counters must be stream-ordered.
extern "C" int bank_scatter_tiles(int r_pad) {
    return (r_pad + kRowTile - 1) / kRowTile;
}

// dtype 0 = float32, 1 = int32; op 0 = sum (and count), 1 = min, 2 = max;
// ident_bits is the identity's 32-bit pattern.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int bank_scatter_launch(const void* rows, const void* vals,
                                   void* out, void* partial, void* arrivals,
                                   int n, int r_pad, int dtype, int op,
                                   int ident_bits, void* stream) {
    if (n < 256 || (n & (n - 1)) || r_pad < 256 || r_pad % 256)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
        float ident;
        memcpy(&ident, &ident_bits, sizeof ident);
        return dispatch<float>(op, rows, vals, out, partial, arrivals, n,
                               r_pad, ident, s);
    }
    if (dtype == 1)
        return dispatch<int32_t>(op, rows, vals, out, partial, arrivals, n,
                                 r_pad, (int32_t)ident_bits, s);
    return (int)cudaErrorInvalidValue;
}
