// Segmented reduce for the aggregation device bank, for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
// (siddhi_tpu/kernels/bank_scatter.py, _build via segmented_reduce):
//
//   in : rows [n] int32, vals [n] float32 or int32, identity of the op
//   out: x[r] = identity (+) { vals[e] : rows[e] == r }   for r < n_rows
//
// with (+) one of sum (count is a sum of ones), min or max.  Two modes, one
// kernel:
//
// - delta (segmented_reduce, the Pallas contract): out[r] = x[r];
// - accumulate (accumulate_): out[r] = out[r] (+) x[r] in place, the bank's
//   a (+) d (siddhi_tpu/aggregation/device_bank.py, upd) with d never
//   written to memory.
//
// n is a power of two >= 256, as the bank pads it; n_rows is any count
// >= 1.  An event whose row lies outside [0, n_rows) contributes nothing,
// as in the one-hot reference.
//
// The Pallas kernel compares every event with every row (O(n r) work, so a
// hot key costs the same as a cold one).  Here the work is O(n slices) row
// tests and O(n) combines, and a hot key still does not serialise:
//
// - The grid is row slices x event chunks.  A block owns kSliceRows rows
//   and kChunk events; each of its 8 warps keeps a private copy of the
//   slice's accumulators in shared memory (8 x 128 x 4 B = 4 KB), so
//   clearing and combining the copies costs 4 stores and 4 loads a thread.
// - A warp loads the rows of kGroups x 32 of its events at once, then the
//   values of only those events that fall in the block's slice, then walks
//   the groups in order.  Lanes whose events share a row find each other
//   with __match_any_sync; the lowest lane of each group combines the
//   group's values in lane order and updates the warp's copy of that row.
//   When all 32 lanes share one row (the hot-key case) the warp combines
//   them with a fixed xor butterfly.  No global atomics on values.
// - The block combines its warps' copies in warp order.  With one chunk it
//   writes the result; otherwise it writes its chunk's partial, and the
//   last block of the slice to finish (a per-slice arrival counter, which
//   it resets for the next launch) combines the partials in chunk order and
//   writes the result.  Each row has exactly one final writer, so
//   accumulating in place is safe, and a call is one launch.
//
// Grid shape: every event is tested once per slice (its row, from L2), so
// the row reads grow as 4 n slices bytes; the clearing and partials grow as
// chunks x n_rows.  kSliceRows = 128 keeps a block's shared memory at 5 KB
// (eight blocks fit an SM) and kChunk = 2,048 gives each warp 256 events,
// one batch of loads; of 64, 128 and 256 rows and 1,024, 2,048 and 4,096
// events, timed on the H100, these were the fastest.  At the bank's shape (n = 32,768, n_rows = 4,097 or
// r_pad = 4,352) that is 33 or 34 slices x 16 chunks = 528 or 544 blocks,
// one wave of about four blocks an SM on 132 SMs, 4.3 MB of row reads from
// L2 and a 264 KiB partial buffer.
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
// Bound: bytes.  Delta mode reads rows and values once and writes the delta
// (8 n + 4 n_rows: 279,552 B at n = 32,768, n_rows = 4,352, 0.083 us at
// 3.35 TB/s); accumulate mode reads and writes the accumulator instead
// (8 n + 8 n_rows: 294,920 B at n_rows = 4,097, 0.088 us).  Launch latency
// and one L2 round trip per batch of loads dominate.
// Build without --use_fast_math: the adds and compares must stay IEEE.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSliceRows = 128;  // rows a block owns
constexpr int kChunk = 2048;     // events a block reduces
constexpr int kGroups = 8;       // 32-event groups a warp loads at once
constexpr int kBatch = 8;        // chunk partials loaded at once in the combine
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChunks = 65535;  // gridDim.y
static_assert(kSliceRows <= kThreads, "one row a thread in the combine");

enum { kSum = 0, kMin = 1, kMax = 2 };

__host__ __device__ constexpr int slices_of(int n_rows) {
    return (n_rows + kSliceRows - 1) / kSliceRows;
}

__host__ __device__ constexpr int chunks_of(int n) {
    return n < kChunk ? 1 : n / kChunk;
}

// Selects, not branches: NaN wins (a's first), then the order; of equal
// values only +0.0 / -0.0 differ in bits, and -0.0 is the smaller.
__device__ __forceinline__ float min_ref(float a, float b) {
    const float eq = __int_as_float(__float_as_int(a) | __float_as_int(b));
    float r = a < b ? a : (b < a ? b : eq);
    r = b != b ? b : r;
    return a != a ? a : r;
}

__device__ __forceinline__ float max_ref(float a, float b) {
    const float eq = __int_as_float(__float_as_int(a) & __float_as_int(b));
    float r = a > b ? a : (b > a ? b : eq);
    r = b != b ? b : r;
    return a != a ? a : r;
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

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) bank_scatter_kernel(
    const int32_t* __restrict__ rows, const T* __restrict__ vals,
    T* __restrict__ out, T* __restrict__ partial,
    unsigned* __restrict__ arrivals, int n_rows, int chunk, T ident,
    int accumulate) {
    __shared__ T acc[kWarps][kSliceRows];
    __shared__ T stage[kWarps][32];
    __shared__ bool last;
    const int slice_lo = blockIdx.x * kSliceRows;
    const unsigned slice_rows = min(kSliceRows, n_rows - slice_lo);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    for (int k = threadIdx.x; k < kWarps * kSliceRows; k += kThreads)
        (&acc[0][0])[k] = ident;
    __syncthreads();

    T* mine = acc[warp];
    T* st = stage[warp];
    const int per_warp = chunk / kWarps;  // a multiple of 32
    const int64_t e_lo = (int64_t)blockIdx.y * chunk + warp * per_warp;
    const int64_t e_hi = e_lo + per_warp;
    for (int64_t e0 = e_lo; e0 < e_hi; e0 += 32 * kGroups) {
        // rows of every group first, then the values of the events in
        // this slice: two round trips a batch, all loads in flight
        unsigned r[kGroups];
        T v[kGroups];
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
            r[g] = e0 + g * 32 < e_hi  // uniform across the warp
                       ? (unsigned)rows[e0 + g * 32 + lane] - (unsigned)slice_lo
                       : slice_rows;  // no event: outside the slice
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
            v[g] = r[g] < slice_rows ? vals[e0 + g * 32 + lane] : ident;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
            const bool in = r[g] < slice_rows;
            if (!__ballot_sync(kFull, in)) continue;  // uniform
            const unsigned peers = __match_any_sync(kFull, in ? r[g] : ~0u);
            if (__all_sync(kFull, in && peers == kFull)) {
                // every lane on one row: a fixed butterfly over the warp
                T x = v[g];
                for (int o = 16; o > 0; o >>= 1)
                    x = comb<OP>(x, __shfl_xor_sync(kFull, x, o));
                if (lane == 0) mine[r[g]] = comb<OP>(mine[r[g]], x);
                continue;
            }
            st[lane] = v[g];
            __syncwarp();
            if (in && (peers & ((1u << lane) - 1u)) == 0u) {
                // lowest lane of its group: combine the group in lane order
                T x = v[g];
                for (unsigned rest = peers & (peers - 1u); rest;
                     rest &= rest - 1u)
                    x = comb<OP>(x, st[__ffs(rest) - 1]);
                mine[r[g]] = comb<OP>(mine[r[g]], x);
            }
            __syncwarp();  // the next group overwrites st
        }
    }
    __syncthreads();

    const int n_chunks = gridDim.y;
    const int k = threadIdx.x;  // one row a thread: kSliceRows <= kThreads
    T x = ident;
    if (k < kSliceRows) {
        x = acc[0][k];
        for (int w = 1; w < kWarps; ++w) x = comb<OP>(x, acc[w][k]);
    }
    if (n_chunks > 1) {
        // partial layout [slice][chunk][kSliceRows]
        T* slice_part = partial + (int64_t)blockIdx.x * n_chunks * kSliceRows;
        if (k < kSliceRows) slice_part[blockIdx.y * kSliceRows + k] = x;
        // the slice's last block to arrive combines every chunk, in order
        __threadfence();  // this block's partial is visible before it counts
        __syncthreads();
        if (threadIdx.x == 0)
            last = atomicAdd(&arrivals[blockIdx.x], 1u) ==
                   (unsigned)n_chunks - 1u;
        __syncthreads();
        if (!last) return;
        __threadfence();
        if (threadIdx.x == 0) arrivals[blockIdx.x] = 0u;  // for the next launch
        if (k < kSliceRows) {
            x = __ldcg(slice_part + k);  // from L2: other blocks wrote it
            for (int c0 = 1; c0 < n_chunks; c0 += kBatch) {
                T y[kBatch];
#pragma unroll
                for (int j = 0; j < kBatch; ++j)
                    if (c0 + j < n_chunks)
                        y[j] = __ldcg(slice_part + (c0 + j) * kSliceRows + k);
#pragma unroll
                for (int j = 0; j < kBatch; ++j)
                    if (c0 + j < n_chunks) x = comb<OP>(x, y[j]);
            }
        }
    }
    if ((unsigned)k < slice_rows) {
        T* dst = out + slice_lo + k;
        *dst = accumulate ? comb<OP>(*dst, x) : x;
    }
}

}  // namespace

// What a launch takes besides its tensors, fixed per shape, op and mode:
// the caller builds it once (kernels/bank_scatter.py _Plan, field for
// field) and passes its host address, so a call converts five arguments,
// not twelve.  partial is the chunk-partial scratch (bank_scatter_scratch
// words, none for one chunk) and arrivals the per-slice counters
// (bank_scatter_slices of them, zero before the first launch; each launch
// leaves them zero); launches that share either must be stream-ordered.
// dtype 0 = float32, 1 = int32; op 0 = sum (and count), 1 = min, 2 = max;
// accumulate 0 writes the delta to out, 1 folds it into out in place;
// ident_bits is the identity's 32-bit pattern.
struct Plan {
    void* partial;
    void* arrivals;
    int n;
    int n_rows;
    int dtype;
    int op;
    int accumulate;
    int ident_bits;
};

namespace {

template <typename T, int OP>
int launch(const void* rows, const void* vals, void* out, const Plan& p,
           T ident, cudaStream_t stream) {
    const int n_chunks = chunks_of(p.n);
    bank_scatter_kernel<T, OP><<<dim3(slices_of(p.n_rows), n_chunks),
                                 kThreads, 0, stream>>>(
        (const int32_t*)rows, (const T*)vals, (T*)out, (T*)p.partial,
        (unsigned*)p.arrivals, p.n_rows, p.n / n_chunks, ident,
        p.accumulate);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* rows, const void* vals, void* out, const Plan& p,
             T ident, cudaStream_t stream) {
    switch (p.op) {
        case kSum: return launch<T, kSum>(rows, vals, out, p, ident, stream);
        case kMin: return launch<T, kMin>(rows, vals, out, p, ident, stream);
        case kMax: return launch<T, kMax>(rows, vals, out, p, ident, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Arrival counters a launch over n_rows rows needs.
extern "C" int bank_scatter_slices(int n_rows) { return slices_of(n_rows); }

// 32-bit words of chunk-partial scratch a launch of n events over n_rows
// rows needs (0: one chunk, no scratch); -1 where it would not fit an int.
extern "C" int bank_scatter_scratch(int n, int n_rows) {
    const int64_t n_chunks = chunks_of(n);
    const int64_t words = n_chunks * slices_of(n_rows) * kSliceRows;
    return n_chunks == 1 ? 0 : words > INT32_MAX ? -1 : (int)words;
}

// One launch as `plan` says.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int bank_scatter_launch(const void* rows, const void* vals,
                                   void* out, const void* plan,
                                   void* stream) {
    const Plan& p = *(const Plan*)plan;
    if (p.n < 256 || (p.n & (p.n - 1)) || p.n_rows < 1 ||
        chunks_of(p.n) > kMaxChunks)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (p.dtype == 0) {
        float ident;
        memcpy(&ident, &p.ident_bits, sizeof ident);
        return dispatch<float>(rows, vals, out, p, ident, s);
    }
    if (p.dtype == 1)
        return dispatch<int32_t>(rows, vals, out, p, (int32_t)p.ident_bits,
                                 s);
    return (int)cudaErrorInvalidValue;
}
