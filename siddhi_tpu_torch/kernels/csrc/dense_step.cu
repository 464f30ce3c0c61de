// Packed dense-NFA step for capture-free every-chains, for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
// (siddhi_tpu/kernels/dense_step.py, build_packed_nfa -> _pallas_call).
// It computes what that kernel's body computes, on the same packed
// interface, bit for bit (pure int32 / bit arithmetic):
//
//   in : ok    [S, W]    int32, bit b of word w = node filter ok for row w*32+b
//        A     [S*I, W]  int32, packed activity (row s*I+i = node s, lane i)
//        FT    [S*I, Bp] int32, within anchors (relative ms, 0 = unset)
//        ts    [Bp]      int32, event time of each batch row
//   out: A', FT' (same shapes), emit [I, W] packed, anch [I, Bp], ovf [Bp]
//
// Per row: clear instances whose anchor is older than `within`, then
// sweep the nodes in reverse.  fire = pending & ok (lane 0 of node 0 is
// always pending); anchors are stamped; the k-th fired instance of node s
// takes the k-th free lane of node s+1 and fired instances beyond the
// free count add to the row's overflow; the last node emits.
//
// Mapping: one thread per batch row, so one warp per packed word.  A
// thread reads its bit of each broadcast word, its own anchor columns
// (row-contiguous, so a warp's reads coalesce), keeps two nodes in
// registers while it sweeps (node s and node s+1, which node s places
// into), and a warp writes each packed word with one __ballot_sync.
// Rows do not interact, so blocks need no ordering.
//
// Bound: device-memory bytes.  At S=16, I=4, B=131072 the anchors are
// 33.5 MB read and 33.5 MB written; packed planes, ts, anchors out and
// overflow add about 5 MB; about 21 us at 3.35 TB/s.  The arithmetic is a
// few integer operations per byte.  This first version favours a simple
// per-row program over tiling: anchor traffic dominates and is already
// one coalesced read and one write per element.

#include <cuda_runtime.h>
#include <stdint.h>

template <int MAXI>
__global__ void __launch_bounds__(256) packed_nfa_step_kernel(
    const int32_t* __restrict__ ok, const int32_t* __restrict__ A,
    const int32_t* __restrict__ FT, const int32_t* __restrict__ ts,
    int32_t* __restrict__ A_out, int32_t* __restrict__ FT_out,
    int32_t* __restrict__ emit_out, int32_t* __restrict__ anch_out,
    int32_t* __restrict__ ovf_out, int S, int I, int W, int has_within,
    int within) {
    const int64_t Bp = (int64_t)W * 32;
    const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    // Bp and blockDim are multiples of 32: a warp is wholly in or out,
    // so every __ballot_sync below sees all 32 lanes.
    if (row >= Bp) return;
    const int w = (int)(row >> 5);
    const int lane = (int)(row & 31);
    const int32_t t = ts[row];
    const uint32_t lanes = (1u << I) - 1u;  // I <= 16

    uint32_t nxt_a = 0;  // node s+1 activity, bit i = lane i
    int32_t nxt_f[MAXI];
    uint32_t emit = 0;
    int32_t anch[MAXI];
    int32_t ovf = 0;
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
        nxt_f[i] = 0;
        anch[i] = 0;
    }

    for (int s = S - 1; s >= 0; --s) {
        // load node s, clearing expired instances
        uint32_t cur_a = 0;
        int32_t cur_f[MAXI];
#pragma unroll
        for (int i = 0; i < MAXI; ++i) {
            cur_f[i] = 0;
            if (i < I) {
                const int64_t r = (int64_t)s * I + i;
                uint32_t bit = ((uint32_t)A[r * W + w] >> lane) & 1u;
                int32_t fs = FT[r * Bp + row];
                if (has_within) {
                    // int32 wrap-around subtraction, as in the JAX step
                    const int32_t d = (int32_t)((uint32_t)t - (uint32_t)fs);
                    if (fs > 0 && d > within) {
                        bit = 0u;
                        fs = 0;
                    }
                }
                cur_a |= bit << i;
                cur_f[i] = fs;
            }
        }
        const uint32_t okbit = ((uint32_t)ok[(int64_t)s * W + w] >> lane) & 1u;
        const uint32_t pend = cur_a | (s == 0 ? 1u : 0u);
        const uint32_t fire = okbit ? pend : 0u;

#pragma unroll
        for (int i = 0; i < MAXI; ++i) {
            if (i < I && ((fire >> i) & 1u) && (s == 0 || cur_f[i] == 0))
                cur_f[i] = t;
        }
        if (s != 0) cur_a &= ~fire;

        if (s == S - 1) {
            emit = fire;
#pragma unroll
            for (int i = 0; i < MAXI; ++i)
                anch[i] = ((fire >> i) & 1u) ? (cur_f[i] > 0 ? cur_f[i] : t) : 0;
        } else {
            // rank-matched placement into node s+1
            const uint32_t freel = ~nxt_a & lanes;
            const int n_fire = __popc(fire);
            const int n_free = __popc(freel);
            ovf += n_fire > n_free ? n_fire - n_free : 0;
            uint32_t got = 0;
#pragma unroll
            for (int j = 0; j < MAXI; ++j) {
                if (j < I && ((freel >> j) & 1u)) {
                    const int rank = __popc(freel & ((1u << j) - 1u));
                    if (rank < n_fire) {
                        int32_t moved = 0;
#pragma unroll
                        for (int i = 0; i < MAXI; ++i) {
                            if (i < I && ((fire >> i) & 1u) &&
                                __popc(fire & ((1u << i) - 1u)) == rank)
                                moved = cur_f[i] > 0 ? cur_f[i] : t;
                        }
                        got |= 1u << j;
                        nxt_f[j] = moved;
                    }
                }
            }
            nxt_a |= got;
            // node s+1 is final now: write it
#pragma unroll
            for (int i = 0; i < MAXI; ++i) {
                if (i < I) {
                    const int64_t r = (int64_t)(s + 1) * I + i;
                    const uint32_t word =
                        __ballot_sync(0xffffffffu, (nxt_a >> i) & 1u);
                    if (lane == 0) A_out[r * W + w] = (int32_t)word;
                    FT_out[r * Bp + row] = nxt_f[i];
                }
            }
        }
        nxt_a = cur_a;
#pragma unroll
        for (int i = 0; i < MAXI; ++i) nxt_f[i] = cur_f[i];
    }
    // node 0
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
        if (i < I) {
            const uint32_t word = __ballot_sync(0xffffffffu, (nxt_a >> i) & 1u);
            if (lane == 0) A_out[(int64_t)i * W + w] = (int32_t)word;
            FT_out[(int64_t)i * Bp + row] = nxt_f[i];
        }
    }
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
        if (i < I) {
            const uint32_t word = __ballot_sync(0xffffffffu, (emit >> i) & 1u);
            if (lane == 0) emit_out[(int64_t)i * W + w] = (int32_t)word;
            anch_out[(int64_t)i * Bp + row] = anch[i];
        }
    }
    ovf_out[row] = ovf;
}

template <int MAXI>
static void launch(const void* ok, const void* A, const void* FT,
                   const void* ts, void* A_out, void* FT_out, void* emit_out,
                   void* anch_out, void* ovf_out, int S, int I, int W,
                   int has_within, int within, cudaStream_t stream) {
    const int threads = 256;
    const int64_t rows = (int64_t)W * 32;
    const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
    packed_nfa_step_kernel<MAXI><<<blocks, threads, 0, stream>>>(
        (const int32_t*)ok, (const int32_t*)A, (const int32_t*)FT,
        (const int32_t*)ts, (int32_t*)A_out, (int32_t*)FT_out,
        (int32_t*)emit_out, (int32_t*)anch_out, (int32_t*)ovf_out, S, I, W,
        has_within, within);
}

// Returns the cudaError_t of the launch (0 on success).
extern "C" int dense_step_launch(const void* ok, const void* A,
                                 const void* FT, const void* ts, void* A_out,
                                 void* FT_out, void* emit_out, void* anch_out,
                                 void* ovf_out, int S, int I, int W,
                                 int has_within, int within, void* stream) {
    if (S < 1 || S > 32 || I < 1 || I > 16 || W < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (I <= 4)
        launch<4>(ok, A, FT, ts, A_out, FT_out, emit_out, anch_out, ovf_out,
                  S, I, W, has_within, within, st);
    else if (I <= 8)
        launch<8>(ok, A, FT, ts, A_out, FT_out, emit_out, anch_out, ovf_out,
                  S, I, W, has_within, within, st);
    else
        launch<16>(ok, A, FT, ts, A_out, FT_out, emit_out, anch_out, ovf_out,
                   S, I, W, has_within, within, st);
    return (int)cudaGetLastError();
}
