// Fused hot-key scan (max-plus + counting chains), for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
// (siddhi_tpu/kernels/scan_chain.py, _build via fused_scan):
//
//   in : F  [H, n, S+1] float32 0/1, column j = filter of node j (col 0 unused)
//        ts [H, n]      float32, event time relative to the scan's base
//        v  [H, S]      float32, youngest pending start per lane (NEG = none)
//        c  [H, S]      float32, pending-chain count per lane
//   out: v', c' [H, S], emit [H, n] (rows event e emits: c[S-1] before e)
//
// Per event e of slot h, with f = F[h, e] > 0.5 and lanes i = 0..S-1:
//   emit[e] = f[S] && v[S-1] > NEG/2 ? c[S-1] : 0          (pre-update)
//   vs, cs  = v, c shifted up one lane (lane 0 gets 0 and 1)
//   term1   = f[i] ? (i == 1 ? ts[e] : vs[i]) : NEG + vs[i]
//   term2   = f[i+1] ? NEG + v[i] : v[i]
//   v[i]    = max(max(term1, term2), NEG);  lane 0: 0
//   c[i]    = (f[i] ? cs[i] : 0) + (f[i+1] ? 0 : c[i]);  lane 0: 1
//
// The update is lower-bidiagonal: lane i at event e reads lane i-1 and
// itself before e.  So, given lane i-1's whole pre-update sequence
// (p_e, q_e), lane i is a first-order recurrence with
//   a_e = f[i] ? src_e : NEG,  alpha_e = f[i] ? q_e : 0,  keep_e = !f[i+1]
//   v_{e+1} = max(a_e, keep_e ? v_e : NEG)       a segmented max-scan
//   c_{e+1} = alpha_e + (keep_e ? c_e : 0)       a segmented sum-scan
// (src = ts for lane 1, p for the others).  Each step x -> (max(a, k ? x.v :
// NEG), alpha + (k ? x.c : 0)) is the element (k, a, alpha); two compose as
//   (K1,A1,C1) then (K2,A2,C2) = (K1 & K2, K2 ? max(A1,A2) : A2,
//                                 K2 ? C1 + C2 : C2),  identity (1, NEG, 0).
//
// Mapping: lanes in order, events in parallel.  One block per slot walks
// the slot's events in tiles of up to 2,048 (128 threads x kE = 16
// consecutive events each; fewer threads where n is small).  The block
// stages a tile's F rows with coalesced 16-byte loads, 16 in flight a
// lane, and warp ballots into a bitmap in shared memory; each thread
// packs its events' rows into one uint32 mask an event (bit j-1 = column
// j) and holds its events' ts.  The wrapper passes 16-byte aligned
// tensors.  Then, for lane i = 1 .. S-1 in order, each thread folds its
// kE events into one element, a block-wide exclusive scan of the elements
// (warp shuffles, then each warp scans the warp totals) gives its prefix,
// the prefix applied to the lane's carry (its value before the tile)
// gives the thread's first value, and the thread re-walks its events,
// keeping the lane's pre-update values in registers for lane i+1.  The
// last thread's final value is the lane's carry for the next tile.  After
// lane S-1 the emits are stored.  Dependent depth per tile:
// (S-1) x (2 kE + a 5-step and a 2-step shuffle scan + one barrier),
// instead of the retired one-warp-a-slot mapping's n dependent events
// (136 cycles each).  At the routed shape (S=2, n <= 2,048) that is one
// pass.
//
// Bound: the bytes.  F, ts and emit are read or written once
// (H n (S+3) + 4 H S floats, 0.33 MB at H=8, n=2048, S=2, about 0.1 us at
// 3.35 TB/s; 147 MB, 44 us, at H=256, n=4096, S=32); the float work, about
// 12 operations an event and lane, is under a seventh of that at the card's
// float32 peak.  At small H the launch and the per-lane barriers set the
// time.  At H=256, S=32 a block's staging and its 31 lane scans take
// turns (two blocks an SM), which keeps it above the byte bound; staging
// the next tile while the lanes run is the next step.
//
// Numerics: bit-exact with the sequential body on the engine's domain:
// F in {0, 1}; ts finite, no -0.0, below 2^24; live v finite, no -0.0,
// below 2^24 in magnitude; dead v finite and <= NEG/2; c integer-valued in
// [0, 2^24) and every count the walk reaches below 2^24 (the engine's
// bound).  There max is an exact selection, NEG + x == NEG for every live
// x (absorption at 1e30), the NEG floor absorbs the rest, so the floor on
// load (max(v, NEG)) changes no output; counts are exact integer sums in
// any order.  NaN and infinities lie outside.  max() here propagates NaN,
// but the segmented form drops a lane's value at a reset (f[i+1]) where
// the sequential body keeps NEG + NaN, so a NaN stops at the next reset
// instead of sticking to the lane.  NEG and NEG/2 are the float32
// roundings -1e30f and -5e29f of the reference's weakly typed python
// floats.  Build without --use_fast_math: adds and compares must stay
// IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegHalf = -5e29f;
constexpr int kE = 16;             // consecutive events a thread owns
constexpr int kMaxThreads = 128;
constexpr int kTile = kE * kMaxThreads;  // events per tile, at most
constexpr int kMaxCols = 33;       // S + 1 <= 33
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStage = 16;         // float4 loads in flight a lane
constexpr unsigned kFull = 0xffffffffu;

// jnp.maximum: NaN if either is NaN, else the larger (one instruction;
// the NaN it returns is the canonical one)
__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// one segmented step, or a run of them composed: x -> (max(a, k ? x.v :
// NEG), c + (k ? x.c : 0))
struct Seg {
    int k;
    float a;
    float c;
};

__device__ __forceinline__ Seg identity() { return Seg{1, kNeg, 0.0f}; }

// bits 0..7 of x to bits 0, 4, .., 28
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
    x &= 0xffu;
    x = (x | (x << 12)) & 0x000f000fu;
    x = (x | (x << 6)) & 0x03030303u;
    return (x | (x << 3)) & 0x11111111u;
}

// x, then y
__device__ __forceinline__ Seg combine(Seg x, Seg y) {
    return Seg{x.k & y.k, y.k ? max_nan(x.a, y.a) : y.a,
               y.k ? x.c + y.c : y.c};
}

__device__ __forceinline__ Seg shfl_up(Seg s, int d) {
    return Seg{__shfl_up_sync(kFull, s.k, d), __shfl_up_sync(kFull, s.a, d),
               __shfl_up_sync(kFull, s.c, d)};
}

__device__ __forceinline__ Seg shfl(Seg s, int src) {
    return Seg{__shfl_sync(kFull, s.k, src), __shfl_sync(kFull, s.a, src),
               __shfl_sync(kFull, s.c, src)};
}

// inclusive scan over lanes 0 .. width-1 of a warp (width a power of two)
__device__ __forceinline__ Seg warp_inclusive(Seg s, int lane,
                                              int width = 32) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        if (d >= width) break;
        const Seg o = shfl_up(s, d);
        if (lane >= d) s = combine(o, s);
    }
    return s;
}

__global__ void __launch_bounds__(kMaxThreads) scan_chain_kernel(
    const float* __restrict__ F, const float* __restrict__ ts,
    const float* __restrict__ v_in, const float* __restrict__ c_in,
    float* __restrict__ v_out, float* __restrict__ c_out,
    float* __restrict__ emit, int n, int S) {
    __shared__ uint32_t bits[kTile * kMaxCols / 32 + 1];  // + the pad word
    __shared__ int tot_k[2][kMaxWarps];
    __shared__ float tot_a[2][kMaxWarps], tot_c[2][kMaxWarps];
    __shared__ float car_v[32], car_c[32];  // each lane's value before a tile

    const int h = blockIdx.x;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int nwarps = blockDim.x >> 5;
    const int cols = S + 1;
    // n and the tile are powers of two >= 16, so a thread's kE events are
    // all real or all past the tile
    const int tile = n < kE * (int)blockDim.x ? n : kE * (int)blockDim.x;
    const int active = tile / kE;
    const bool mine = t < active;
    const int64_t hS = (int64_t)h * S;

    if (t < S) {
        car_v[t] = max_nan(v_in[hS + t], kNeg);  // the first step's floor
        car_c[t] = c_in[hS + t];
    }
    const float c0 = c_in[hS];  // lane 0's count before the first event
    int buf = 0;

    for (int e0 = 0; e0 < n; e0 += tile) {
        __syncthreads();  // carries set; the last tile's bitmap read
        // stage the tile's F rows: bit b of the bitmap is float b of the
        // tile's rows (contiguous in F) > 0.5.  A warp reads 128 floats a
        // load (a float4 a lane), kStage loads in flight; four ballots,
        // one a component, give the chunk's four words
        const float4* Ft = (const float4*)(F + ((int64_t)h * n + e0) * cols);
        const int total4 = tile * cols / 4;  // tile * cols is a multiple of 16
        const int words = (total4 + 7) / 8;
        const int chunks = (total4 + 31) >> 5;
        for (int q0 = warp * kStage; q0 < chunks; q0 += nwarps * kStage) {
            float4 f[kStage];
#pragma unroll
            for (int u = 0; u < kStage; ++u) {
                const int idx = (q0 + u) * 32 + lane;
                f[u] = idx < total4 ? Ft[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < kStage; ++u) {
                const uint32_t bx = __ballot_sync(kFull, f[u].x > 0.5f);
                const uint32_t by = __ballot_sync(kFull, f[u].y > 0.5f);
                const uint32_t bz = __ballot_sync(kFull, f[u].z > 0.5f);
                const uint32_t bw = __ballot_sync(kFull, f[u].w > 0.5f);
                // lane j < 4 builds word j: float 4m + c of the word is
                // component c of lane 8j + m
                const int sh = 8 * (lane & 3);
                const uint32_t m = spread4(bx >> sh) | (spread4(by >> sh) << 1) |
                                   (spread4(bz >> sh) << 2) |
                                   (spread4(bw >> sh) << 3);
                const int w = (q0 + u) * 4 + lane;
                if (lane < 4 && w < words) bits[w] = m;
            }
        }
        if (t == 0) bits[words] = 0u;  // read by the last event's mask
        // pv, pc: the previous lane's pre-update values at this thread's
        // events; for lane 1, ts and lane 0's count
        float pv[kE], pc[kE];
        uint32_t fm[kE];
        if (mine) {
            const float4* tst = (const float4*)(ts + (int64_t)h * n + e0 + t * kE);
#pragma unroll
            for (int k = 0; k < kE / 4; ++k) {
                const float4 q = tst[k];
                pv[4 * k] = q.x;
                pv[4 * k + 1] = q.y;
                pv[4 * k + 2] = q.z;
                pv[4 * k + 3] = q.w;
            }
#pragma unroll
            for (int k = 0; k < kE; ++k) pc[k] = 1.0f;
            if (e0 == 0 && t == 0) pc[0] = c0;
        }
        __syncthreads();
        if (mine) {
#pragma unroll
            for (int k = 0; k < kE; ++k) {
                const int b = (t * kE + k) * cols + 1;
                const uint64_t w =
                    bits[b >> 5] | ((uint64_t)bits[(b >> 5) + 1] << 32);
                fm[k] = (uint32_t)(w >> (b & 31));  // bit j-1: column j
            }
        }

        for (int i = 1; i < S; ++i) {
            const float xv = car_v[i], xc = car_c[i];
            int kp[kE];
            float a[kE], al[kE];
            Seg agg = identity();
            if (mine) {
#pragma unroll
                for (int k = 0; k < kE; ++k) {
                    const bool fi = (fm[k] >> (i - 1)) & 1u;
                    kp[k] = ((fm[k] >> i) & 1u) ? 0 : 1;
                    a[k] = fi ? pv[k] : kNeg;
                    al[k] = fi ? pc[k] : 0.0f;
                    agg = combine(agg, Seg{kp[k], a[k], al[k]});
                }
            }
            // block-wide exclusive scan of the threads' elements
            const Seg inc = warp_inclusive(agg, lane);
            if (lane == 31) {
                tot_k[buf][warp] = inc.k;
                tot_a[buf][warp] = inc.a;
                tot_c[buf][warp] = inc.c;
            }
            Seg pre = shfl_up(inc, 1);
            if (lane == 0) pre = identity();
            __syncthreads();
            Seg wt = lane < nwarps
                         ? Seg{tot_k[buf][lane], tot_a[buf][lane],
                               tot_c[buf][lane]}
                         : identity();
            wt = shfl(warp_inclusive(wt, lane, nwarps), warp > 0 ? warp - 1 : 0);
            if (warp > 0) pre = combine(wt, pre);
            buf ^= 1;
            if (mine) {
                float x = max_nan(pre.a, pre.k ? xv : kNeg);
                float y = pre.c + (pre.k ? xc : 0.0f);
#pragma unroll
                for (int k = 0; k < kE; ++k) {
                    pv[k] = x;
                    pc[k] = y;
                    x = max_nan(a[k], kp[k] ? x : kNeg);
                    y = al[k] + (kp[k] ? y : 0.0f);
                }
                // every thread read the carry before the barrier above
                if (t == active - 1) {
                    car_v[i] = x;
                    car_c[i] = y;
                }
            }
        }

        if (mine) {
            float o[kE];
#pragma unroll
            for (int k = 0; k < kE; ++k) {
                const bool fS = (fm[k] >> (S - 1)) & 1u;
                o[k] = (fS && pv[k] > kNegHalf) ? pc[k] : 0.0f;
            }
            float4* em = (float4*)(emit + (int64_t)h * n + e0 + t * kE);
#pragma unroll
            for (int k = 0; k < kE / 4; ++k)
                em[k] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2],
                                    o[4 * k + 3]);
        }
    }
    __syncthreads();
    if (t < S) {
        v_out[hS + t] = t == 0 ? 0.0f : car_v[t];
        c_out[hS + t] = t == 0 ? 1.0f : car_c[t];
    }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int scan_chain_launch(const void* F, const void* ts,
                                 const void* v_in, const void* c_in,
                                 void* v_out, void* c_out, void* emit, int H,
                                 int n, int S, void* stream) {
    if (S < 2 || S > 32 || H < 1 || H > 256 || n < 16 || (n & (n - 1)))
        return (int)cudaErrorInvalidValue;
    int threads = n / kE;
    threads = threads < 32 ? 32 : threads > kMaxThreads ? kMaxThreads : threads;
    scan_chain_kernel<<<H, threads, 0, (cudaStream_t)stream>>>(
        (const float*)F, (const float*)ts, (const float*)v_in,
        (const float*)c_in, (float*)v_out, (float*)c_out, (float*)emit, n, S);
    return (int)cudaGetLastError();
}
