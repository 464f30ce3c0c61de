// Fused hot-key scan (max-plus + counting chains), for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
// (siddhi_tpu/kernels/scan_chain.py, _build via fused_scan).  It computes
// what that kernel's body computes, in the same order of float32
// operations, so it agrees bit for bit on every lane, dead lanes included:
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
// Mapping: one warp per slot, lane i holding v[i] and c[i] (S <= 32), so
// the shift is one __shfl_up_sync each.  A warp stages a tile of up to 32
// events' filter rows in shared memory with coalesced loads (the rows of
// one slot are contiguous), holds the tile's timestamps one per lane, and
// writes the tile's emissions from shared memory with one coalesced store.
//
// Bound: the serial chain.  Each slot's n events are a dependent chain of
// a shuffle and about five dependent float32 operations per event; the
// bytes (F, ts and emit, 0.33 MB at H=8, n=2048, S=2) take under 1 us.
// Slots are independent warps, so H <= 256 warps use a few SMs at most;
// a simple correct kernel first.
//
// Numerics: NEG and NEG/2 are the float32 roundings -1e30f and -5e29f of
// the reference's weakly typed python floats.  The max is written as the
// reference's jnp.maximum behaves (NaN-propagating select) rather than
// fmaxf, which drops NaNs; no NaN is reachable without a fault harness.
// Build without --use_fast_math: adds and compares must stay IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegHalf = -5e29f;
constexpr int kWarpsPerBlock = 4;
constexpr int kTile = 32;        // events staged per pass (<= warp size)
constexpr int kMaxCols = 33;     // S + 1 <= 33

__device__ __forceinline__ float max_ref(float a, float b) {
    // jnp.maximum: NaN if either is NaN, else the larger
    return (a > b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32) scan_chain_kernel(
    const float* __restrict__ F, const float* __restrict__ ts,
    const float* __restrict__ v_in, const float* __restrict__ c_in,
    float* __restrict__ v_out, float* __restrict__ c_out,
    float* __restrict__ emit, int H, int n, int S) {
    __shared__ float f_tile[kWarpsPerBlock][kTile * kMaxCols];
    __shared__ float e_tile[kWarpsPerBlock][kTile];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int h = blockIdx.x * kWarpsPerBlock + warp;
    if (h >= H) return;  // whole warp: h is uniform across it
    const unsigned full = 0xffffffffu;
    const int cols = S + 1;
    const int tile = n < kTile ? n : kTile;  // n is a power of two >= 16
    float* ft = f_tile[warp];
    float* et = e_tile[warp];

    float v = lane < S ? v_in[(int64_t)h * S + lane] : kNeg;
    float c = lane < S ? c_in[(int64_t)h * S + lane] : 0.0f;
    const float* Fh = F + (int64_t)h * n * cols;
    const float* tsh = ts + (int64_t)h * n;
    float* emh = emit + (int64_t)h * n;

    for (int e0 = 0; e0 < n; e0 += tile) {
        const float* src = Fh + (int64_t)e0 * cols;
        for (int k = lane; k < tile * cols; k += 32) ft[k] = src[k];
        const float ts_lane = lane < tile ? tsh[e0 + lane] : 0.0f;
        __syncwarp();
        for (int k = 0; k < tile; ++k) {
            const float* row = ft + k * cols;
            const bool fi = lane < cols && row[lane] > 0.5f;
            const bool fip1 = lane + 1 < cols && row[lane + 1] > 0.5f;
            const float t = __shfl_sync(full, ts_lane, k);
            if (lane == S - 1) {
                const bool fS = row[S] > 0.5f;
                et[k] = (fS && v > kNegHalf) ? c : 0.0f;
            }
            float vs = __shfl_up_sync(full, v, 1);
            float cs = __shfl_up_sync(full, c, 1);
            if (lane == 0) {
                vs = 0.0f;
                cs = 1.0f;
            }
            const float t1_true = lane == 1 ? t : vs;
            const float term1 = fi ? t1_true : kNeg + vs;
            const float term2 = fip1 ? kNeg + v : v;
            const float nv = max_ref(max_ref(term1, term2), kNeg);
            const float nc = (fi ? cs : 0.0f) + (fip1 ? 0.0f : c);
            v = lane == 0 ? 0.0f : nv;
            c = lane == 0 ? 1.0f : nc;
        }
        __syncwarp();
        if (lane < tile) emh[e0 + lane] = et[lane];
        __syncwarp();  // the next tile overwrites ft and et
    }
    if (lane < S) {
        v_out[(int64_t)h * S + lane] = v;
        c_out[(int64_t)h * S + lane] = c;
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
    const int blocks = (H + kWarpsPerBlock - 1) / kWarpsPerBlock;
    scan_chain_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
        (const float*)F, (const float*)ts, (const float*)v_in,
        (const float*)c_in, (float*)v_out, (float*)c_out, (float*)emit, H, n,
        S);
    return (int)cudaGetLastError();
}
