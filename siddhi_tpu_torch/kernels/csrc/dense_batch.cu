// Batch dense-NFA step for capture-free every-chains, for sm_90a.
//
// Replaces the Pallas kernel of the JAX package
// (siddhi_tpu/kernels/dense_step.py, build_packed_nfa -> _pallas_call)
// together with the engine's collision-round loop around it
// (siddhi_tpu/ops/dense_nfa.py, process and _collision_rounds).  The
// packed step is row-independent and the rounds keep each partition's
// event order, so walking each partition's events in batch order gives
// the same state and emits as the rounds, bit for bit (pure int32 / bit
// arithmetic).  One launch takes a whole batch.
//
//   state, in place: active [P+1, S, I] uint8 (bool), first [P+1, S, I]
//                    int32 (within anchors, relative ms, 0 = unset),
//                    overflow [P+1] int32
//   batch: order [N] (batch rows grouped by partition, batch order
//          within one), seg_start [K+1], seg_part [K] (each row at most
//          once), ok [N, S] uint8 (node filter AND on-stream), ts [N]
//   out:   emit [N, 2I] uint8, anchor [N, 2I] int32 by batch row (the
//          second bank is zero in this class), n_emit int32
//
// Per event, the packed step's per-row program: clear instances whose
// anchor is older than `within` (int32 wrap-around subtraction), then
// sweep the nodes in reverse.  fire = pending & ok (lane 0 of node 0 is
// always pending); anchors are stamped; the k-th fired instance of node s
// takes the k-th free lane of node s+1 and fired instances beyond the
// free count add to the row's overflow; the last node emits.
//
// Mapping: one thread per segment (one partition), warps of 32
// segments, blocks of 1-4 warps.  A warp gathers its 32 state rows into
// shared memory together: lanes run over (row, 16-byte chunk) of the
// anchors and over (row, node) of the activity, so neighbouring lanes
// read neighbouring bytes of one row and the random rows are read as
// whole sectors.  Activity becomes one uint32 bitmask a node (I <= 32),
// stored [node][33] so each thread's reads are conflict-free; an anchor
// row's stride is an odd number of 16-byte units, so a quarter-warp's
// 16-byte reads of its own rows are conflict-free too.  Each thread then
// walks its events against its row in shared memory and the warp writes
// the rows back.
//
// The walk works on bits: fired lanes are visited by find-first-set, and
// the k-th fired lane of node s meets the k-th free lane of node s+1 by
// taking the lowest remaining bit of each, so an event costs a few
// operations a node plus a few a fired lane (the packed kernel's
// all-lanes-by-all-lanes placement made the serial walk of a long
// segment instruction-bound).  Where I is 4, 8, 16 or 32 a node's anchors
// move as whole 16-byte vectors, and expiry, the stamp and the emit row
// are selects on them.  A thread loads its events' ts and ok flags
// kChunk at a time, all loads of a chunk in flight together and held in
// registers (the chunk loop is unrolled), with the next chunk's
// batch-row indices loading meanwhile; ok is one vector load a row where
// S is a power of two.  A partition has exactly one owning thread: no
// atomics on state, and the same bits on every launch.  n_emit is one
// integer atomic add a warp (integer sums do not depend on order).
//
// Bound, the larger of:
// - bytes: every state row of the batch read and written once (at S=16,
//   I=4 a row is 64 B of activity, 256 B of anchors and 4 B of overflow:
//   324 B), plus ts, order, ok, emit and anchors per event (64 B at that
//   shape) and the segment arrays.  At 1 M partitions, 131,072 one-event
//   segments: 84.9 + 8.4 + 1.0 MB, about 95 MB, 28 us at 3.35 TB/s.
// - the serial chain: a segment's events are dependent through its row,
//   so the longest segment times one event's dependent operations
//   (per node: read, fire, placement, write) at the top SM clock.  The
//   skew-routed batch's hot cold key (600+ events) sets this one.
// Simple first: one thread walks a segment; a long segment is not split.

#include <cuda_runtime.h>
#include <stdint.h>

// Shape constants of a launch, built once per (S, I, within) by
// dense_batch_plan and passed by address.
struct Plan {
    int S;
    int I;
    int has_within;
    int within;
    int warps;
    int smem;
};

namespace {

constexpr int kMaxWarps = 4;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kMaskStride = 33;  // words per node in the activity masks
constexpr int kChunk = 8;        // events a thread loads ahead at once

// 16-byte units per anchor row in shared memory: odd, so a quarter
// warp's 16-byte reads of 8 rows fall in 8 different bank groups
__host__ __device__ inline int row_units(int S, int I) {
    return ((S * I + 3) / 4) | 1;
}

// a warp's bytes: anchor rows, activity masks and row indices; a whole
// number of 16-byte units, so the next warp's rows stay aligned
__host__ __device__ inline int warp_smem(int S, int I) {
    return (32 * row_units(S, I) * 16 + S * kMaskStride * 4 + 32 * 4 + 15) &
           ~15;
}

// 4 bytes (nonzero = set) -> 4 bits, and back to 0/1 bytes
__device__ inline uint32_t bytes_to_bits(uint32_t w) {
    return ((w & 0xFFu) ? 1u : 0u) | ((w & 0xFF00u) ? 2u : 0u) |
           ((w & 0xFF0000u) ? 4u : 0u) | ((w & 0xFF000000u) ? 8u : 0u);
}

__device__ inline uint32_t bits_to_bytes(uint32_t b) {
    return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

// 16 bytes -> 16 bits, and back
__device__ inline uint32_t bytes16_to_bits(uint4 v) {
    return bytes_to_bits(v.x) | (bytes_to_bits(v.y) << 4) |
           (bytes_to_bits(v.z) << 8) | (bytes_to_bits(v.w) << 12);
}

__device__ inline uint4 bits_to_bytes16(uint32_t m) {
    return make_uint4(bits_to_bytes(m), bits_to_bytes(m >> 4),
                      bits_to_bytes(m >> 8), bits_to_bytes(m >> 12));
}

// the activity of one node of one row (I bytes) as a bitmask
__device__ inline uint32_t load_mask(const uint8_t* src, int I, bool vec) {
    if (vec) {
        if (I == 4) return bytes_to_bits(*(const uint32_t*)src);
        if (I == 8) {
            const uint2 v = *(const uint2*)src;
            return bytes_to_bits(v.x) | (bytes_to_bits(v.y) << 4);
        }
        uint32_t m = bytes16_to_bits(*(const uint4*)src);
        if (I == 32) m |= bytes16_to_bits(*(const uint4*)(src + 16)) << 16;
        return m;
    }
    uint32_t m = 0;
    for (int i = 0; i < I; ++i) m |= (src[i] ? 1u : 0u) << i;
    return m;
}

__device__ inline void store_mask(uint8_t* dst, int I, bool vec, uint32_t m) {
    if (vec) {
        if (I == 4) {
            *(uint32_t*)dst = bits_to_bytes(m);
        } else if (I == 8) {
            *(uint2*)dst = make_uint2(bits_to_bytes(m), bits_to_bytes(m >> 4));
        } else {
            *(uint4*)dst = bits_to_bytes16(m);
            if (I == 32) *(uint4*)(dst + 16) = bits_to_bytes16(m >> 16);
        }
        return;
    }
    for (int i = 0; i < I; ++i) dst[i] = (uint8_t)((m >> i) & 1u);
}

// one event's filter flags, bit s = node s.  vec: S is 2, 4, 8, 16 or
// 32 and the rows are aligned to S bytes, so the row is one or two
// vector loads; else S predicated byte loads, all issued before any is
// used
__device__ inline uint32_t load_ok(const uint8_t* ok, int e, int S,
                                   bool vec) {
    const uint8_t* r = ok + (int64_t)e * S;
    if (vec) {
        if (S == 2) return bytes_to_bits(*(const uint16_t*)r);
        if (S == 4) return bytes_to_bits(*(const uint32_t*)r);
        if (S == 8) {
            const uint2 v = *(const uint2*)r;
            return bytes_to_bits(v.x) | (bytes_to_bits(v.y) << 4);
        }
        uint32_t m = bytes16_to_bits(*(const uint4*)r);
        if (S == 32) m |= bytes16_to_bits(*(const uint4*)(r + 16)) << 16;
        return m;
    }
    uint8_t b[32];
#pragma unroll
    for (int s = 0; s < 32; ++s) b[s] = s < S ? r[s] : 0;
    uint32_t m = 0;
#pragma unroll
    for (int s = 0; s < 32; ++s) m |= (b[s] ? 1u : 0u) << s;
    return m;
}

// int32 wrap-around subtraction, as in the JAX step
__device__ inline bool expired(int32_t f, int32_t t, int within) {
    return f > 0 && (int32_t)((uint32_t)t - (uint32_t)f) > within;
}

// Clears node anchors `fs` older than `within` and their lanes in `a`
// (the lane-by-lane path, any I).
__device__ inline uint32_t expire(int32_t* fs, int I, int32_t t, int within,
                                  uint32_t a) {
    for (int i = 0; i < I; ++i) {
        if (expired(fs[i], t, within)) {
            fs[i] = 0;
            a &= ~(1u << i);
        }
    }
    return a;
}

// Four lanes of a node at once: which hold no anchor, which are past
// `within`, the anchors after expiry and the stamp, and the emit row's
// anchors of the lanes in `b`.
__device__ inline uint32_t zero4(int4 v) {
    return (v.x == 0 ? 1u : 0u) | (v.y == 0 ? 2u : 0u) |
           (v.z == 0 ? 4u : 0u) | (v.w == 0 ? 8u : 0u);
}

__device__ inline uint32_t dead4(int4 v, int32_t t, int within) {
    return (expired(v.x, t, within) ? 1u : 0u) |
           (expired(v.y, t, within) ? 2u : 0u) |
           (expired(v.z, t, within) ? 4u : 0u) |
           (expired(v.w, t, within) ? 8u : 0u);
}

__device__ inline int4 stamp4(int4 v, uint32_t stamp, uint32_t dead,
                              int32_t t) {
    return make_int4((stamp & 1u) ? t : (dead & 1u) ? 0 : v.x,
                     (stamp & 2u) ? t : (dead & 2u) ? 0 : v.y,
                     (stamp & 4u) ? t : (dead & 4u) ? 0 : v.z,
                     (stamp & 8u) ? t : (dead & 8u) ? 0 : v.w);
}

__device__ inline int4 emit4(int4 v, uint32_t b, int32_t t) {
    return make_int4((b & 1u) ? (v.x > 0 ? v.x : t) : 0,
                     (b & 2u) ? (v.y > 0 ? v.y : t) : 0,
                     (b & 4u) ? (v.z > 0 ? v.z : t) : 0,
                     (b & 8u) ? (v.w > 0 ? v.w : t) : 0);
}

template <int VI>
__global__ void __launch_bounds__(32 * kMaxWarps) dense_batch_kernel(
    uint8_t* __restrict__ active, int32_t* __restrict__ first,
    int32_t* __restrict__ overflow, const int32_t* __restrict__ order,
    const int32_t* __restrict__ seg_start,
    const int32_t* __restrict__ seg_part, const uint8_t* __restrict__ ok,
    const int32_t* __restrict__ ts, uint8_t* __restrict__ emit_out,
    int32_t* __restrict__ anch_out, int32_t* __restrict__ n_emit, int K,
    int S, int I, int has_within, int within, int vec_rows, int vec_act,
    int vec_ok) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (k - lane >= K) return;  // the whole warp lies past the last segment
    const int SI = S * I;
    const int m = row_units(S, I);
    const int stride = 4 * m;  // words per anchor row
    unsigned char* base = smem + (size_t)(threadIdx.x >> 5) * warp_smem(S, I);
    int32_t* sF = (int32_t*)base;                    // [32][stride] anchors
    uint32_t* sA = (uint32_t*)(base + 32 * m * 16);  // [S][33] activity
    int32_t* sP = (int32_t*)(sA + S * kMaskStride);  // [32] state rows

    const bool has = k < K;
    const int p = has ? seg_part[k] : -1;
    sP[lane] = p;
    __syncwarp();

    // gather the warp's rows: anchors, then activity as bitmasks
    if (vec_rows) {
        const int chunks = SI / 4;
        for (int idx = lane; idx < 32 * chunks; idx += 32) {
            const int r = idx / chunks, c = idx - r * chunks;
            const int pr = sP[r];
            if (pr >= 0)
                ((int4*)(sF + r * stride))[c] =
                    ((const int4*)(first + (int64_t)pr * SI))[c];
        }
    } else {
        for (int idx = lane; idx < 32 * SI; idx += 32) {
            const int r = idx / SI, c = idx - r * SI;
            const int pr = sP[r];
            if (pr >= 0) sF[r * stride + c] = first[(int64_t)pr * SI + c];
        }
    }
    for (int idx = lane; idx < 32 * S; idx += 32) {
        const int r = idx / S, s = idx - r * S;
        const int pr = sP[r];
        sA[s * kMaskStride + r] =
            pr >= 0 ? load_mask(active + (int64_t)pr * SI + s * I, I,
                                vec_act != 0)
                    : 0u;
    }
    __syncwarp();

    // walk this thread's segment, event after event
    uint32_t count = 0;
    if (has) {
        const uint32_t lanes = I == 32 ? 0xffffffffu : (1u << I) - 1u;
        int32_t* row = sF + lane * stride;
        uint32_t* am = sA + lane;  // node s's mask at am[s * kMaskStride]
        int32_t ovf = 0;
        const int j0 = seg_start[k], j1 = seg_start[k + 1];
        // events go in chunks: a chunk's ts and ok loads are issued
        // together (one wait a chunk, not one a load) into registers (the
        // chunk loop is unrolled), and the next chunk's row indices load
        // meanwhile
        int ev[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
            ev[q] = j0 + q < j1 ? order[j0 + q] : 0;
        for (int jb = j0; jb < j1; jb += kChunk) {
            int32_t tv[kChunk];
            uint32_t ov[kChunk];
#pragma unroll
            for (int q = 0; q < kChunk; ++q) {
                if (jb + q < j1) {
                    tv[q] = ts[ev[q]];
                    ov[q] = load_ok(ok, ev[q], S, vec_ok != 0);
                }
            }
            int evn[kChunk];
#pragma unroll
            for (int q = 0; q < kChunk; ++q)
                evn[q] = jb + kChunk + q < j1 ? order[jb + kChunk + q] : 0;
#pragma unroll
            for (int q = 0; q < kChunk; ++q) {
                if (jb + q >= j1) break;
                const int e = ev[q];
                const int32_t t = tv[q];
                const uint32_t okm = ov[q];
                // sweep the nodes in reverse; nxt_a is node s+1's activity
                uint32_t nxt_a = 0;
                for (int s = S - 1; s >= 0; --s) {
                    int32_t* fs = row + s * I;
                    uint32_t a = am[s * kMaskStride];
                    const bool ok_s = (okm >> s) & 1u;
                    uint32_t fire;
                    int4 v[VI > 0 ? VI / 4 : 1];
                    if (VI) {
                        // expiry, fire and stamp as selects on the node's
                        // anchors, read and written as whole vectors
                        uint32_t zero = 0, dead = 0;
#pragma unroll
                        for (int c = 0; c < VI / 4; ++c) {
                            v[c] = ((const int4*)fs)[c];
                            zero |= zero4(v[c]) << (4 * c);
                            if (has_within)
                                dead |= dead4(v[c], t, within) << (4 * c);
                        }
                        a &= ~dead;
                        fire = ok_s ? (a | (s == 0 ? 1u : 0u)) : 0u;
                        // node 0 arms afresh with this event; a later node
                        // keeps its instance's anchor
                        const uint32_t stamp =
                            s == 0 ? fire : fire & (zero | dead);
                        if (stamp | dead) {
#pragma unroll
                            for (int c = 0; c < VI / 4; ++c) {
                                v[c] = stamp4(v[c], stamp >> (4 * c),
                                              dead >> (4 * c), t);
                                ((int4*)fs)[c] = v[c];
                            }
                        }
                    } else {
                        if (has_within) a = expire(fs, I, t, within, a);
                        fire = ok_s ? (a | (s == 0 ? 1u : 0u)) : 0u;
                        for (uint32_t b = fire; b; b &= b - 1) {
                            const int i = __ffs(b) - 1;
                            if (s == 0 || fs[i] == 0) fs[i] = t;
                        }
                    }
                    if (s != 0) a &= ~fire;
                    if (s == S - 1) {
                        uint8_t* er = emit_out + (int64_t)e * 2 * I;
                        int32_t* ar = anch_out + (int64_t)e * 2 * I;
                        if (VI) {
                            // bank 0 the emits, bank 1 zero
#pragma unroll
                            for (int w = 0; w < VI / 2; ++w)
                                ((uint32_t*)er)[w] =
                                    w < VI / 4 ? bits_to_bytes(fire >> (4 * w))
                                               : 0u;
#pragma unroll
                            for (int c = 0; c < VI / 2; ++c)
                                ((int4*)ar)[c] =
                                    c < VI / 4
                                        ? emit4(v[c], fire >> (4 * c), t)
                                        : make_int4(0, 0, 0, 0);
                        } else {
                            for (int i = 0; i < I; ++i) {
                                const bool on = (fire >> i) & 1u;
                                er[i] = on ? 1 : 0;
                                er[I + i] = 0;
                                ar[i] = on ? (fs[i] > 0 ? fs[i] : t) : 0;
                                ar[I + i] = 0;
                            }
                        }
                        count += __popc(fire);
                    } else if (fire) {
                        // the k-th fired lane takes the k-th free lane of
                        // node s+1; fired lanes past the free ones overflow
                        int32_t* fn = fs + I;
                        uint32_t src = fire, fr = ~nxt_a & lanes;
                        while (src && fr) {
                            const int i = __ffs(src) - 1, j = __ffs(fr) - 1;
                            src &= src - 1;
                            fr &= fr - 1;
                            fn[j] = fs[i] > 0 ? fs[i] : t;
                            nxt_a |= 1u << j;
                        }
                        ovf += __popc(src);
                        am[(s + 1) * kMaskStride] = nxt_a;
                    }
                    am[s * kMaskStride] = a;
                    nxt_a = a;
                }
            }
#pragma unroll
            for (int q = 0; q < kChunk; ++q) ev[q] = evn[q];
        }
        if (ovf) overflow[p] += ovf;  // the row's only owner
    }
    count = __reduce_add_sync(0xffffffffu, count);
    if (lane == 0 && count) atomicAdd(n_emit, (int)count);
    __syncwarp();

    // write the rows back
    if (vec_rows) {
        const int chunks = SI / 4;
        for (int idx = lane; idx < 32 * chunks; idx += 32) {
            const int r = idx / chunks, c = idx - r * chunks;
            const int pr = sP[r];
            if (pr >= 0)
                ((int4*)(first + (int64_t)pr * SI))[c] =
                    ((const int4*)(sF + r * stride))[c];
        }
    } else {
        for (int idx = lane; idx < 32 * SI; idx += 32) {
            const int r = idx / SI, c = idx - r * SI;
            const int pr = sP[r];
            if (pr >= 0) first[(int64_t)pr * SI + c] = sF[r * stride + c];
        }
    }
    for (int idx = lane; idx < 32 * S; idx += 32) {
        const int r = idx / S, s = idx - r * S;
        const int pr = sP[r];
        if (pr >= 0)
            store_mask(active + (int64_t)pr * SI + s * I, I, vec_act != 0,
                       sA[s * kMaskStride + r]);
    }
}

typedef void (*KernelFn)(uint8_t*, int32_t*, int32_t*, const int32_t*,
                         const int32_t*, const int32_t*, const uint8_t*,
                         const int32_t*, uint8_t*, int32_t*, int32_t*, int,
                         int, int, int, int, int, int, int);

KernelFn pick(int I) {
    if (I == 4) return dense_batch_kernel<4>;
    if (I == 8) return dense_batch_kernel<8>;
    if (I == 16) return dense_batch_kernel<16>;
    if (I == 32) return dense_batch_kernel<32>;
    return dense_batch_kernel<0>;
}

}  // namespace

// Fills *plan for (S, I, within) on the current device: warps per block
// (as many as fit 48 KB of shared memory, 1 to 4) and the block's
// dynamic shared memory, raising the kernel's limit where it passes
// 48 KB (at S = I = 32 one warp takes 135,936 B of the 232,448 B a block
// may have).  Returns a cudaError_t (0 on success).
extern "C" int dense_batch_plan(void* plan, int S, int I, int has_within,
                                int within) {
    if (S < 1 || S > 32 || I < 1 || I > 32 || within < 0)
        return (int)cudaErrorInvalidValue;
    const int per_warp = warp_smem(S, I);
    int warps = kSmemDefault / per_warp;
    warps = warps < 1 ? 1 : warps > kMaxWarps ? kMaxWarps : warps;
    Plan* p = (Plan*)plan;
    p->S = S;
    p->I = I;
    p->has_within = has_within;
    p->within = within;
    p->warps = warps;
    p->smem = warps * per_warp;
    if (p->smem > kSmemDefault) {
        const cudaError_t err = cudaFuncSetAttribute(
            (const void*)pick(I), cudaFuncAttributeMaxDynamicSharedMemorySize,
            p->smem);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// One batch: zeroes n_emit, then one launch over the K segments.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dense_batch_launch(const void* plan, void* active, void* first,
                                  void* overflow, const void* order,
                                  const void* seg_start, const void* seg_part,
                                  const void* ok, const void* ts, void* emit,
                                  void* anchor, void* n_emit, int K, int N,
                                  void* stream) {
    const Plan* p = (const Plan*)plan;
    if (K < 1 || N < K || p->S < 1 || p->S > 32 || p->I < 1 || p->I > 32)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(n_emit, 0, sizeof(int32_t), st);
    if (err != cudaSuccess) return (int)err;
    const int SI = p->S * p->I;
    const int vec_rows = SI % 4 == 0 && (uintptr_t)first % 16 == 0;
    const int vec_act = (p->I == 4 || p->I == 8 || p->I == 16 ||
                         p->I == 32) &&
                        (uintptr_t)active % (p->I < 16 ? p->I : 16) == 0;
    const int vec_ok = (p->S == 2 || p->S == 4 || p->S == 8 || p->S == 16 ||
                        p->S == 32) &&
                       (uintptr_t)ok % (p->S < 16 ? p->S : 16) == 0;
    const int threads = 32 * p->warps;
    const unsigned blocks = (unsigned)((K + threads - 1) / threads);
    pick(p->I)<<<blocks, threads, p->smem, st>>>(
        (uint8_t*)active, (int32_t*)first, (int32_t*)overflow,
        (const int32_t*)order, (const int32_t*)seg_start,
        (const int32_t*)seg_part, (const uint8_t*)ok, (const int32_t*)ts,
        (uint8_t*)emit, (int32_t*)anchor, (int32_t*)n_emit, K, p->S, p->I,
        p->has_within, p->within, vec_rows, vec_act, vec_ok);
    return (int)cudaGetLastError();
}
