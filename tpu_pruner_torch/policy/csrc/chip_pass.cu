// Per-chip idle-candidate pass over [chips, samples] fleet tensors, for Hopper
// (sm_90a). Two passes, one per sample storage:
//
//   the f32 pass    (tp_chip_pass_groups, tp_chip_pass_long) replaces
//                   tpu_pruner/policy/pallas_engine.py::_chip_kernel
//                   (pallas_engine.py:33; f32 samples + bool validity mask);
//   tp_chip_pass_q  replaces tpu_pruner/policy/pallas_engine.py::_chip_kernel_q
//                   (pallas_engine.py:104; int8 1%-bucket samples, -1 = invalid
//                   in-band).
//
// And the two slice reductions at the end of this file, which reduce the
// pass's chip verdicts to slice verdicts and have no Pallas counterpart: the
// contiguous slice gate, tp_slice_gate, for chips in slice order, and the
// scatter reduction, tp_slice_scatter, for chips in any order. Last, the
// streaming window's key join, tp_window_join, and its row gather,
// tp_window_gather, which have none either; and the policy sweep,
// tp_sweep_pass and tp_sweep_scatter (a grid of policies in one pass of the
// window), which has none either.
//
// Both read every sample byte once and write one byte per chip: they are
// bound by device-memory bandwidth and do no tensor-core work. At the fleet
// size of 131,072 chips x 360 samples the f32 pass moves 425,328,648 B
// (127 us at 3.35 TB/s) and the int8 pass 95,027,208 B (28.4 us).
//
// The f32 pass has two designs; kernels._choose_plan_f32 picks one per
// launch from the row length. The group design (below) takes rows of up to
// 256 samples, such as an audit dump's 8; the long-row design (below) takes
// longer rows, such as the 360 of the example fleet, and rows of any length
// where a caller forces its plan, as the group design's timing control.
//
// tp_chip_pass_q has two designs; kernels._choose_plan_q picks one per
// launch. The row design takes short rows (T in RowsT below: T <= 64 and at
// most 5 vectors of each array a thread) of at most 16 MiB an array whose
// three inputs start on 16-byte boundaries; the tile design takes the rest,
// views off such a boundary included. That is where the row design
// measured faster on the H100 with its inputs in L2, as the streaming
// window finds its ring (PERF.md gives both designs warm and cold).
//
// The tile design is built against the latency limit of a long-row
// stream. One warp per 360-byte row with 1-byte lane loads keeps only a few
// KB in flight per SM, where Little's law asks for ~15 KB (3.35 TB/s x ~0.6
// us over 132 SMs); that design reached 48% of its bound on the H100. So:
//   - it cuts the fleet into flat tiles of R rows, R a multiple of 16, so a
//     tile's byte range [r0*T, (r0+R)*T) starts on a 16-byte boundary for
//     every T (relative to the array's base); rows are not the unit of copy;
//   - one producer warp copies each array's tile, and the tile's ages, into
//     shared memory with Hopper's 1-D bulk copy (cp.async.bulk ...
//     mbarrier::complete_tx, marked evict-first in L2), and four consumer
//     warps reduce it once its mbarrier completes: one instruction moves a
//     whole tile, and the many resident blocks of an SM (each ~12 KB at
//     T=360) keep far more than 15 KB in flight;
//   - each block has one tile (a grid of ceil(C/R) blocks), so the hardware
//     scheduler balances tiles across SMs; on the H100 this beat a
//     persistent grid whose blocks walk a ring of tiles (PERF.md). A block
//     walks its tile's parts through a ring of stages with a full and an
//     empty mbarrier each, which a row longer than a stage needs;
//   - it reduces from shared memory in 4-byte words with max.s16x2 (two
//     signed 16-bit maxima per instruction, the int8 samples as high
//     bytes), lanes_per_row lanes to a row; the partial words at a row's
//     edges are masked, the halves folded as scalars and the lanes by
//     shuffles.
// Edges: a base pointer off a 16-byte boundary (a view such as x[1:]) has its
// aligned interior copied in bulk and its head and tail (< 16 B each) read
// with plain loads into the same stage; the last tile is clipped to the rows
// that exist; a tile larger than one stage (T above 384) is streamed in
// parts, and a row that spans parts carries its max in shared memory. No
// byte outside the tensors is read. The launch plan (rows per tile, part
// size, parts, stages, lanes per row, shared memory, grid) is computed by
// kernels._plan_q in Python and checked here.
//
// The row design is built for the streaming window's ring, T = 12 chunk
// maxima a chip: 131,072 x 12 is 3.8 MB, one wave of the tile design's
// 512-row tiles, whose consumers wait for a whole tile before they reduce.
// The pass is one launch plus one memory round trip, and the row design
// spends nothing else: no shared memory, no barrier, no producer warp.
//   - each thread owns G = 16 / gcd(T, 16) consecutive rows, the fewest
//     whose G*T bytes are whole 16-byte vectors (T = 12: 4 rows, 3 vectors
//     an array), so a group starts on a 16-byte boundary;
//   - it issues all its loads before any arithmetic: the vectors of both
//     arrays (ld.global.nc.v4; L2 prefetch and evict-first hints measured no
//     faster) and its G ages (one float4 per 4 rows);
//   - T is a template argument, so each row's words and the masks of the
//     words it shares with a neighbour are constants, and the folds run
//     from registers with max.s16x2, which sm_90a runs as a three-input
//     VIMNMX3 (__vmaxs4 compiled to more instructions);
//   - it writes its G verdict bytes in one store of G bytes;
//   - the last group, if ragged, reads the rows that exist byte by byte.
// The launch plan (rows per thread and grid, at 128 threads a block) is
// computed by kernels._plan_q_rows and checked here with the inputs'
// alignment.
//
// Numerics follow the reference's XLA semantics exactly, without -ftz or
// fast math, so each rule is explicit here:
//   - subnormal inputs (0 < |x| < FLT_MIN) read as 0, as XLA and the TPU
//     flush them: a valid sample of 1e-40 is idle;
//   - NaN propagates into a row's peak (jnp.max semantics): a valid NaN
//     tensorcore sample makes the chip busy, and a NaN HBM peak never
//     rescues (NaN >= cutoff is false);
//   - the cutoff may be +inf (threshold disabled); an +inf HBM sample still
//     rescues then, since inf >= inf.
//
// [lookback_s, cutoff] come from a 2-float device buffer, so parameter
// changes need neither a rebuild nor a host sync. Each entry point returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for a launch
// plan it refuses); the Python wrapper raises on non-zero.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float flush_subnormal(float x) {
    return fabsf(x) < FLT_MIN ? 0.0f : x;
}

// Running max that tracks NaN apart, so the warp reduction can use plain
// float compares and the NaN is put back at the end.
struct PeakF32 {
    float max = -INFINITY;
    bool nan = false;
    __device__ __forceinline__ void add(float x) {
        if (isnan(x)) nan = true;
        else if (x > max) max = x;
    }
    __device__ __forceinline__ void warp_reduce() {
        for (int off = 16; off > 0; off >>= 1) {
            float other = __shfl_xor_sync(kFullMask, max, off);
            max = other > max ? other : max;
        }
        nan = __any_sync(kFullMask, nan);
    }
    __device__ __forceinline__ float value() const { return nan ? NAN : max; }
};

// One chip row's running peaks, as every design of the f32 pass folds it.
struct RowPeaks {
    PeakF32 tc, hbm;
    bool has_data = false;
    __device__ __forceinline__ void add(float x_tc, float x_hbm, bool v) {
        // invalid samples read as -1, as jnp.where(valid, x, -1) does
        has_data |= v;
        tc.add(v ? flush_subnormal(x_tc) : -1.0f);
        hbm.add(v ? flush_subnormal(x_hbm) : -1.0f);
    }
};

// The verdict of one chip from its folded row, as every design applies it.
__device__ __forceinline__ uint8_t verdict_f32(const RowPeaks& p, float age, float lookback,
                                               float cutoff) {
    const bool idle = p.tc.value() <= 0.0f && p.has_data;
    const bool hbm_active = p.hbm.value() >= cutoff;
    const bool eligible = flush_subnormal(age) >= lookback;
    return (idle && !hbm_active && eligible) ? 1 : 0;
}

// ── int8 pass: bulk-copy ring, one producer warp, four consumer warps ───────

constexpr int kQConsumerWarps = 4;
constexpr int kQThreads = (kQConsumerWarps + 1) * 32;  // the last warp copies
constexpr int kQMaxStages = 2;  // the plan uses 1, or 2 for a tile in parts
constexpr int kQCarryRows = 16;          // rows of a tile that is cut into parts
constexpr int64_t kQSmemMax = 48 * 1024;  // dynamic shared memory without opt-in
constexpr uint32_t kNeg4 = 0x80808080u;  // four int8 -128: identity of the max

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}

// Announce the bytes the stage's bulk copies will bring (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase with the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    }
}

// 1-D bulk copy global -> shared; both addresses and the size are multiples
// of 16 bytes. Completion is counted in bytes on the mbarrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy) : "memory");
}

struct QPlan {
    int64_t num_chips, num_samples;
    int64_t rows;        // rows per tile, a multiple of 16
    int64_t part_bytes;  // bytes per sample array per stage, a multiple of 16
    int parts;           // parts per tile: ceil(rows * T / part_bytes)
    int stages;          // ring depth
    int lanes;           // lanes per row: a power of two up to 32
};

// The parts of this block's tile, as bytes of each sample array relative to
// its base. Producer and consumers walk them in the same order, with
// counters rather than divisions (a 64-bit division is a long software
// routine).
struct PartWalk {
    const QPlan q;
    const int64_t row0;       // the tile's first chip
    const int64_t tile_rows;  // its chips (fewer in a clipped last tile)
    int64_t start = 0;        // first byte of the current part within the tile
    int part = 0;
    int stage = 0;
    uint32_t phase = 0;       // parity of the ring's current round

    __device__ __forceinline__ explicit PartWalk(const QPlan& plan)
        : q(plan), row0(int64_t(blockIdx.x) * plan.rows),
          tile_rows(min64(plan.rows, plan.num_chips - row0)) {}
    __device__ __forceinline__ bool valid() const { return part < q.parts; }
    __device__ __forceinline__ int len() const {  // 0 past the end of a clipped tile
        return int(max64(0, min64(tile_rows * q.num_samples - start, q.part_bytes)));
    }
    __device__ __forceinline__ int age_len() const { return int(tile_rows) * 4; }
    __device__ __forceinline__ void next() {
        if (++stage == q.stages) stage = 0, phase ^= 1;
        ++part;
        start += q.part_bytes;
    }
};

// A stage holds one part of each sample array and the tile's ages. An array
// whose base is `mis` bytes past a 16-byte boundary sits in its buffer at
// offset `mis`, so that buffer and global memory agree mod 16. Its first
// `head` bytes (up to the next 16-byte boundary) and its last < 16 bytes go
// by plain loads; the interior, `bulk` bytes, by one bulk copy.
struct Span {
    int mis, head, bulk, len;
    __device__ __forceinline__ Span(const void* base, int len_) : len(len_) {
        mis = int(reinterpret_cast<uintptr_t>(base) & 15);
        head = (16 - mis) & 15;
        bulk = len > head ? (len - head) & ~15 : 0;
    }
    // lane k < 16 copies head byte k, lane k >= 16 tail byte k - 16
    __device__ __forceinline__ void copy_edge(unsigned char* buf, const unsigned char* src,
                                              int lane) const {
        const int j = lane < 16 ? lane : head + bulk + (lane - 16);
        if (lane < 16 ? j < min(head, len) : j < len) buf[mis + j] = src[j];
    }
};

// Two signed 16-bit maxima in one instruction (sm_90).
__device__ __forceinline__ uint32_t max_s16x2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// Fold a word of four int8 samples into acc, which holds byte maxima as the
// high bytes of two 16-bit halves (x * 256 orders as x does): the odd bytes
// already sit there, the even bytes are shifted in.
constexpr uint32_t kAccInit = 0x80008000u;  // -128 * 256 in each half
__device__ __forceinline__ uint32_t fold_word(uint32_t acc, uint32_t v) {
    acc = max_s16x2(acc, v & 0xff00ff00u);
    return max_s16x2(acc, (v << 8) & 0xff00ff00u);
}

// The same for a word at a row's edge: only its bytes [lo, hi) count, the
// others read as -128.
__device__ __forceinline__ uint32_t fold_partial(uint32_t acc, uint32_t v, int lo, int hi) {
    const uint32_t keep = (0xffffffffu << (8 * lo)) & (0xffffffffu >> (8 * (4 - hi)));
    return fold_word(acc, (v & keep) | (kNeg4 & ~keep));
}

// Bytes [beg, end) of one row in a stage buffer: the whole words are shared
// by the row's lanes; the partial words at either end, if any, go to its
// first and last lane. An empty range is [0, 0).
struct RowBytes {
    const uint32_t* words;
    int beg, end;
    __device__ __forceinline__ int first_word() const { return (beg + 3) >> 2; }
    __device__ __forceinline__ int whole_words() const { return (end >> 2) - first_word(); }
    __device__ __forceinline__ uint32_t fold_edges(uint32_t acc, int lane_in_row, int lanes) const {
        const int w_head = beg >> 2, w_tail = end >> 2;
        const bool head_partial = beg & 3;
        if (lane_in_row == 0 && head_partial)  // the word holding beg, maybe end too
            acc = fold_partial(acc, words[w_head], beg & 3, min(end - 4 * w_head, 4));
        if (lane_in_row == lanes - 1 && (end & 3) && !(head_partial && w_tail == w_head))
            acc = fold_partial(acc, words[w_tail], 0, end & 3);
        return acc;
    }
};

__device__ __forceinline__ int peak_of(uint32_t acc) {
    return max(int(int16_t(acc)), int(int16_t(acc >> 16))) >> 8;
}

// The verdict of one chip from its two peaks, as both designs apply it.
__device__ __forceinline__ uint8_t verdict_q(int peak_tc, int peak_hbm, float age,
                                             float lookback, float cutoff) {
    // the -1 sentinel makes has_data implicit: peak == 0 needs a valid zero
    const bool idle = peak_tc == 0;
    const bool hbm_active = float(peak_hbm) >= cutoff;
    const bool eligible = flush_subnormal(age) >= lookback;
    return (idle && !hbm_active && eligible) ? 1 : 0;
}

__global__ void __launch_bounds__(kQThreads)
chip_pass_q_kernel(const int8_t* __restrict__ tc_q, const int8_t* __restrict__ hbm_q,
                   const float* __restrict__ age, const float* __restrict__ params_q,
                   uint8_t* __restrict__ out, const QPlan q) {
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ __align__(8) uint64_t full[kQMaxStages], empty[kQMaxStages];
    __shared__ int carry[2][kQCarryRows];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t T = q.num_samples;
    // stage layout: tc part | hbm part | tile ages, each with 16 bytes of slack
    const int array_bytes = int(q.part_bytes) + 16;
    const int stage_bytes = 2 * array_bytes + int(q.rows) * 4 + 16;

    if (threadIdx.x == 0) {
        for (int s = 0; s < q.stages; ++s) {
            mbar_init(&full[s], 32);                // every producer lane arrives
            mbar_init(&empty[s], kQConsumerWarps);  // every consumer warp releases
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == kQConsumerWarps) {  // producer: fill the ring ahead of the consumers
        for (PartWalk w(q); w.valid(); w.next()) {
            // a fresh barrier passes a wait on parity 1: the first round is free
            mbar_wait(&empty[w.stage], w.phase ^ 1);
            unsigned char* buf = ring + w.stage * stage_bytes;
            uint64_t* bar = &full[w.stage];
            const auto* src_tc = reinterpret_cast<const unsigned char*>(tc_q + w.row0 * T + w.start);
            const auto* src_hbm = reinterpret_cast<const unsigned char*>(hbm_q + w.row0 * T + w.start);
            const auto* src_age = reinterpret_cast<const unsigned char*>(age + w.row0);
            const Span tc(src_tc, w.len()), hbm(src_hbm, w.len()), ag(src_age, w.age_len());
            if (lane == 0) {
                mbar_expect_tx(bar, uint32_t(tc.bulk + hbm.bulk + ag.bulk));
                if (tc.bulk) bulk_copy(buf + tc.mis + tc.head, src_tc + tc.head, tc.bulk, bar);
                if (hbm.bulk)
                    bulk_copy(buf + array_bytes + hbm.mis + hbm.head, src_hbm + hbm.head, hbm.bulk,
                              bar);
                if (ag.bulk)
                    bulk_copy(buf + 2 * array_bytes + ag.mis + ag.head, src_age + ag.head, ag.bulk,
                              bar);
            }
            tc.copy_edge(buf, src_tc, lane);
            hbm.copy_edge(buf + array_bytes, src_hbm, lane);
            ag.copy_edge(buf + 2 * array_bytes, src_age, lane);
            mbar_arrive(bar);  // after this lane's plain stores
        }
        return;
    }

    // consumers: a row of the tile belongs to one lane group of one warp in
    // every part, so a row cut by parts carries its max in that group alone
    const float lookback = flush_subnormal(params_q[0]);
    const float cutoff = flush_subnormal(params_q[1]);
    const int lane_in_row = lane & (q.lanes - 1);
    const int rows_per_warp = 32 / q.lanes;
    const int rows_per_round = kQConsumerWarps * rows_per_warp;  // a power of two
    const int row_in_warp = lane / q.lanes;
    const int row_in_round = warp * rows_per_warp + row_in_warp;
    const int mis_tc = int(reinterpret_cast<uintptr_t>(tc_q) & 15);
    const int mis_hbm = int(reinterpret_cast<uintptr_t>(hbm_q) & 15);
    const int mis_age = int(reinterpret_cast<uintptr_t>(age) & 15);
    for (PartWalk w(q); w.valid(); w.next()) {
        mbar_wait(&full[w.stage], w.phase);
        const unsigned char* buf = ring + w.stage * stage_bytes;
        const auto* words_tc = reinterpret_cast<const uint32_t*>(buf);
        const auto* words_hbm = reinterpret_cast<const uint32_t*>(buf + array_bytes);
        const auto* ages = reinterpret_cast<const float*>(buf + 2 * array_bytes + mis_age);
        const int len = w.len();
        // rows [r_first, r_last] meet this part: all rows of the tile when it
        // has one part. Tile-local offsets fit 32 bits (plan_ok checks).
        const int Ti = int(T), start = int(w.start);
        int r_first = 0, r_last = int(w.tile_rows) - 1;
        if (q.parts > 1) {
            r_first = start / Ti;
            r_last = len ? (start + len - 1) / Ti : r_first - 1;
        }
        // The loop bound depends only on the warp, so whole warps shuffle.
        for (int r = (r_first & ~(rows_per_round - 1)) + row_in_round;
             r - row_in_warp <= r_last; r += rows_per_round) {
            const bool active = r >= r_first && r <= r_last;
            int beg = 0, end = 0;  // the row's bytes within this part
            if (active) {
                beg = max(r * Ti - start, 0);
                end = min(r * Ti + Ti - start, len);
            }
            const RowBytes a{words_tc, active ? mis_tc + beg : 0, active ? mis_tc + end : 0};
            const RowBytes b{words_hbm, active ? mis_hbm + beg : 0, active ? mis_hbm + end : 0};
            uint32_t acc_tc = kAccInit, acc_hbm = kAccInit;
            const int wa = a.first_word(), na = a.whole_words();
            const int wb = b.first_word(), nb = b.whole_words();
            // the two arrays may be misaligned differently, so their word
            // ranges can differ by one
            for (int k = lane_in_row; k < max(na, nb); k += q.lanes) {
                if (k < na) acc_tc = fold_word(acc_tc, words_tc[wa + k]);
                if (k < nb) acc_hbm = fold_word(acc_hbm, words_hbm[wb + k]);
            }
            int peak_tc = peak_of(a.fold_edges(acc_tc, lane_in_row, q.lanes));
            int peak_hbm = peak_of(b.fold_edges(acc_hbm, lane_in_row, q.lanes));
            for (int off = q.lanes >> 1; off > 0; off >>= 1) {
                peak_tc = max(peak_tc, __shfl_xor_sync(kFullMask, peak_tc, off));
                peak_hbm = max(peak_hbm, __shfl_xor_sync(kFullMask, peak_hbm, off));
            }
            if (!active || lane_in_row != 0) continue;
            if (q.parts > 1) {
                if (r * Ti < start) {  // the row began in an earlier part
                    peak_tc = max(peak_tc, carry[0][r]);
                    peak_hbm = max(peak_hbm, carry[1][r]);
                }
                if (r * Ti + Ti > start + len) {  // and goes on in the next one
                    carry[0][r] = peak_tc;
                    carry[1][r] = peak_hbm;
                    continue;
                }
            }
            out[w.row0 + r] = verdict_q(peak_tc, peak_hbm, ages[r], lookback, cutoff);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[w.stage]);  // this warp is done with the stage
    }
}

bool plan_ok(const QPlan& q, int64_t smem_bytes, int64_t grid) {
    const bool lanes_pow2 = q.lanes >= 1 && q.lanes <= 32 && (q.lanes & (q.lanes - 1)) == 0;
    const int64_t stage = 2 * (q.part_bytes + 16) + q.rows * 4 + 16;
    return q.num_chips > 0 && q.num_samples > 0 && q.rows > 0 && q.rows % 16 == 0 &&
           q.rows * q.num_samples <= INT32_MAX &&  // tile-local offsets are 32-bit
           q.part_bytes > 0 && q.part_bytes % 16 == 0 && q.parts >= 1 &&
           int64_t(q.parts) * q.part_bytes >= q.rows * q.num_samples &&
           (q.parts == 1 || q.rows <= kQCarryRows) && q.stages >= 1 &&
           q.stages <= kQMaxStages && lanes_pow2 && smem_bytes >= q.stages * stage &&
           smem_bytes <= kQSmemMax && grid <= 0x7fffffff &&
           (grid - 1) * q.rows < q.num_chips && q.num_chips <= grid * q.rows;  // a tile a block
}


// ── int8 pass for short rows: a thread reduces whole rows from registers ────

constexpr int kRowsThreads = 128;  // threads per block (kernels._Q_ROWS_THREADS)

// The row lengths with a kernel (kernels._Q_ROWS_T): T <= 64 whose group is
// at most 5 vectors of each array, but not 5, whose thread walks 16 rows of
// 5 vectors. The lengths left out measured slower than the tile design.
using RowsT = std::integer_sequence<int, 1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32, 40, 48, 64>;

template <int... Ts>
constexpr bool contains(int T, std::integer_sequence<int, Ts...>) {
    return ((T == Ts) || ...);
}

__host__ __device__ constexpr int gcd_int(int a, int b) { return b ? gcd_int(b, a % b) : a; }
// the rows a thread owns: the fewest whose bytes are whole 16-byte vectors
__host__ __device__ constexpr int rows_per_thread(int T) { return 16 / gcd_int(T, 16); }

// The peak of row R of a group of T-byte rows held as 4-byte words: the
// words inside the row fold whole, a word shared with a neighbouring row
// folds only the row's bytes. R and T are constants, so are the word
// indices and masks.
template <int T, int R, int W>
__device__ __forceinline__ int row_peak(const uint32_t (&w)[W]) {
    constexpr int first = R * T / 4, last = (R * T + T - 1) / 4;
    uint32_t acc = kAccInit;
#pragma unroll
    for (int k = first; k <= last; ++k) {
        const int lo = max(R * T - 4 * k, 0), hi = min(R * T + T - 4 * k, 4);
        acc = lo == 0 && hi == 4 ? fold_word(acc, w[k]) : fold_partial(acc, w[k], lo, hi);
    }
    return peak_of(acc);
}

// The verdicts of a group's rows 0..G-1.
template <int T, int W, int G, int... Rs>
__device__ __forceinline__ void group_verdicts(const uint32_t (&wa)[W], const uint32_t (&wb)[W],
                                               const float (&ages)[G], float lookback,
                                               float cutoff, uint8_t (&v)[G],
                                               std::integer_sequence<int, Rs...>) {
    ((v[Rs] = verdict_q(row_peak<T, Rs>(wa), row_peak<T, Rs>(wb), ages[Rs], lookback, cutoff)),
     ...);
}

// G consecutive ages from a 4*G-byte aligned address.
template <int G>
__device__ __forceinline__ void load_ages(const float* p, float (&a)[G]) {
    if constexpr (G % 4 == 0) {
#pragma unroll
        for (int i = 0; i < G / 4; ++i) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(p) + i);
            a[4 * i] = x.x, a[4 * i + 1] = x.y, a[4 * i + 2] = x.z, a[4 * i + 3] = x.w;
        }
    } else if constexpr (G == 2) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(p));
        a[0] = x.x, a[1] = x.y;
    } else {
        a[0] = __ldg(p);
    }
}

__device__ __forceinline__ uint32_t pack4(const uint8_t* v) {
    return v[0] | uint32_t(v[1]) << 8 | uint32_t(v[2]) << 16 | uint32_t(v[3]) << 24;
}

// G verdict bytes in one store, to a G-byte aligned address.
template <int G>
__device__ __forceinline__ void store_verdicts(uint8_t* p, const uint8_t (&v)[G]) {
    if constexpr (G == 1) {
        *p = v[0];
    } else if constexpr (G == 2) {
        *reinterpret_cast<uint16_t*>(p) = uint16_t(v[0] | v[1] << 8);
    } else if constexpr (G == 4) {
        *reinterpret_cast<uint32_t*>(p) = pack4(v);
    } else if constexpr (G == 8) {
        *reinterpret_cast<uint2*>(p) = make_uint2(pack4(v), pack4(v + 4));
    } else {
        *reinterpret_cast<uint4*>(p) = make_uint4(pack4(v), pack4(v + 4), pack4(v + 8),
                                                  pack4(v + 12));
    }
}

template <int T>
__global__ void __launch_bounds__(kRowsThreads)
chip_pass_q_rows_kernel(const int8_t* __restrict__ tc_q, const int8_t* __restrict__ hbm_q,
                        const float* __restrict__ age, const float* __restrict__ params_q,
                        uint8_t* __restrict__ out, int64_t num_chips) {
    constexpr int G = rows_per_thread(T);
    constexpr int V = G * T / 16;  // 16-byte vectors of each array
    constexpr int W = 4 * V;       // their 4-byte words
    const int64_t group = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t row0 = group * G;
    if (row0 >= num_chips) return;
    const float lookback = flush_subnormal(__ldg(params_q));
    const float cutoff = flush_subnormal(__ldg(params_q + 1));
    if (row0 + G > num_chips) {  // the ragged last group: the rows that exist, bytewise
        for (int64_t r = row0; r < num_chips; ++r) {
            int peak_tc = -128, peak_hbm = -128;
            for (int t = 0; t < T; ++t) {
                peak_tc = max(peak_tc, int(tc_q[r * T + t]));
                peak_hbm = max(peak_hbm, int(hbm_q[r * T + t]));
            }
            out[r] = verdict_q(peak_tc, peak_hbm, age[r], lookback, cutoff);
        }
        return;
    }
    // every load before any arithmetic
    uint32_t wa[W], wb[W];
    const uint4* va = reinterpret_cast<const uint4*>(tc_q) + group * V;
    const uint4* vb = reinterpret_cast<const uint4*>(hbm_q) + group * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const uint4 x = __ldg(va + v), y = __ldg(vb + v);
        wa[4 * v] = x.x, wa[4 * v + 1] = x.y, wa[4 * v + 2] = x.z, wa[4 * v + 3] = x.w;
        wb[4 * v] = y.x, wb[4 * v + 1] = y.y, wb[4 * v + 2] = y.z, wb[4 * v + 3] = y.w;
    }
    float ages[G];
    load_ages(age + row0, ages);
    uint8_t verdicts[G];
    group_verdicts<T>(wa, wb, ages, lookback, cutoff, verdicts,
                      std::make_integer_sequence<int, G>{});
    store_verdicts(out + row0, verdicts);
}

struct RowsArgs {
    const int8_t* tc_q;
    const int8_t* hbm_q;
    const float* age;
    const float* params_q;
    uint8_t* out;
    int64_t num_chips;
};

template <int T>
void launch_rows_if(int t, const RowsArgs& a, unsigned grid, cudaStream_t stream) {
    if (t == T)
        chip_pass_q_rows_kernel<T><<<grid, kRowsThreads, 0, stream>>>(
            a.tc_q, a.hbm_q, a.age, a.params_q, a.out, a.num_chips);
}

// Launch the instantiation for T, one of RowsT.
template <int... Ts>
void launch_rows(int T, std::integer_sequence<int, Ts...>, const RowsArgs& a, unsigned grid,
                 cudaStream_t stream) {
    (launch_rows_if<Ts>(T, a, grid, stream), ...);
}

bool rows_plan_ok(const RowsArgs& a, int64_t T, int64_t rows, int64_t grid) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(a.tc_q) |
                            reinterpret_cast<uintptr_t>(a.hbm_q) |
                            reinterpret_cast<uintptr_t>(a.age) |
                            reinterpret_cast<uintptr_t>(a.out);
    if (T < 1 || T > 64 || !contains(int(T), RowsT{}) || (bases & 15) != 0)
        return false;
    const int64_t per_block = kRowsThreads * rows;
    return a.num_chips > 0 && rows == rows_per_thread(int(T)) && grid <= 0x7fffffff &&
           (grid - 1) * per_block < a.num_chips && a.num_chips <= grid * per_block;
}

// ── f32 pass for short rows: a lane group per row ──────────────────────────
//
// An audit dump holds 8 samples a chip (dump.py's 2100 s window at its 300 s
// step). The first port's design, a warp a row (retired; PERF.md), read such a
// row with 8 of its 32 lanes, ran three 5-step warp reductions for 8 values,
// and loaded the row's age only after them, a second memory round trip: at
// 1,048,576 x 8 it took 0.28 ms against a bound of 0.024 ms on the H100
// (PERF.md). The group design:
//   - gives a row L lanes, L a power of two up to 32, and each lane up to K
//     samples (kernels._plan_groups: K = 4 up to 8 samples, else 8; L the
//     fewest lanes that cover the row); lane l reads samples l, l + L, ...,
//     so a warp's j-th loads are runs of L samples of its 32 / L
//     consecutive rows;
//   - issues every load before any arithmetic, the row's age (its first
//     lane) and the parameters included: a thread keeps up to K samples of
//     each array in flight, where a lane of the first port's design kept one;
//   - reduces over log2(L) xor shuffles, which stay inside the row's aligned
//     group of lanes, and takes the NaN and has-data flags from ballots
//     masked to the group;
//   - needs no shared memory, no alignment and no template on T, so views
//     off a 16-byte boundary take it as they are.

// A lane's K samples of each array of one row: samples first, first +
// stride, ..., those below T. load issues every load before any
// arithmetic; fold adds the same samples to the row's peaks.
template <int K>
struct LaneSamples {
    float tc[K], hbm[K];
    uint8_t valid[K];
    __device__ __forceinline__ void load(const float* __restrict__ tc_row,
                                         const float* __restrict__ hbm_row,
                                         const uint8_t* __restrict__ valid_row, int first,
                                         int stride, int T, bool live) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const int t = first + j * stride;
            const bool in = live && t < T;
            valid[j] = in ? __ldg(valid_row + t) : 0;
            tc[j] = in ? __ldg(tc_row + t) : 0.0f;
            hbm[j] = in ? __ldg(hbm_row + t) : 0.0f;
        }
    }
    __device__ __forceinline__ void fold(RowPeaks& p, int first, int stride, int T,
                                         bool live) const {
#pragma unroll
        for (int j = 0; j < K; ++j)
            if (live && first + j * stride < T) p.add(tc[j], hbm[j], valid[j] != 0);
    }
};

template <int K>
__global__ void __launch_bounds__(kThreads)
chip_pass_groups_kernel(const float* __restrict__ tc, const float* __restrict__ hbm,
                        const uint8_t* __restrict__ valid, const float* __restrict__ age,
                        const float* __restrict__ params, uint8_t* __restrict__ out,
                        int64_t num_chips, int num_samples, int log2_lanes) {
    const int lanes = 1 << log2_lanes;
    const int lane = threadIdx.x & 31;
    const int64_t warp_row0 =
        (int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) << (5 - log2_lanes);
    if (warp_row0 >= num_chips) return;  // whole warp leaves together
    const int lane_in_row = lane & (lanes - 1);
    const int64_t row = warp_row0 + (lane >> log2_lanes);
    const bool live = row < num_chips;
    const int64_t base = row * num_samples;

    // every load before any arithmetic, the age and the parameters included
    LaneSamples<K> x;
    x.load(tc + base, hbm + base, valid + base, lane_in_row, lanes, num_samples, live);
    const bool leader = live && lane_in_row == 0;
    const float row_age = leader ? __ldg(age + row) : 0.0f;
    const float lookback = flush_subnormal(__ldg(params));
    const float cutoff = flush_subnormal(__ldg(params + 1));

    RowPeaks p;
    x.fold(p, lane_in_row, lanes, num_samples, live);
    // xor offsets below L stay inside the row's aligned group of lanes
    for (int off = lanes >> 1; off > 0; off >>= 1) {
        const float other_tc = __shfl_xor_sync(kFullMask, p.tc.max, off);
        const float other_hbm = __shfl_xor_sync(kFullMask, p.hbm.max, off);
        p.tc.max = other_tc > p.tc.max ? other_tc : p.tc.max;
        p.hbm.max = other_hbm > p.hbm.max ? other_hbm : p.hbm.max;
    }
    const unsigned group = (lanes == 32 ? kFullMask : (1u << lanes) - 1)
                           << (lane - lane_in_row);
    p.tc.nan = __ballot_sync(kFullMask, p.tc.nan) & group;
    p.hbm.nan = __ballot_sync(kFullMask, p.hbm.nan) & group;
    p.has_data = __ballot_sync(kFullMask, p.has_data) & group;
    if (leader) out[row] = verdict_f32(p, row_age, lookback, cutoff);
}

// The samples a lane of the group design takes (kernels._F32_GROUPS_K).
using GroupsK = std::integer_sequence<int, 4, 8>;

struct F32Args {
    const float* tc;
    const float* hbm;
    const uint8_t* valid;
    const float* age;
    const float* params;
    uint8_t* out;
    int64_t num_chips;
};

template <int K>
void launch_groups_if(int k, const F32Args& a, int T, int log2_lanes, unsigned grid,
                      cudaStream_t stream) {
    if (k == K)
        chip_pass_groups_kernel<K><<<grid, kThreads, 0, stream>>>(
            a.tc, a.hbm, a.valid, a.age, a.params, a.out, a.num_chips, T, log2_lanes);
}

template <int... Ks>
void launch_groups(int k, std::integer_sequence<int, Ks...>, const F32Args& a, int T,
                   int log2_lanes, unsigned grid, cudaStream_t stream) {
    (launch_groups_if<Ks>(k, a, T, log2_lanes, grid, stream), ...);
}

bool groups_plan_ok(const F32Args& a, int64_t T, int64_t lanes, int64_t k, int64_t grid) {
    const bool lanes_pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
    if (!lanes_pow2 || !contains(int(k), GroupsK{}) || T < 1 || lanes * k < T)
        return false;
    const int64_t per_block = kWarpsPerBlock * (32 / lanes);
    return a.num_chips > 0 && grid <= 0x7fffffff && (grid - 1) * per_block < a.num_chips &&
           a.num_chips <= grid * per_block;
}

// ── f32 pass for long rows: a warp a row, in chunks of 32 K samples ────────
//
// Above 256 samples the group design runs out of lanes, and the first
// port's design, a warp a row, reached 55-59% of its bound at T = 360 on the
// H100 (PERF.md): a lane kept one sample of each array in flight, and loaded
// the age only after the row's three reductions. The long-row design:
//   - gives a row one warp and walks it in chunks of 32 K samples, K = 12
//     or 16 (kernels._plan_long: 16 when that takes the row in one chunk
//     and 12 does not, else 12; T = 360 is one chunk of 12);
//   - issues every load of a chunk (3 K a lane) before folding it, and the
//     row's age and the parameters before the first chunk, so a warp keeps
//     about 9 * 32 K bytes in flight where the first port's design kept 288;
//   - loads the next chunk only after folding this one: two register
//     buffers (the next chunk in flight during the fold) measured slower
//     on the H100 in an exploratory build, since they double the samples a
//     thread holds in registers and so cut the warps an SM can hold, which
//     keep more bytes in flight than a second buffer does;
//   - folds the lanes with xor shuffles and takes the NaN and has-data
//     flags from warp votes, as the group design does;
//   - needs no shared memory and no alignment, so views off a 16-byte
//     boundary take it as they are, and no limit on T.
template <int K>
__global__ void __launch_bounds__(kThreads)
chip_pass_long_kernel(const float* __restrict__ tc, const float* __restrict__ hbm,
                      const uint8_t* __restrict__ valid, const float* __restrict__ age,
                      const float* __restrict__ params, uint8_t* __restrict__ out,
                      int64_t num_chips, int num_samples) {
    constexpr int kChunk = 32 * K;
    const int lane = threadIdx.x & 31;
    const int64_t row = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    if (row >= num_chips) return;  // whole warp leaves together
    const float* tc_row = tc + row * num_samples;
    const float* hbm_row = hbm + row * num_samples;
    const uint8_t* valid_row = valid + row * num_samples;

    LaneSamples<K> x;
    x.load(tc_row, hbm_row, valid_row, lane, 32, num_samples, true);
    const float row_age = lane == 0 ? __ldg(age + row) : 0.0f;
    const float lookback = flush_subnormal(__ldg(params));
    const float cutoff = flush_subnormal(__ldg(params + 1));

    RowPeaks p;
    for (int t0 = 0;; t0 += kChunk) {
        x.fold(p, t0 + lane, 32, num_samples, true);
        if (t0 + kChunk >= num_samples) break;
        x.load(tc_row, hbm_row, valid_row, t0 + kChunk + lane, 32, num_samples, true);
    }
    p.tc.warp_reduce();
    p.hbm.warp_reduce();
    p.has_data = __any_sync(kFullMask, p.has_data);
    if (lane == 0) out[row] = verdict_f32(p, row_age, lookback, cutoff);
}

// The samples a lane of a chunk of the long-row design (kernels._F32_LONG_K).
using LongK = std::integer_sequence<int, 12, 16>;

template <int K>
void launch_long_if(int k, const F32Args& a, int T, unsigned grid, cudaStream_t stream) {
    if (k == K)
        chip_pass_long_kernel<K><<<grid, kThreads, 0, stream>>>(
            a.tc, a.hbm, a.valid, a.age, a.params, a.out, a.num_chips, T);
}

template <int... Ks>
void launch_long(int k, std::integer_sequence<int, Ks...>, const F32Args& a, int T, unsigned grid,
                 cudaStream_t stream) {
    (launch_long_if<Ks>(k, a, T, grid, stream), ...);
}

// a warp a row; T leaves room for a chunk past it in 32-bit sample indices
bool long_plan_ok(const F32Args& a, int64_t T, int64_t k, int64_t grid) {
    if (!contains(int(k), LongK{}) || T < 1 || T > (int64_t(1) << 30)) return false;
    return a.num_chips > 0 && grid <= 0x7fffffff &&
           (grid - 1) * kWarpsPerBlock < a.num_chips && a.num_chips <= grid * kWarpsPerBlock;
}

// ── the contiguous slice gate: chip verdicts -> slice verdicts ─────────────
//
// tp_slice_gate has no Pallas counterpart. It is the reduction that the
// reference leaves to XLA inside its jitted evaluate_fleet_c and _qc
// (tpu_pruner/policy/engine.py:233-239, a cumsum and a boundary gather),
// which the port ran as 14 eager operations after the pass. It reads the
// candidate bytes (bool[C], nonzero = candidate) and the bounds ([S+1],
// int32 or int64) and writes bool[S], with the semantics of
// kernels.slice_gate_plain:
//   - bound b is read where that gather reads it, clamp(b, -(C+1), C) with a
//     negative one counted from the end; slice s covers the chips between its
//     two read bounds, in either order;
//   - s is idle iff bounds[s+1] - bounds[s], taken in the bounds' dtype (the
//     wrapper passes narrower dtypes widened, with their width: wrap_bits)
//     and cast to int32, is > 0, and no chip it covers is busy (a 0 byte).
//     An empty or inverted slice is never idle, and reads no chip.
// It moves at most C + |bounds| + S bytes (172 KB at 131,072 chips in 8,192
// slices): a launch and two dependent memory round trips (the bounds, then
// the chips) bound it, not bandwidth.
//
// The work split is decided per slice, inside the kernel, from the slice's
// own length. Block b owns `per` consecutive slices, b x per onwards, a
// thread each; `per` is kGateThreads unless the fleet has more chips than
// kGateChipsPerBlock per block at that, when the slices are spread over
// more blocks (up to one slice a block). Each thread reads its slice's chips
// as granules, the aligned 16-byte words that hold them,
// with the bytes outside the slice's range masked off (a granule never
// crosses a page, so reading all of it is safe):
//   - a slice of up to kGateLaneGranules granules (up to 113 chips; every
//     slice of the main path's 16-chip fleets) is read by its thread alone,
//     all its loads issued at once, and its verdict written at once;
//   - a longer slice has its first and last granule read by its thread; if
//     neither holds a busy chip, the block's kGateThreads threads walk its
//     interior granules together with those of the block's other long
//     slices, as one run, load-balanced: the block's warp w reads granules
//     [w, w + 1) x 32 kGateWalkGranules of each round, 32 consecutive
//     granules (512 bytes) a load. A busy granule sets its slice's bit in
//     shared memory, and after a block barrier the owners' verdicts are
//     written. The walk does not stop early.
// So a long slice is read by a block of threads on one SM wherever it sits
// among short ones, few long slices are spread over as many blocks, and a
// block whose slices are all short passes one barrier and no other. One SM
// reads a slice of 1,048,576 chips at under 50 GB/s; a cluster of blocks on
// 8 SMs would read it faster, but its scheduling and barriers cost every
// launch, the main path's included (PERF.md §6).

constexpr int kGateThreads = 512;      // a block (kernels._GATE_THREADS)
constexpr int kGateLaneGranules = 8;   // the longest slice a thread reads alone (_GATE_LANE_GRANULES)
constexpr int kGateWalkGranules = 8;   // granules a thread a round of the walk (_GATE_WALK_GRANULES)
constexpr int kGateWarps = kGateThreads / 32;
constexpr int64_t kGateChipsPerBlock = 16384;  // spread slices over C / this blocks (_GATE_CHIPS_PER_BLOCK)

// One slice's chips as granules: n granules from `first`, the first one's
// bytes from lo and the last one's up to hi (exclusive) in range.
struct GateSlice {
    const uint4* first = nullptr;
    int64_t n = 0;
    int lo = 0, hi = 16;
    bool open = false;  // int32(bounds[s+1] - bounds[s]) > 0
};

// clamp(b, -(C+1), C), then a negative one from the end: where the plain
// version's gather reads bound b.
__device__ __forceinline__ int64_t gate_index(int64_t b, int64_t num_chips) {
    const int64_t n = num_chips + 1;
    b = b < -n ? -n : (b > num_chips ? num_chips : b);
    return b < 0 ? b + n : b;
}

template <typename B>
__device__ __forceinline__ GateSlice gate_slice(const uint8_t* cand, const B* bounds, int64_t s,
                                                int64_t num_chips, int wrap_bits,
                                                bool wrap_signed) {
    const int64_t b0 = int64_t(bounds[s]), b1 = int64_t(bounds[s + 1]);
    // the difference in the bounds' own width, then cast to int32
    const uint32_t d = uint32_t(uint64_t(b1) - uint64_t(b0));
    int32_t chips = int32_t(d);
    if (wrap_bits == 8) chips = wrap_signed ? int32_t(int8_t(d & 0xffu)) : int32_t(d & 0xffu);
    if (wrap_bits == 16)
        chips = wrap_signed ? int32_t(int16_t(d & 0xffffu)) : int32_t(d & 0xffffu);
    GateSlice g;
    g.open = chips > 0;
    if (!g.open) return g;  // never idle: no chip to read
    int64_t lo = gate_index(b0, num_chips), hi = gate_index(b1, num_chips);
    if (lo > hi) {
        const int64_t t = lo;
        lo = hi, hi = t;
    }
    if (lo == hi) return g;  // no chip: idle
    const uintptr_t p = reinterpret_cast<uintptr_t>(cand) + uintptr_t(lo);
    const uintptr_t q = reinterpret_cast<uintptr_t>(cand) + uintptr_t(hi);
    const uintptr_t a = p & ~uintptr_t(15), z = (q + 15) & ~uintptr_t(15);
    g.first = reinterpret_cast<const uint4*>(a);
    g.n = int64_t((z - a) >> 4);
    g.lo = int(p - a);
    g.hi = int(q - (z - 16));
    return g;
}

// Whether a word holds a 0 byte (exact: a byte above the lowest zero byte
// may set a false bit, but the word tests nonzero iff one byte is zero).
__device__ __forceinline__ bool has_zero_byte(uint64_t x) {
    return ((x - 0x0101010101010101ull) & ~x & 0x8080808080808080ull) != 0ull;
}

__device__ __forceinline__ uint64_t low_word(const uint4& v) {
    return uint64_t(v.x) | (uint64_t(v.y) << 32);
}

__device__ __forceinline__ uint64_t high_word(const uint4& v) {
    return uint64_t(v.z) | (uint64_t(v.w) << 32);
}

__device__ __forceinline__ bool any_busy(const uint4& v) {
    return has_zero_byte(low_word(v)) | has_zero_byte(high_word(v));
}

// The bytes [lo, hi) of a 64-bit word, clamped to [0, 8), as a mask.
__device__ __forceinline__ uint64_t byte_mask(int lo, int hi) {
    lo = min(max(lo, 0), 8), hi = min(max(hi, 0), 8);
    const uint64_t below_hi = hi == 8 ? ~0ull : (1ull << (8 * hi)) - 1;
    const uint64_t below_lo = lo == 8 ? ~0ull : (1ull << (8 * lo)) - 1;
    return below_hi & ~below_lo;
}

// Whether bytes [lo, hi) of granule v hold a 0 byte: the others are set to
// 0xff first.
__device__ __forceinline__ bool masked_busy(const uint4& v, int lo, int hi) {
    return has_zero_byte(low_word(v) | ~byte_mask(lo, hi)) |
           has_zero_byte(high_word(v) | ~byte_mask(lo - 8, hi - 8));
}

// The owning thread's part of a slice: a short slice's verdict, and a long
// one's first and last granule. Writes the verdict where these settle it;
// returns whether the slice's interior is left to the walk.
__device__ __forceinline__ bool gate_own(const GateSlice& g, uint8_t* verdict) {
    const uint4 none = make_uint4(~0u, ~0u, ~0u, ~0u);
    const bool alone = g.n <= kGateLaneGranules;
    const uint4 head = g.n > 0 ? __ldg(g.first) : none;
    const uint4 tail = g.n > 1 ? __ldg(g.first + g.n - 1) : none;
    uint4 mid[kGateLaneGranules - 2];
#pragma unroll
    for (int u = 0; u < kGateLaneGranules - 2; ++u)
        mid[u] = alone && u + 1 < g.n - 1 ? __ldg(g.first + 1 + u) : none;
    bool busy = masked_busy(head, g.lo, g.n == 1 ? g.hi : 16) | masked_busy(tail, 0, g.hi);
#pragma unroll
    for (int u = 0; u < kGateLaneGranules - 2; ++u) busy |= any_busy(mid[u]);
    if (alone || busy) {
        *verdict = (g.open && !busy) ? 1 : 0;
        return false;
    }
    return true;
}

template <typename B>
__global__ void __launch_bounds__(kGateThreads)
slice_gate_kernel(const uint8_t* __restrict__ cand, const B* __restrict__ bounds,
                  uint8_t* __restrict__ out, int64_t num_chips, int64_t num_slices, int per,
                  int wrap_bits, int wrap_signed) {
    // The block's long slices, in thread order, as one run of granules: list
    // e's are run[walk_start[e], walk_start[e+1]), from walk_first[e]; its
    // owner is thread walk_owner[e], and a busy granule sets bit e of
    // walk_busy.
    __shared__ const uint4* walk_first[kGateThreads];
    __shared__ int64_t walk_start[kGateThreads + 1];
    __shared__ int walk_owner[kGateThreads];
    __shared__ unsigned walk_busy[kGateWarps];
    __shared__ int64_t warp_lists[kGateWarps], warp_granules[kGateWarps];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid < kGateWarps) walk_busy[tid] = 0u;
    const int64_t block_first = int64_t(blockIdx.x) * per, s = block_first + tid;
    GateSlice g;
    bool listed = false;
    if (tid < per && s < num_slices) {
        g = gate_slice(cand, bounds, s, num_chips, wrap_bits, wrap_signed != 0);
        listed = gate_own(g, out + s);
    }
    if (!__syncthreads_or(listed)) return;  // every slice of the block is settled

    // each listed thread's place in the lists and in the run: a warp's
    // shuffle scan, then the warps' sums scanned by warp 0
    int64_t lists = listed ? 1 : 0, granules = listed ? g.n - 2 : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int64_t l = __shfl_up_sync(kFullMask, lists, off);
        const int64_t n = __shfl_up_sync(kFullMask, granules, off);
        if (lane >= off) lists += l, granules += n;
    }
    if (lane == 31) warp_lists[warp] = lists, warp_granules[warp] = granules;
    __syncthreads();
    if (warp == 0) {
        int64_t l = lane < kGateWarps ? warp_lists[lane] : 0;
        int64_t n = lane < kGateWarps ? warp_granules[lane] : 0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int64_t l2 = __shfl_up_sync(kFullMask, l, off);
            const int64_t n2 = __shfl_up_sync(kFullMask, n, off);
            if (lane >= off) l += l2, n += n2;
        }
        if (lane < kGateWarps) warp_lists[lane] = l, warp_granules[lane] = n;
    }
    __syncthreads();
    const int n_lists = int(warp_lists[kGateWarps - 1]);
    const int64_t total = warp_granules[kGateWarps - 1];
    if (listed) {
        const int e = int(lists - 1 + (warp > 0 ? warp_lists[warp - 1] : 0));
        walk_first[e] = g.first + 1;
        walk_start[e] = granules - (g.n - 2) + (warp > 0 ? warp_granules[warp - 1] : 0);
        walk_owner[e] = tid;
    }
    if (tid == 0) walk_start[n_lists] = total;
    __syncthreads();

    // the walk: warp w reads granules [w, w + 1) x 32 kGateWalkGranules of
    // each round, granule 32 u + lane of them at load u
    constexpr int64_t kRound = int64_t(kGateThreads) * kGateWalkGranules;
    int flagged = -1;  // the last list this thread flagged
    for (int64_t at = int64_t(warp) * 32 * kGateWalkGranules + lane; at < total; at += kRound) {
        int e = 0, top = n_lists;  // the last list that starts at or before `at`
        while (top - e > 1) {
            const int mid = (e + top) >> 1;
            if (walk_start[mid] <= at) e = mid;
            else top = mid;
        }
        uint4 x[kGateWalkGranules];
        int list_of[kGateWalkGranules];
#pragma unroll
        for (int u = 0; u < kGateWalkGranules; ++u) {
            const int64_t j = at + int64_t(u) * 32;
            while (e + 1 < n_lists && walk_start[e + 1] <= j) ++e;
            list_of[u] = e;
            x[u] = j < total ? __ldg(walk_first[e] + (j - walk_start[e]))
                             : make_uint4(~0u, ~0u, ~0u, ~0u);
        }
#pragma unroll
        for (int u = 0; u < kGateWalkGranules; ++u) {
            if (list_of[u] == flagged || !any_busy(x[u])) continue;
            flagged = list_of[u];
            atomicOr(&walk_busy[flagged >> 5], 1u << (flagged & 31));
        }
    }
    __syncthreads();
    for (int e = tid; e < n_lists; e += kGateThreads)
        out[block_first + walk_owner[e]] = ((walk_busy[e >> 5] >> (e & 31)) & 1u) ? 0 : 1;
}

// The gate's slices a block (per) and blocks: kGateThreads slices a block,
// or, where that leaves more than kGateChipsPerBlock chips a block, the
// slices spread over C / kGateChipsPerBlock blocks (at most one a slice).
struct GateGrid {
    int64_t per, blocks;
};

GateGrid gate_grid(int64_t num_chips, int64_t num_slices) {
    int64_t blocks = (num_slices + kGateThreads - 1) / kGateThreads;
    const int64_t spread = (num_chips + kGateChipsPerBlock - 1) / kGateChipsPerBlock;
    if (spread > blocks) blocks = spread < num_slices ? spread : num_slices;
    const int64_t per = (num_slices + blocks - 1) / blocks;
    return {per, (num_slices + per - 1) / per};
}

template <typename B>
void launch_gate(const uint8_t* cand, const void* bounds, uint8_t* out, int64_t num_chips,
                 int64_t num_slices, int wrap_bits, int wrap_signed, cudaStream_t stream) {
    const GateGrid grid = gate_grid(num_chips, num_slices);
    slice_gate_kernel<B><<<unsigned(grid.blocks), kGateThreads, 0, stream>>>(
        cand, static_cast<const B*>(bounds), out, num_chips, num_slices, int(grid.per),
        wrap_bits, wrap_signed);
}

// ── the scatter slice reduction: chip verdicts in any order -> slice verdicts
//
// tp_slice_scatter has no Pallas counterpart. It is the reduction of the
// reference's slice_verdicts (tpu_pruner/policy/engine.py:73-86, two
// segment_sum over the slice ids), which the port ran as two index_add_ and
// 13 more eager operations (kernels.slice_counts). It reads the candidate
// bytes (bool[C], nonzero = candidate) and the ids ([C], int32 or int64, in
// any order) and writes bool[S], with the semantics of
// kernels.slice_scatter_plain: an id outside [0, S) counts nowhere (an int64
// id is compared as it is, never cut to 32 bits); slice s is idle iff some
// chip has id s and none of them is busy, so a slice with no chip is never
// idle.
//
// A verdict needs two facts a slice and no count, so the kernel keeps two
// marks a slice in a scratch buffer that the entry point zeroes first
// (marks[2 s] "a candidate chip of s", marks[2 s + 1] "a busy chip of s"),
// and each chip sets one mark to 1: the writes are idempotent, so no atomic
// is needed and the result does not depend on their order. Counting put
// every chip of a slice on one word: at 260,000 chips in host order, the
// 50,944 chips of one Multislice group were 2 x 50,944 atomics on one
// address, serialised in L2. Here a lane skips a mark that the lane before
// it holds (a host's chips are adjacent, a sorted fleet's slices lie along
// warps), and a warp's stores to one address merge into one, so that group
// costs about one store a warp. Reading a mark before writing it, and one
// leader a distinct mark by __match_any_sync, both measured slower on the
// H100 at that layout: the read is a second dependent round trip, and the
// match costs more than the stores it saves (PERF.md §6). A second kernel
// then writes verdict s = (marks[2 s], marks[2 s + 1]) == (1, 0). That is
// three device operations a call (the memset, the marks, the verdicts),
// each bound by its launch and a memory round trip, not by bandwidth: the
// inputs are 5 C bytes (1.3 MB at 260,000 chips).

constexpr int kScatterThreads = 256;

template <typename I>
__global__ void __launch_bounds__(kScatterThreads)
slice_marks_kernel(const uint8_t* __restrict__ cand, const I* __restrict__ ids,
                   uint8_t* __restrict__ marks, int64_t num_chips, int64_t num_slices) {
    const int64_t c = int64_t(blockIdx.x) * kScatterThreads + threadIdx.x;
    long long m = -1;  // this chip's mark, -1 for none
    if (c < num_chips) {
        const int64_t s = int64_t(ids[c]);
        if (s >= 0 && s < num_slices) m = 2 * s + (cand[c] ? 0 : 1);
    }
    const long long before = __shfl_up_sync(kFullMask, m, 1);
    if (m >= 0 && ((threadIdx.x & 31) == 0 || before != m)) marks[m] = 1;
}

__global__ void __launch_bounds__(kScatterThreads)
slice_verdict_kernel(const uint16_t* __restrict__ marks, uint8_t* __restrict__ out,
                     int64_t num_slices) {
    const int64_t s = int64_t(blockIdx.x) * kScatterThreads + threadIdx.x;
    if (s < num_slices) out[s] = marks[s] == 1u;  // little-endian: the candidate mark alone
}

int64_t scatter_blocks(int64_t n) { return (n + kScatterThreads - 1) / kScatterThreads; }

template <typename I>
void launch_marks(const uint8_t* cand, const void* ids, uint8_t* marks, int64_t num_chips,
                  int64_t num_slices, cudaStream_t stream) {
    slice_marks_kernel<I><<<unsigned(scatter_blocks(num_chips)), kScatterThreads, 0, stream>>>(
        cand, static_cast<const I*>(ids), marks, num_chips, num_slices);
}

// --- the streaming window's key join and row gather ----------------------------
//
// When the fleet changes between daemon cycles, the window's two int8 rings
// [rows, K] are re-keyed (engine.rekey_window): each of this cycle's C chips
// takes the row its int64 key had, or a new row of INVALID_Q (-1) where the
// key is new; the rows of absent chips seen fewer than K cycles ago follow,
// in row order; the rest go. The reference keeps a window per fleet and
// starts over when the fleet changes, so no Pallas kernel does this. The
// result is bit for bit engine.rekey_plain's.
//
// The join (tp_window_join) is a hash join on the card: the chips' keys go
// up from pinned host memory in one copy, then one memset and three
// kernels:
//   - the build inserts each row r into an open-addressing table of int32
//     slots (0 empty, else r + 1), a power of two of at least 2 (R + C),
//     with atomicCAS; keys are compared through the rows' key arrays, so
//     every int64 is a key and none is a sentinel. A row that meets its own
//     key marks the rows' keys repeated;
//   - the probe looks each chip's key up: a chip that finds its row takes it
//     (atomicCAS on the row's owner, 0 free, else chip + 1) and writes the
//     row into the gather's index; a chip that finds the row taken marks
//     the chips' keys repeated. A chip whose key is not there inserts
//     itself (R + chip + 1) where the probe met the empty slot, so a second
//     chip of the same key meets it: a new key repeated is seen too;
//   - the compaction keeps, in row order, each row that no chip took and
//     whose last-seen cycle is fewer than K cycles back: an ordered stream
//     compaction in one pass, tiles of kJoinThreads x kJoinItems rows taken
//     in launch order from a ticket, each tile's offset found by a
//     decoupled look-back over the tiles before it. A kept row's place goes
//     into the index after the C chips', and its key and cycle into the
//     next call's rows on the card and into pinned host memory, which the
//     kernel writes through its device mapping. The last tile to finish
//     writes the counts (new, retained, dropped, moved) and the flags there,
//     so the host waits once and copies nothing back.
// A zeroed scratch buffer (head words, tile states, the table, the owners)
// is one memset: every mark above starts at 0. At 263,000 rows and 260,000
// chips the kernels read about 5 MB and write the index and kept rows.
//
// The gather (tp_window_gather) then moves both rings by that index: rows
// out take the old row index[row], or are all INVALID_Q where it is -1. It
// is a copy bound by bandwidth: the carried rows of both rings read once,
// both rings written once (about 12.6 MB at 263,000 rows of K = 12). One
// launch moves both rings: a thread a word of a row, 4-byte words where K
// and the rings allow, else bytes, so neighbouring threads write
// neighbouring words and the gather of a row's words reads one line.

constexpr int kJoinThreads = 256;
constexpr int kJoinItems = 8;  // rows a thread of the compaction, in rounds of kJoinThreads
constexpr int kJoinWarps = kJoinThreads / 32;
constexpr int64_t kJoinTile = int64_t(kJoinThreads) * kJoinItems;
constexpr int kGatherThreads = 256;

// The head words of the join's scratch buffer, unsigned long long each.
enum JoinHead { kTicket, kDone, kUntaken, kKept, kMoved, kChipsRepeat, kRowsRepeat, kHeadWords };
// A tile's state in the look-back: flag << 32 | rows kept (flag 1: the
// tile's own count, 2: the count of every row up to the tile's end).
constexpr unsigned long long kTileOwn = 1ull << 32, kTileAll = 2ull << 32;
// The host's words before the kept rows: flags, new, retained, dropped,
// moved, and three unused.
constexpr int64_t kJoinCounts = 8;

struct JoinRows {  // the window's rows: the last cycle's P chips, then Q kept rows
    const int64_t* keys;
    int64_t present;
    int64_t cycle;  // the cycle the first `present` rows were seen in
    const int64_t* kept_keys;
    const int64_t* kept_seen;
    int64_t total;

    __device__ int64_t key(int64_t r) const {
        return r < present ? __ldg(keys + r) : __ldg(kept_keys + (r - present));
    }
    __device__ int64_t seen(int64_t r) const {
        return r < present ? cycle : __ldg(kept_seen + (r - present));
    }
};

struct JoinScratch {
    unsigned long long* head;
    unsigned long long* tiles;
    int32_t* table;
    int32_t* owner;
    uint64_t mask;  // table slots - 1
    int shift;      // 64 - log2(table slots)
};

int64_t join_table_slots(int64_t rows, int64_t chips) {
    int64_t slots = 16;
    while (slots < 2 * (rows + chips)) slots *= 2;
    return slots;
}

int64_t join_tiles(int64_t rows) { return rows > 0 ? (rows + kJoinTile - 1) / kJoinTile : 1; }

int64_t join_scratch_bytes(int64_t rows, int64_t chips) {
    return int64_t(sizeof(unsigned long long)) * (kHeadWords + join_tiles(rows)) +
           int64_t(sizeof(int32_t)) * (join_table_slots(rows, chips) + rows);
}

__device__ __forceinline__ uint64_t join_slot(int64_t key, int shift) {
    return (uint64_t(key) * 0x9E3779B97F4A7C15ull) >> shift;
}

__global__ void __launch_bounds__(kJoinThreads)
join_build_kernel(JoinRows rows, JoinScratch s) {
    const int64_t r = int64_t(blockIdx.x) * kJoinThreads + threadIdx.x;
    if (r >= rows.total) return;
    const int64_t key = rows.key(r);
    for (uint64_t at = join_slot(key, s.shift);; at = (at + 1) & s.mask) {
        const int32_t held = atomicCAS(s.table + at, 0, int32_t(r + 1));
        if (held == 0) return;
        if (rows.key(held - 1) == key) {  // only rows are in the table yet
            s.head[kRowsRepeat] = 1;
            return;
        }
    }
}

__global__ void __launch_bounds__(kJoinThreads)
join_probe_kernel(JoinRows rows, const int64_t* __restrict__ keys, int64_t chips,
                  JoinScratch s, int32_t* __restrict__ index) {
    const int64_t c = int64_t(blockIdx.x) * kJoinThreads + threadIdx.x;
    if (c >= chips) return;
    const int64_t key = __ldg(keys + c);
    int32_t src = -1;
    for (uint64_t at = join_slot(key, s.shift);; at = (at + 1) & s.mask) {
        int32_t held = *reinterpret_cast<volatile int32_t*>(s.table + at);
        if (held == 0) held = atomicCAS(s.table + at, 0, int32_t(rows.total + c + 1));
        if (held == 0) break;  // a new key, now in the table
        const int64_t e = held - 1;
        if ((e < rows.total ? rows.key(e) : __ldg(keys + (e - rows.total))) != key) continue;
        if (e < rows.total && atomicCAS(s.owner + e, 0, int32_t(c + 1)) == 0)
            src = int32_t(e);
        else  // the row another chip of this key took, or that chip itself
            s.head[kChipsRepeat] = 1;
        break;
    }
    index[c] = src;
}

__device__ __forceinline__ long long join_block_sum(long long v, long long* shared) {
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(kFullMask, v, off);
    if ((threadIdx.x & 31) == 0) shared[threadIdx.x / 32] = v;
    __syncthreads();
    long long sum = 0;
    for (int w = 0; w < kJoinWarps; ++w) sum += shared[w];
    __syncthreads();
    return sum;
}

struct JoinOut {
    int32_t* index;           // [C + R]: the kept rows' entries from C on
    int64_t* kept_keys;       // [R] on the card: the next call's rows
    int64_t* kept_seen;       // [R]
    int64_t* host;            // pinned: kJoinCounts words, then R keys, then R cycles
};

__global__ void __launch_bounds__(kJoinThreads)
join_compact_kernel(JoinRows rows, int64_t chips, int64_t cycle, int64_t chunks, JoinScratch s,
                    JoinOut out, int64_t tiles) {
    __shared__ unsigned long long tile_at;
    __shared__ unsigned before[kJoinItems * kJoinWarps];  // then the exclusive prefix
    __shared__ long long sums[kJoinWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
    if (threadIdx.x == 0) tile_at = atomicAdd(s.head + kTicket, 1ull);
    __syncthreads();
    const int64_t tile = int64_t(tile_at), base = tile * kJoinTile;
    unsigned keep = 0;
    long long untaken = 0, moved = 0;
    for (int i = 0; i < kJoinItems; ++i) {
        const int64_t r = base + int64_t(i) * kJoinThreads + threadIdx.x;
        if (r < rows.total) {
            const int32_t owner = s.owner[r];
            if (owner == 0) {
                untaken += 1;
                if (int64_t(uint64_t(cycle) - uint64_t(rows.seen(r))) < chunks) keep |= 1u << i;
            } else {
                moved += owner - 1 != r;
            }
        }
        const unsigned ballot = __ballot_sync(kFullMask, (keep >> i) & 1u);
        if (lane == 0) before[i * kJoinWarps + warp] = __popc(ballot);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned running = 0;
        for (int e = 0; e < kJoinItems * kJoinWarps; ++e) {
            const unsigned n = before[e];
            before[e] = running;
            running += n;
        }
        // the look-back: the tiles before this one started before it
        unsigned long long prefix = 0;
        if (tile == 0) {
            atomicExch(s.tiles, kTileAll | running);
        } else {
            atomicExch(s.tiles + tile, kTileOwn | running);
            for (int64_t t = tile - 1;; ) {
                const unsigned long long state =
                    *reinterpret_cast<volatile unsigned long long*>(s.tiles + t);
                if ((state >> 32) == 0) continue;  // not yet counted
                prefix += state & 0xffffffffull;
                if ((state & kTileAll) == kTileAll) break;
                --t;
            }
            atomicExch(s.tiles + tile, kTileAll | (prefix + running));
        }
        tile_at = prefix;
        atomicAdd(s.head + kKept, (unsigned long long)running);
    }
    __syncthreads();
    const int64_t prefix = int64_t(tile_at);
    const unsigned below = (1u << lane) - 1u;
    for (int i = 0; i < kJoinItems; ++i) {
        const unsigned ballot = __ballot_sync(kFullMask, (keep >> i) & 1u);
        if (!((keep >> i) & 1u)) continue;
        const int64_t r = base + int64_t(i) * kJoinThreads + threadIdx.x;
        const int64_t at = prefix + before[i * kJoinWarps + warp] + __popc(ballot & below);
        const int64_t key = rows.key(r), seen = rows.seen(r);
        out.index[chips + at] = int32_t(r);
        out.kept_keys[at] = key;
        out.kept_seen[at] = seen;
        out.host[kJoinCounts + at] = key;
        out.host[kJoinCounts + rows.total + at] = seen;
        moved += chips + at != r;
    }
    untaken = join_block_sum(untaken, sums);
    moved = join_block_sum(moved, sums);
    if (threadIdx.x == 0) {
        atomicAdd(s.head + kUntaken, (unsigned long long)untaken);
        atomicAdd(s.head + kMoved, (unsigned long long)moved);
        __threadfence();
        if (atomicAdd(s.head + kDone, 1ull) == (unsigned long long)(tiles - 1)) {
            // the last tile: every count is in
            const int64_t left = int64_t(atomicAdd(s.head + kUntaken, 0ull));
            const int64_t kept = int64_t(atomicAdd(s.head + kKept, 0ull));
            out.host[0] = int64_t(s.head[kChipsRepeat] != 0) | int64_t(s.head[kRowsRepeat] != 0) << 1;
            out.host[1] = chips - (rows.total - left);  // new: the chips that took no row
            out.host[2] = kept;
            out.host[3] = left - kept;  // dropped
            out.host[4] = int64_t(atomicAdd(s.head + kMoved, 0ull));
            __threadfence_system();
        }
    }
}

template <typename W>
__global__ void __launch_bounds__(kGatherThreads)
window_gather_kernel(const W* __restrict__ tc_in, const W* __restrict__ hbm_in,
                     const int32_t* __restrict__ index, W* __restrict__ tc_out,
                     W* __restrict__ hbm_out, int64_t words, int64_t row_words) {
    const int64_t t = int64_t(blockIdx.x) * kGatherThreads + threadIdx.x;
    if (t >= words) return;
    const int64_t row = t / row_words;
    const int32_t src = __ldg(index + row);
    if (src < 0) {
        tc_out[t] = W(~W(0));  // every byte INVALID_Q
        hbm_out[t] = W(~W(0));
    } else {
        const int64_t from = int64_t(src) * row_words + (t - row * row_words);
        tc_out[t] = __ldg(tc_in + from);
        hbm_out[t] = __ldg(hbm_in + from);
    }
}

template <typename W>
void launch_window_gather(const void* tc_in, const void* hbm_in, const int32_t* index,
                          void* tc_out, void* hbm_out, int64_t rows, int64_t row_words,
                          cudaStream_t stream) {
    const int64_t words = rows * row_words;
    window_gather_kernel<W><<<unsigned((words + kGatherThreads - 1) / kGatherThreads),
                              kGatherThreads, 0, stream>>>(
        static_cast<const W*>(tc_in), static_cast<const W*>(hbm_in), index,
        static_cast<W*>(tc_out), static_cast<W*>(hbm_out), words, row_words);
}


// ── the policy sweep: a grid of up to 64 policies in one pass ──────────────
//
// tp_sweep_pass and tp_sweep_scatter have no Pallas counterpart: the
// reference judges one policy a call, so a grid of policies (an operator's
// what-if over the daemon's -t window and --hbm-threshold) took a call a
// policy, each a pass over a suffix of the window. A grid pairs D windows
// (the newest n_d samples of a row; age gate lookback_d) with H HBM cutoffs;
// policy p = d H + h is bit p of a 64-bit mask. engine.evaluate_fleet_sweep
// calls both, kernels.sweep_pass_plain and sweep_scatter_plain are their
// plain versions, with the f32 pass's numerics (verdict_f32's, per policy).
//
// The pass reads each sample of the longest window once and writes 8 bytes
// a chip: at 260,000 chips x 1,440 samples, 3.37 GB, 1.0 ms at 3.35 TB/s.
// It is the long-row design walked from the newest sample back: a warp a
// row, lane l holding the samples at distances l, l + 32, ... from the
// newest, K = kSweepK of them a chunk, every load of a chunk issued before
// its fold. The lanes keep running peaks (RowPeaks), so at any step of the
// walk the warp's peaks are those of a suffix. A window's end falls inside
// one step of 32 samples (and a lane's chunk of K steps): when the walk
// reaches that step, each lane takes its running peaks plus its sample of
// the step if that lies inside the window, and the warp reduces them once
// into the window's slot in shared memory. So D windows cost D reductions
// a row, not D walks. Then each lane judges policies lane and lane + 32
// from the slots, and two ballots give the row's mask.
//
// The grid travels by value in the kernel's parameters (__grid_constant__,
// read where it lies): no copy to the card, and a call with another grid
// needs neither a rebuild nor a wait. Each block copies the per-policy
// tables it reads lane by lane into shared memory first.
//
// The slice reduction needs a bit a policy for each slice: AND over its
// chips. tp_sweep_scatter is one memset and three kernels:
//   - the marks: a thread a chip; lanes of one slice AND their masks along
//     the warp (a host's chips are adjacent) and the first lane of each run
//     stores "has a chip" and ORs the bits its run lacks into the slice's
//     word, an atomic only where a bit is lacking; at the groups cell's
//     layout that is one atomic a run of a host's chips, not a chip;
//   - the slices: a thread a slice writes its mask (has a chip and lacks no
//     bit) and counts the slices of each bit by ballots, in shared memory,
//     then one global add a policy a block;
//   - the chips: a thread a chip reads its slice's mask and counts the chips
//     of each bit alike.
// It moves about 8 C + 4 C (ids) + 33 S bytes: launches and round trips
// bound it, not bandwidth.

constexpr int kSweepMaxPolicies = 64;
constexpr int kSweepK = 12;  // samples a lane a chunk (kernels._SWEEP_K)
constexpr int kSweepScatterThreads = 256;

struct SweepGrid {
    int durations, thresholds, policies;
    int n_max;                              // the longest window's samples
    int bound[kSweepMaxPolicies];           // the windows' samples, ascending
    int slot[kSweepMaxPolicies];            // the window (d) of each bound
    float lookback[kSweepMaxPolicies];      // by window, flushed
    float cutoff[kSweepMaxPolicies];        // by threshold, flushed
};

// One window's peaks: the warp's reduction of each lane's, into its slot.
__device__ __forceinline__ void sweep_record(RowPeaks q, float* tc_slot, float* hbm_slot,
                                             uint8_t* has_slot, int lane) {
    q.tc.warp_reduce();
    q.hbm.warp_reduce();
    const bool has = __any_sync(kFullMask, q.has_data);
    if (lane == 0) *tc_slot = q.tc.value(), *hbm_slot = q.hbm.value(), *has_slot = has;
}

__global__ void __launch_bounds__(kThreads)
sweep_pass_kernel(const float* __restrict__ tc, const float* __restrict__ hbm,
                  const uint8_t* __restrict__ valid, const float* __restrict__ age,
                  unsigned long long* __restrict__ out, int64_t num_chips, int num_samples,
                  const __grid_constant__ SweepGrid g) {
    __shared__ float s_tc[kWarpsPerBlock][kSweepMaxPolicies];
    __shared__ float s_hbm[kWarpsPerBlock][kSweepMaxPolicies];
    __shared__ uint8_t s_has[kWarpsPerBlock][kSweepMaxPolicies];
    __shared__ uint8_t s_window[kSweepMaxPolicies];  // by policy
    __shared__ float s_cutoff[kSweepMaxPolicies], s_lookback[kSweepMaxPolicies];
    if (int(threadIdx.x) < g.policies) {
        const int p = threadIdx.x, d = p / g.thresholds;
        s_window[p] = uint8_t(d);
        s_cutoff[p] = g.cutoff[p - d * g.thresholds];
        s_lookback[p] = g.lookback[d];
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t row = int64_t(blockIdx.x) * kWarpsPerBlock + warp;
    if (row >= num_chips) return;  // whole warp leaves together, after the barrier
    // the sample at distance k from the row's newest is [-k]
    const int64_t newest = row * num_samples + num_samples - 1;
    const float* tc_row = tc + newest;
    const float* hbm_row = hbm + newest;
    const uint8_t* valid_row = valid + newest;
    const float row_age = flush_subnormal(__ldg(age + row));  // one address for the warp

    RowPeaks p;  // this lane's samples so far, newest first
    int next = 0;                  // the next window end to record, in g.bound
    int at = g.bound[0] >> 5;      // the step (32 samples) it falls in
    float x_tc[kSweepK], x_hbm[kSweepK];
    uint8_t x_v[kSweepK];
    for (int k0 = 0; k0 < g.n_max; k0 += 32 * kSweepK) {
#pragma unroll
        for (int j = 0; j < kSweepK; ++j) {
            const int k = k0 + 32 * j + lane;
            const bool in = k < g.n_max;
            x_v[j] = in ? __ldg(valid_row - k) : 0;
            x_tc[j] = in ? __ldg(tc_row - k) : 0.0f;
            x_hbm[j] = in ? __ldg(hbm_row - k) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kSweepK; ++j) {
            const int step = (k0 >> 5) + j;
            while (step == at) {  // warp-uniform: every window that ends in this step
                RowPeaks q = p;
                if (lane < (g.bound[next] & 31)) q.add(x_tc[j], x_hbm[j], x_v[j] != 0);
                const int d = g.slot[next];
                sweep_record(q, &s_tc[warp][d], &s_hbm[warp][d], &s_has[warp][d], lane);
                at = ++next < g.durations ? g.bound[next] >> 5 : 0x7fffffff;
            }
            p.add(x_tc[j], x_hbm[j], x_v[j] != 0);  // past n_max: invalid, reads as -1
        }
    }
    for (; next < g.durations; ++next) {  // windows that end on the walk's last step
        const int d = g.slot[next];
        sweep_record(p, &s_tc[warp][d], &s_hbm[warp][d], &s_has[warp][d], lane);
    }
    __syncwarp();
    unsigned half[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int pol = lane + 32 * h;
        bool bit = false;
        if (pol < g.policies) {
            const int d = s_window[pol];
            const bool idle = s_tc[warp][d] <= 0.0f && s_has[warp][d];
            const bool hbm_active = s_hbm[warp][d] >= s_cutoff[pol];
            bit = idle && !hbm_active && row_age >= s_lookback[pol];
        }
        half[h] = __ballot_sync(kFullMask, bit);
    }
    if (lane == 0) out[row] = (static_cast<unsigned long long>(half[1]) << 32) | half[0];
}

// Add the ballot counts of each of m's bits (policies) over the warp into
// the block's counts: lane l adds those of bits l and l + 32.
__device__ __forceinline__ void sweep_count_bits(unsigned long long m, int policies,
                                                 unsigned long long* s_count, int lane) {
    unsigned long long n[2] = {0, 0};
#pragma unroll
    for (int b = 0; b < kSweepMaxPolicies; ++b) {
        if (b >= policies) break;  // block-uniform
        const unsigned c = __popc(__ballot_sync(kFullMask, (m >> b) & 1));
        if (lane == (b & 31)) n[b >> 5] += c;
    }
    if (n[0]) atomicAdd(s_count + lane, n[0]);
    if (n[1]) atomicAdd(s_count + lane + 32, n[1]);
}

template <typename I>
__global__ void __launch_bounds__(kSweepScatterThreads)
sweep_marks_kernel(const unsigned long long* __restrict__ masks, const I* __restrict__ ids,
                   unsigned long long* __restrict__ lacking, uint8_t* __restrict__ has,
                   int64_t num_chips, int64_t num_slices, unsigned long long policy_bits) {
    const int64_t c = int64_t(blockIdx.x) * kSweepScatterThreads + threadIdx.x;
    const int lane = threadIdx.x & 31;
    long long s = -1;  // this chip's slice, -1 for none
    unsigned long long acc = ~0ull;
    if (c < num_chips) {
        const int64_t id = int64_t(ids[c]);
        if (id >= 0 && id < num_slices) s = id, acc = masks[c];
    }
    // AND of the lanes from this one on that hold its slice: a run's first
    // lane ends with its whole run (lanes of another run of the same slice
    // may join in, which changes nothing)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long other = __shfl_down_sync(kFullMask, acc, off);
        const long long other_s = __shfl_down_sync(kFullMask, s, off);
        if (lane + off < 32 && other_s == s) acc &= other;
    }
    const long long before = __shfl_up_sync(kFullMask, s, 1);
    if (s >= 0 && (lane == 0 || before != s)) {
        has[s] = 1;
        const unsigned long long lack = ~acc & policy_bits;
        if (lack) atomicOr(lacking + s, lack);
    }
}

__global__ void __launch_bounds__(kSweepScatterThreads)
sweep_slices_kernel(const unsigned long long* __restrict__ lacking,
                    const uint8_t* __restrict__ has, unsigned long long* __restrict__ slice_masks,
                    unsigned long long* __restrict__ counts, int64_t num_slices, int policies,
                    unsigned long long policy_bits) {
    __shared__ unsigned long long s_count[kSweepMaxPolicies];
    if (threadIdx.x < kSweepMaxPolicies) s_count[threadIdx.x] = 0;
    __syncthreads();
    const int64_t s = int64_t(blockIdx.x) * kSweepScatterThreads + threadIdx.x;
    unsigned long long m = 0;
    if (s < num_slices) {
        m = has[s] ? ~lacking[s] & policy_bits : 0;
        slice_masks[s] = m;
    }
    sweep_count_bits(m, policies, s_count, threadIdx.x & 31);
    __syncthreads();
    if (int(threadIdx.x) < policies && s_count[threadIdx.x])
        atomicAdd(counts + 2 * threadIdx.x, s_count[threadIdx.x]);
}

template <typename I>
__global__ void __launch_bounds__(kSweepScatterThreads)
sweep_chips_kernel(const I* __restrict__ ids, const unsigned long long* __restrict__ slice_masks,
                   unsigned long long* __restrict__ counts, int64_t num_chips,
                   int64_t num_slices, int policies) {
    __shared__ unsigned long long s_count[kSweepMaxPolicies];
    if (threadIdx.x < kSweepMaxPolicies) s_count[threadIdx.x] = 0;
    __syncthreads();
    const int64_t c = int64_t(blockIdx.x) * kSweepScatterThreads + threadIdx.x;
    unsigned long long m = 0;
    if (c < num_chips) {
        const int64_t id = int64_t(ids[c]);
        if (id >= 0 && id < num_slices) m = slice_masks[id];
    }
    sweep_count_bits(m, policies, s_count, threadIdx.x & 31);
    __syncthreads();
    if (int(threadIdx.x) < policies && s_count[threadIdx.x])
        atomicAdd(counts + 2 * threadIdx.x + 1, s_count[threadIdx.x]);
}

int64_t sweep_blocks(int64_t n) { return (n + kSweepScatterThreads - 1) / kSweepScatterThreads; }

template <typename I>
void launch_sweep_scatter(const unsigned long long* masks, const void* ids,
                          unsigned long long* slice_masks, unsigned long long* counts,
                          unsigned long long* lacking, uint8_t* has, int64_t num_chips,
                          int64_t num_slices, int policies, cudaStream_t stream) {
    const auto id = static_cast<const I*>(ids);
    const unsigned long long bits = policies == 64 ? ~0ull : (1ull << policies) - 1;
    sweep_marks_kernel<I><<<unsigned(sweep_blocks(num_chips)), kSweepScatterThreads, 0, stream>>>(
        masks, id, lacking, has, num_chips, num_slices, bits);
    sweep_slices_kernel<<<unsigned(sweep_blocks(num_slices)), kSweepScatterThreads, 0, stream>>>(
        lacking, has, slice_masks, counts, num_slices, policies, bits);
    sweep_chips_kernel<I><<<unsigned(sweep_blocks(num_chips)), kSweepScatterThreads, 0, stream>>>(
        id, slice_masks, counts, num_chips, num_slices, policies);
}

}  // namespace

extern "C" {

int tp_chip_pass_q(const void* tc_q, const void* hbm_q, const void* age,
                   const void* params_q, void* out, int64_t num_chips,
                   int64_t num_samples, int64_t rows_per_tile, int64_t part_bytes,
                   int parts, int stages, int lanes_per_row, int64_t smem_bytes,
                   int64_t grid, void* stream) {
    const QPlan q{num_chips, num_samples, rows_per_tile, part_bytes, parts, stages,
                  lanes_per_row};
    if (!plan_ok(q, smem_bytes, grid)) return int(cudaErrorInvalidValue);
    chip_pass_q_kernel<<<unsigned(grid), kQThreads, size_t(smem_bytes),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(tc_q), static_cast<const int8_t*>(hbm_q),
        static_cast<const float*>(age), static_cast<const float*>(params_q),
        static_cast<uint8_t*>(out), q);
    return int(cudaGetLastError());
}

// The row design of tp_chip_pass_q; rows (per thread) and grid are
// kernels.PlanRows in order.
int tp_chip_pass_q_rows(const void* tc_q, const void* hbm_q, const void* age,
                        const void* params_q, void* out, int64_t num_chips,
                        int64_t num_samples, int64_t rows, int64_t grid, void* stream) {
    const RowsArgs a{static_cast<const int8_t*>(tc_q), static_cast<const int8_t*>(hbm_q),
                     static_cast<const float*>(age), static_cast<const float*>(params_q),
                     static_cast<uint8_t*>(out), num_chips};
    if (!rows_plan_ok(a, num_samples, rows, grid))
        return int(cudaErrorInvalidValue);
    launch_rows(int(num_samples), RowsT{}, a, unsigned(grid), static_cast<cudaStream_t>(stream));
    return int(cudaGetLastError());
}

// The group design of the f32 pass; lanes (a row), samples (a lane) and
// grid are kernels.PlanGroups in order.
int tp_chip_pass_groups(const void* tc, const void* hbm, const void* valid, const void* age,
                        const void* params, void* out, int64_t num_chips, int64_t num_samples,
                        int64_t lanes, int64_t samples, int64_t grid, void* stream) {
    const F32Args a{static_cast<const float*>(tc), static_cast<const float*>(hbm),
                    static_cast<const uint8_t*>(valid), static_cast<const float*>(age),
                    static_cast<const float*>(params), static_cast<uint8_t*>(out), num_chips};
    if (!groups_plan_ok(a, num_samples, lanes, samples, grid))
        return int(cudaErrorInvalidValue);
    int log2_lanes = 0;
    while ((int64_t(1) << log2_lanes) < lanes) ++log2_lanes;
    launch_groups(int(samples), GroupsK{}, a, int(num_samples), log2_lanes, unsigned(grid),
                  static_cast<cudaStream_t>(stream));
    return int(cudaGetLastError());
}

// The long-row design of the f32 pass; samples (a lane a chunk) and grid
// are kernels.PlanLong in order.
int tp_chip_pass_long(const void* tc, const void* hbm, const void* valid, const void* age,
                      const void* params, void* out, int64_t num_chips, int64_t num_samples,
                      int64_t samples, int64_t grid, void* stream) {
    const F32Args a{static_cast<const float*>(tc), static_cast<const float*>(hbm),
                    static_cast<const uint8_t*>(valid), static_cast<const float*>(age),
                    static_cast<const float*>(params), static_cast<uint8_t*>(out), num_chips};
    if (!long_plan_ok(a, num_samples, samples, grid)) return int(cudaErrorInvalidValue);
    launch_long(int(samples), LongK{}, a, int(num_samples), unsigned(grid),
                static_cast<cudaStream_t>(stream));
    return int(cudaGetLastError());
}

// The slice gate; bound_bytes is 4 (int32 bounds) or 8 (int64), wrap_bits
// and wrap_signed the width and signedness the bounds' difference is taken
// in (32 and 1 for int32 and int64). The grid follows from num_chips and
// num_slices (gate_grid).
int tp_slice_gate(const void* candidate, const void* bounds, void* out, int64_t num_chips,
                  int64_t num_slices, int bound_bytes, int wrap_bits, int wrap_signed,
                  void* stream) {
    if (num_chips < 0 || num_slices < 1 || (bound_bytes != 4 && bound_bytes != 8) ||
        (wrap_bits != 8 && wrap_bits != 16 && wrap_bits != 32) ||
        gate_grid(num_chips, num_slices).blocks > 0x7fffffff)
        return int(cudaErrorInvalidValue);
    const auto c = static_cast<const uint8_t*>(candidate);
    const auto o = static_cast<uint8_t*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    if (bound_bytes == 4)
        launch_gate<int32_t>(c, bounds, o, num_chips, num_slices, wrap_bits, wrap_signed, s);
    else
        launch_gate<int64_t>(c, bounds, o, num_chips, num_slices, wrap_bits, wrap_signed, s);
    return int(cudaGetLastError());
}

// The scatter slice reduction; id_bytes is 4 (int32 ids) or 8 (int64), marks
// a scratch buffer of 2 num_slices bytes, which this zeroes first. Takes
// C >= 1 and S >= 1 (the wrapper launches nothing otherwise).
int tp_slice_scatter(const void* candidate, const void* ids, void* marks, void* out,
                     int64_t num_chips, int64_t num_slices, int id_bytes, void* stream) {
    if (num_chips < 1 || num_slices < 1 || (id_bytes != 4 && id_bytes != 8) ||
        scatter_blocks(num_chips) > 0x7fffffff || scatter_blocks(num_slices) > 0x7fffffff)
        return int(cudaErrorInvalidValue);
    const auto c = static_cast<const uint8_t*>(candidate);
    const auto m = static_cast<uint8_t*>(marks);
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t zeroed = cudaMemsetAsync(m, 0, size_t(2 * num_slices), s);
    if (zeroed != cudaSuccess) return int(zeroed);
    if (id_bytes == 4)
        launch_marks<int32_t>(c, ids, m, num_chips, num_slices, s);
    else
        launch_marks<int64_t>(c, ids, m, num_chips, num_slices, s);
    slice_verdict_kernel<<<unsigned(scatter_blocks(num_slices)), kScatterThreads, 0, s>>>(
        reinterpret_cast<const uint16_t*>(m), static_cast<uint8_t*>(out), num_slices);
    return int(cudaGetLastError());
}

// The join's scratch buffer, in bytes, for R rows and C chips.
int64_t tp_window_join_scratch(int64_t rows, int64_t chips) {
    return join_scratch_bytes(rows, chips);
}

// The window's key join: the rows are row_keys [P] (the last cycle's chips,
// seen in prev_cycle), then kept_keys [Q] each last seen in kept_seen, on
// the card; this cycle's chips are host_keys [C] in pinned host memory, in
// cycle, which this copies to keys [C] on the card first; K chunks. scratch
// holds tp_window_join_scratch(P + Q, C) bytes on the card, which this
// zeroes. Writes index [C + P + Q] (int32: each chip's old row or -1, then
// the kept rows' old rows), out_kept [2, P + Q] (int64 on the card: the kept
// rows' keys, then from P + Q on their cycles) and host, pinned host memory
// of at least 8 + 2 (P + Q) int64: {flags (1 the chips' keys repeat, 2 the
// rows'), new, retained, dropped, moved}, then from 8 on the kept rows'
// keys and from 8 + P + Q on their cycles. A copy, a memset and up to three
// kernels, no wait: host is written once the stream reaches the call's end.
int tp_window_join(const void* row_keys, int64_t P, int64_t prev_cycle, const void* kept_keys,
                   const void* kept_seen, int64_t Q, const void* host_keys, void* keys, int64_t C,
                   int64_t cycle, int64_t K, void* scratch, int64_t scratch_bytes, void* index,
                   void* out_kept, void* host, void* stream) {
    const int64_t R = P + Q;
    if (P < 0 || Q < 0 || C < 0 || R + C + 1 > 0x7fffffff ||
        scratch_bytes < join_scratch_bytes(R, C))
        return int(cudaErrorInvalidValue);
    cudaPointerAttributes host_at;
    cudaError_t status = cudaPointerGetAttributes(&host_at, host);
    if (status != cudaSuccess) return int(status);
    if (host_at.type != cudaMemoryTypeHost || host_at.devicePointer == nullptr)
        return int(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    if (C > 0) {
        status = cudaMemcpyAsync(keys, host_keys, size_t(C) * sizeof(int64_t),
                                 cudaMemcpyHostToDevice, s);
        if (status != cudaSuccess) return int(status);
    }
    status = cudaMemsetAsync(scratch, 0, size_t(join_scratch_bytes(R, C)), s);
    if (status != cudaSuccess) return int(status);
    const int64_t slots = join_table_slots(R, C), tiles = join_tiles(R);
    int shift = 64;
    for (int64_t n = slots; n > 1; n /= 2) --shift;
    const auto head = static_cast<unsigned long long*>(scratch);
    const auto table = reinterpret_cast<int32_t*>(head + kHeadWords + tiles);
    const JoinScratch js{head, head + kHeadWords, table, table + slots, uint64_t(slots - 1),
                         shift};
    const JoinRows rows{static_cast<const int64_t*>(row_keys), P, prev_cycle,
                        static_cast<const int64_t*>(kept_keys),
                        static_cast<const int64_t*>(kept_seen), R};
    const auto kept = static_cast<int64_t*>(out_kept);
    const JoinOut out{static_cast<int32_t*>(index), kept, kept + R,
                      static_cast<int64_t*>(host_at.devicePointer)};
    if (R > 0)
        join_build_kernel<<<unsigned((R + kJoinThreads - 1) / kJoinThreads), kJoinThreads, 0, s>>>(
            rows, js);
    if (C > 0)
        join_probe_kernel<<<unsigned((C + kJoinThreads - 1) / kJoinThreads), kJoinThreads, 0, s>>>(
            rows, static_cast<const int64_t*>(keys), C, js, out.index);
    join_compact_kernel<<<unsigned(tiles), kJoinThreads, 0, s>>>(rows, C, cycle, K, js, out,
                                                                  tiles);
    return int(cudaGetLastError());
}

// The window's row gather: rows out rows of row_bytes (K) each, row r the
// old row index[r] (int32), or all INVALID_Q where that is -1. Takes
// rows >= 1 (the wrapper launches nothing otherwise); 4-byte words where
// row_bytes and every pointer allow.
int tp_window_gather(const void* tc_in, const void* hbm_in, const void* index, void* tc_out,
                     void* hbm_out, int64_t rows, int64_t row_bytes, void* stream) {
    if (rows < 1 || row_bytes < 1 ||
        (rows * row_bytes + kGatherThreads - 1) / kGatherThreads > 0x7fffffff)
        return int(cudaErrorInvalidValue);
    const auto idx = static_cast<const int32_t*>(index);
    const auto s = static_cast<cudaStream_t>(stream);
    const uintptr_t bases = reinterpret_cast<uintptr_t>(tc_in) | reinterpret_cast<uintptr_t>(hbm_in) |
                            reinterpret_cast<uintptr_t>(tc_out) | reinterpret_cast<uintptr_t>(hbm_out);
    if (row_bytes % 4 == 0 && bases % 4 == 0)
        launch_window_gather<uint32_t>(tc_in, hbm_in, idx, tc_out, hbm_out, rows, row_bytes / 4, s);
    else
        launch_window_gather<uint8_t>(tc_in, hbm_in, idx, tc_out, hbm_out, rows, row_bytes, s);
    return int(cudaGetLastError());
}

// The policy sweep's pass: masks [C] (a 64-bit word a chip) of the grid of
// windows samples [D] (int32 on the host: the newest samples of each, 1 to
// T), with lookbacks [D] and cutoffs [H] (f32 on the host, +inf where a
// threshold is disabled), D H from 1 to 64; samples (a lane a chunk) and
// grid are kernels.PlanSweep in order.
int tp_sweep_pass(const void* tc, const void* hbm, const void* valid, const void* age, void* out,
                  int64_t num_chips, int64_t num_samples, const void* samples, int64_t durations,
                  const void* lookbacks, const void* cutoffs, int64_t thresholds,
                  int64_t samples_per_lane, int64_t grid, void* stream) {
    if (num_chips < 1 || num_samples < 1 || num_samples > (int64_t(1) << 30) || durations < 1 ||
        thresholds < 1 || durations * thresholds > kSweepMaxPolicies ||
        samples_per_lane != kSweepK || grid > 0x7fffffff ||
        (grid - 1) * kWarpsPerBlock >= num_chips || num_chips > grid * kWarpsPerBlock)
        return int(cudaErrorInvalidValue);
    SweepGrid g{};
    g.durations = int(durations);
    g.thresholds = int(thresholds);
    g.policies = int(durations * thresholds);
    const auto n = static_cast<const int32_t*>(samples);
    const auto look = static_cast<const float*>(lookbacks);
    const auto cut = static_cast<const float*>(cutoffs);
    for (int d = 0; d < g.durations; ++d) {
        if (n[d] < 1 || n[d] > num_samples) return int(cudaErrorInvalidValue);
        g.n_max = n[d] > g.n_max ? n[d] : g.n_max;
        g.lookback[d] = fabsf(look[d]) < FLT_MIN ? 0.0f : look[d];
        int i = d;  // insertion sort of the window ends, ascending
        for (; i > 0 && g.bound[i - 1] > n[d]; --i) g.bound[i] = g.bound[i - 1], g.slot[i] = g.slot[i - 1];
        g.bound[i] = n[d];
        g.slot[i] = d;
    }
    for (int h = 0; h < g.thresholds; ++h) g.cutoff[h] = fabsf(cut[h]) < FLT_MIN ? 0.0f : cut[h];
    sweep_pass_kernel<<<unsigned(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tc), static_cast<const float*>(hbm),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(age),
        static_cast<unsigned long long*>(out), num_chips, int(num_samples), g);
    return int(cudaGetLastError());
}

// The sweep's slice reduction; id_bytes is 4 (int32 ids) or 8 (int64). buf
// holds 8 S + 16 P + 9 S bytes on the card: the slice masks [S], the counts
// [P, 2] (slices and chips a policy), then the scratch (a word of lacking
// bits and a byte "has a chip" a slice), counts and scratch zeroed here
// first. Takes C >= 1, S >= 1 and 1 <= P <= 64 (the wrapper launches
// nothing otherwise).
int tp_sweep_scatter(const void* masks, const void* ids, int id_bytes, void* buf,
                     int64_t num_chips, int64_t num_slices, int64_t policies, void* stream) {
    if (num_chips < 1 || num_slices < 1 || policies < 1 || policies > kSweepMaxPolicies ||
        (id_bytes != 4 && id_bytes != 8) || sweep_blocks(num_chips) > 0x7fffffff ||
        sweep_blocks(num_slices) > 0x7fffffff)
        return int(cudaErrorInvalidValue);
    const auto words = static_cast<unsigned long long*>(buf);
    unsigned long long* slice_masks = words;
    unsigned long long* counts = words + num_slices;
    unsigned long long* lacking = counts + 2 * policies;
    const auto has = reinterpret_cast<uint8_t*>(lacking + num_slices);
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t zeroed =
        cudaMemsetAsync(counts, 0, size_t(16 * policies + 9 * num_slices), s);
    if (zeroed != cudaSuccess) return int(zeroed);
    const auto m = static_cast<const unsigned long long*>(masks);
    if (id_bytes == 4)
        launch_sweep_scatter<int32_t>(m, ids, slice_masks, counts, lacking, has, num_chips,
                                      num_slices, int(policies), s);
    else
        launch_sweep_scatter<int64_t>(m, ids, slice_masks, counts, lacking, has, num_chips,
                                      num_slices, int(policies), s);
    return int(cudaGetLastError());
}

}  // extern "C"
