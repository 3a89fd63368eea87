// Per-chip idle-candidate pass over [chips, samples] fleet tensors, for Hopper
// (sm_90a). Two kernels, one per sample storage:
//
//   tp_chip_pass    replaces tpu_pruner/policy/pallas_engine.py::_chip_kernel
//                   (pallas_engine.py:33; f32 samples + bool validity mask);
//   tp_chip_pass_q  replaces tpu_pruner/policy/pallas_engine.py::_chip_kernel_q
//                   (pallas_engine.py:104; int8 1%-bucket samples, -1 = invalid
//                   in-band).
//
// And the two slice reductions at the end of this file, which reduce the
// pass's chip verdicts to slice verdicts and have no Pallas counterpart: the
// contiguous slice gate, tp_slice_gate, for chips in slice order, and the
// scatter reduction, tp_slice_scatter, for chips in any order.
//
// Both read every sample byte once and write one byte per chip: they are
// bound by device-memory bandwidth and do no tensor-core work. At the fleet
// size of 131,072 chips x 360 samples the f32 pass moves 425,328,648 B
// (127 us at 3.35 TB/s) and the int8 pass 95,027,208 B (28.4 us).
//
// tp_chip_pass has three designs; kernels._choose_plan_f32 picks one per
// launch from the row length. The group design (below) takes rows of up to
// 256 samples, such as an audit dump's 8; the long-row design (below) takes
// longer rows, such as the 360 of the example fleet. The warp design, the
// first port, is kept as the timing control and runs only when a caller
// forces its plan: one warp per chip row, lanes striding over the samples
// with one scalar load of each array in flight, a shuffle reduction across
// the warp, and lane 0 loading the age and applying the gates.
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

__global__ void __launch_bounds__(kThreads)
chip_pass_kernel(const float* __restrict__ tc, const float* __restrict__ hbm,
                 const uint8_t* __restrict__ valid, const float* __restrict__ age,
                 const float* __restrict__ params, uint8_t* __restrict__ out,
                 int64_t num_chips, int64_t num_samples) {
    const int lane = threadIdx.x & 31;
    const int64_t row = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    if (row >= num_chips) return;  // whole warp leaves together

    const int64_t base = row * num_samples;
    PeakF32 peak_tc, peak_hbm;
    bool has_data = false;
    for (int64_t t = lane; t < num_samples; t += 32) {
        // invalid samples read as -1, as jnp.where(valid, x, -1) does
        const bool v = valid[base + t] != 0;
        has_data |= v;
        peak_tc.add(v ? flush_subnormal(tc[base + t]) : -1.0f);
        peak_hbm.add(v ? flush_subnormal(hbm[base + t]) : -1.0f);
    }
    peak_tc.warp_reduce();
    peak_hbm.warp_reduce();
    has_data = __any_sync(kFullMask, has_data);

    if (lane == 0) {
        const float lookback = flush_subnormal(params[0]);
        const float cutoff = flush_subnormal(params[1]);
        out[row] = verdict_f32(RowPeaks{peak_tc, peak_hbm, has_data}, age[row], lookback,
                               cutoff);
    }
}

unsigned grid_for(int64_t num_chips) {
    return unsigned((num_chips + kWarpsPerBlock - 1) / kWarpsPerBlock);
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
// step). The warp design reads such a row with 8 of its 32 lanes, runs three
// 5-step warp reductions for 8 values, and loads the row's age only after
// them, a second memory round trip: at 1,048,576 x 8 it took 0.28 ms against
// a bound of 0.024 ms on the H100 (PERF.md). The group design:
//   - gives a row L lanes, L a power of two up to 32, and each lane up to K
//     samples (kernels._plan_groups: K = 4 up to 8 samples, else 8; L the
//     fewest lanes that cover the row); lane l reads samples l, l + L, ...,
//     so a warp's j-th loads are runs of L samples of its 32 / L
//     consecutive rows;
//   - issues every load before any arithmetic, the row's age (its first
//     lane) and the parameters included: a thread keeps up to K samples of
//     each array in flight, where a lane of the warp design keeps one;
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
// Above 256 samples the group design runs out of lanes, and the warp design
// reaches 55-59% of its bound at T = 360 on the H100 (PERF.md): a lane
// keeps one sample of each array in flight, and loads the age only after
// the row's three reductions. The long-row design:
//   - gives a row one warp and walks it in chunks of 32 K samples, K = 12
//     or 16 (kernels._plan_long: 16 when that takes the row in one chunk
//     and 12 does not, else 12; T = 360 is one chunk of 12);
//   - issues every load of a chunk (3 K a lane) before folding it, and the
//     row's age and the parameters before the first chunk, so a warp keeps
//     about 9 * 32 K bytes in flight where the warp design keeps 288;
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

}  // namespace

extern "C" {

int tp_chip_pass(const void* tc, const void* hbm, const void* valid, const void* age,
                 const void* params, void* out, int64_t num_chips, int64_t num_samples,
                 void* stream) {
    chip_pass_kernel<<<grid_for(num_chips), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tc), static_cast<const float*>(hbm),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(age),
        static_cast<const float*>(params), static_cast<uint8_t*>(out), num_chips,
        num_samples);
    return int(cudaGetLastError());
}

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

// The group design of tp_chip_pass; lanes (a row), samples (a lane) and
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

// The long-row design of tp_chip_pass; samples (a lane a chunk) and grid
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

}  // extern "C"
