// Extend-add of the flat supernodal LDL^T factorization, one call per tree level.
//
// Replaces the extend-add of the JAX package's flat factorization,
// galahad_tpu/linalg/supernodal_flat.py::_ea_slot_apply and ::_ea_q_apply (with
// _ea_gather_blocks and _ea_onehot; run there through the jitted scans
// _k_ea_slot_scan / _k_ea_q_scan, one scan step per bucket of children of one
// padded shape).  Contract, for every child of a front of the level, with Schur
// block C (u x u, row stride fps) and strictly increasing parent positions ppos:
//     P[ppos[i]][ppos[j]] += C[i][j]        i, j < u, both triangles of C
// where P is the parent front (Fd x Fd, row-major in the flat store).  The
// children of a parent are added one at a time in the order of the host-built
// table, so every destination receives its adds in one fixed order: no atomics,
// no barrier across blocks, and two runs give the same bits (and the plain
// version's).  An entry that no child reaches is neither read nor written;
// nothing outside a child's Schur block is read.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3): bytes.  Each child entry is
// read once and used in one addition; each destination entry is read and
// written once.  The TPU version expanded every child to its parent's full
// front with one-hot matrix products (scatter is slow there); none of that is
// carried over.  What held the first version back was latency, not bytes: a
// level's time was its longest tiles' chains of dependent loads.
//
// Design.  A tile is ROWS = 16 rows and up to 32 columns of one parent front
// that some child reaches; a group of lanes owns it, lane c its column c, and
// keeps the tile's 16 rows of that column in registers.  A tile of a front
// wider than 16 takes a whole warp; fronts of 9..16 and of 1..8 are packed two
// and four to a warp, a group of 16 or 8 lanes each (the host orders the tiles
// so: wide, then 16, then 8; each class by pairs, most first).  The host lists,
// per tile and in the children's order, one "pair" per child that reaches the
// tile: the store entry of the first child row and column that land in it, fps
// and the masks of the tile rows and columns the child reaches.  ppos is
// strictly increasing, so the child rows that land in the tile are consecutive
// and the k-th set bit of a mask is the k-th of them: a lane finds its child
// column and each row's child row by a population count.
//   Latency is what the design is about.  (i) A tile's first two pair records
// ride in its row of the tile table; lane q of the tile's lanes loads the
// record of pair 2 + q (16 bytes, one load for the whole group, in chunks of
// the group's width), and the pair loop takes every record from a register or
// a shuffle, with no global load inside the loop: a tile of one or two pairs
// starts its copies one latency after its warp starts.  (ii) A pair's 16 row copies carry no predicate: a row the
// child does not reach is clamped onto one of the pair's own child rows, so
// every address lies in the child's Schur block and the 16 copies issue back to
// back (predicated loads need a predicate register each, and there are seven:
// the first version's loads went out four at a time).  The adds are predicated:
// a masked term is skipped, never added as 0 (the sign of a zero would differ).
// (iii) A pair's copies are issued STAGES - 1 = 2 pairs ahead of its adds, into
// a ring of STAGES stages per warp in shared memory (cp.async, 4 or 8 bytes a
// lane): a chain of n pairs costs about n / 2 latencies, and the copies in
// flight hold no registers.  (iv) 16 rows of accumulators and 128-thread
// blocks keep the f64 kernel within 128 registers with no spill: 16 resident
// warps per SM (24 in f32); what the compiler and the card made of it is read
// back by extend_add_attributes.
//   Tiles are disjoint and the children lie in lower levels, so nothing a
// launch reads is written by it (child entries are read through the read-only
// path).  A level is one launch; the launcher adds it to *launched.
#include <cuda_runtime.h>

#define THREADS 128
#define WARPS (THREADS / 32)
#define ROWS 16          // rows of a tile: a lane holds them in registers
#define INLINE 2         // pair records a tile's row carries
#define TILE_WORDS (4 + 2 * INLINE) // int64 words of a tile's row
#define FULL 0xffffffffu
#define STAGES 3         // shared-memory stages of a warp; 3 beat 2 on an H100 (PERF.md §6)
static_assert(INLINE == 2, "the kernel reads a tile row's two inline records");

// tables (see linalg/ea_kernels.py::build_ea_level):
//   tiles : TILE_WORDS words: store entry of the tile's first element, Fd | pairs << 32,
//           first pair, 0, then the records of its first INLINE pairs (0 where
//           none); the n32 tiles of fronts wider than 16 first, then n16 of
//           9..16, then n8 of 1..8
//   pairs : store entry of C[first row][first column] in the tile,
//           fps | row mask << 16 | column mask << 32

// minimum resident blocks per SM asked of the compiler: 16 warps in f64, where
// 4 blocks of 3 x 16 KB of stages also fill the SM's shared memory; 24 in f32
template <typename T> struct Residency;
template <> struct Residency<double> { static constexpr int blocks = 4; };
template <> struct Residency<float> { static constexpr int blocks = 6; };

// a pair's record, as the lanes of a tile use it
struct Pair {
    long long src;
    int fps;
    unsigned rows, cols;
};

__device__ __forceinline__ Pair unpack(long long src, long long word)
{
    const unsigned long long w = (unsigned long long)word;
    return Pair{src, (int)(w & 0xffffu), (unsigned)(w >> 16) & 0xffffu, (unsigned)(w >> 32)};
}

// the record that lane q of this lane's group holds in chunk
__device__ __forceinline__ Pair take(const longlong2& chunk, int q, int width)
{
    return unpack(__shfl_sync(FULL, chunk.x, q, width), __shfl_sync(FULL, chunk.y, q, width));
}

// copy the ROWS entries of column c of pair p's block into this lane's column
// of a stage (row r at s[r * 32]), row r from child row popc(rows below r);
// a row the child does not reach copies the child's next row in the tile, or
// its last.  cp.async: the copies hold no register and carry no predicate.
template <typename T>
__device__ __forceinline__ void copy_rows(T* s, const T* __restrict__ store, const Pair& p,
                                          int c)
{
    const T* C = store + p.src + __popc(p.cols & ((1u << c) - 1u));
    const int last = __popc(p.rows) - 1;
    const unsigned s0 = (unsigned)__cvta_generic_to_shared(s);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int i = min(__popc(p.rows & ((1u << r) - 1u)), last);
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                     :: "r"(s0 + (unsigned)(r * 32 * sizeof(T))), "l"(C + i * p.fps),
                        "n"(sizeof(T)));
    }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// all of this lane's copies but those of the newest STAGES - 1 groups have landed
__device__ __forceinline__ void wait_for_oldest()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 1));
}

template <typename T>
__device__ __forceinline__ void add_rows(T (&acc)[ROWS], const T* s, unsigned rows)
{
#pragma unroll
    for (int h = 0; h < ROWS; h += ROWS / 2) {
        T v[ROWS / 2];
#pragma unroll
        for (int r = 0; r < ROWS / 2; ++r) v[r] = s[(h + r) * 32];
#pragma unroll
        for (int r = 0; r < ROWS / 2; ++r)
            if ((rows >> (h + r)) & 1u) acc[h + r] += v[r];
    }
}

// a tile's pair records past the first INLINE, chunk k: lane c holds pair
// INLINE + k * width + c (0 past the tile's pairs)
__device__ __forceinline__ longlong2 chunk_at(const longlong2* __restrict__ pr, int np,
                                              int k, int width, int c)
{
    const int p = k * width + c;
    return p < np ? __ldg(pr + p) : make_longlong2(0, 0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, Residency<T>::blocks) extend_add_kernel(
    T* __restrict__ store, const long long* __restrict__ tiles,
    const longlong2* __restrict__ pairs, int n32, int n16, int n8)
{
    const int lane = threadIdx.x & 31;
    int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
    // this warp's tiles: one of a front wider than 16, two of 9..16 or four of 1..8
    int lg, t, end;
    if (w < n32) {
        lg = 5, t = w, end = n32;
    } else if ((w -= n32) < (n16 + 1) / 2) {
        lg = 4, t = n32 + 2 * w + (lane >> 4), end = n32 + n16;
    } else if ((w -= (n16 + 1) / 2) < (n8 + 3) / 4) {
        lg = 3, t = n32 + n16 + 4 * w + (lane >> 3), end = n32 + n16 + n8;
    } else {
        return;                                  // the whole warp
    }
    const int width = 1 << lg, c = lane & (width - 1);
    long long dst = 0, first = 0;
    int Fd = 0, np = 0;
    longlong2 r0 = make_longlong2(0, 0), r1 = r0;
    if (t < end) {                               // a lane group past the last tile idles
        const longlong2* tr =
            reinterpret_cast<const longlong2*>(tiles) + TILE_WORDS / 2 * (size_t)t;
        const longlong2 a = __ldg(tr), b = __ldg(tr + 1);
        r0 = __ldg(tr + 2), r1 = __ldg(tr + 3);
        dst = a.x, Fd = (int)(unsigned)a.y, np = (int)(a.y >> 32), first = b.x;
    }
    const int npmax = (int)__reduce_max_sync(FULL, (unsigned)np);
    const longlong2* pr = pairs + first + INLINE;
    const int rest = max(np - INLINE, 0);

    // the rows of this lane's column that some child reaches
    const Pair p0 = unpack(r0.x, r0.y), p1 = unpack(r1.x, r1.y);
    unsigned touched = (((p0.cols >> c) & 1u) ? p0.rows : 0u) |
                       (((p1.cols >> c) & 1u) ? p1.rows : 0u);
    longlong2 chunk = chunk_at(pr, rest, 0, width, c);
    for (int k = 0; INLINE + k * width < npmax; ++k) {
        const longlong2 ck = k ? chunk_at(pr, rest, k, width, c) : chunk;
        const int cnt = min(width, npmax - INLINE - k * width);
        for (int q = 0; q < cnt; ++q) {
            const Pair p = take(ck, q, width);
            if ((p.cols >> c) & 1u) touched |= p.rows;
        }
    }

    // the tile's reached entries of this column, every load unpredicated
    T* P = store + dst + c;
    T acc[ROWS];
    if (touched) {
        const int t0 = __ffs(touched) - 1;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
            acc[r] = P[(((touched >> r) & 1u) ? r : t0) * Fd];
    }

    // the pairs in the children's order, each pair's copies issued STAGES - 1
    // pairs ahead of its adds: a ring of STAGES stages per warp in shared memory
    __shared__ T stage[WARPS][STAGES][ROWS * 32];
    T* const ring = stage[threadIdx.x >> 5][0] + lane;
    int fetched = 0;                             // pairs whose records were taken
    auto fetch = [&]() -> Pair {                 // the next pair's record, 0 past npmax
        const int q = fetched++;
        if (q >= npmax) return Pair{0, 0, 0u, 0u};
        if (q == 0) return p0;
        if (q == 1) return p1;                   // 0 where the tile has one pair
        const int j = q - INLINE;
        if (j > 0 && (j & (width - 1)) == 0) chunk = chunk_at(pr, rest, j / width, width, c);
        return take(chunk, j & (width - 1), width);
    };
    Pair held[STAGES];                           // the record of each stage's pair
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        held[s] = fetch();
        if ((held[s].cols >> c) & 1u) copy_rows(ring + s * ROWS * 32, store, held[s], c);
        commit();
    }
    for (int base = 0; base < npmax; base += STAGES) {
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {             // stage s holds pair base + s
            if (base + s >= npmax) break;
            const int sq = (s + STAGES - 1) % STAGES;
            held[sq] = fetch();
            if ((held[sq].cols >> c) & 1u)
                copy_rows(ring + sq * ROWS * 32, store, held[sq], c);
            commit();
            wait_for_oldest();
            if ((held[s].cols >> c) & 1u) add_rows(acc, ring + s * ROWS * 32, held[s].rows);
        }
    }

    if (touched) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
            if ((touched >> r) & 1u) P[r * Fd] = acc[r];
    }
}

static int warps_of(int n32, int n16, int n8)
{
    return n32 + (n16 + 1) / 2 + (n8 + 3) / 4;
}

template <typename T>
static int launch(void* store, const long long* tiles, const long long* pairs, int n32,
                  int n16, int n8, int* launched, void* stream)
{
    const int warps = warps_of(n32, n16, n8);
    if (warps <= 0) return 0;
    extend_add_kernel<T><<<(warps + WARPS - 1) / WARPS, THREADS, 0, (cudaStream_t)stream>>>(
        (T*)store, tiles, reinterpret_cast<const longlong2*>(pairs), n32, n16, n8);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return (int)err;
}

extern "C" int extend_add_f32(void* store, const long long* tiles, const long long* pairs,
                              int n32, int n16, int n8, int* launched, void* stream)
{
    return launch<float>(store, tiles, pairs, n32, n16, n8, launched, stream);
}

extern "C" int extend_add_f64(void* store, const long long* tiles, const long long* pairs,
                              int n32, int n16, int n8, int* launched, void* stream)
{
    return launch<double>(store, tiles, pairs, n32, n16, n8, launched, stream);
}

// what the compiler and the card made of the kernel of one type (f64 != 0:
// double): out = registers per thread, local (spill) bytes per thread, threads
// per block, resident blocks per SM
extern "C" int extend_add_attributes(int f64, int* out)
{
    cudaFuncAttributes fa;
    const void* fn = f64 ? (const void*)extend_add_kernel<double>
                         : (const void*)extend_add_kernel<float>;
    cudaError_t err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = THREADS;
    out[3] = blocks;
    return 0;
}

// the table layout the kernel reads, for the wrapper to hold against its own:
// out = rows of a tile, columns of a tile, inline pair records, words of a tile row
extern "C" void extend_add_layout(int* out)
{
    out[0] = ROWS;
    out[1] = 32;
    out[2] = INLINE;
    out[3] = TILE_WORDS;
}

extern "C" const char* extend_add_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
