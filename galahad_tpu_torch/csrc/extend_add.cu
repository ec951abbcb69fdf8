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
// carried over.
//
// Design: a warp owns one 32 x 32 tile of a parent front that some child
// reaches (a front of 8 or 16 is one tile with idle lanes), lane c the tile's
// column c, and keeps the tile's 32 rows of that column in registers.  The
// host lists, per tile and in the children's order, one "pair" per child that
// reaches the tile: the store entry of the first child row and column that land
// in it and two 32-bit masks of the tile rows and columns the child reaches.
// ppos is strictly increasing, so the child rows that land in the tile are
// consecutive and the k-th set bit of a mask is the k-th of them: a lane finds
// its child column and each row's child row by a population count, with no
// search and no shared memory.  The warp first ORs the pairs' masks into the
// rows its column receives (shuffles), loads exactly those entries of P, adds
// the children in order, 16 rows of loads in flight before their adds, and
// writes each reached entry once.  Tiles are disjoint and the children lie in
// lower levels, so nothing a launch reads is written by it.  A level is one
// launch of 8 warps (tiles) per block; the launcher adds it to *launched.
//
// Left for later: fronts of 8 and 16 use a quarter / half of a warp; a pair's
// record and its first loads are two dependent latencies.
#include <cuda_runtime.h>

#define THREADS 256
#define WARPS 8
#define TILE 32          // rows and columns of a tile (a lane per column)
#define BATCH 16         // rows whose loads are issued before their adds
#define FULL 0xffffffffu

// tables (see linalg/ea_kernels.py::build_ea_level):
//   tile : store entry of the tile's first element, Fd, first pair, pairs
//   pair : store entry of C[first row][first column] in the tile, fps,
//          row mask | column mask << 32

template <typename T>
__global__ void __launch_bounds__(THREADS) extend_add_kernel(
    T* __restrict__ store, const long long* __restrict__ tiles, int n_tiles,
    const long long* __restrict__ pairs)
{
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (t >= n_tiles) return;
    const long long* tl = tiles + 4 * (size_t)t;
    T* P = store + tl[0] + lane;
    const long long Fd = tl[1];
    const long long* pr = pairs + 3 * (size_t)tl[2];
    const int np = (int)tl[3];
    const unsigned below = (1u << lane) - 1u;

    // the rows of this lane's column that some child reaches
    unsigned touched = 0;
    for (int p0 = 0; p0 < np; p0 += 32) {
        const unsigned long long m =
            p0 + lane < np ? (unsigned long long)pr[3 * (size_t)(p0 + lane) + 2] : 0ull;
        const int cnt = min(32, np - p0);
        for (int q = 0; q < cnt; ++q) {
            const unsigned long long mq = __shfl_sync(FULL, m, q);
            if (((unsigned)(mq >> 32) >> lane) & 1u) touched |= (unsigned)mq;
        }
    }
    if (touched == 0) return;

    T acc[TILE];
#pragma unroll
    for (int r = 0; r < TILE; ++r)
        acc[r] = ((touched >> r) & 1u) ? P[r * Fd] : (T)0;

    for (int p = 0; p < np; ++p) {
        const long long* q = pr + 3 * (size_t)p;
        const unsigned long long mm = (unsigned long long)q[2];
        const unsigned cmask = (unsigned)(mm >> 32);
        if (!((cmask >> lane) & 1u)) continue;
        const unsigned rmask = (unsigned)mm;
        const long long fps = q[1];
        const T* C = store + q[0] + __popc(cmask & below);
#pragma unroll
        for (int h = 0; h < TILE; h += BATCH) {
            const unsigned rm = (rmask >> h) & ((1u << BATCH) - 1u);
            if (rm == 0) continue;
            const int base = h ? __popc(rmask & ((1u << h) - 1u)) : 0;
            T v[BATCH];
#pragma unroll
            for (int r = 0; r < BATCH; ++r) {
                const long long i = base + __popc(rm & ((1u << r) - 1u));
                v[r] = ((rm >> r) & 1u) ? C[i * fps] : (T)0;
            }
#pragma unroll
            for (int r = 0; r < BATCH; ++r)
                if ((rm >> r) & 1u) acc[h + r] += v[r];
        }
    }

#pragma unroll
    for (int r = 0; r < TILE; ++r)
        if ((touched >> r) & 1u) P[r * Fd] = acc[r];
}

template <typename T>
static int launch(void* store, const long long* tiles, int n_tiles, const long long* pairs,
                  int* launched, void* stream)
{
    if (n_tiles <= 0) return 0;
    extend_add_kernel<T><<<(n_tiles + WARPS - 1) / WARPS, THREADS, 0, (cudaStream_t)stream>>>(
        (T*)store, tiles, n_tiles, pairs);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return (int)err;
}

extern "C" int extend_add_f32(void* store, const long long* tiles, int n_tiles,
                              const long long* pairs, int* launched, void* stream)
{
    return launch<float>(store, tiles, n_tiles, pairs, launched, stream);
}

extern "C" int extend_add_f64(void* store, const long long* tiles, int n_tiles,
                              const long long* pairs, int* launched, void* stream)
{
    return launch<double>(store, tiles, n_tiles, pairs, launched, stream);
}

extern "C" const char* extend_add_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
