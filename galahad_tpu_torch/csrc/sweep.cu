// Triangular sweeps of the flat supernodal LDL^T solve, one call per tree level.
//
// Replaces the sweeps of the JAX package's flat solve,
// galahad_tpu/linalg/supernodal_flat.py::_fwd_one and ::_bwd_one (run there
// through the jitted scans _k_fwd_scan / _k_bwd_scan, one scan step per chunk of
// fronts).  Contract, per front F (Fpad x Fpad, row-major, in the flat store)
// with ncols eliminated columns, nf real rows and the row map fr[0..Fpad):
//   forward + diagonal scale:
//     z  = L11^-1 y[fr[0..ncols)]          L = unit-lower, strictly below the
//     y[fr[j]]  = z_j / dsafe_j  (j < ncols)   diagonal of columns < ncols only;
//     y[fr[r]] += -(L21 z)_r     (r >= ncols)  dsafe_j = d_j, or 1 if |d_j| <= tiny
//   backward:
//     y[fr[0..ncols)] = L11^-T ( y[fr[0..ncols)] - L21^T y[fr[ncols..nf)] )
// Columns >= ncols hold the Schur block and the upper triangle is not L: the
// kernels index by ncols and never rely on stored zeros there.  Padded rows
// (>= nf) map to the spare slot y[n], which holds 0; no result depends on what
// the store holds in a front's padded rows.
//
// Fronts of one tree level are never ancestors of each other, so a level is one
// call: in the forward pass a front reads only its own eliminated rows of y and
// its struct-row change does not depend on y's struct values; in the backward
// pass it reads rows of ancestors, which are final.  Several fronts of a level
// add into the same ancestor row: each front writes its struct-row change into
// a scratch vector (indexed like the level's row map) and sweep_accumulate, one
// thread per distinct destination row, adds the scratch entries of a host-built
// list in a fixed order.  No atomics on values anywhere: two runs give the same
// bits.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; 67 / 34 TFLOP/s float32 /
// float64 outside the tensor cores): bytes.  Every L entry is read once per
// sweep and used in one multiply-add (0.25 operations per byte in float64).
// What it costs in practice is latency: the columns of a front are a recurrence
// of 32-column steps, and the top levels of the tree hold a handful of large
// fronts (the root of a 2-D grid problem is one dense triangle of 112 steps).
//
// Design for this card, by front size (tables built once per plan level on the
// host, linalg/sweep_kernels.py::build_sweep_level):
//   * Fpad 8, 16, 32: 4 / 2 / 1 fronts per warp, 8 warps per block.  Forward: a
//     lane owns a ROW (its first Fpad entries in registers), z_j travels by
//     __shfl_sync, the lane of row r > j subtracts L[r][j] z_j.  Backward: a
//     lane owns a COLUMN (loads coalesced along rows), x_i travels by shuffle
//     from i = Fpad-1 down, the lane of column j < i subtracts L[i][j] x_i.  No
//     barrier, no shared memory.
//   * Fpad >= 64: ONE wavefront launch per level and direction for all such
//     fronts.  A front is cut into work items of 32 rows (forward) or 32
//     columns (backward):
//       forward, triangle row block b: waits, column block by column block in
//         ascending order, for z of blocks 0..b-1 and adds L[rows b, cols j] z_j
//         as each arrives; solves its 32 x 32 unit-lower diagonal block (one
//         warp, shuffles), writes z (scratch) and y = z / dsafe, publishes a
//         ready flag.  Struct row block: waits on every triangle block of its
//         front in the same order and writes -(L21 z) for its rows into the
//         scratch.  A front with ncols <= 32 and few struct rows is one item.
//       backward, column block c (descending): subtracts L21[:, c]^T y2 first
//         (struct rows belong to ancestors: final, no wait), then waits for x of
//         blocks last..c+1 in descending order and subtracts L[rows r, cols c]^T
//         x_r for each, solves the transposed diagonal block, writes y and x
//         (scratch), publishes its flag.
//     Dispatch is by TICKET: a block takes its next item from one atomicAdd
//     counter (asked for one item ahead), and the host table lists every item
//     after all items it waits on.
//     So a waited-on item is always held by a running block, every wait ends,
//     and no cooperative launch or grid barrier is needed, for any grid size.
//     Memory order: a producer warp writes its 32 values, __syncwarp(), then
//     lane 0 stores the flag with st.release.gpu (cumulative: it orders the
//     warp's writes); the consumer's thread 0 polls with ld.acquire.gpu and the
//     block reads the values (through L2) after a barrier.  The ticket counter and the flags are cleared by one
//     cudaMemsetAsync per call.  Every sum runs in a fixed order (column
//     blocks ascending forward, row blocks descending backward, the lanes'
//     partial sums combined by one butterfly / one pass over the warps), which
//     does not depend on which block took which item or when a flag arrived.
//     A wait is bounded: after max_polls polls a block sets the call's abort
//     word and the host-visible status word (1 + its ticket) and leaves; every
//     other block sees the abort word and leaves too.  A wrong table never
//     hangs the card.  Loads go out in constant-size register batches; the
//     L block of the next step is loaded before its flag is awaited.
// A level and direction is at most three launches forward (small fronts, the
// wavefront, the accumulation) and two backward (the wavefront, small fronts).
// Each launcher adds the kernels it launched to *launched.
//
// Left for later: 16-byte loads for the small fronts; a look-ahead that would
// take the diagonal solve off the flag round trip of each step.
#include <cuda_runtime.h>

#define THREADS 256
#define WARPS 8
#define PB 32            // rows / columns of one work item
#define TW 8             // columns of a work-item table (long long)
#define RPW 4            // rows a warp takes together: WARPS * RPW == PB
#define KU 4             // column blocks whose loads are in flight together
#define FULL 0xffffffffu

// item tables (see linalg/sweep_kernels.py::build_sweep_level):
//   small : store offset, row-map offset, ncols offset, Fpad, fronts, -, -, -
//   wave  : store offset, row-map offset, Fpad, lo, hi, ncols, nf, flag base
//     forward: rows lo..hi; the rows below ncols are one triangle block (lo a
//       multiple of 32), the rows from ncols on are struct rows (an item that has
//       both holds its front's last triangle block)
//     backward: columns lo..hi, one column block (lo a multiple of 32)
//   the flag of triangle block j of a front is flags[flag base + j] forward and
//   flags[flag base + (blocks - 1 - j)] backward, so that waits go up the flags
// sync (int32, cleared per call): ticket, abort, flags...

template <typename T>
__device__ __forceinline__ T warp_sum(T s)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    return s;
}

// ---------------------------------------------------------------------------
// Fpad 8, 16, 32
// ---------------------------------------------------------------------------
template <typename T, int N>
__device__ __forceinline__ void fwd_small(const T* store, T* y, const int* rows,
                                          const int* ncols, T* work,
                                          const long long* it, T tiny)
{
    constexpr int G = 32 / N;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int count = (int)it[4];
    if (warp * G >= count) return;
    const int g = lane / N;
    const int r = lane % N;
    const int f = warp * G + g;
    const bool live = f < count;
    const long long fro = it[1] + (long long)f * N;
    int nc = 0, yr = 0;
    T v = (T)0, d = (T)1;
    T row[N];
#pragma unroll
    for (int k = 0; k < N; ++k) row[k] = (T)0;
    if (live) {
        nc = ncols[it[2] + f];
        nc = nc < 0 ? 0 : (nc > N ? N : nc);
        if (nc > 0) {
            const T* Fr = store + it[0] + ((size_t)f * N + r) * N;
#pragma unroll
            for (int k = 0; k < N; ++k) row[k] = Fr[k];
            d = Fr[r];
            yr = rows[fro + r];
            if (r < nc) v = y[yr];
        }
    }
    const int ncmax = __reduce_max_sync(FULL, nc);
#pragma unroll
    for (int j = 0; j < N; ++j) {
        if (j >= ncmax) break;
        const T zj = __shfl_sync(FULL, v, g * N + j);
        if (j < nc && r > j) v -= row[j] * zj;
    }
    if (nc > 0) {
        if (r < nc) y[yr] = v / ((fabs(d) > tiny) ? d : (T)1);
        else work[fro + r] = v;
    }
}

template <typename T, int N>
__device__ __forceinline__ void bwd_small(const T* store, T* y, const int* rows,
                                          const int* ncols, const long long* it, int n)
{
    constexpr int G = 32 / N;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int count = (int)it[4];
    if (warp * G >= count) return;
    const int g = lane / N;
    const int j = lane % N;
    const int f = warp * G + g;
    const bool live = f < count;
    int nc = 0, yr = n;
    if (live) {
        nc = ncols[it[2] + f];
        nc = nc < 0 ? 0 : (nc > N ? N : nc);
        if (nc > 0) yr = rows[it[1] + (long long)f * N + j];
    }
    // the front's real rows come first: nf = lanes of the group whose row is not
    // the spare slot; the padded rows of the store are never read
    const unsigned real = __ballot_sync(FULL, yr < n);
    const int nf = __popc((real >> (g * N)) & (N == 32 ? FULL : ((1u << (N & 31)) - 1u)));
    T v = (T)0;
    T col[N];
#pragma unroll
    for (int k = 0; k < N; ++k) col[k] = (T)0;
    if (nc > 0) {
        const T* Fc = store + it[0] + (size_t)f * N * N + j;
        if (j < nc) {
#pragma unroll
            for (int k = 0; k < N; ++k)
                if (k < nf) col[k] = Fc[k * N];
        }
        v = y[yr];
    }
    const int ncmax = __reduce_max_sync(FULL, nc);
    if (ncmax == 0) return;
#pragma unroll
    for (int i = N - 1; i >= 1; --i) {
        const T xi = __shfl_sync(FULL, v, g * N + i);
        if (j < i && j < nc) v -= col[i] * xi;
    }
    if (j < nc) y[yr] = v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sweep_fwd_small(const T* store, T* y, const int* __restrict__ rows,
                const int* __restrict__ ncols, T* work,
                const long long* __restrict__ table, T tiny)
{
    const long long* it = table + (size_t)blockIdx.x * TW;
    switch ((int)it[3]) {
    case 8:  fwd_small<T, 8>(store, y, rows, ncols, work, it, tiny); break;
    case 16: fwd_small<T, 16>(store, y, rows, ncols, work, it, tiny); break;
    case 32: fwd_small<T, 32>(store, y, rows, ncols, work, it, tiny); break;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sweep_bwd_small(const T* store, T* y, const int* __restrict__ rows,
                const int* __restrict__ ncols, const long long* __restrict__ table, int n)
{
    const long long* it = table + (size_t)blockIdx.x * TW;
    switch ((int)it[3]) {
    case 8:  bwd_small<T, 8>(store, y, rows, ncols, it, n); break;
    case 16: bwd_small<T, 16>(store, y, rows, ncols, it, n); break;
    case 32: bwd_small<T, 32>(store, y, rows, ncols, it, n); break;
    }
}

// ---------------------------------------------------------------------------
// Fpad >= 64: the wavefront
// ---------------------------------------------------------------------------
#define RU 8             // struct rows a warp has in flight together (backward)

__device__ __forceinline__ int ld_acquire(const int* p)
{
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v)
{
    asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

struct Waiter {
    int* flags;              // the item's front's flags
    int* abort_word;         // the call's
    int* status;             // host-visible, never cleared by the kernels
    int ticket;
    long long max_polls;
    int* sh;                 // two ints of shared memory, used in turn
    int turn;
};

// Called by every thread of the block.  Waits until flag j is set; returns one
// past the last consecutive set flag from j on (at most lim), or -1 if the call
// was aborted (by this block's own time-out or another's).
__device__ int wait_flags(Waiter& w, int j, int lim)
{
    int* sh = w.sh + (w.turn ^= 1);             // the other slot was read before the
                                                // last barrier: one barrier suffices
    if (threadIdx.x == 0) {
        int r = -1;
        long long polls = 0;
        for (;;) {
            if (ld_acquire(w.flags + j)) {
                r = j + 1;
                break;
            }
            if ((++polls & 255) == 0) {
                if (*(volatile int*)w.abort_word) break;
                if (polls >= w.max_polls) {
                    *(volatile int*)w.abort_word = 1;
                    *(volatile int*)w.status = w.ticket + 1;
                    __threadfence_system();
                    break;
                }
            }
        }
        if (r > 0)
            while (r < lim && ld_acquire(w.flags + r)) ++r;
        *sh = r;
    }
    __syncthreads();
    return *sh;
}

// Forward: adds to s[q], the lane's share of row row0 + q (q < RPW, rows from
// rend on skipped), L[row, c] z[c] for the columns c < ncol of the column blocks
// 0..nblk, ascending; blocks from `ready` on are awaited.  Returns the blocks
// known ready, or -1 on abort.  A term is added or skipped, never added as 0,
// so the sum does not depend on how the blocks came in.
template <typename T>
__device__ int fwd_dots(const T* F, int ld, const T* z, int nblk, int ready, int ncol,
                        int row0, int rend, T s[RPW], Waiter& w)
{
    const int lane = threadIdx.x & 31;
    const T* Lr[RPW];
    bool rin[RPW];
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
        rin[q] = row0 + q < rend;
        Lr[q] = F + (size_t)(rin[q] ? row0 + q : 0) * ld;
    }
    int j = 0;
    while (j < nblk) {
        if (j + KU <= ready) {                   // KU ready blocks, loads in flight together
            T l[RPW][KU], zk[KU];
#pragma unroll
            for (int u = 0; u < KU; ++u) {
                const int c = (j + u) * PB + lane;
                const bool in = c < ncol;
                zk[u] = in ? __ldcg(z + c) : (T)0;
#pragma unroll
                for (int q = 0; q < RPW; ++q) l[q][u] = (in && rin[q]) ? Lr[q][c] : (T)0;
            }
#pragma unroll
            for (int u = 0; u < KU; ++u) {
                const bool in = (j + u) * PB + lane < ncol;
#pragma unroll
                for (int q = 0; q < RPW; ++q)
                    if (in && rin[q]) s[q] += l[q][u] * zk[u];
            }
            j += KU;
            continue;
        }
        const int c = j * PB + lane;             // one block: its L before its flag
        const bool in = c < ncol;
        T l[RPW];
#pragma unroll
        for (int q = 0; q < RPW; ++q) l[q] = (in && rin[q]) ? Lr[q][c] : (T)0;
        if (j >= ready) {
            ready = wait_flags(w, j, nblk);
            if (ready < 0) return -1;
        }
        const T zj = in ? __ldcg(z + c) : (T)0;
#pragma unroll
        for (int q = 0; q < RPW; ++q)
            if (in && rin[q]) s[q] += l[q] * zj;
        ++j;
    }
    return ready;
}

template <typename T>
__device__ bool fwd_item(const T* store, T* y, const int* rows, T* work,
                         const long long* it, T tiny, Waiter& w, T (*D)[PB + 1],
                         T* red)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const T* F = store + it[0];
    const int* fr = rows + it[1];
    T* z = work + it[1];
    const int ld = (int)it[2], lo = (int)it[3], hi = (int)it[4], nc = (int)it[5];
    const int blocks = (nc + PB - 1) / PB;
    int ready = 0;
    if (lo < nc) {                               // a triangle row block
        const int b = lo / PB;
        const int nt = ((hi < nc) ? hi : nc) - lo;
        // the diagonal block and warp 0's right-hand side, asked for before any wait
        for (int i = warp; i < PB; i += WARPS)
            D[i][lane] = (i < nt && lane <= i) ? F[(size_t)(lo + i) * ld + lo + lane] : (T)0;
        T v = (T)0;
        int yr = 0;
        if (warp == 0 && lane < nt) {
            yr = fr[lo + lane];
            v = y[yr];
        }
        T s[RPW];
#pragma unroll
        for (int q = 0; q < RPW; ++q) s[q] = (T)0;
        ready = fwd_dots<T>(F, ld, z, b, 0, b * PB, lo + warp * RPW, lo + nt, s, w);
        if (ready < 0) return false;
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
            const T t = warp_sum(s[q]);
            if (lane == 0) red[warp * RPW + q] = t;
        }
        __syncthreads();
        if (warp == 0) {
            if (lane < nt) v -= red[lane];
            T dl[PB];
#pragma unroll
            for (int j = 0; j < PB; ++j) dl[j] = D[lane][j];
#pragma unroll
            for (int j = 0; j < PB - 1; ++j) {
                const T zj = __shfl_sync(FULL, v, j);
                if (lane > j && lane < nt) v -= dl[j] * zj;
            }
            if (lane < nt) {
                const T d = D[lane][lane];
                z[lo + lane] = v;
                y[yr] = v / ((fabs(d) > tiny) ? d : (T)1);
            }
            __syncwarp();                        // the warp's z, then one release store
            if (lane == 0) st_release(w.flags + b, 1);
        }
        ready = b + 1;
        if (hi > nc) __syncthreads();            // the item's own z block, for its struct rows
    }
    for (int p = (lo > nc ? lo : nc); p < hi; p += PB) {      // struct rows, 32 at a time
        T s[RPW];
#pragma unroll
        for (int q = 0; q < RPW; ++q) s[q] = (T)0;
        ready = fwd_dots<T>(F, ld, z, blocks, ready, nc, p + warp * RPW, hi, s, w);
        if (ready < 0) return false;
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
            const T t = warp_sum(s[q]);
            const int r = p + warp * RPW + q;
            if (lane == 0 && r < hi) z[r] = -t;
        }
    }
    return true;
}

template <typename T>
__device__ bool bwd_item(const T* store, T* y, const int* rows, T* work,
                         const long long* it, Waiter& w, T (*D)[PB + 1],
                         T (*red)[PB], T* ys)
{
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const T* F = store + it[0];
    const int* fr = rows + it[1];
    T* x = work + it[1];
    const int ld = (int)it[2], c0 = (int)it[3], c1 = (int)it[4];
    const int nc = (int)it[5], nf = (int)it[6];
    const int nb = c1 - c0;
    const int blocks = (nc + PB - 1) / PB;
    const int nw = blocks - 1 - c0 / PB;         // flags 0..nw: blocks last..c0 / 32 + 1
    const bool col = lane < nb;
    const T* Fc = F + c0 + lane;                 // the lane's column
    for (int i = warp; i < PB; i += WARPS)
        D[i][lane] = (i < nb && lane < i) ? F[(size_t)(c0 + i) * ld + c0 + lane] : (T)0;
    T yc = (T)0;
    if (warp == 0 && col) yc = y[fr[c0 + lane]];
    T a = (T)0;
    // struct rows (rows of ancestors: final), THREADS at a time through shared memory
    for (int r0 = nc; r0 < nf; r0 += THREADS) {
        const int cnt = (nf - r0 < THREADS) ? nf - r0 : THREADS;
        __syncthreads();
        ys[tid] = (tid < cnt) ? y[fr[r0 + tid]] : (T)0;
        __syncthreads();
        for (int k0 = warp; k0 < cnt; k0 += WARPS * RU) {
            T l[RU];
#pragma unroll
            for (int u = 0; u < RU; ++u) {
                const int i = k0 + WARPS * u;
                l[u] = (col && i < cnt) ? Fc[(size_t)(r0 + i) * ld] : (T)0;
            }
#pragma unroll
            for (int u = 0; u < RU; ++u) {
                const int i = k0 + WARPS * u;
                if (col && i < cnt) a += l[u] * ys[i];
            }
        }
    }
    // the triangle blocks below the item's, last first; the warp's rows of each
    int k = 0, ready = 0;
    while (k < nw) {
        if (k + KU <= ready) {
            T l[KU][RPW], xs[KU][RPW];
#pragma unroll
            for (int u = 0; u < KU; ++u) {
                const int r0 = (blocks - 1 - k - u) * PB + warp * RPW;
#pragma unroll
                for (int q = 0; q < RPW; ++q) {
                    const bool in = r0 + q < nc;
                    l[u][q] = (col && in) ? Fc[(size_t)(r0 + q) * ld] : (T)0;
                    xs[u][q] = in ? __ldcg(x + r0 + q) : (T)0;
                }
            }
#pragma unroll
            for (int u = 0; u < KU; ++u) {
                const int r0 = (blocks - 1 - k - u) * PB + warp * RPW;
#pragma unroll
                for (int q = 0; q < RPW; ++q)
                    if (col && r0 + q < nc) a += l[u][q] * xs[u][q];
            }
            k += KU;
            continue;
        }
        const int r0 = (blocks - 1 - k) * PB + warp * RPW;
        T l[RPW];
#pragma unroll
        for (int q = 0; q < RPW; ++q)
            l[q] = (col && r0 + q < nc) ? Fc[(size_t)(r0 + q) * ld] : (T)0;
        if (k >= ready) {
            ready = wait_flags(w, k, nw);
            if (ready < 0) return false;
        }
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
            const bool in = r0 + q < nc;
            const T xq = in ? __ldcg(x + r0 + q) : (T)0;
            if (col && in) a += l[q] * xq;
        }
        ++k;
    }
    red[warp][lane] = a;
    __syncthreads();
    if (warp == 0) {
        T acc = (T)0;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) acc += red[q][lane];
        T v = col ? yc - acc : (T)0;
        T dl[PB];
#pragma unroll
        for (int i = 0; i < PB; ++i) dl[i] = D[i][lane];
#pragma unroll
        for (int i = PB - 1; i >= 1; --i) {
            const T xi = __shfl_sync(FULL, v, i);
            if (lane < i && i < nb) v -= dl[i] * xi;
        }
        if (col) {
            y[fr[c0 + lane]] = v;
            x[c0 + lane] = v;
        }
        __syncwarp();                            // the warp's x, then one release store
        if (lane == 0) st_release(w.flags + nw, 1);
    }
    return true;
}

// Persistent blocks take items by ticket until the table is done or the call
// is aborted.  Thread 0 asks for a block's next ticket when the block starts
// an item, so that the atomic's latency hides behind the item.  Progress still
// holds: the lowest unfinished ticket is always the one its block works on.
template <typename T, bool FWD>
__global__ void __launch_bounds__(THREADS)
sweep_wave(const T* store, T* y, const int* __restrict__ rows, T* work,
           const long long* __restrict__ table, int n_items, int* sync, int* status,
           long long max_polls, T tiny)
{
    __shared__ T D[PB][PB + 1];
    __shared__ T red[WARPS][PB];
    __shared__ T ys[THREADS];
    __shared__ int sh[3];
    int next = 0;                                // thread 0: the ticket taken ahead
    if (threadIdx.x == 0) next = atomicAdd(sync, 1);
    for (;;) {
        __syncthreads();                         // the last item's shared memory is free
        if (threadIdx.x == 0) sh[0] = *(volatile int*)(sync + 1) ? n_items : next;
        __syncthreads();
        const int t = sh[0];
        if (t >= n_items) return;
        if (threadIdx.x == 0) next = atomicAdd(sync, 1);
        const long long* it = table + (size_t)t * TW;
        Waiter w{sync + 2 + it[7], sync + 1, status, t, max_polls, sh + 1, 0};
        const bool ok = FWD ? fwd_item<T>(store, y, rows, work, it, tiny, w, D, &red[0][0])
                            : bwd_item<T>(store, y, rows, work, it, w, D, red, ys);
        if (!ok) return;
    }
}

// ---------------------------------------------------------------------------
// struct-row accumulation: one thread per distinct destination row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
sweep_accumulate(T* y, const T* work, const int* __restrict__ acc_row,
                 const int* __restrict__ acc_ptr, const int* __restrict__ acc_pos,
                 int n_acc)
{
    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= n_acc) return;
    T s = (T)0;
    for (int k = acc_ptr[t]; k < acc_ptr[t + 1]; ++k) s += work[acc_pos[k]];
    y[acc_row[t]] += s;
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// blocks of the wavefront kernel the card holds at once (per device, cached)
template <typename T, bool FWD>
static int wave_grid(int n_items)
{
    static int resident[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) dev = 0;
    if (resident[dev] == 0) {
        int per = 0, sms = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, sweep_wave<T, FWD>, THREADS, 0);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        resident[dev] = (per > 0 ? per : 1) * (sms > 0 ? sms : 1);
    }
    return n_items < resident[dev] ? n_items : resident[dev];
}

// clears the ticket, the abort word and the flags, then launches the wavefront
template <typename T, bool FWD>
static cudaError_t launch_wave(const void* store, void* y, const int* rows, void* work,
                               const long long* wave, int n_wave, int* sync, int n_flags,
                               int* status, long long max_polls, double tiny,
                               cudaStream_t st)
{
    cudaError_t err = cudaMemsetAsync(sync, 0, sizeof(int) * (size_t)(2 + n_flags), st);
    if (err != cudaSuccess) return err;
    sweep_wave<T, FWD><<<wave_grid<T, FWD>(n_wave), THREADS, 0, st>>>(
        (const T*)store, (T*)y, rows, (T*)work, wave, n_wave, sync, status, max_polls,
        (T)tiny);
    return cudaGetLastError();
}

template <typename T>
static int launch_fwd(const void* store, void* y, const int* rows, const int* ncols,
                      const long long* small, int n_small, const long long* wave,
                      int n_wave, int* sync, int n_flags, int* status, long long max_polls,
                      const int* acc_row, const int* acc_ptr, const int* acc_pos,
                      int n_acc, void* work, double tiny, int* launched, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaSuccess;
    if (n_small > 0) {
        sweep_fwd_small<T><<<n_small, THREADS, 0, st>>>(
            (const T*)store, (T*)y, rows, ncols, (T*)work, small, (T)tiny);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        ++*launched;
    }
    if (n_wave > 0) {
        err = launch_wave<T, true>(store, y, rows, work, wave, n_wave, sync, n_flags, status,
                                   max_polls, tiny, st);
        if (err != cudaSuccess) return (int)err;
        ++*launched;
    }
    if (n_acc > 0) {
        sweep_accumulate<T><<<(n_acc + THREADS - 1) / THREADS, THREADS, 0, st>>>(
            (T*)y, (const T*)work, acc_row, acc_ptr, acc_pos, n_acc);
        if ((err = cudaGetLastError()) == cudaSuccess) ++*launched;
    }
    return (int)err;
}

template <typename T>
static int launch_bwd(const void* store, void* y, const int* rows, const int* ncols,
                      const long long* small, int n_small, const long long* wave,
                      int n_wave, int* sync, int n_flags, int* status, long long max_polls,
                      void* work, int n, int* launched, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaSuccess;
    if (n_wave > 0) {
        err = launch_wave<T, false>(store, y, rows, work, wave, n_wave, sync, n_flags, status,
                                    max_polls, 0.0, st);
        if (err != cudaSuccess) return (int)err;
        ++*launched;
    }
    if (n_small > 0) {
        sweep_bwd_small<T><<<n_small, THREADS, 0, st>>>(
            (const T*)store, (T*)y, rows, ncols, small, n);
        if ((err = cudaGetLastError()) == cudaSuccess) ++*launched;
    }
    return (int)err;
}

#define SWEEP_FWD_ARGS                                                              \
    const void* store, void* y, const int* rows, const int* ncols,                  \
    const long long* small, int n_small, const long long* wave, int n_wave,         \
    int* sync, int n_flags, int* status, long long max_polls, const int* acc_row,   \
    const int* acc_ptr, const int* acc_pos, int n_acc, void* work, double tiny,     \
    int* launched, void* stream
#define SWEEP_FWD_PASS                                                              \
    store, y, rows, ncols, small, n_small, wave, n_wave, sync, n_flags, status,     \
    max_polls, acc_row, acc_ptr, acc_pos, n_acc, work, tiny, launched, stream
#define SWEEP_BWD_ARGS                                                              \
    const void* store, void* y, const int* rows, const int* ncols,                  \
    const long long* small, int n_small, const long long* wave, int n_wave,         \
    int* sync, int n_flags, int* status, long long max_polls, void* work, int n,    \
    int* launched, void* stream
#define SWEEP_BWD_PASS                                                              \
    store, y, rows, ncols, small, n_small, wave, n_wave, sync, n_flags, status,     \
    max_polls, work, n, launched, stream

extern "C" int sweep_fwd_f32(SWEEP_FWD_ARGS) { return launch_fwd<float>(SWEEP_FWD_PASS); }
extern "C" int sweep_fwd_f64(SWEEP_FWD_ARGS) { return launch_fwd<double>(SWEEP_FWD_PASS); }
extern "C" int sweep_bwd_f32(SWEEP_BWD_ARGS) { return launch_bwd<float>(SWEEP_BWD_PASS); }
extern "C" int sweep_bwd_f64(SWEEP_BWD_ARGS) { return launch_bwd<double>(SWEEP_BWD_PASS); }

extern "C" const char* sweep_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
