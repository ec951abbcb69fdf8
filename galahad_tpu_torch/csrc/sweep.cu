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
// list in a fixed order.  No atomics anywhere: two runs give the same bits.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; 67 / 34 TFLOP/s float32 /
// float64 outside the tensor cores): bytes.  Every L entry is read once per
// sweep and used in one multiply-add (0.25 operations per byte in float64).
// What it costs in practice is latency: the columns of a front are a recurrence,
// and the top levels of the tree hold a handful of large fronts.
//
// Design for this card, by front size (one table of work items per kernel,
// built once per plan level on the host):
//   * Fpad 8, 16, 32: 4 / 2 / 1 fronts per warp, 8 warps per block.  Forward: a
//     lane owns a ROW (its first Fpad entries in registers), z_j travels by
//     __shfl_sync, the lane of row r > j subtracts L[r][j] z_j.  Backward: a
//     lane owns a COLUMN (loads coalesced along rows), x_i travels by shuffle
//     from i = Fpad-1 down, the lane of column j < i subtracts L[i][j] x_i.  No
//     barrier, no shared memory.
//   * Fpad >= 64: one block per front, panels of 32 columns.
//     Forward is left-looking: for the 32 rows of a panel each of the 8 warps
//     takes the dot products of four rows' entries left of the panel with z
//     (contiguous reads along a row, the four rows' loads in flight together, a
//     butterfly of shuffles per row), then warp 0 solves the 32 x 32 diagonal
//     block (staged in shared memory) by shuffles.  z lives in the scratch
//     vector, so ncols has no upper limit.
//     Backward is right-looking: warp 0 solves the transposed diagonal block,
//     then thread t subtracts the panel's 32 rows times x from the running
//     right-hand sides of columns t, t+256, ... (again contiguous along a row,
//     and no reduction across threads).
//   * The block below the triangle, (nf - ncols) x ncols, has no recurrence.  For
//     a front where it is small the front's block does it; for a "heavy" front
//     it is cut into strips of 64 rows, one block each, in a launch of its own:
//     forward after the triangle (each row a dot product with z), backward
//     before it (each strip's partial L21^T y2 goes to scratch, and the front's
//     block adds the partials in strip order).
//   * A triangle of more than 512 columns would keep one SM busy for
//     milliseconds while the rest of the card idles (the root front of a 2-D
//     grid problem is one dense triangle).  Such a front is cut into column
//     blocks of 512, and the level's launches go in ROUNDS, one per column
//     block: forward, round r solves the 512 x 512 triangle of block r (one
//     thread block) and then its strips subtract block r's columns times z from
//     every row below, triangle rows of later blocks included; backward, rounds
//     run from the last block to the first, strips first.  All but 1/(2 blocks)
//     of a large triangle is then spread over the card.
// A level and direction is one launch for the small fronts, two per round
// (fronts >= 64, strips) and, forward, the accumulation.  Each launcher adds the
// kernels it launched to *launched.
//
// Left for later: 16-byte loads for the small fronts; the strips of a front with
// few columns use one lane in four; warp 0 solves a diagonal block while seven
// warps wait (no look-ahead); a round is two dependent launches.
#include <cuda_runtime.h>

#define THREADS 256
#define WARPS 8
#define PB 32            // panel width
#define STRIP 64         // rows of one strip
#define TW 8             // columns of a work-item table (long long)
#define FULL 0xffffffffu

// item tables (see linalg/sweep_kernels.py::build_sweep_level):
//   small : store offset, row-map offset, ncols offset, Fpad, fronts, -, -, -
//   big   : store offset, row-map offset, Fpad, c0, c1, nf, heavy, partials offset
//   strip : store offset, row-map offset, Fpad, c0, c1, first row, rows, partials offset
// c0..c1 is the item's column block; rounds[4 r .. 4 r + 4) (on the host) holds
// first big item, big items, first strip item, strip items of round r

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
// Fpad >= 64: rows below a triangle
// ---------------------------------------------------------------------------

// dot products of RPW rows (from row0; only the first nrows count) with
// z[k0..k1), all lanes of a warp together: the rows' loads are in flight at once
#define RPW 4            // rows a warp takes together: WARPS * RPW == PB
#define KU 4             // column steps of 32 whose loads are in flight together
#define RU 16            // rows whose loads are in flight together (backward)
template <typename T>
__device__ __forceinline__ void warp_dots(const T* F, int ld, const T* z, int k0, int k1,
                                          int row0, int nrows, T s[RPW])
{
    const int lane = threadIdx.x & 31;
    const T* Lr[RPW];
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
        Lr[q] = F + (size_t)(row0 + (q < nrows ? q : 0)) * ld;
        s[q] = (T)0;
    }
    // KU column steps at a time, their loads started before the first multiply
    for (int k = k0 + lane; k < k1; k += 32 * KU) {
        T zk[KU], l[RPW][KU];
#pragma unroll
        for (int u = 0; u < KU; ++u) {
            const int kk = k + 32 * u;
            const bool in = kk < k1;
            zk[u] = in ? z[kk] : (T)0;
#pragma unroll
            for (int q = 0; q < RPW; ++q) l[q][u] = in ? Lr[q][kk] : (T)0;
        }
#pragma unroll
        for (int u = 0; u < KU; ++u)
#pragma unroll
            for (int q = 0; q < RPW; ++q) s[q] += l[q][u] * zk[u];
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) s[q] = warp_sum(s[q]);
}

// forward: z[r] (-)= (row r of F, columns c0..c1) . z[c0..c1)  for nrows rows from r0
template <typename T>
__device__ __forceinline__ void fwd_rows(const T* F, int ld, int c0, int c1, int r0,
                                         int nrows, T* z, bool add)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int i = warp * RPW; i < nrows; i += WARPS * RPW) {
        const int cnt = (nrows - i < RPW) ? nrows - i : RPW;
        T s[RPW];
        warp_dots<T>(F, ld, z, c0, c1, r0 + i, cnt, s);
        if (lane == 0) {
#pragma unroll
            for (int q = 0; q < RPW; ++q)
                if (q < cnt) z[r0 + i + q] = add ? z[r0 + i + q] - s[q] : -s[q];
        }
    }
}

// backward: sum over the cn rows from r0 of F[r][j] * xs[r - r0]; xs holds 0 from
// cn up to the next multiple of RU.  RU rows at a time, their loads (one row
// pitch apart) started before the first multiply.
template <typename T>
__device__ __forceinline__ T bwd_colsum(const T* F, int ld, int r0, int cn, const T* xs,
                                        int j)
{
    const T* Lc = F + (size_t)r0 * ld + j;
    T s = (T)0;
    for (int i0 = 0; i0 < cn; i0 += RU) {
        T l[RU];
#pragma unroll
        for (int u = 0; u < RU; ++u) {
            const int i = (i0 + u < cn) ? i0 + u : cn - 1;
            l[u] = Lc[(size_t)i * ld];
        }
#pragma unroll
        for (int u = 0; u < RU; ++u) s += l[u] * xs[i0 + u];
    }
    return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sweep_fwd_strip(const T* store, T* work, const long long* __restrict__ table)
{
    const long long* it = table + (size_t)blockIdx.x * TW;
    const int c0 = (int)it[3];
    fwd_rows<T>(store + it[0], (int)it[2], c0, (int)it[4], (int)it[5], (int)it[6],
                work + it[1], c0 > 0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sweep_bwd_strip(const T* store, const T* y, const int* __restrict__ rows, T* part,
                const long long* __restrict__ table)
{
    __shared__ T ys[STRIP];
    const long long* it = table + (size_t)blockIdx.x * TW;
    const T* F = store + it[0];
    const int* fr = rows + it[1];
    const int ld = (int)it[2], c0 = (int)it[3], c1 = (int)it[4];
    const int r0 = (int)it[5], cn = (int)it[6];
    T* out = part + it[7];
    const int tid = threadIdx.x;
    if (tid < STRIP) ys[tid] = (tid < cn) ? y[fr[r0 + tid]] : (T)0;
    __syncthreads();
    for (int j = c0 + tid; j < c1; j += THREADS)
        out[j - c0] = bwd_colsum<T>(F, ld, r0, cn, ys, j);
}

// ---------------------------------------------------------------------------
// Fpad >= 64: the triangle of the columns c0..c1 of a front, one block
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
sweep_fwd_big(const T* store, T* y, const int* __restrict__ rows, T* work,
              const long long* __restrict__ table, T tiny)
{
    __shared__ T D[PB][PB + 1];
    __shared__ T red[PB];
    const long long* it = table + (size_t)blockIdx.x * TW;
    const T* F = store + it[0];
    const int* fr = rows + it[1];
    T* z = work + it[1];
    const int ld = (int)it[2], c0 = (int)it[3], c1 = (int)it[4], nf = (int)it[5];
    const bool heavy = it[6] != 0;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int bs = c0; bs < c1; bs += PB) {
        const int nb = (c1 - bs < PB) ? c1 - bs : PB;
        const int i0 = warp * RPW;
        // warp 0's right-hand side, asked for before the dots so that its
        // latency hides behind theirs
        T v = (T)0;
        int yr = 0;
        if (warp == 0 && lane < nb) {
            yr = fr[bs + lane];
            v = y[yr];
            if (c0 > 0) v += z[bs + lane];        // what earlier column blocks left here
        }
        {
            const int cnt = (nb - i0 < RPW) ? nb - i0 : RPW;     // <= 0: no row here
            T dq[RPW];
#pragma unroll
            for (int q = 0; q < RPW; ++q)
                dq[q] = (q < cnt && lane < nb)
                            ? F[(size_t)(bs + i0 + q) * ld + bs + lane] : (T)0;
            T s[RPW];
            if (cnt > 0) warp_dots<T>(F, ld, z, c0, bs, bs + i0, cnt, s);
#pragma unroll
            for (int q = 0; q < RPW; ++q) {
                if (q < cnt && lane == 0) red[i0 + q] = s[q];
                D[i0 + q][lane] = dq[q];
            }
        }
        __syncthreads();
        if (warp == 0) {
            if (lane < nb) v -= red[lane];
            T dl[PB];
#pragma unroll
            for (int j = 0; j < PB; ++j) dl[j] = D[lane][j];
#pragma unroll
            for (int j = 0; j < PB - 1; ++j) {
                const T zj = __shfl_sync(FULL, v, j);
                if (lane > j && lane < nb) v -= dl[j] * zj;
            }
            if (lane < nb) {
                const T d = D[lane][lane];
                z[bs + lane] = v;
                y[yr] = v / ((fabs(d) > tiny) ? d : (T)1);
            }
        }
        __syncthreads();
    }
    if (!heavy) fwd_rows<T>(F, ld, c0, c1, c1, nf - c1, z, false);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sweep_bwd_big(const T* store, T* y, const int* __restrict__ rows, T* work,
              const T* part, const long long* __restrict__ table)
{
    __shared__ T D[PB][PB + 1];
    __shared__ T xs[PB];
    __shared__ T ys[STRIP];
    const long long* it = table + (size_t)blockIdx.x * TW;
    const T* F = store + it[0];
    const int* fr = rows + it[1];
    T* acc = work + it[1];
    const int ld = (int)it[2], c0 = (int)it[3], c1 = (int)it[4], nf = (int)it[5];
    const bool heavy = it[6] != 0;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    // running right-hand sides of the columns c0..c1: y - (rows below)^T y
    if (heavy) {
        const T* ps = part + it[7];
        const int nstrips = (nf - c1 + STRIP - 1) / STRIP;
        const int w = c1 - c0;
        for (int j = c0 + tid; j < c1; j += THREADS) {
            T a = y[fr[j]];
            for (int s0 = 0; s0 < nstrips; s0 += 8) {
                T p[8];
#pragma unroll
                for (int u = 0; u < 8; ++u)
                    p[u] = (s0 + u < nstrips) ? ps[(size_t)(s0 + u) * w + (j - c0)] : (T)0;
#pragma unroll
                for (int u = 0; u < 8; ++u) a -= p[u];
            }
            acc[j] = a;
        }
    } else {
        for (int j = c0 + tid; j < c1; j += THREADS) acc[j] = y[fr[j]];
        for (int r0 = c1; r0 < nf; r0 += STRIP) {
            const int cn = (nf - r0 < STRIP) ? nf - r0 : STRIP;
            __syncthreads();
            if (tid < STRIP) ys[tid] = (tid < cn) ? y[fr[r0 + tid]] : (T)0;
            __syncthreads();
            for (int j = c0 + tid; j < c1; j += THREADS)
                acc[j] -= bwd_colsum<T>(F, ld, r0, cn, ys, j);
        }
    }
    for (int bs = c0 + ((c1 - c0 - 1) / PB) * PB; bs >= c0; bs -= PB) {
        const int nb = (c1 - bs < PB) ? c1 - bs : PB;
        for (int i = warp; i < PB; i += WARPS)
            D[i][lane] = (i < nb && lane < nb) ? F[(size_t)(bs + i) * ld + bs + lane] : (T)0;
        __syncthreads();
        if (warp == 0) {
            T v = (lane < nb) ? acc[bs + lane] : (T)0;
            T dl[PB];
#pragma unroll
            for (int i = 0; i < PB; ++i) dl[i] = D[i][lane];
#pragma unroll
            for (int i = PB - 1; i >= 1; --i) {
                const T xi = __shfl_sync(FULL, v, i);
                if (lane < i && i < nb) v -= dl[i] * xi;
            }
            if (lane < nb) y[fr[bs + lane]] = v;
            xs[lane] = (lane < nb) ? v : (T)0;
        }
        __syncthreads();
        for (int j = c0 + tid; j < bs; j += THREADS)
            acc[j] -= bwd_colsum<T>(F, ld, bs, nb, xs, j);
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
template <typename T>
static int launch_fwd(const void* store, void* y, const int* rows, const int* ncols,
                      const long long* small, int n_small, const long long* big,
                      const long long* strips, const int* rounds, int n_rounds,
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
    for (int r = 0; r < n_rounds; ++r) {
        const int* rd = rounds + 4 * r;
        if (rd[1] > 0) {
            sweep_fwd_big<T><<<rd[1], THREADS, 0, st>>>(
                (const T*)store, (T*)y, rows, (T*)work, big + (size_t)rd[0] * TW, (T)tiny);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
            ++*launched;
        }
        if (rd[3] > 0) {
            sweep_fwd_strip<T><<<rd[3], THREADS, 0, st>>>(
                (const T*)store, (T*)work, strips + (size_t)rd[2] * TW);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
            ++*launched;
        }
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
                      const long long* small, int n_small, const long long* big,
                      const long long* strips, const int* rounds, int n_rounds,
                      void* work, void* part, int n, int* launched, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaSuccess;
    for (int r = n_rounds - 1; r >= 0; --r) {
        const int* rd = rounds + 4 * r;
        if (rd[3] > 0) {
            sweep_bwd_strip<T><<<rd[3], THREADS, 0, st>>>(
                (const T*)store, (const T*)y, rows, (T*)part, strips + (size_t)rd[2] * TW);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
            ++*launched;
        }
        if (rd[1] > 0) {
            sweep_bwd_big<T><<<rd[1], THREADS, 0, st>>>(
                (const T*)store, (T*)y, rows, (T*)work, (const T*)part,
                big + (size_t)rd[0] * TW);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
            ++*launched;
        }
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
    const long long* small, int n_small, const long long* big,                      \
    const long long* strips, const int* rounds, int n_rounds, const int* acc_row,   \
    const int* acc_ptr, const int* acc_pos, int n_acc, void* work, double tiny,     \
    int* launched, void* stream
#define SWEEP_FWD_PASS                                                              \
    store, y, rows, ncols, small, n_small, big, strips, rounds, n_rounds, acc_row,  \
    acc_ptr, acc_pos, n_acc, work, tiny, launched, stream
#define SWEEP_BWD_ARGS                                                              \
    const void* store, void* y, const int* rows, const int* ncols,                  \
    const long long* small, int n_small, const long long* big,                      \
    const long long* strips, const int* rounds, int n_rounds, void* work,           \
    void* part, int n, int* launched, void* stream
#define SWEEP_BWD_PASS                                                              \
    store, y, rows, ncols, small, n_small, big, strips, rounds, n_rounds, work,     \
    part, n, launched, stream

extern "C" int sweep_fwd_f32(SWEEP_FWD_ARGS) { return launch_fwd<float>(SWEEP_FWD_PASS); }
extern "C" int sweep_fwd_f64(SWEEP_FWD_ARGS) { return launch_fwd<double>(SWEEP_FWD_PASS); }
extern "C" int sweep_bwd_f32(SWEEP_BWD_ARGS) { return launch_bwd<float>(SWEEP_BWD_PASS); }
extern "C" int sweep_bwd_f64(SWEEP_BWD_ARGS) { return launch_bwd<double>(SWEEP_BWD_PASS); }

extern "C" const char* sweep_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
