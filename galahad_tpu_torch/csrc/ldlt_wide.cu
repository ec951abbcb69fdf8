// Partial LDL^T of every wide front (Fpad > 128) of one tree level, in ONE
// persistent cooperative launch.
//
// Replaces, together with partial_ldlt.cu, the TPU kernel
// galahad_tpu/linalg/pallas_kernels.py::partial_ldlt_pallas (body _ldlt_kernel).
// That kernel stops at fronts of 128; wider fronts run the same elimination in
// its XLA twin galahad_tpu/linalg/supernodal_flat.py::_partial_ldlt_dyn (panels
// of 32 columns, the trailing product a matrix product), through the jitted scan
// _k_factor_scan.  Contract, for front f of the level's table (store offset,
// Fpad, ncols, nf; row-major Fpad x Fpad in the flat store):
//   * the first ncols columns are eliminated with no pivoting: column j ends as
//     d_j on the diagonal and the unit-lower L below it; a pivot with
//     |d| <= 16*tiny is divided by 1 instead;
//   * the trailing square [ncols, nf)^2 holds F22 - L21 D L21^T in BOTH
//     triangles (the extend-add reads the whole block);
//   * only rows and columns < nf (the front's real rows) exist: the kernel never
//     reads or writes an entry at or beyond nf, and never reads or writes an
//     entry above the diagonal in a row < ncols (unspecified by the contract).
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; 67 TFLOP/s float64 on the
// tensor cores, 67 TFLOP/s float32 outside them): at the flagship's fronts the
// bytes (each front's nf^2 entries read once and written once) and the
// operations are within 15 % of each other.  What it cost before this kernel was
// latency: two launches per 32-column panel and a library product per panel,
// 1,038 calls per factorization, each a few microseconds of work.
//
// Design for this card.  One launch per level of 128-thread blocks, as many as
// fit on the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs,
// fewer if the level has less work), launched with cudaLaunchCooperativeKernel
// so that the grid barrier of cooperative groups may be used.  The level's
// fronts are listed heaviest first (by panel count), so the fronts still active
// at panel step k are a prefix of the table; they step together, and a front
// drops out when its panels are done.  Per step k (b = 32 k):
//   1. strip: rows b+32 .. nf-1 of each active front are solved against the
//      factored 32 x 32 diagonal block, a thread per row, 128 rows per work
//      item, and go back into the store as L21.
//   -- grid barrier --
//   2. update: 64 x 64 tiles of the lower triangle of rows [b+32, nf) x columns
//      [b+32, ncols): A -= L21 D L21^T, only where later panels will read it.
//      The trailing square [ncols, nf)^2 is NOT touched here: it takes all
//      ncols columns in one pass at the end (phase 3), so a front that keeps a
//      large Schur block reads and writes it once instead of once per panel.
//      Look-ahead: the first work items of the step are the tile (0,0) of each
//      front, and the block that updates it factors the next 32 x 32 diagonal
//      block (which lies inside it) at once, in shared memory: the next step
//      starts with its strips.
//   -- grid barrier --
// then, after the last step and one more barrier,
//   3. Schur: 64 x 64 tiles of the lower triangle of [ncols, nf)^2, each summing
//      over all ncols eliminated columns in chunks of 32, and writing every
//      entry also to its mirror place in the upper triangle.
// A tile keeps its entries in registers in the accumulator layout of mma.sync
// (four warps, a 32 x 32 quarter each; the quarter above the diagonal of a
// diagonal tile is skipped).  Its operands (64 rows x 32 columns of L on each
// side, and the 32 pivots) are staged in shared memory with cp.async,
// double-buffered: the next chunk or tile loads while this one's product runs.
// float64 runs mma.sync.m8n8k4 on the tensor cores, float32 the same layout in
// FFMA (no TF32).  Loads of the diagonal and strip phases are issued as
// unrolled batches, so that their latencies overlap, and a reciprocal replaces
// the division on the pivot chain.
//
// Work items go to blocks through one atomic counter per phase (a block takes the
// next item when it is free), but an item's result does not depend on the block
// that computes it: every entry's sum runs over k in ascending order inside one
// warp, and nothing is added atomically: two runs give the same bits.  Arithmetic per entry is the
// plain version's (a -= l_i * (dn * l_k) inside a panel, (l_i * d_k) * l_k in the
// products), up to fused multiply-adds, the tensor cores' order inside a k-group
// of 4, and l = a * (1/dn) in place of a / dn.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define THREADS 128
#define WARPS 4
#define PB 32            // panel width, and the depth of one staged chunk
#define TM 64            // product tile (rows and columns)
#define LDS 36           // padded row of a staged operand (16-byte multiple, no conflicts)
#define STRIP 128        // rows of one strip item (a thread per row)
#define ROW 4            // int64 entries per front in the table

enum { STEP = 0, SCHUR = 1 };

__device__ __forceinline__ long long cdiv(long long a, long long b)
{
    return a > 0 ? (a + b - 1) / b : 0;
}

__device__ __forceinline__ long long tri(long long t) { return t * (t + 1) / 2; }

// tiles of the lower triangle of a block of tR tile rows by tC tile columns
// whose diagonal starts at tile (0,0): rows I < tR, columns J <= min(I, tC-1)
__device__ __forceinline__ long long tiles_of(long long tR, long long tC)
{
    return tC > 0 ? tri(tC) + (tR - tC) * tC : 0;
}

__device__ __forceinline__ void tile_decode(long long q, long long tC, int* I, int* J)
{
    if (q < tri(tC)) {
        long long i = (long long)((sqrt(8.0 * (double)q + 1.0) - 1.0) * 0.5);
        while (tri(i + 1) <= q) ++i;
        while (tri(i) > q) --i;
        *I = (int)i;
        *J = (int)(q - tri(i));
    } else {
        q -= tri(tC);
        *I = (int)(tC + q / tC);
        *J = (int)(q % tC);
    }
}

struct Front {
    long long off, fpad, ncols, nf;
};

__device__ __forceinline__ Front front_at(const long long* __restrict__ tab, int f)
{
    const long long* r = tab + (size_t)ROW * f;
    return Front{__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3)};
}

// fronts still active at panel b (a prefix of the table)
__device__ int active_fronts(const long long* __restrict__ tab, int n, int b)
{
    int c = 0;
    while (c < n && __ldg(tab + (size_t)ROW * c + 2) > b) ++c;
    return c;
}

// correctly rounded reciprocal: a multiply by it takes the place of a division on
// the elimination's sequential chain (at most an ulp or so from the quotient)
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// The work queue of a phase: the next item index, one counter for the grid.  A
// block takes its next item when it is free (so the blocks that factor a
// look-ahead diagonal block take fewer tiles); which block computes an item does
// not change its bits.
__device__ __forceinline__ long long grab(unsigned long long* ctr, long long* slot)
{
    if (threadIdx.x == 0) *slot = (long long)atomicAdd(ctr, 1ull);
    __syncthreads();
    const long long v = *slot;
    __syncthreads();
    return v;
}

// --------------------------------------------------------------------------
// 32 x 32 diagonal block of panel b, by the whole block: the lower triangle in
// shared memory S (32 x 33), a thread per entry of each column step, three
// barriers per column; only the nact active columns are updated and written.
// (A first design, one warp with a row per lane and 64-bit shuffles, was
// markedly slower on the card: this factor lies on the root's sequential chain.)
// --------------------------------------------------------------------------
template <typename T>
__device__ void factor_diag(T* F, long long fp, int b, int nact, int nf, T tiny, T* S)
{
    constexpr int PER = PB * PB / THREADS;      // entries of the block per thread
    const int tid = threadIdx.x;
    const int nr = min(PB, nf - b);
    {
        T v[PER];
#pragma unroll
        for (int m = 0; m < PER; ++m) {
            const int e = tid + THREADS * m, r = e / PB, c = e % PB;
            v[m] = (r < nr && c <= r) ? F[(size_t)(b + r) * fp + b + c] : (T)0;
        }
#pragma unroll
        for (int m = 0; m < PER; ++m) {
            const int e = tid + THREADS * m;
            S[(e / PB) * 33 + e % PB] = v[m];
        }
    }
    __syncthreads();
    for (int j = 0; j < nact; ++j) {
        const T d = S[j * 33 + j];
        const T dn = (fabs(d) > tiny) ? d : (T)1;
        T l = (T)0;
        if (tid > j && tid < PB) l = S[tid * 33 + j] * rcp(dn);
        __syncthreads();
        if (tid > j && tid < PB) S[tid * 33 + j] = l;
        __syncthreads();
#pragma unroll
        for (int m = 0; m < PER; ++m) {
            const int e = tid + THREADS * m, r = e / PB, k = e % PB;
            if (k > j && k <= r && k < nact) S[r * 33 + k] -= S[r * 33 + j] * (dn * S[k * 33 + j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) {
        const int e = tid + THREADS * m, r = e / PB, c = e % PB;
        if (r < nr && c <= r && c < nact) F[(size_t)(b + r) * fp + b + c] = S[r * 33 + c];
    }
    __syncthreads();
}

// --------------------------------------------------------------------------
// 1. strips: rows b+32 .. nf-1 against the factored diagonal block
// --------------------------------------------------------------------------
template <typename T>
__device__ void strip_phase(T* store, const long long* __restrict__ tab, int nact_f, int b,
                            T* smem, T tiny, unsigned long long* ctr, long long* slot)
{
    constexpr int PER = STRIP / WARPS;   // rows a warp stages
    T* Mt = smem;                        // Mt[j][k] = dn_j * L11[k][j], k > j
    T* dnv = Mt + PB * 33;
    T* rinv = dnv + PB;                  // 1 / dn_j
    T* Ts = rinv + PB;                   // STRIP x 33
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    long long total = 0;
    for (int f = 0; f < nact_f; ++f) total += cdiv(front_at(tab, f).nf - b - PB, STRIP);
    for (long long it = grab(ctr, slot); it < total; it = grab(ctr, slot)) {
        long long q = it;
        int f = 0;
        Front fr;
        for (;; ++f) {
            fr = front_at(tab, f);
            const long long s = cdiv(fr.nf - b - PB, STRIP);
            if (q < s) break;
            q -= s;
        }
        const long long fp = fr.fpad;
        const int nf = (int)fr.nf;
        const int nact = (int)min((long long)PB, fr.ncols - b);
        T* F = store + fr.off;
        const int r0 = b + PB + (int)q * STRIP;
        const int nrows = min(STRIP, nf - r0);
        {
            T v[PER];
#pragma unroll
            for (int m = 0; m < PER; ++m) {
                const int i = warp + WARPS * m;
                v[m] = (i < nrows) ? F[(size_t)(r0 + i) * fp + b + lane] : (T)0;
            }
            T w[PB / WARPS];
#pragma unroll
            for (int m = 0; m < PB / WARPS; ++m) {
                const int i = warp + WARPS * m;
                w[m] = (i > lane) ? F[(size_t)(b + i) * fp + b + lane] : (T)0;
            }
            if (tid < PB) {
                const T d = F[(size_t)(b + tid) * fp + b + tid];
                const T dn = (fabs(d) > tiny) ? d : (T)1;
                dnv[tid] = dn;
                rinv[tid] = rcp(dn);
            }
#pragma unroll
            for (int m = 0; m < PER; ++m) {
                const int i = warp + WARPS * m;
                if (i < nrows) Ts[i * 33 + lane] = v[m];
            }
            __syncthreads();
            const T dl = dnv[lane];
#pragma unroll
            for (int m = 0; m < PB / WARPS; ++m)
                Mt[lane * 33 + warp + WARPS * m] = dl * w[m];
        }
        __syncthreads();
        if (tid < nrows) {
            T a[PB];
#pragma unroll
            for (int k = 0; k < PB; ++k) a[k] = Ts[tid * 33 + k];
#pragma unroll
            for (int j = 0; j < PB; ++j) {
                if (j >= nact) break;
                const T x = a[j] * rinv[j];
                a[j] = x;
#pragma unroll
                for (int k = j + 1; k < PB; ++k) a[k] -= x * Mt[j * 33 + k];
            }
#pragma unroll
            for (int k = 0; k < PB; ++k) Ts[tid * 33 + k] = a[k];
        }
        __syncthreads();
        if (lane < nact)
            for (int i = warp; i < nrows; i += WARPS)
                F[(size_t)(r0 + i) * fp + b + lane] = Ts[i * 33 + lane];
        __syncthreads();
    }
}

// --------------------------------------------------------------------------
// 2./3. products: C -= L_rows D L_cols^T on 64 x 64 tiles
// --------------------------------------------------------------------------
struct Tile {
    int f, I, J;
    bool ok, head;       // head: a front's tile (0,0) of a step, which carries the look-ahead
};

// rows / columns of the product phase of front fr: tR x tC tile grid
__device__ __forceinline__ void grid_of(int mode, const Front& fr, int b, long long* tR,
                                        long long* tC)
{
    if (mode == STEP) {
        *tR = cdiv(fr.nf - b - PB, TM);
        *tC = cdiv(fr.ncols - b - PB, TM);
    } else {
        *tR = *tC = (fr.ncols > 0) ? cdiv(fr.nf - fr.ncols, TM) : 0;
    }
}

// fronts of the phase: the active prefix in a step, all in the Schur phase;
// a step first lists one head item per active front
__device__ Tile tile_at(int mode, const long long* __restrict__ tab, int nfr, int b,
                        long long it)
{
    const int heads = mode == STEP ? nfr : 0;
    if (it < heads) {
        const Front fr = front_at(tab, (int)it);
        return Tile{(int)it, 0, 0, fr.ncols > b + PB, true};
    }
    long long q = it - heads;
    for (int f = 0; f < nfr; ++f) {
        long long tR, tC;
        grid_of(mode, front_at(tab, f), b, &tR, &tC);
        const long long n = tiles_of(tR, tC) - (mode == STEP && tC > 0 ? 1 : 0);
        if (q < n) {
            int I, J;
            tile_decode(mode == STEP ? q + 1 : q, tC, &I, &J);
            return Tile{f, I, J, true, false};
        }
        q -= n;
    }
    return Tile{0, 0, 0, false, false};
}

__device__ long long phase_items(int mode, const long long* __restrict__ tab, int nfr, int b)
{
    long long total = mode == STEP ? nfr : 0;
    for (int f = 0; f < nfr; ++f) {
        long long tR, tC;
        grid_of(mode, front_at(tab, f), b, &tR, &tC);
        total += tiles_of(tR, tC) - (mode == STEP && tC > 0 ? 1 : 0);
    }
    return total;
}

// what a tile computes: C rows [r0, r0+64) x columns [c0, c0+64), entries with
// r < nf, c < cmax, c <= r; the sum over columns kbase + [0, 32 nch), of which
// those < klim are eliminated
struct Geo {
    long long r0, c0, cmax, kbase, klim, fp, nf;
    int nch;
};

__device__ __forceinline__ Geo geo_of(int mode, const Front& fr, int b, const Tile& tl)
{
    Geo g;
    g.fp = fr.fpad;
    g.nf = fr.nf;
    g.klim = fr.ncols;
    if (mode == STEP) {
        g.r0 = b + PB + (long long)TM * tl.I;
        g.c0 = b + PB + (long long)TM * tl.J;
        g.cmax = fr.ncols;
        g.kbase = b;
        g.nch = 1;
    } else {
        g.r0 = fr.ncols + (long long)TM * tl.I;
        g.c0 = fr.ncols + (long long)TM * tl.J;
        g.cmax = fr.nf;
        g.kbase = 0;
        g.nch = (int)cdiv(fr.ncols, PB);
    }
    return g;
}

// stage chunk kc of a tile: rows r0.. and c0.. of columns kbase+32kc .. +31
// (zero-filled at or beyond nf and klim) and the chunk's diagonal entries
template <typename T>
__device__ void stage(const T* F, const Geo& g, int kc, T* buf, T* dbuf)
{
    constexpr int E = 16 / (int)sizeof(T);       // elements per 16-byte chunk
    constexpr int CH = PB / E;                   // chunks per operand row
    const long long col0 = g.kbase + (long long)PB * kc;
    for (int c = threadIdx.x; c < 2 * TM * CH; c += THREADS) {
        const int op = c / (TM * CH);
        const int rem = c - op * TM * CH;
        const int i = rem / CH, ch = rem - i * CH;
        const long long row = (op ? g.c0 : g.r0) + i;
        const long long cs = col0 + ch * E;
        long long nbytes = row < g.nf ? (g.klim - cs) * (long long)sizeof(T) : 0;
        nbytes = nbytes < 0 ? 0 : (nbytes > 16 ? 16 : nbytes);
        const T* src = F + (nbytes ? row * g.fp + cs : 0);
        cp_async16(buf + (op * TM + i) * LDS + ch * E, src, (int)nbytes);
    }
    if (threadIdx.x < PB) {
        const long long k = col0 + threadIdx.x;
        const bool on = k < g.klim;
        const unsigned s = (unsigned)__cvta_generic_to_shared(dbuf + threadIdx.x);
        if constexpr (sizeof(T) == 8)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                         :: "r"(s), "l"(F + (on ? k * g.fp + k : 0)), "r"(on ? 8 : 0));
        else
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                         :: "r"(s), "l"(F + (on ? k * g.fp + k : 0)), "r"(on ? 4 : 0));
    }
}

__device__ __forceinline__ void mma_f64(double& c0, double& c1, double a, double b)
{
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                 "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
                 : "+d"(c0), "+d"(c1) : "d"(a), "d"(b));
}

// acc -= (A D) B^T for one staged chunk; A, B are 64 x LDS, d the chunk's diagonal
// (a pivot with |d| <= tiny counts as 1; columns past the eliminated ones were
// staged as zeros in A and B)
template <typename T>
__device__ __forceinline__ void chunk_product(T (&acc)[4][4][2], const T* A, const T* B,
                                              const T* d, int wr, int wc, int g, int t, T tiny)
{
    if constexpr (sizeof(T) == 8) {
#pragma unroll
        for (int ks = 0; ks < PB / 4; ++ks) {
            double dk = d[4 * ks + t];
            dk = (fabs(dk) > tiny) ? dk : 1.0;
            double a[4], bb[4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) a[mi] = -(A[(wr + 8 * mi + g) * LDS + 4 * ks + t] * dk);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) bb[ni] = B[(wc + 8 * ni + g) * LDS + 4 * ks + t];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
                    mma_f64(acc[mi][ni][0], acc[mi][ni][1], a[mi], bb[ni]);
        }
    } else {
#pragma unroll 4
        for (int k = 0; k < PB; ++k) {
            T dk = d[k];
            dk = (fabs(dk) > tiny) ? dk : (T)1;
            T a[4], bb[4][2];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) a[mi] = -(A[(wr + 8 * mi + g) * LDS + k] * dk);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int e = 0; e < 2; ++e) bb[ni][e] = B[(wc + 8 * ni + 2 * t + e) * LDS + k];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        acc[mi][ni][e] = fmaf(a[mi], bb[ni][e], acc[mi][ni][e]);
        }
    }
}

template <int mode, typename T>
__device__ void product_phase(T* store, const long long* __restrict__ tab, int nfr,
                              int b, T* smem, T tiny, unsigned long long* ctr, long long* slot)
{
    const long long total = phase_items(mode, tab, nfr, b);
    long long it = grab(ctr, slot);
    if (it >= total) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
    T* dsm = smem + 4 * TM * LDS;                 // the two buffers' pivots
    auto bufp = [&](int k) { return smem + k * 2 * TM * LDS; };
    int buf = 0;
    Tile cur = tile_at(mode, tab, nfr, b, it);
    Front fc = front_at(tab, cur.f);
    Geo gc = geo_of(mode, fc, b, cur);
    if (cur.ok) stage(store + fc.off, gc, 0, bufp(buf), dsm + buf * PB);
    cp_async_commit();
    while (it < total) {
        const long long itn = grab(ctr, slot);
        const Tile nxt = itn < total ? tile_at(mode, tab, nfr, b, itn)
                                     : Tile{0, 0, 0, false, false};
        const Front fn = front_at(tab, nxt.f);
        const Geo gn = geo_of(mode, fn, b, nxt);
        if (!cur.ok) {
            // nothing staged for this item: stage the next one in its place
            if (nxt.ok) stage(store + fn.off, gn, 0, bufp(buf), dsm + buf * PB);
            cp_async_commit();
        } else {
            T* F = store + fc.off;
            const bool skip = cur.I == cur.J && warp == 1;     // above the diagonal
            const long long rb = gc.r0 + wr + g, cb = gc.c0 + wc + 2 * t;
            T acc[4][4][2];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const long long r = rb + 8 * mi, c = cb + 8 * ni + e;
                        acc[mi][ni][e] = (!skip && r < gc.nf && c < gc.cmax && c <= r)
                                         ? F[r * gc.fp + c] : (T)0;
                    }
            for (int kc = 0; kc < gc.nch; ++kc) {
                if (kc + 1 < gc.nch)
                    stage(F, gc, kc + 1, bufp(buf ^ 1), dsm + (buf ^ 1) * PB);
                else if (nxt.ok)
                    stage(store + fn.off, gn, 0, bufp(buf ^ 1), dsm + (buf ^ 1) * PB);
                cp_async_commit();
                cp_async_wait<1>();
                __syncthreads();
                if (!skip)
                    chunk_product(acc, bufp(buf), bufp(buf) + TM * LDS, dsm + buf * PB,
                                  wr, wc, g, t, tiny);
                __syncthreads();
                buf ^= 1;
            }
            if (!skip) {
#pragma unroll
                for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const long long r = rb + 8 * mi, c = cb + 8 * ni + e;
                            if (r < gc.nf && c < gc.cmax && c <= r) {
                                F[r * gc.fp + c] = acc[mi][ni][e];
                                if (mode == SCHUR && c < r) F[c * gc.fp + r] = acc[mi][ni][e];
                            }
                        }
            }
            if (cur.head && fc.ncols > b + PB) {
                // the next panel's diagonal block lies in this tile: factor it now,
                // in the buffer that no stage is loading into
                __syncthreads();
                factor_diag(F, fc.fpad, b + PB, (int)min((long long)PB, fc.ncols - b - PB),
                            (int)fc.nf, tiny, bufp(buf ^ 1));
            }
            __syncthreads();
        }
        cur = nxt;
        fc = fn;
        gc = gn;
        it = itn;
    }
    cp_async_wait<0>();
    __syncthreads();
}

// --------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) ldlt_wide_kernel(
    T* store, const long long* __restrict__ tab, int n_fronts, int steps, T tiny,
    unsigned long long* ctrs)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ long long slot;
    T* smem = reinterpret_cast<T*>(smem_raw);
    cg::grid_group grid = cg::this_grid();
    // phase p takes its items from ctrs[p % 3]; block 0 clears the counter of
    // phase p+1 while phase p runs (its last use, phase p-2, ended two barriers ago)
    int p = 0;
    auto next_phase = [&]() {
        ++p;
        if (blockIdx.x == 0 && threadIdx.x == 0) ctrs[(p + 1) % 3] = 0ull;
        return ctrs + p % 3;
    };
    if (blockIdx.x == 0 && threadIdx.x < 3) ctrs[threadIdx.x] = 0ull;

    // the diagonal block of the first panel, a block per front
    const int n0 = active_fronts(tab, n_fronts, 0);
    for (int f = blockIdx.x; f < n0; f += gridDim.x) {
        const Front fr = front_at(tab, f);
        factor_diag(store + fr.off, fr.fpad, 0, (int)min((long long)PB, fr.ncols),
                    (int)fr.nf, tiny, smem);
    }
    for (int k = 0; k < steps; ++k) {
        const int b = k * PB;
        const int na = active_fronts(tab, n_fronts, b);
        grid.sync();
        strip_phase(store, tab, na, b, smem, tiny, next_phase(), &slot);
        grid.sync();
        product_phase<STEP>(store, tab, na, b, smem, tiny, next_phase(), &slot);
    }
    grid.sync();
    product_phase<SCHUR>(store, tab, n_fronts, 0, smem, tiny, next_phase(), &slot);
}

template <typename T>
static size_t smem_bytes()
{
    const size_t prod = (4 * TM * LDS + 2 * PB) * sizeof(T);
    const size_t strip = (PB * 33 + 2 * PB + STRIP * 33) * sizeof(T);
    const size_t diag = PB * 33 * sizeof(T);
    return prod > strip ? (prod > diag ? prod : diag) : (strip > diag ? strip : diag);
}

template <typename T>
static int launch(void* store, const long long* tab, int n_fronts, int steps, int max_items,
                  double tiny, void* counters, int* launched, void* stream)
{
    if (n_fronts <= 0 || steps <= 0) return 0;
    static int blocks_per_sm[64];          // per device: 0 = not asked yet
    static int sms[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    const size_t smem = smem_bytes<T>();
    if (blocks_per_sm[dev] == 0) {
        err = cudaFuncSetAttribute(ldlt_wide_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        int nb = 0, ns = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, ldlt_wide_kernel<T>, THREADS,
                                                            smem);
        if (err != cudaSuccess) return (int)err;
        err = cudaDeviceGetAttribute(&ns, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
        if (nb <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
        sms[dev] = ns;
        blocks_per_sm[dev] = nb;
    }
    int grid = blocks_per_sm[dev] * sms[dev];
    if (max_items > 0 && max_items < grid) grid = max_items;
    T* st = (T*)store;
    T tn = (T)tiny;
    unsigned long long* ctrs = (unsigned long long*)counters;
    void* args[] = {&st, (void*)&tab, &n_fronts, &steps, &tn, &ctrs};
    err = cudaLaunchCooperativeKernel((const void*)ldlt_wide_kernel<T>, dim3(grid),
                                      dim3(THREADS), args, smem, (cudaStream_t)stream);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return (int)err;
}

// counters: 3 int64 of device memory the call may overwrite (the phases' work queues)
extern "C" int ldlt_wide_f32(void* store, const long long* tab, int n_fronts, int steps,
                             int max_items, double tiny, void* counters, int* launched,
                             void* stream)
{
    return launch<float>(store, tab, n_fronts, steps, max_items, tiny, counters, launched,
                         stream);
}

extern "C" int ldlt_wide_f64(void* store, const long long* tab, int n_fronts, int steps,
                             int max_items, double tiny, void* counters, int* launched,
                             void* stream)
{
    return launch<double>(store, tab, n_fronts, steps, max_items, tiny, counters, launched,
                          stream);
}

extern "C" const char* ldlt_wide_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
