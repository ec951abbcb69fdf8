// Block-tridiagonal Cholesky factorization and solve, one launch each.
//
// Replaces galahad_tpu/linalg/banded.py::block_tridiag_cholesky (a lax.scan of
// one dependent step per block row) and ::block_tridiag_solve (a forward and a
// backward lax.scan), the KKT factorization and solves of the banded IPM
// (galahad_tpu/qp/ipm_banded.py).  The matrix is block tridiagonal with (b, b)
// blocks, 1 <= b <= 32, D (k, b, b) on the diagonal and L (k-1, b, b) below it,
// row-major, contiguous.  Contract, as the plain versions in
// galahad_tpu_torch/linalg/banded.py:
//   factor:  Ld_0 = chol(D_0);  Lo_{i-1} = L_{i-1} Ld_{i-1}^-T,
//            Ld_i = chol(sym(D_i - Lo_{i-1} Lo_{i-1}'));  a block whose factor
//            has a diagonal entry that is not finite or not positive becomes
//            the identity and clears ok (the recurrence goes on with it)
//   solve:   forward  y_i = Ld_i^-1 (r_i - Lo_{i-1} y_{i-1}),
//            backward x_i = Ld_i^-T (y_i - Lo_i' x_{i+1}),  per right-hand side
//
// What bounds it on an H100 SXM: neither bytes nor operations, but chains of
// dependent steps.  At k = 2,500, b = 8, f64 a factorization moves 5.1 MB
// (1.5 us at 3.35 TB/s) and a solve 2.9 MB (0.9 us); at k = 125,000 a
// factorization moves 256 MB (0.077 ms).
//
// Both kernels are compiled for a block size B in {1, 2, 4, 8, 16, 32}; any
// other b runs in the next B, padded in shared memory with an identity
// diagonal and zero coupling (which gives the same leading factor and
// solution), so no index of the arithmetic holds a run-time b.  Each block has
// one IO warp beside the warps of the chain.  It copies the blocks of the
// steps ahead into a ring of mbarrier-guarded slots (one cp.async.bulk per
// run of contiguous blocks where b == B and the pointers are 16-byte aligned,
// else element copies), prepares them off the chain, hands each over by a
// named barrier, and writes the chain's results to device memory, so the
// chain issues no copy and no global store.
//
// Factorization: the recurrence S_i = D_i - Lo_{i-1} Lo_{i-1}' is nonlinear,
// so a chunk cannot push unit inflows through it as the solve does; but the
// Schur complement composes.  The k block rows are cut into P chunks of m
// rows, the last row of chunk j its separator s_j, and each chunk runs on a
// block of its own, in one launch:
//   1. every middle chunk at once: the Cholesky of its interior rows (an SPD
//      principal submatrix, from no inflow) with the spike of its coupling to
//      s_{j-1}, folded onto its two end rows: E_j on s_{j-1}, F_j between
//      s_{j-1} and s_j, G_j = D_{s_j} less the interior's share; chunk 0 runs
//      the contract's chain and gives S at s_0 (Sigma_0);
//   2. one hop a chunk, in chunk order: Sigma_j = G_j - F_j' (Sigma_{j-1} -
//      E_j)^-1 F_j, a b x b Cholesky, a triangular solve and a product
//      (Sigma_{j-1} - E_j is a Schur complement of an SPD matrix);
//   3. each chunk as soon as its inflow is published: the contract's chain
//      from Ld_{s_{j-1}} = chol(Sigma_{j-1}), the same operations in the
//      same order as the sequential chain, so only the inflow carries the
//      partition's rounding.  Each separator's Ld is written once, by the
//      chunk after it, the one chunk that uses it.
// A factorization is about (c1 + c3) m row steps and P hops instead of k
// steps (banded_kernels.default_factor_chunk).  One chunk is the sequential
// chain itself, with no workspace; so are blocks of 17..32 (CHUNKED_MAX_B).
// In a step (lane r owns row r of the block) the IO warp repacks D_i and
// L_{i-1} into rows of B+1 entries (lanes reading one column of a block hit
// distinct banks).  Each Cholesky column is a round of rsqrt, a product and
// an fma: the pivot's rsqrt(p) gives l_rj = s_rj rsqrt(p) and d = p rsqrt(p)
// and is kept as the reciprocal of the diagonal, so the next step's
// triangular solve only multiplies, and every lane forms the next pivot
// itself.  Lo_{i-1} is kept transposed, so that S's B sums run side by side.
// Chunks are handed out by an atomic ticket and wait only on earlier tickets,
// each wait bounded as the solve's.  A pivot that fails in any phase of a
// chunked launch makes the block that finishes last rerun the sequential
// chain over all k rows in the same launch: the partition cannot reproduce
// the identity-and-go-on rule downstream of a failed block.
//
// Solve: the recurrences are linear, so the k block rows are cut into P
// chunks of m rows that run on many SMs at once.  Per direction:
//   1. a chunk with an inflow (every chunk but the first in that direction)
//      runs its substitution with zero inflow, giving yh at its last row, and
//      pushes the B unit inflows through the same substitution, giving the
//      transfer T_j (B x B) with y_last = yh + T_j y_inflow;
//   2. in chunk order, y_last = yh + T_j y_inflow as soon as the chunk before
//      has published its y_last, then publishes its own;
//   3. the chunk runs its substitution again from its true inflow: inside a
//      chunk the same operations in the same order as the sequential solve,
//      so only the inflow carries the partitioning's rounding.
// One thread holds one of the B + 1 vectors of phase 1 whole, so a row step
// is register arithmetic on blocks read by broadcast, with no shuffle; the
// rows go R to a stage, for which the IO warp forms the reciprocals of
// diag(Ld_i) and transposes the forward couplings.  A solve is about
// 4 m + 2 P dependent steps instead of 2 k.  Work items (the P forward chunks, then the P backward
// chunks from the last) are handed out by an atomic ticket; an item waits
// only on items of earlier tickets, which are held by running blocks, so
// every wait ends without a grid barrier, for any grid size.  A published
// row is its B values themselves, stored relaxed into a buffer of all-one
// bits that no published value keeps (one L2 round trip a hop, no flag);
// the backward item of a chunk waits for the forward item's flag (release /
// acquire) before it reads the chunk's y.  A wait is bounded: after WAIT_NS
// it sets the host-visible status word, takes NaN for what it waited for,
// and goes on (the wrapper raises at its next call).  The workspace is set
// by one cudaMemsetAsync per call.
//
// No atomics on values and one fixed order of operations, whatever block
// took which item: two runs give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr unsigned FULL = 0xffffffffu;
constexpr int NS = 3;                         // the factor's stages of the chain's ring
constexpr int NL = 4;                         // its landing slots: copies in flight ahead
constexpr int BAR_FULL = 1, BAR_DONE = BAR_FULL + NS;   // its named barriers: FULL + s, DONE + s
constexpr unsigned long long WAIT_NS = 10000000000ull;   // a wait gives up after 10 s
// the factor runs in chunks for blocks of up to 16; at 32 the chunks' spike
// and hop spill registers, and compiling them doubles the file's build
constexpr int CHUNKED_MAX_B = 16;

// ---------------------------------------------------------------------------
// Hopper primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p)
{
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

// arrive (one of the barrier's count) and expect `bytes` of bulk copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

// arrive when this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
                 : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity)
{
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns()
{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Waits for a landing slot's copies.  They always land; a slot that does not
// within WAIT_NS is a fault of the kernel, and the kernel traps (the next
// synchronisation raises) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity)
{
    if (mbar_try_wait(bar, parity)) return;
    const unsigned long long t0 = global_ns();
    while (!mbar_try_wait(bar, parity))
        if (global_ns() - t0 > WAIT_NS) __trap();
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem)
{
    if constexpr (sizeof(T) == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(smem)), "l"(gmem)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(smem)), "l"(gmem)
                     : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count)
{
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count)
{
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p)
{
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v)
{
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ bool unpublished(double x) { return __double_as_longlong(x) == -1ll; }
__device__ __forceinline__ bool unpublished(float x) { return __float_as_int(x) == -1; }

__device__ __forceinline__ double ld_relaxed(const double* p)
{
    double v;
    asm volatile("ld.relaxed.gpu.global.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ float ld_relaxed(const float* p)
{
    float v;
    asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void st_relaxed(double* p, double v)
{
    asm volatile("st.relaxed.gpu.global.f64 [%0], %1;" ::"l"(p), "d"(v) : "memory");
}
__device__ __forceinline__ void st_relaxed(float* p, float v)
{
    asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

// Waits for the flag to be 1; false (and the status word set) if it gave up.
__device__ bool wait_flag(const int* flag, int* status)
{
    if (ld_acquire(flag) == 1) return true;
    const unsigned long long t0 = global_ns();
    for (;;) {
        if (ld_acquire(flag) == 1) return true;
        if (global_ns() - t0 > WAIT_NS) {
            *(volatile int*)status = 1;
            __threadfence_system();
            return false;
        }
    }
}

// the warp's index, known to the compiler to be the same in all its lanes (so
// that shuffles under a branch on it need no convergence handling)
__device__ __forceinline__ int warp_index()
{
    return __shfl_sync(FULL, (int)(threadIdx.x >> 5), 0);
}

__device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsq(double x) { return rsqrt(x); }

// N entries at p (shared memory, 16-byte aligned where N entries fill 16-byte
// words) into registers, 16 bytes a load where they fill whole words: a
// block row read by broadcast costs N / 2 (f64) or N / 4 (f32) loads.
template <typename T, int N>
__device__ __forceinline__ void lds_row(const T* p, T (&v)[N])
{
    if constexpr ((N * sizeof(T)) % 16 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 16 / (int)sizeof(T)) {
            if constexpr (sizeof(T) == 8) {
                const double2 w = *reinterpret_cast<const double2*>(p + i);
                v[i] = w.x;
                v[i + 1] = w.y;
            } else {
                const float4 w = *reinterpret_cast<const float4*>(p + i);
                v[i] = w.x;
                v[i + 1] = w.y;
                v[i + 2] = w.z;
                v[i + 3] = w.w;
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = p[i];
    }
}

// The IO warp copies the b x b block at src into the B x B block at dst
// (row-major); beyond b, `diag` on the diagonal (1 for a diagonal block, 0
// for a coupling block) and 0 elsewhere.  Element copies: for b < B, or
// pointers that a bulk copy does not take.
template <typename T, int B>
__device__ __forceinline__ void land_elements(T* dst, const T* src, int b, T diag, int lane)
{
    for (int e = lane; e < B * B; e += 32) {
        const int r = e / B, c = e % B;
        if (r < b && c < b)
            cp_async(dst + e, src + r * b + c);
        else
            dst[e] = r == c ? diag : T(0);
    }
}

// The IO warp repacks the B x B block at src (row-major) into rows of P = B+1.
template <typename T, int B>
__device__ __forceinline__ void repack(T* dst, const T* src, int lane)
{
    for (int e = lane; e < B * B; e += 32) dst[(e / B) * (B + 1) + e % B] = src[e];
}

// ---------------------------------------------------------------------------
// Factorization: chunks of the chain on many blocks, one IO warp each
// ---------------------------------------------------------------------------
//
// A work item is a chunk j of the rows [a, e] (chunks of m rows, a = j m; its
// last row e is the separator s_j).  Its chain warp walks a sequence of steps
// that its IO warp feeds and drains as one stream (the landing ring counts
// on across the item and a rerun):
//   * the first chunk: the contract's chain over rows 0 .. e, whose last step
//     forms S at s_0 (Sigma_0) and publishes it instead of factoring it;
//   * a middle chunk, phase 1: the chain over its interior a .. e-1 from no
//     inflow, carrying the spike X (lane c holds column c; X_a = Ld_a^-1
//     L_{a-1}, X_i = -Ld_i^-1 Lo_{i-1} X_{i-1}) and E = sum X'X, then at e
//     G = S at e from the interior's last Lo and F = X' Lo', where lane t
//     holds column t; the interior folded onto its end rows;
//   * phase 2, the hop: wait for Sigma_{j-1}, C = chol(Sigma_{j-1} - E), W =
//     C^-1 F, publish Sigma_j = G - W'W (b x b, the same values in both
//     triangles);
//   * phase 3, every chunk but the first: a step that factors Sigma_{j-1}
//     into Ld_{a-1} (this chunk writes it, and only this chunk uses it), then
//     the chain's own steps over a .. e: the same operations in the same
//     order as the sequential chain, so only the inflow carries the
//     partition's rounding; at a middle chunk's e only Lo_{e-1} (Ld_e is the
//     next chunk's).
// The whole sequential chain (one chunk, or the rerun) is the phase-3 loop
// with every condition of the chunks folded away.  A failed pivot in any
// phase of a chunked launch sets a device word; the block that finishes last
// (a counter after a fence) then reruns the sequential chain over all k rows,
// so that (Ld, Lo, ok) are the sequential chain's bits, and counts the rerun
// in the second int of the host-visible status word.  Sigma is published as
// values into a buffer of all-one bits, as the solve publishes its rows.
//
// Shared memory, in T after NL mbarriers and the block's ticket (128
// bytes): NL landing slots [D_i | L_{i-1}] (2 B^2), NS stages [D_i | L_{i-1}]
// (2 B P: rows of P, read by row and by column), NS output slots [Ld_i |
// Lo_{i-1}' | rinv_i] (2 B^2 + B, only read by broadcast: Ld by rows, Lo by
// columns, so Lo is kept transposed and row q of it feeds B independent
// sums), the output slot of step n-1 being the chain's input of step n; then
// the spike's X (B^2, row-major; the hop's W in its place), the hop's C
// (B^2) and 1/diag(C).

template <int B>
struct FactorShape {
    static constexpr int P = B + 1, BB = B * B, SP = B * P;
    static constexpr int LAND = 2 * BB, STAGE = 2 * SP, OUT = (2 * BB + B + 3) / 4 * 4;
    static constexpr int FOLD = 2 * BB + (B + 3) / 4 * 4;
    static constexpr int THREADS = 64;
};

// (a) row r of Lo = Lc Ldp^-T (Lc the stage's coupling block in rows of B+1):
// x Ldp' = l, forward substitution
template <typename T, int B>
__device__ __forceinline__ void lo_row(const T* Ls, const T* Ldp, const T* rinvp, int r, T (&x)[B])
{
    constexpr int P = B + 1;
    T rinv[B];
    lds_row<T, B>(rinvp, rinv);
#pragma unroll
    for (int c = 0; c < B; ++c) {
        T lrow[B];
        lds_row<T, B>(Ldp + c * B, lrow);
        T v = Ls[r * P + c];
#pragma unroll
        for (int q = 0; q < c; ++q) v -= x[q] * lrow[q];
        x[c] = v * rinv[c];
    }
}

// (b) row r of S = sym(D - Lo Lo'), entries c <= r (Lo Lo' left out without
// `couple`); each (Lo Lo')_rc takes its terms in q order
template <typename T, int B>
__device__ __forceinline__ void s_row(const T* Ds, const T* LoT, bool couple, const T (&x)[B],
                                      int r, T (&srow)[B])
{
    constexpr int P = B + 1;
    T p[B];
#pragma unroll
    for (int c = 0; c < B; ++c) p[c] = T(0);
    if (couple) {
#pragma unroll
        for (int q = 0; q < B; ++q) {
            T ocol[B];
            lds_row<T, B>(LoT + q * B, ocol);
#pragma unroll
            for (int c = 0; c < B; ++c) p[c] += x[q] * ocol[c];
        }
    }
#pragma unroll
    for (int c = 0; c < B; ++c)
        srow[c] = c <= r ? ((Ds[r * P + c] - p[c]) + (Ds[c * P + r] - p[c])) * T(0.5) : T(0);
}

// (c) Cholesky of the rows srow (lane r's row r, entries c <= r), right-
// looking, one column per round, the pivot applied by one rsqrt.  Column j
// reaches every lane by shuffles of S (not of L) issued before the pivot's
// rsqrt is known, and every lane forms the next pivot itself with lane j+1's
// own operation, so a round's chain is rsqrt, a product and an fma.  l: row r
// of the factor, rs_own: 1 / its diagonal; false where a pivot is not finite
// or not positive (the same in every lane: pivots are shuffled).
template <typename T, int B>
__device__ __forceinline__ bool chol_rows(T (&srow)[B], int r, T (&l)[B], T& rs_own)
{
    rs_own = T(1);
    bool good = true;
    T piv = __shfl_sync(FULL, srow[0], 0);
#pragma unroll
    for (int j = 0; j < B; ++j) {
        T scj[B];                        // lane c's s_cj after rounds 0..j-1
#pragma unroll
        for (int c = j + 1; c < B; ++c) scj[c] = __shfl_sync(FULL, srow[j], c);
        const T dnext = j + 1 < B ? __shfl_sync(FULL, srow[j + 1 < B ? j + 1 : j], j + 1) : T(0);
        good = good && piv > T(0) && isfinite(piv);
        const T rs = rsq(piv);
        const T lrj = r > j ? srow[j] * rs : (r == j ? piv * rs : T(0));
        l[j] = lrj;
        if (r == j) rs_own = rs;
#pragma unroll
        for (int c = j + 1; c < B; ++c) {
            const T lcj = scj[c] * rs;
            if (c <= r) srow[c] = fma(-lrj, lcj, srow[c]);
        }
        if (j + 1 < B) {
            const T l1 = scj[j + 1] * rs;            // l_{j+1,j}, as lane j+1 has it
            piv = fma(-l1, l1, dnext);               // lane j+1's s_{j+1,j+1} now
        }
    }
    return good;
}

// (d) Ld and 1 / diag(Ld) into the output slot (the identity where the
// factorization failed)
template <typename T, int B>
__device__ __forceinline__ void put_factor(T* Ldo, T* rinvo, const T (&l)[B], T rs_own, bool good,
                                           int r, bool writer)
{
    __syncwarp();                     // every lane is done with the slot's LoT
    if (writer) {
#pragma unroll
        for (int c = 0; c < B; ++c) Ldo[r * B + c] = good ? l[c] : (c == r ? T(1) : T(0));
        rinvo[r] = good ? rs_own : T(1);
    }
    __syncwarp();
}

// y = Lm^-1 v for one column (Lm row-major B x B in shared memory, rinv its
// reciprocal diagonal), forward substitution
template <typename T, int B>
__device__ __forceinline__ void lower_solve(const T* Lm, const T* rinvm, const T (&v)[B], T (&y)[B])
{
    T rinv[B];
    lds_row<T, B>(rinvm, rinv);
#pragma unroll
    for (int q = 0; q < B; ++q) {
        T lrow[B];
        lds_row<T, B>(Lm + q * B, lrow);
        T s = v[q];
#pragma unroll
        for (int p = 0; p < q; ++p) s -= lrow[p] * y[p];
        y[q] = s * rinv[q];
    }
}

// acc[u] = sum_q y_q M[q][u], M row-major B x B in shared memory (lane r: y is
// column r of M, so acc is row r of M'M)
template <typename T, int B>
__device__ __forceinline__ void gram_row(const T* M, const T (&y)[B], T (&acc)[B])
{
#pragma unroll
    for (int q = 0; q < B; ++q) {
        T mrow[B];
        lds_row<T, B>(M + q * B, mrow);
#pragma unroll
        for (int u = 0; u < B; ++u) acc[u] += y[q] * mrow[u];
    }
}

// lane r (a writer) publishes row r of a symmetric B x B matrix, entries u <=
// r given, into both triangles at dst
template <typename T, int B>
__device__ __forceinline__ void publish_sym(T* dst, const T (&row)[B], int r)
{
#pragma unroll
    for (int u = 0; u < B; ++u) {
        if (u <= r) {
            const T v = unpublished(row[u]) ? T(NAN) : row[u];
            st_relaxed(dst + r * B + u, v);
            if (u < r) st_relaxed(dst + u * B + r, v);
        }
    }
}

// Waits until row r of the B x B matrix at src is published (every lane of
// the warp; bounded: NaN and the status word set if not within WAIT_NS)
template <typename T, int B>
__device__ void wait_row(const T* src, int r, T (&z)[B], int* status)
{
    const unsigned long long t0 = global_ns();
    for (;;) {
        bool all = true;
#pragma unroll
        for (int c = 0; c < B; ++c) {
            z[c] = ld_relaxed(src + r * B + c);
            all = all && !unpublished(z[c]);
        }
        if (__all_sync(FULL, all)) return;
        if (global_ns() - t0 > WAIT_NS) break;
    }
#pragma unroll
    for (int c = 0; c < B; ++c) z[c] = T(NAN);
    if ((threadIdx.x & 31) == 0) {
        *(volatile int*)status = 1;
        __threadfence_system();
    }
}

// One work item, both warps: chunk j of a chunked launch, or (WHOLE) the
// sequential chain over all k rows, the phase-3 loop with every condition of
// the chunks folded away.  `landed`: the landing ring's turns
// of the block's earlier items; `nsteps`: this item's.  Returns, in the
// chain warp, whether every pivot was good.
template <typename T, int B, bool WHOLE>
__device__ __forceinline__ bool factor_item(const T* __restrict__ D, const T* __restrict__ L,
                                            T* __restrict__ Ld, T* __restrict__ Lo, int k, int b,
                                            int bulk, int m, int nchunks, int j, unsigned landed,
                                            int& nsteps, T* sigma, int* status,
                                            unsigned char* smem_raw)
{
    using S = FactorShape<B>;
    constexpr int P = S::P, BB = S::BB;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
    T* land = reinterpret_cast<T*>(smem_raw + 128);
    T* stage = land + NL * S::LAND;
    T* outs = stage + NS * S::STAGE;
    T* Xs = outs + NS * S::OUT;                     // the spike X (the hop's W)
    const int warp = warp_index(), lane = threadIdx.x & 31;
    const int bb = b * b;
    const int a = WHOLE ? 0 : j * m;
    const int e = WHOLE ? k - 1 : min(a + m, k) - 1;
    const bool last = WHOLE || j == nchunks - 1;
    const bool inflow = !WHOLE && j > 0;       // from Sigma_{j-1}
    const bool fold = inflow && !last;         // phase 1 and the hop's Sigma_j
    const int n1 = fold ? e - a + 1 : 0;       // phase-1 steps (rows a .. e)
    const int r0 = inflow ? a - 1 : 0;         // phase 3: rows r0 .. e
    const int nst = n1 + e - r0 + 1;
    nsteps = nst;
    bool good_all = true;

    if (warp == 1) {
        // ---- the IO warp ----
        auto row_of = [&](int n) { return n < n1 ? a + n : r0 + n - n1; };
        auto land_step = [&](int n) {
            const unsigned g = landed + n;
            const int l = g % NL, i = row_of(n);
            T* dst = land + l * S::LAND;
            if (bulk) {
                if (lane == 0) {
                    const unsigned bytes = sizeof(T) * S::BB;
                    mbar_arrive_tx(bars + l, i > 0 ? 2 * bytes : bytes);
                    bulk_copy(dst, D + (size_t)i * bb, bytes, bars + l);
                    if (i > 0) bulk_copy(dst + S::BB, L + (size_t)(i - 1) * bb, bytes, bars + l);
                }
            } else {
                land_elements<T, B>(dst, D + (size_t)i * bb, b, T(1), lane);
                if (i > 0)
                    land_elements<T, B>(dst + S::BB, L + (size_t)(i - 1) * bb, b, T(0), lane);
                if (lane == 0) mbar_arrive_tx(bars + l, 0);
            }
            mbar_arrive_cp_async(bars + l);
        };
        auto stage_step = [&](int n) {
            const unsigned g = landed + n;
            const T* src = land + (g % NL) * S::LAND;
            T* dst = stage + (n % NS) * S::STAGE;
            mbar_wait(bars + g % NL, (g / NL) & 1u);
            repack<T, B>(dst, src, lane);
            if (row_of(n) > 0) repack<T, B>(dst + S::SP, src + S::BB, lane);
            __syncwarp();
            if (n + NL < nst) land_step(n + NL);
        };
        for (int n = 0; n < NL && n < nst; ++n) land_step(n);
        for (int n = 0; n < NS && n < nst; ++n) {
            stage_step(n);
            bar_arrive(BAR_FULL + n % NS, S::THREADS);
        }
        for (int n = 0; n < nst; ++n) {
            bar_sync(BAR_DONE + n % NS, S::THREADS);
            if (n >= n1) {
                // phase 3: write Ld_i (not at a middle separator) and Lo_{i-1}
                // (not at the step that factors Sigma) out of the output slot
                const int i = row_of(n);
                const bool wld = last || i < e, wlo = i > r0;
                const T* o = outs + (n % NS) * S::OUT;
                for (int q = lane; q < S::BB; q += 32) {
                    const int r = q / B, c = q % B;
                    if (r < b && c < b) {
                        if (wld) Ld[(size_t)i * bb + r * b + c] = o[q];
                        if (wlo) Lo[(size_t)(i - 1) * bb + r * b + c] = o[S::BB + c * B + r];
                    }
                }
            }
            if (n + NS < nst) {
                stage_step(n + NS);
                bar_arrive(BAR_FULL + n % NS, S::THREADS);
            }
        }
    } else {
        // ---- the chain: lane r owns row r of each block ----
        const int r = lane < B ? lane : B - 1;    // lanes beyond B shadow row B-1, never write
        const bool writer = lane < B;
        T X[B], E[B], F[B], G[B];                 // lane r: column r of X, row r of E, ...
#pragma unroll
        for (int c = 0; c < B; ++c) E[c] = T(0);

        // ---- phase 1: the interior from no inflow, with the spike ----
        for (int n = 0; n < n1; ++n) {
            const int s = n % NS, i = a + n;
            bar_sync(BAR_FULL + s, S::THREADS);
            const T* Ds = stage + s * S::STAGE;
            const T* Ls = Ds + S::SP;
            T* Ldo = outs + s * S::OUT;
            T* LoT = Ldo + S::BB;
            T* rinvo = LoT + S::BB;
            const T* Ldp = outs + ((n + NS - 1) % NS) * S::OUT;
            const bool couple = i > a;
            T x[B];
#pragma unroll
            for (int c = 0; c < B; ++c) x[c] = T(0);
            if (couple) {
                lo_row<T, B>(Ls, Ldp, Ldp + 2 * S::BB, r, x);
                if (writer) {
#pragma unroll
                    for (int c = 0; c < B; ++c) LoT[c * B + r] = x[c];
                }
                __syncwarp();
            }
            T srow[B];
            s_row<T, B>(Ds, LoT, couple, x, r, srow);
            if (i == e) {
#pragma unroll
                for (int c = 0; c < B; ++c) G[c] = srow[c];
                if (couple) {
#pragma unroll
                    for (int c = 0; c < B; ++c) F[c] = T(0);
                    gram_row<T, B>(Xs, x, F);
                } else {
#pragma unroll
                    for (int c = 0; c < B; ++c) F[c] = Ls[r * P + c];
                }
                __syncwarp();
                bar_arrive(BAR_DONE + s, S::THREADS);
                break;
            }
            T l[B], rs_own;
            const bool good = chol_rows<T, B>(srow, r, l, rs_own);
            good_all = good_all && good;
            put_factor<T, B>(Ldo, rinvo, l, rs_own, good, r, writer);
            T t[B];
            if (couple) {
#pragma unroll
                for (int c = 0; c < B; ++c) t[c] = T(0);
#pragma unroll
                for (int q = 0; q < B; ++q) {
                    T ocol[B];
                    lds_row<T, B>(LoT + q * B, ocol);
#pragma unroll
                    for (int c = 0; c < B; ++c) t[c] -= ocol[c] * X[q];
                }
            } else {
#pragma unroll
                for (int c = 0; c < B; ++c) t[c] = Ls[c * P + r];
            }
            lower_solve<T, B>(Ldo, rinvo, t, X);
            if (writer) {
#pragma unroll
                for (int q = 0; q < B; ++q) Xs[q * B + r] = X[q];
            }
            __syncwarp();
            gram_row<T, B>(Xs, X, E);
            bar_arrive(BAR_DONE + s, S::THREADS);
        }

        // ---- phase 2: the hop ----
        T sig[B];
        if (inflow) {
            wait_row<T, B>(sigma + (size_t)(j - 1) * BB, r, sig, status);
            if (fold) {
                T* Cs = Xs + BB;
                T* crinv = Cs + BB;
                T srow[B], l[B], rs_own;
#pragma unroll
                for (int c = 0; c < B; ++c) srow[c] = c <= r ? sig[c] - E[c] : T(0);
                const bool good = chol_rows<T, B>(srow, r, l, rs_own);
                good_all = good_all && good;
                if (writer) {
#pragma unroll
                    for (int c = 0; c < B; ++c) Cs[r * B + c] = l[c];
                    crinv[r] = rs_own;
                }
                __syncwarp();
                T w[B], acc[B];
                lower_solve<T, B>(Cs, crinv, F, w);
                if (writer) {
#pragma unroll
                    for (int q = 0; q < B; ++q) Xs[q * B + r] = w[q];
                }
                __syncwarp();
#pragma unroll
                for (int c = 0; c < B; ++c) acc[c] = T(0);
                gram_row<T, B>(Xs, w, acc);
#pragma unroll
                for (int c = 0; c < B; ++c) acc[c] = G[c] - acc[c];
                if (writer) publish_sym<T, B>(sigma + (size_t)j * BB, acc, r);
            }
        }

        // ---- phase 3: the chain's own steps ----
        for (int n = n1; n < nst; ++n) {
            const int s = n % NS, i = r0 + n - n1;
            bar_sync(BAR_FULL + s, S::THREADS);
            const T* Ds = stage + s * S::STAGE;
            const T* Ls = Ds + S::SP;
            T* Ldo = outs + s * S::OUT;
            T* LoT = Ldo + S::BB;                                   // Lo_{i-1}'
            T* rinvo = LoT + S::BB;
            const T* Ldp = outs + ((n + NS - 1) % NS) * S::OUT;     // Ld_{i-1}
            const bool couple = i > r0;
            T x[B];
#pragma unroll
            for (int c = 0; c < B; ++c) x[c] = T(0);
            if (couple) {
                lo_row<T, B>(Ls, Ldp, Ldp + 2 * S::BB, r, x);
                if (writer) {
#pragma unroll
                    for (int c = 0; c < B; ++c) LoT[c * B + r] = x[c];
                }
                __syncwarp();
            }
            if (!last && i == e && inflow) {         // a middle separator: Lo only
                bar_arrive(BAR_DONE + s, S::THREADS);
                continue;
            }
            T srow[B];
            if (inflow && i == r0) {
#pragma unroll
                for (int c = 0; c < B; ++c) srow[c] = c <= r ? sig[c] : T(0);
            } else {
                s_row<T, B>(Ds, LoT, couple, x, r, srow);
            }
            if (!last && i == e) {                    // chunk 0's separator: Sigma_0
                if (writer) publish_sym<T, B>(sigma, srow, r);
                __syncwarp();
                bar_arrive(BAR_DONE + s, S::THREADS);
                continue;
            }
            T l[B], rs_own;
            const bool good = chol_rows<T, B>(srow, r, l, rs_own);
            good_all = good_all && good;
            put_factor<T, B>(Ldo, rinvo, l, rs_own, good, r, writer);
            bar_arrive(BAR_DONE + s, S::THREADS);
        }
    }
    return good_all;
}

template <typename T, int B>
__global__ void __launch_bounds__(64)
factor_kernel(const T* __restrict__ D, const T* __restrict__ L, T* __restrict__ Ld,
              T* __restrict__ Lo, unsigned char* __restrict__ ok, int k, int b, int bulk, int m,
              int nchunks, unsigned char* __restrict__ work, int* status)
{
    extern __shared__ __align__(128) unsigned char smem_raw[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
    int* sh = reinterpret_cast<int*>(smem_raw + 64);            // the ticket, the last flag
    T* sigma = reinterpret_cast<T*>(work);
    int* ticket = reinterpret_cast<int*>(work + sizeof(T) * (size_t)nchunks * B * B);
    int* finished = ticket + 1;
    int* failed = ticket + 2;

    if (threadIdx.x == 0) {
        for (int l = 0; l < NL; ++l) mbar_init(bars + l, 33);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        if (nchunks > 1) sh[0] = atomicAdd(ticket, 1) + 1;
    }
    __syncthreads();
    int nsteps = 0;
    const bool chunked = nchunks > 1;
    if constexpr (B <= CHUNKED_MAX_B) {
        if (chunked) {
            const bool good = factor_item<T, B, false>(D, L, Ld, Lo, k, b, bulk, m, nchunks, sh[0],
                                                       0, nsteps, sigma, status, smem_raw);
            // report a failed pivot; the last block to finish checks, and
            // reruns the sequential chain if any chunk failed
            if (threadIdx.x == 0 && !good) *(volatile int*)failed = 1;
            __syncthreads();
            if (threadIdx.x == 0) {
                __threadfence();
                sh[1] = atomicAdd(finished, 1) == nchunks - 2;
            }
            __syncthreads();
            if (!sh[1]) return;
            __threadfence();
            if (*(volatile int*)failed == -1) {
                if (threadIdx.x == 0) *ok = 1;
                return;
            }
        }
    }
    const bool good = factor_item<T, B, true>(D, L, Ld, Lo, k, b, bulk, m, nchunks, 0, nsteps,
                                              nsteps, sigma, status, smem_raw);
    if (threadIdx.x == 0) {
        *ok = good ? 1 : 0;
        if (chunked) {                         // count the rerun where the host sees it
            volatile int* st = status;
            st[1] = st[1] + 1;
            __threadfence_system();
        }
    }
}

// ---------------------------------------------------------------------------
// Solve: chunks of rows on many blocks, forward then backward
// ---------------------------------------------------------------------------
//
// A chain thread holds one whole vector (its B entries in registers): the
// right-hand side (thread 0) and, in phase 1, the unit inflows (thread u:
// e_{u-1}).  It reads the blocks from shared memory by broadcast, so a row
// step has no shuffle and no bank conflict: a B x B product and a
// substitution, in the order of operations of the sequential solve.  Rows go
// R to a stage.  Shared memory, in T after NSLOT mbarriers and the block's
// ticket (128 bytes): NSLOT slots [Ld (R B^2) | coupling (R B^2) | v (R B) |
// 1/diag(Ld) (R B)], each a stage's rows ascending in memory, then T_j
// (B x B).  Forward the coupling is Lo_{i-1} and v = r_i; backward Lo_i and
// v = y_i (from out, written by the forward items).  In phase 3 the chain
// leaves each row's result in place of its v, and the IO warp writes the
// stage's rows of out from there, coalesced.  The IO warp lands a stage
// NSLOT - 2 stages ahead of the one it hands over.
//
// Workspace per right-hand side, set to all-one bytes per call: vals = [y of
// each chunk's last row (P x B), x of each chunk's first row (P x B)], where
// an all-one value means "not yet published" (a published value that happens
// to have those bits is stored as NaN), then sync = [ticket, done flags of
// the forward items (P)] (-1 until set).

constexpr int NSLOT = 6;
constexpr int SBAR_FULL = 1, SBAR_DONE = SBAR_FULL + NSLOT, SBAR_CHAIN = SBAR_DONE + NSLOT;

template <int B>
struct SolveShape {
    static constexpr int BB = B * B;
    static constexpr int R = B >= 32 ? 1 : (64 / B < 16 ? 64 / B : 16);    // rows a stage
    static constexpr int V = B + 1;                        // vectors of phase 1
    static constexpr int CHAIN = ((V + 31) / 32) * 32;
    static constexpr int THREADS = CHAIN + 32;
    static constexpr int SLOT = 2 * R * BB + 2 * R * B;   // a multiple of 4: 16-byte slots
};

// Waits until the B values at src are published (bounded: NaN and the status
// word set if not within WAIT_NS).  Every lane of the warp calls it; lane 0
// reads, the others get its verdict.
template <typename T, int B>
__device__ void wait_values(const T* src, T z[B], int* status)
{
    const unsigned long long t0 = global_ns();
    bool late = false;
    for (;;) {
        bool all = true;
        if ((threadIdx.x & 31) == 0) {
#pragma unroll
            for (int c = 0; c < B; ++c) {
                z[c] = ld_relaxed(src + c);
                all = all && !unpublished(z[c]);
            }
        }
        if (__shfl_sync(FULL, (int)all, 0)) break;
        if (global_ns() - t0 > WAIT_NS) {
            late = true;
            break;
        }
    }
    if (late) {
#pragma unroll
        for (int c = 0; c < B; ++c) z[c] = T(NAN);
        if ((threadIdx.x & 31) == 0) {
            *(volatile int*)status = 1;
            __threadfence_system();
        }
    }
}

template <typename T, int B>
__device__ __forceinline__ void publish(T* dst, const T y[B])
{
#pragma unroll
    for (int c = 0; c < B; ++c) st_relaxed(dst + c, unpublished(y[c]) ? T(NAN) : y[c]);
}

// One row step of a vector y (this thread's), blocks in shared memory.
// t = base - C z, z the previous row's y, C the coupling (forward Lo_{i-1},
// backward Lo_i'), stored as C' (forward the IO warp transposes Lo_{i-1};
// backward Lo_i as it is), so that row q of the stored block holds the
// coefficients of z_q and feeds B independent sums.  base is v for the
// right-hand side and 0 for a unit inflow; without `couple` the product is
// skipped; `unit` > 0: t = -(column unit-1 of C), the first step of unit
// inflow e_{unit-1}.  Forward y = Ld^-1 t, backward y = Ld^-T t (Ld
// row-major).  Same operations, in the same order, as the sequential solve.
template <typename T, int B, bool FWD>
__device__ __forceinline__ void row_step(const T* Ls, const T* Os, const T* v, const T* rd,
                                         bool rhs, bool couple, int unit, T y[B])
{
    T t[B], w[B];
    lds_row<T, B>(v, w);
#pragma unroll
    for (int c = 0; c < B; ++c) t[c] = rhs ? w[c] : T(0);
    if (unit > 0) {
#pragma unroll
        for (int c = 0; c < B; ++c) t[c] = -Os[(unit - 1) * B + c];
    } else if (couple) {
#pragma unroll
        for (int q = 0; q < B; ++q) {            // each t[c] takes its terms in q order
            lds_row<T, B>(Os + q * B, w);
#pragma unroll
            for (int c = 0; c < B; ++c) t[c] -= w[c] * y[q];
        }
    }
    T rdr[B];
    lds_row<T, B>(rd, rdr);
    if (FWD) {
#pragma unroll
        for (int c = 0; c < B; ++c) {
            lds_row<T, B>(Ls + c * B, w);
            T s = t[c];
#pragma unroll
            for (int q = 0; q < c; ++q) s -= w[q] * y[q];
            y[c] = s * rdr[c];
        }
    } else {
        // right-looking over the rows of Ld: each t[c] takes its terms in
        // descending q, as the left-looking x_c = (t_c - sum_{q>c} ..) rd_c
#pragma unroll
        for (int qq = 0; qq < B; ++qq) {
            const int q = B - 1 - qq;
            y[q] = t[q] * rdr[q];
            lds_row<T, B>(Ls + q * B, w);
#pragma unroll
            for (int c = 0; c < q; ++c) t[c] -= w[c] * y[q];
        }
    }
}

template <typename T, int B>
__global__ void __launch_bounds__(SolveShape<B>::THREADS)
solve_kernel(const T* __restrict__ Ld, const T* __restrict__ Lo, const T* __restrict__ rhs,
             T* out, int k, int b, int nrhs, int m, int nchunks, int bulk,
             unsigned char* __restrict__ work, int* status)
{
    using S = SolveShape<B>;
    constexpr int R = S::R, BB = S::BB;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
    int* sh = reinterpret_cast<int*>(smem_raw + 8 * NSLOT);      // the block's ticket
    T* slots = reinterpret_cast<T*>(smem_raw + 128);
    T* Tm = slots + NSLOT * S::SLOT;
    const int tid = threadIdx.x;
    const int warp = warp_index(), lane = tid & 31;
    const bool io = warp == S::CHAIN / 32;
    const int bb = b * b;
    const int col = blockIdx.y;
    T* ylast = reinterpret_cast<T*>(work) + (size_t)col * 2 * nchunks * B;
    T* xfirst = ylast + (size_t)nchunks * B;
    int* ticket = reinterpret_cast<int*>(reinterpret_cast<T*>(work) +
                                         (size_t)nrhs * 2 * nchunks * B) +
                  (size_t)col * (1 + nchunks);
    int* fdone = ticket + 1;

    if (tid == 0) {
        for (int l = 0; l < NSLOT; ++l) mbar_init(bars + l, 33);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        sh[0] = atomicAdd(ticket, 1) + 1;
    }
    __syncthreads();
    int item = sh[0];
    unsigned staged = 0;                         // stages of the earlier items

    T y[B];
    while (item < 2 * nchunks) {
        const bool fwd = item < nchunks;
        const int j = fwd ? item : 2 * nchunks - 1 - item;
        const int s0 = j * m;
        const int len = min(m, k - s0);
        const bool inflow = fwd ? j > 0 : j < nchunks - 1;
        const int ns = (len + R - 1) / R;        // stages a pass
        const int nst = inflow ? 2 * ns : ns;
        // stage n: its rows, a contiguous range [lo, lo + cnt) taken in the
        // direction's order, and whether it belongs to phase 1
        auto stage_rows = [&](int n, int& lo, int& cnt) {
            const int idx0 = (n % ns) * R;
            cnt = min(R, len - idx0);
            lo = fwd ? s0 + idx0 : s0 + len - idx0 - cnt;
        };

        if (io) {
            // ---- the IO warp ----
            bool poison = false;
            if (!fwd) {                      // y of this chunk's rows, from its forward item
                int got = 1;
                if (lane == 0) got = wait_flag(fdone + j, status);
                poison = !__shfl_sync(FULL, got, 0);
            }
            auto land = [&](int n) {
                const unsigned slot = (staged + n) % NSLOT;
                uint64_t* bar = bars + slot;
                T* dst = slots + slot * S::SLOT;
                int lo, cnt;
                stage_rows(n, lo, cnt);
                // the coupling blocks of rows lo .. lo+cnt-1 (forward Lo_{i-1},
                // backward Lo_i) that exist: positions p0 .. p0+no-1
                const int p0 = fwd && lo == 0 ? 1 : 0;
                const int no = cnt - ((fwd && lo == 0) || (!fwd && lo + cnt == k) ? 1 : 0);
                const int o0 = (fwd ? lo - 1 : lo) + p0;          // first coupling block
                if (bulk) {
                    if (lane == 0) {
                        const unsigned blk = sizeof(T) * BB;
                        mbar_arrive_tx(bar, (cnt + no) * blk);
                        bulk_copy(dst, Ld + (size_t)lo * bb, cnt * blk, bar);
                        if (no > 0)
                            bulk_copy(dst + (R + p0) * BB, Lo + (size_t)o0 * bb, no * blk, bar);
                    }
                } else {
                    for (int p = 0; p < cnt; ++p) {
                        land_elements<T, B>(dst + p * BB, Ld + (size_t)(lo + p) * bb, b, T(1),
                                            lane);
                        if (p >= p0 && p < p0 + no)
                            land_elements<T, B>(dst + (R + p) * BB,
                                                Lo + (size_t)(o0 + p - p0) * bb, b, T(0), lane);
                    }
                    if (lane == 0) mbar_arrive_tx(bar, 0);
                }
                T* v = dst + 2 * R * BB;
                const T* src = fwd ? rhs : out;
                for (int e = lane; e < cnt * B; e += 32) {
                    const int p = e / B, r = e % B;
                    if (r < b)
                        cp_async(v + e, src + ((size_t)(lo + p) * b + r) * nrhs + col);
                    else
                        v[e] = T(0);
                }
                mbar_arrive_cp_async(bar);
            };
            auto prep = [&](int n) {             // wait for a stage, form 1/diag(Ld), hand over
                const unsigned slot = (staged + n) % NSLOT;
                T* st = slots + slot * S::SLOT;
                int lo, cnt;
                stage_rows(n, lo, cnt);
                mbar_wait(bars + slot, ((staged + n) / NSLOT) & 1u);
                if (fwd && B > 1) {              // the coupling blocks, transposed in place
                    constexpr int PER = (R * BB + 31) / 32;
                    T* cpl = st + R * BB;
                    T tmp[PER];
#pragma unroll
                    for (int t = 0; t < PER; ++t) {
                        const int e = lane + 32 * t;
                        if (e < cnt * BB) tmp[t] = cpl[e];
                    }
                    __syncwarp();
#pragma unroll
                    for (int t = 0; t < PER; ++t) {
                        const int e = lane + 32 * t, w = e % BB;
                        if (e < cnt * BB) cpl[e - w + (w % B) * B + w / B] = tmp[t];
                    }
                }
                T* v = st + 2 * R * BB;
                for (int e = lane; e < cnt * B; e += 32) {
                    const int p = e / B, r = e % B;
                    v[R * B + e] = T(1) / st[p * BB + r * B + r];
                    if (poison) v[e] = T(NAN);
                }
                __syncwarp();
                bar_arrive(SBAR_FULL + slot, S::THREADS);
            };
            for (int n = 0; n < NSLOT && n < nst; ++n) land(n);
            for (int n = 0; n < 2 && n < nst; ++n) prep(n);
            for (int n = 0; n < nst; ++n) {
                const unsigned slot = (staged + n) % NSLOT;
                bar_sync(SBAR_DONE + slot, S::THREADS);
                if (!(inflow && n < ns)) {       // phase 3: write the stage's rows of out
                    int lo, cnt;
                    stage_rows(n, lo, cnt);
                    const T* res = slots + slot * S::SLOT + 2 * R * BB;
                    for (int e = lane; e < cnt * B; e += 32) {
                        const int p = e / B, r = e % B;
                        if (r < b) out[((size_t)(lo + p) * b + r) * nrhs + col] = res[e];
                    }
                    __syncwarp();
                }
                if (n + NSLOT < nst) land(n + NSLOT);
                if (n + 2 < nst) prep(n + 2);
            }
        } else {
            // ---- the chain: thread u holds vector u ----
            const int u = tid;
            for (int n = 0; n < nst; ++n) {
                const unsigned slot = (staged + n) % NSLOT;
                const bool phase1 = inflow && n < ns;
                int lo, cnt;
                stage_rows(n, lo, cnt);
                bar_sync(SBAR_FULL + slot, S::THREADS);
                T* st = slots + slot * S::SLOT;
                if (u < S::V && (phase1 || u == 0)) {
                    for (int q = 0; q < cnt; ++q) {
                        const int p = fwd ? q : cnt - 1 - q;       // position in the slot
                        const bool first = n % ns == 0 && q == 0;
                        const bool couple = !(first && (phase1 || !inflow));
                        const int unit = phase1 && first ? u : 0;
                        const T* Ls = st + p * BB;
                        const T* Os = st + R * BB + p * BB;
                        const T* v = st + 2 * R * BB + p * B;
                        if (fwd)
                            row_step<T, B, true>(Ls, Os, v, v + R * B, u == 0, couple, unit, y);
                        else
                            row_step<T, B, false>(Ls, Os, v, v + R * B, u == 0, couple, unit, y);
                        if (!phase1) {       // the row's result, for the IO warp to write out
                            T* o = st + 2 * R * BB + p * B;
#pragma unroll
                            for (int c = 0; c < B; ++c) o[c] = y[c];
                        }
                    }
                }
                __syncwarp();
                bar_arrive(SBAR_DONE + slot, S::THREADS);

                if (phase1 && n == ns - 1) {
                    // ---- phase 2: T_j from the unit inflows, then the inflow ----
                    if (u >= 1 && u <= B) {
#pragma unroll
                        for (int c = 0; c < B; ++c) Tm[c * B + u - 1] = y[c];
                    }
                    bar_sync(SBAR_CHAIN, S::CHAIN);
                    if (warp == 0) {
                        T z[B];
                        wait_values<T, B>(fwd ? ylast + (size_t)(j - 1) * B
                                              : xfirst + (size_t)(j + 1) * B, z, status);
                        if (u == 0) {
                            T last[B];
#pragma unroll
                            for (int c = 0; c < B; ++c) {
                                T s = y[c];
#pragma unroll
                                for (int q = 0; q < B; ++q) s += Tm[c * B + q] * z[q];
                                last[c] = s;
                            }
                            publish<T, B>(fwd ? ylast + (size_t)j * B : xfirst + (size_t)j * B,
                                          last);
#pragma unroll
                            for (int c = 0; c < B; ++c) y[c] = z[c];   // phase 3 from the inflow
                        }
                        __syncwarp();
                    }
                }
            }
            if (!inflow && u == 0)           // no inflow: publish the last row after the pass
                publish<T, B>(fwd ? ylast + (size_t)j * B : xfirst + (size_t)j * B, y);
        }
        staged += nst;
        __syncthreads();                         // the item's rows of out are written
        if (tid == 0) {
            if (fwd) st_release(fdone + j, 1);
            sh[0] = atomicAdd(ticket, 1) + 1;
        }
        __syncthreads();
        item = sh[0];
    }
}

// ---------------------------------------------------------------------------
// Launchers (plain C interface, bound with ctypes)
// ---------------------------------------------------------------------------

template <typename T, int B>
static size_t factor_smem()
{
    using S = FactorShape<B>;
    return 128 + sizeof(T) * ((size_t)NL * S::LAND + (size_t)NS * (S::STAGE + S::OUT) + S::FOLD);
}

template <typename T, int B>
static size_t solve_smem()
{
    using S = SolveShape<B>;
    return 128 + sizeof(T) * ((size_t)NSLOT * S::SLOT + S::BB);
}

// allow more than 48 KB of dynamic shared memory where a launch needs it (once
// per kernel, before its first launch: outside a graph capture)
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, bool* done)
{
    if (bytes <= 48 * 1024 || *done) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) *done = true;
    return err;
}

// a bulk copy takes 16-byte aligned blocks of a multiple of 16 bytes
template <typename T, int B>
static int bulk_ok(int b, const void* p, const void* q)
{
    return b == B && (sizeof(T) * B * B) % 16 == 0 && ((uintptr_t)p % 16) == 0 &&
           ((uintptr_t)q % 16) == 0;
}

// the factor's workspace of a chunked launch, set to all-one bytes: Sigma of
// each chunk (P x B^2; all-one bits until published), then the ticket, the
// count of finished items and the failure word (-1 until set)
template <typename T>
static size_t factor_work_bytes(int nchunks, int B)
{
    return sizeof(T) * (size_t)nchunks * B * B + 3 * sizeof(int);
}

template <typename T, int B>
static int factor_launch(const void* D, const void* L, void* Ld, void* Lo, void* ok, int k, int b,
                         int m, void* work, void* status, void* stream)
{
    static bool allowed = false;
    const size_t bytes = factor_smem<T, B>();
    cudaError_t err = allow_smem(factor_kernel<T, B>, bytes, &allowed);
    if (err != cudaSuccess) return (int)err;
    const int nchunks = (k + m - 1) / m;
    if (nchunks > 1) {
        err = cudaMemsetAsync(work, 0xff, factor_work_bytes<T>(nchunks, B), (cudaStream_t)stream);
        if (err != cudaSuccess) return (int)err;
    }
    factor_kernel<T, B><<<nchunks, FactorShape<B>::THREADS, bytes, (cudaStream_t)stream>>>(
        (const T*)D, (const T*)L, (T*)Ld, (T*)Lo, (unsigned char*)ok, k, b,
        bulk_ok<T, B>(b, D, L), m, nchunks, (unsigned char*)work, (int*)status);
    return (int)cudaGetLastError();
}

// the solve's workspace: values, then the ticket and flags (solve_work_bytes)
template <typename T>
static size_t solve_work_bytes(int nrhs, int nchunks, int B)
{
    return sizeof(T) * (size_t)nrhs * 2 * nchunks * B + sizeof(int) * (size_t)nrhs * (1 + nchunks);
}

template <typename T, int B>
static int solve_launch(const void* Ld, const void* Lo, const void* rhs, void* out, int k, int b,
                        int nrhs, int m, void* work, void* status, void* stream)
{
    static bool allowed = false;
    const size_t bytes = solve_smem<T, B>();
    cudaError_t err = allow_smem(solve_kernel<T, B>, bytes, &allowed);
    if (err != cudaSuccess) return (int)err;
    const int nchunks = (k + m - 1) / m;
    err = cudaMemsetAsync(work, 0xff, solve_work_bytes<T>(nrhs, nchunks, B), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    solve_kernel<T, B><<<dim3(nchunks, nrhs), SolveShape<B>::THREADS, bytes,
                         (cudaStream_t)stream>>>(
        (const T*)Ld, (const T*)Lo, (const T*)rhs, (T*)out, k, b, nrhs, m, nchunks,
        bulk_ok<T, B>(b, Ld, Lo), (unsigned char*)work, (int*)status);
    return (int)cudaGetLastError();
}

template <typename T>
static int factor_any(const void* D, const void* L, void* Ld, void* Lo, void* ok, int k, int b,
                      int m, void* work, void* status, void* stream)
{
    if (k < 1 || b < 1 || b > 32 || m < 1) return (int)cudaErrorInvalidValue;
    if (m > k || b > CHUNKED_MAX_B) m = k;
    if (m < k && !work) return (int)cudaErrorInvalidValue;
#define FACTOR(BB) factor_launch<T, BB>(D, L, Ld, Lo, ok, k, b, m, work, status, stream)
    if (b <= 1) return FACTOR(1);
    if (b <= 2) return FACTOR(2);
    if (b <= 4) return FACTOR(4);
    if (b <= 8) return FACTOR(8);
    if (b <= 16) return FACTOR(16);
    return FACTOR(32);
#undef FACTOR
}

template <typename T>
static int solve_any(const void* Ld, const void* Lo, const void* rhs, void* out, int k, int b,
                     int nrhs, int m, void* work, void* status, void* stream)
{
    if (k < 1 || b < 1 || b > 32 || nrhs < 1 || m < 1) return (int)cudaErrorInvalidValue;
#define SOLVE(BB) solve_launch<T, BB>(Ld, Lo, rhs, out, k, b, nrhs, m, work, status, stream)
    if (b <= 1) return SOLVE(1);
    if (b <= 2) return SOLVE(2);
    if (b <= 4) return SOLVE(4);
    if (b <= 8) return SOLVE(8);
    if (b <= 16) return SOLVE(16);
    return SOLVE(32);
#undef SOLVE
}

extern "C" int banded_factor_f32(const void* D, const void* L, void* Ld, void* Lo, void* ok,
                                 int k, int b, int m, void* work, void* status, void* stream)
{
    return factor_any<float>(D, L, Ld, Lo, ok, k, b, m, work, status, stream);
}

extern "C" int banded_factor_f64(const void* D, const void* L, void* Ld, void* Lo, void* ok,
                                 int k, int b, int m, void* work, void* status, void* stream)
{
    return factor_any<double>(D, L, Ld, Lo, ok, k, b, m, work, status, stream);
}

extern "C" int banded_solve_f32(const void* Ld, const void* Lo, const void* rhs, void* out, int k,
                                int b, int nrhs, int m, void* work, void* status, void* stream)
{
    return solve_any<float>(Ld, Lo, rhs, out, k, b, nrhs, m, work, status, stream);
}

extern "C" int banded_solve_f64(const void* Ld, const void* Lo, const void* rhs, void* out, int k,
                                int b, int nrhs, int m, void* work, void* status, void* stream)
{
    return solve_any<double>(Ld, Lo, rhs, out, k, b, nrhs, m, work, status, stream);
}

extern "C" const char* banded_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
