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
// What bounds it on an H100 SXM: neither bytes nor operations, but the chain.
// At k = 2,500, b = 8, f64 a factorization moves 5.1 MB (1.5 us at 3.35 TB/s)
// and a solve 2.9 MB (0.9 us); every step waits for the one before it, so the
// time is k times the latency of one step.  The design keeps that step short
// and keeps every load off it:
//   * one warp walks the chain (a solve: one warp per right-hand side, the
//     columns are independent); lane r owns row r of the block, so a step is
//     register arithmetic, warp shuffles and reads of shared memory, with one
//     __syncwarp where lanes exchange rows through shared memory;
//   * the blocks of the next STAGES-1 steps are in flight while a step runs:
//     the warp copies them with cp.async into a ring of shared-memory stages
//     (rows padded to b+1 entries, so that lanes reading one column of a block
//     hit distinct banks);
//   * the triangular solves multiply by reciprocals of the diagonal that each
//     lane forms from its stage before the chain reaches it.
// No atomics and one fixed order of operations: two runs give the same bits.

#include <cuda_runtime.h>
#include <math.h>

constexpr int STAGES = 4;                 // blocks of this many steps in flight
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    if constexpr (sizeof(T) == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// the warp copies the b x b block at src into dst (rows of P = b+1 entries)
template <typename T>
__device__ __forceinline__ void copy_block(T* dst, const T* src, int b, int lane)
{
    for (int e = lane; e < b * b; e += 32) cp_async(dst + (e / b) * (b + 1) + e % b, src + e);
}

// ---------------------------------------------------------------------------
// Factorization: one warp, k steps
// ---------------------------------------------------------------------------
//
// Shared memory, in T: STAGES stages of [D_i | L_{i-1}] (2 b P each), then
// Ldp (b P: Ld_{i-1}), Lo (b P: Lo_{i-1}) and rinv (b: 1 / diag(Ld_{i-1})).

template <typename T, int BMAX>
__global__ void __launch_bounds__(32)
factor_kernel(const T* __restrict__ D, const T* __restrict__ L, T* __restrict__ Ld,
              T* __restrict__ Lo, unsigned char* __restrict__ ok, int k, int b)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int P = b + 1;
    const int bb = b * b;
    T* ring = smem;
    T* Ldp = ring + STAGES * 2 * b * P;
    T* Los = Ldp + b * P;
    T* rinv = Los + b * P;
    const int r = threadIdx.x;

    auto prefetch = [&](int i) {
        T* st = ring + (i % STAGES) * 2 * b * P;
        copy_block(st, D + (size_t)i * bb, b, r);
        if (i > 0) copy_block(st + b * P, L + (size_t)(i - 1) * bb, b, r);
    };
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < k) prefetch(s);
        cp_commit();
    }

    bool good_all = true;
    for (int i = 0; i < k; ++i) {
        if (i + STAGES - 1 < k) prefetch(i + STAGES - 1);
        cp_commit();
        cp_wait<STAGES - 1>();
        __syncwarp();
        const T* Ds = ring + (i % STAGES) * 2 * b * P;
        const T* Ls = Ds + b * P;

        // (a) row r of Lo_{i-1} = L_{i-1} Ld_{i-1}^-T: x Ld' = l, forward substitution
        T x[BMAX];
#pragma unroll
        for (int c = 0; c < BMAX; ++c) x[c] = T(0);
        if (i > 0) {
            if (r < b) {
#pragma unroll
                for (int c = 0; c < BMAX; ++c) {
                    if (c < b) {
                        T s = Ls[r * P + c];
#pragma unroll
                        for (int q = 0; q < c; ++q) s -= x[q] * Ldp[c * P + q];
                        x[c] = s * rinv[c];
                    }
                }
#pragma unroll
                for (int c = 0; c < BMAX; ++c) {
                    if (c < b) {
                        Los[r * P + c] = x[c];
                        Lo[(size_t)(i - 1) * bb + r * b + c] = x[c];
                    }
                }
            }
            __syncwarp();
        }

        // (b) row r of S = sym(D_i - Lo Lo'), entries c <= r
        T srow[BMAX];
#pragma unroll
        for (int c = 0; c < BMAX; ++c) {
            srow[c] = T(0);
            if (c < b && c <= r && r < b) {
                T p = T(0);
                if (i > 0) {
#pragma unroll
                    for (int q = 0; q < BMAX; ++q)
                        if (q < b) p += x[q] * Los[c * P + q];
                }
                srow[c] = ((Ds[r * P + c] - p) + (Ds[c * P + r] - p)) * T(0.5);
            }
        }

        // (c) Cholesky of S, right-looking, one column per round: lane j's
        // diagonal is the pivot, the column goes round by shuffles
        T l[BMAX];
        bool good = true;
#pragma unroll
        for (int j = 0; j < BMAX; ++j) {
            l[j] = T(0);
            if (j < b) {
                const T piv = __shfl_sync(FULL, srow[j], j);
                good = good && piv > T(0) && isfinite(piv);
                const T d = sqrt(piv);
                const T lrj = r > j ? srow[j] / d : (r == j ? d : T(0));
                l[j] = lrj;
#pragma unroll
                for (int c = j + 1; c < BMAX; ++c) {
                    if (c < b) {
                        const T lcj = __shfl_sync(FULL, lrj, c);
                        if (c <= r) srow[c] -= lrj * lcj;
                    }
                }
            }
        }
        good_all = good_all && good;      // the same in every lane (pivots are shuffled)

        // (d) Ld_i (the identity where the factorization failed)
        __syncwarp();                     // every lane is done with Ldp and Los
        if (r < b) {
#pragma unroll
            for (int c = 0; c < BMAX; ++c) {
                if (c < b) {
                    const T v = good ? l[c] : (c == r ? T(1) : T(0));
                    Ldp[r * P + c] = v;
                    Ld[(size_t)i * bb + r * b + c] = v;
                }
            }
            rinv[r] = T(1) / Ldp[r * P + r];
        }
        __syncwarp();
    }
    cp_wait<0>();
    if (r == 0) *ok = good_all ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Solve: one warp per right-hand side, forward then backward
// ---------------------------------------------------------------------------
//
// Shared memory, in T: STAGES stages of [Ld_i | Lo | v] (2 b P + b each):
// forward Lo = Lo_{i-1}, v = r_i; backward Lo = Lo_i, v = y_i.

template <typename T, int BMAX>
__global__ void __launch_bounds__(32)
solve_kernel(const T* __restrict__ Ld, const T* __restrict__ Lo, const T* __restrict__ rhs,
             T* out, int k, int b, int nrhs)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* ring = reinterpret_cast<T*>(smem_raw);
    const int P = b + 1;
    const int bb = b * b;
    const int stage = 2 * b * P + b;
    const int r = threadIdx.x;
    const int col = blockIdx.x;

    // ---- forward: L~ y = rhs ----
    auto prefetch_fwd = [&](int i) {
        T* st = ring + (i % STAGES) * stage;
        copy_block(st, Ld + (size_t)i * bb, b, r);
        if (i > 0) copy_block(st + b * P, Lo + (size_t)(i - 1) * bb, b, r);
        if (r < b) cp_async(st + 2 * b * P + r, rhs + ((size_t)i * b + r) * nrhs + col);
    };
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < k) prefetch_fwd(s);
        cp_commit();
    }
    T own = T(0);                         // lane r: component r of y_{i-1}, then of y_i
    for (int i = 0; i < k; ++i) {
        if (i + STAGES - 1 < k) prefetch_fwd(i + STAGES - 1);
        cp_commit();
        cp_wait<STAGES - 1>();
        __syncwarp();
        const T* Ls = ring + (i % STAGES) * stage;
        const T* Os = Ls + b * P;
        const T* vs = Os + b * P;
        const T rdiag = r < b ? T(1) / Ls[r * P + r] : T(0);
        T t = r < b ? vs[r] : T(0);
        if (i > 0) {
#pragma unroll
            for (int c = 0; c < BMAX; ++c) {
                if (c < b) {
                    const T yc = __shfl_sync(FULL, own, c);
                    if (r < b) t -= Os[r * P + c] * yc;
                }
            }
        }
#pragma unroll
        for (int c = 0; c < BMAX; ++c) {
            if (c < b) {
                const T yc = __shfl_sync(FULL, t * rdiag, c);
                if (r > c && r < b) t -= Ls[r * P + c] * yc;
                if (r == c) own = yc;
            }
        }
        if (r < b) out[((size_t)i * b + r) * nrhs + col] = own;
        __syncwarp();
    }
    cp_wait<0>();
    __syncwarp();
    __threadfence_block();                // the backward sweep copies y back from out

    // ---- backward: L~' x = y ----
    auto prefetch_bwd = [&](int s) {         // s-th backward step: block row k-1-s
        const int i = k - 1 - s;
        T* st = ring + (s % STAGES) * stage;
        copy_block(st, Ld + (size_t)i * bb, b, r);
        if (i < k - 1) copy_block(st + b * P, Lo + (size_t)i * bb, b, r);
        if (r < b) cp_async(st + 2 * b * P + r, out + ((size_t)i * b + r) * nrhs + col);
    };
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < k) prefetch_bwd(s);
        cp_commit();
    }
    own = T(0);                           // lane r: component r of x_{i+1}, then of x_i
    for (int s = 0; s < k; ++s) {
        const int i = k - 1 - s;
        if (s + STAGES - 1 < k) prefetch_bwd(s + STAGES - 1);
        cp_commit();
        cp_wait<STAGES - 1>();
        __syncwarp();
        const T* Ls = ring + (s % STAGES) * stage;
        const T* Os = Ls + b * P;
        const T* vs = Os + b * P;
        const T rdiag = r < b ? T(1) / Ls[r * P + r] : T(0);
        T t = r < b ? vs[r] : T(0);
        if (i < k - 1) {
#pragma unroll
            for (int c = 0; c < BMAX; ++c) {
                if (c < b) {
                    const T xc = __shfl_sync(FULL, own, c);
                    if (r < b) t -= Os[c * P + r] * xc;      // (Lo_i' x_{i+1})_r
                }
            }
        }
#pragma unroll
        for (int cc = 0; cc < BMAX; ++cc) {
            const int c = b - 1 - cc;
            if (c >= 0) {
                const T xc = __shfl_sync(FULL, t * rdiag, c);
                if (r < c) t -= Ls[c * P + r] * xc;          // (Ld_i')[r][c] = Ld_i[c][r]
                if (r == c) own = xc;
            }
        }
        if (r < b) out[((size_t)i * b + r) * nrhs + col] = own;
        __syncwarp();
    }
    cp_wait<0>();
}

// ---------------------------------------------------------------------------
// Launchers (plain C interface, bound with ctypes)
// ---------------------------------------------------------------------------

template <typename T>
static size_t factor_smem(int b)
{
    return sizeof(T) * ((size_t)STAGES * 2 * b * (b + 1) + 2 * (size_t)b * (b + 1) + b);
}

template <typename T>
static size_t solve_smem(int b)
{
    return sizeof(T) * (size_t)STAGES * (2 * b * (b + 1) + b);
}

// allow more than 48 KB of dynamic shared memory where a launch needs it (once
// per kernel and size, before the first such launch: outside a graph capture)
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed)
{
    if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) *allowed = bytes;
    return err;
}

template <typename T, int BMAX>
static int factor_launch(const void* D, const void* L, void* Ld, void* Lo, void* ok, int k, int b,
                         void* stream)
{
    static size_t allowed = 0;
    const size_t bytes = factor_smem<T>(b);
    cudaError_t err = allow_smem(factor_kernel<T, BMAX>, bytes, &allowed);
    if (err != cudaSuccess) return (int)err;
    factor_kernel<T, BMAX><<<1, 32, bytes, (cudaStream_t)stream>>>(
        (const T*)D, (const T*)L, (T*)Ld, (T*)Lo, (unsigned char*)ok, k, b);
    return (int)cudaGetLastError();
}

template <typename T, int BMAX>
static int solve_launch(const void* Ld, const void* Lo, const void* rhs, void* out, int k, int b,
                        int nrhs, void* stream)
{
    static size_t allowed = 0;
    const size_t bytes = solve_smem<T>(b);
    cudaError_t err = allow_smem(solve_kernel<T, BMAX>, bytes, &allowed);
    if (err != cudaSuccess) return (int)err;
    solve_kernel<T, BMAX><<<nrhs, 32, bytes, (cudaStream_t)stream>>>(
        (const T*)Ld, (const T*)Lo, (const T*)rhs, (T*)out, k, b, nrhs);
    return (int)cudaGetLastError();
}

template <typename T>
static int factor_any(const void* D, const void* L, void* Ld, void* Lo, void* ok, int k, int b,
                      void* stream)
{
    if (k < 1 || b < 1 || b > 32) return (int)cudaErrorInvalidValue;
    if (b <= 8) return factor_launch<T, 8>(D, L, Ld, Lo, ok, k, b, stream);
    if (b <= 16) return factor_launch<T, 16>(D, L, Ld, Lo, ok, k, b, stream);
    return factor_launch<T, 32>(D, L, Ld, Lo, ok, k, b, stream);
}

template <typename T>
static int solve_any(const void* Ld, const void* Lo, const void* rhs, void* out, int k, int b,
                     int nrhs, void* stream)
{
    if (k < 1 || b < 1 || b > 32 || nrhs < 1) return (int)cudaErrorInvalidValue;
    if (b <= 8) return solve_launch<T, 8>(Ld, Lo, rhs, out, k, b, nrhs, stream);
    if (b <= 16) return solve_launch<T, 16>(Ld, Lo, rhs, out, k, b, nrhs, stream);
    return solve_launch<T, 32>(Ld, Lo, rhs, out, k, b, nrhs, stream);
}

extern "C" int banded_factor_f32(const void* D, const void* L, void* Ld, void* Lo, void* ok,
                                 int k, int b, void* stream)
{
    return factor_any<float>(D, L, Ld, Lo, ok, k, b, stream);
}

extern "C" int banded_factor_f64(const void* D, const void* L, void* Ld, void* Lo, void* ok,
                                 int k, int b, void* stream)
{
    return factor_any<double>(D, L, Ld, Lo, ok, k, b, stream);
}

extern "C" int banded_solve_f32(const void* Ld, const void* Lo, const void* rhs, void* out, int k,
                                int b, int nrhs, void* stream)
{
    return solve_any<float>(Ld, Lo, rhs, out, k, b, nrhs, stream);
}

extern "C" int banded_solve_f64(const void* Ld, const void* Lo, const void* rhs, void* out, int k,
                                int b, int nrhs, void* stream)
{
    return solve_any<double>(Ld, Lo, rhs, out, k, b, nrhs, stream);
}

extern "C" const char* banded_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
