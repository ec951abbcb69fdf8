// Batched partial LDL^T of padded symmetric fronts, Fpad in {8, 16, 32, 64, 96, 128}.
//
// Replaces the TPU kernel galahad_tpu/linalg/pallas_kernels.py::partial_ldlt_pallas
// (body _ldlt_kernel).  Same contract: for front b the first ncols[b] columns are
// eliminated without pivoting; column j < ncols[b] ends with d_j on the diagonal
// and the unit-lower L below it; a pivot with |d| <= 16*tiny is divided by 1
// instead; the trailing square holds F22 - L21 D L21^T in BOTH triangles; entries
// above the diagonal of eliminated columns are unspecified.  The fronts are
// symmetric on entry (up to rounding).  Fronts wider than 128 are ldlt_panel.cu's.
//
// What bounds it on an H100 SXM (NVIDIA data sheet: 3.35 TB/s HBM3; 67 TFLOP/s
// float32 and 34 TFLOP/s float64 outside the tensor cores): bytes,
// 2 * nb * Fpad^2 * sizeof(T) (each front read once, written once), for the small
// fronts that make up a sparse factorization (four in five are 8 x 8); the
// operations, sum over eliminated columns j of (Fpad-1-j) divisions and
// 2 (Fpad-1-j)^2 multiply-adds, only pass the bytes for full fronts of 128.
// What it costs in practice is latency: the columns of one front are a
// sequential recurrence, so the card is filled by running many fronts at once
// and by making each column step cheap.
//
// Design for this card, by front size:
//   * Fpad 8, 16, 32: fronts in REGISTERS, several per block, no block barrier.
//     One lane owns one row (8, 16 or 32 lanes per front: 4, 2 or 1 fronts per
//     warp, 8 warps per block: 32, 16 or 8 fronts per block) and keeps it in
//     Fpad registers, the column loop fully unrolled.  The pivot and the pivot
//     column's entries travel inside the lane group by __shfl_sync.  A warp
//     stages its (contiguous) fronts through a padded slice of shared memory of
//     its own, so that device memory is read and written in 16-byte accesses of
//     neighbouring lanes, and only __syncwarp orders the staging.
//   * Fpad 64, 96, 128: one front per block in shared memory (row stride Fpad+1:
//     no bank conflicts for a lane per row), eliminated in panels of 8 columns.
//     Warp 0 factors the 8-column panel in registers (a lane owns up to four
//     rows of it; shuffles, no barrier), and leaves the masked L and dn * L of
//     the panel in two small column-major arrays.  Then all warps apply the
//     rank-8 update to the LOWER triangle of the trailing square, a 4 x 4
//     register tile per thread, so that 8 shared-memory reads feed 16
//     multiply-adds.  Two block barriers per 8 columns instead of two per
//     column.  The upper triangle of the trailing square is mirrored from the
//     lower one once, at the end.
//   * One launch may serve fronts of several sizes: a table of work items
//     (store offset, ncols offset, Fpad, count), heaviest first, lets the flat
//     factorization factor every small front of a tree level with one call
//     (one launch for the items of 64..128, one for those of 8..32, since the
//     two use very different amounts of shared memory).
// Every sum runs in a fixed order (columns ascending, no atomics).  Arithmetic
// per entry is that of the plain version, a -= l_i * (dn * l_k), up to the fused
// multiply-add.
//
// Left for later: the rank-8 update on the float64 tensor cores (mma.sync
// m8n8k4) was not tried; warp 0 factors a panel while the other warps wait.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS 8
#define PW 8                     // panel width of the shared-memory design

template <typename T> struct alignas(16) Pack { T v[16 / sizeof(T)]; };

// contiguous copy src -> S (padded rows of width N) by one warp or one block
template <typename T, int N>
__device__ __forceinline__ void stage_in(const T* src, T* S, int nel, int t, int nt,
                                         bool vec)
{
    constexpr int V = 16 / sizeof(T);
    constexpr int LD = N + 1;
    if (vec) {
        const Pack<T>* s = reinterpret_cast<const Pack<T>*>(src);
        for (int q = t; q < nel / V; q += nt) {
            const Pack<T> p = s[q];
            const int e = q * V;
            T* d = S + (e / N) * LD + e % N;
#pragma unroll
            for (int u = 0; u < V; ++u) d[u] = p.v[u];
        }
    } else {
        for (int e = t; e < nel; e += nt) S[(e / N) * LD + e % N] = src[e];
    }
}

template <typename T, int N>
__device__ __forceinline__ void stage_out(const T* S, T* dst, int nel, int t, int nt,
                                          bool vec)
{
    constexpr int V = 16 / sizeof(T);
    constexpr int LD = N + 1;
    if (vec) {
        Pack<T>* d = reinterpret_cast<Pack<T>*>(dst);
        for (int q = t; q < nel / V; q += nt) {
            const int e = q * V;
            const T* s = S + (e / N) * LD + e % N;
            Pack<T> p;
#pragma unroll
            for (int u = 0; u < V; ++u) p.v[u] = s[u];
            d[q] = p;
        }
    } else {
        for (int e = t; e < nel; e += nt) dst[e] = S[(e / N) * LD + e % N];
    }
}

template <typename T>
__device__ __forceinline__ void copy_through(const T* src, T* dst, int nel, int t, int nt)
{
    if (src != dst)
        for (int e = t; e < nel; e += nt) dst[e] = src[e];
}

// ---------------------------------------------------------------------------
// Fpad 8, 16, 32: `count` contiguous fronts, 32/N per warp, a lane per row
// ---------------------------------------------------------------------------
template <typename T, int N>
__device__ __forceinline__ void small_fronts(const T* in, T* out, const int* ncols,
                                             int count, T tiny, bool vec, T* smem)
{
    constexpr int G = 32 / N;                  // fronts per warp
    constexpr int LD = N + 1;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int f0 = warp * G;                   // this warp's first front of the item
    if (f0 >= count) return;
    const int nf = (count - f0 < G) ? count - f0 : G;
    const int nel = nf * N * N;
    const int g = lane / N;                    // front of this lane within the warp
    const int r = lane % N;                    // row of this lane within its front
    int nc = 0;
    if (g < nf) {
        nc = ncols[f0 + g];
        nc = nc < 0 ? 0 : (nc > N ? N : nc);
    }
    const int ncmax = __reduce_max_sync(0xffffffffu, nc);
    const T* src = in + (size_t)f0 * N * N;
    T* dst = out + (size_t)f0 * N * N;
    if (ncmax == 0) {
        copy_through(src, dst, nel, lane, 32);
        return;
    }
    T* S = smem + warp * (32 * LD);            // 32 rows of this warp's fronts
    stage_in<T, N>(src, S, nel, lane, 32, vec);
    __syncwarp();
    T row[N];
#pragma unroll
    for (int k = 0; k < N; ++k) row[k] = (g < nf) ? S[lane * LD + k] : (T)0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        if (j >= ncmax) break;                 // uniform over the warp
        const bool act = j < nc;
        const T d = __shfl_sync(0xffffffffu, row[j], j, N);
        const T dn = (act && fabs(d) > tiny) ? d : (T)1;
        const T l = row[j] / dn;
        const bool upd = act && r > j;
#pragma unroll
        for (int k = j + 1; k < N; ++k) {
            const T lk = __shfl_sync(0xffffffffu, l, k, N);
            if (upd) row[k] -= l * (dn * lk);
        }
        if (upd) row[j] = l;
    }
    __syncwarp();
    if (g < nf) {
#pragma unroll
        for (int k = 0; k < N; ++k) S[lane * LD + k] = row[k];
    }
    __syncwarp();
    stage_out<T, N>(S, dst, nel, lane, 32, vec);
}

// ---------------------------------------------------------------------------
// Fpad 64, 96, 128: one front per block, panels of PW columns
// ---------------------------------------------------------------------------
template <typename T, int N>
__device__ __forceinline__ void medium_front(const T* in, T* out, int nc, T tiny,
                                             bool vec, T* smem)
{
    constexpr int LD = N + 1;
    constexpr int SLOTS = N / 32;              // rows of a panel owned by one lane
    T* S = smem;                               // N x LD, the front
    T* Lt = S + N * LD;                        // PW x N: Lt[jj][r] = masked L[r][j0+jj]
    T* Wt = Lt + PW * N;                       // PW x N: dn_jj * Lt[jj][r]
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    nc = nc < 0 ? 0 : (nc > N ? N : nc);
    if (nc == 0) {
        copy_through(in, out, N * N, tid, THREADS);
        return;
    }
    stage_in<T, N>(in, S, N * N, tid, THREADS, vec);
    __syncthreads();

    for (int j0 = 0; j0 < nc; j0 += PW) {
        if (warp == 0) {
            // rows j0 + lane + 32 s of the panel, in registers
            T a[SLOTS][PW];
            T dnv[PW];
#pragma unroll
            for (int s = 0; s < SLOTS; ++s) {
                const int rr = j0 + lane + 32 * s;
#pragma unroll
                for (int jj = 0; jj < PW; ++jj)
                    a[s][jj] = (rr < N) ? S[rr * LD + j0 + jj] : (T)0;
            }
#pragma unroll
            for (int jj = 0; jj < PW; ++jj) {
                dnv[jj] = (T)1;
                if (j0 + jj < nc) {            // uniform over the warp
                    const T d = __shfl_sync(0xffffffffu, a[0][jj], jj);
                    const T dn = (fabs(d) > tiny) ? d : (T)1;
                    dnv[jj] = dn;
                    T l[SLOTS];
#pragma unroll
                    for (int s = 0; s < SLOTS; ++s) l[s] = a[s][jj] / dn;
#pragma unroll
                    for (int kk = jj + 1; kk < PW; ++kk) {
                        const T t = dn * __shfl_sync(0xffffffffu, l[0], kk);
#pragma unroll
                        for (int s = 0; s < SLOTS; ++s)
                            if (lane + 32 * s > jj) a[s][kk] -= l[s] * t;
                    }
#pragma unroll
                    for (int s = 0; s < SLOTS; ++s)
                        if (lane + 32 * s > jj) a[s][jj] = l[s];
                }
            }
#pragma unroll
            for (int s = 0; s < SLOTS; ++s) {
                const int rr = j0 + lane + 32 * s;
                if (rr < N) {
#pragma unroll
                    for (int jj = 0; jj < PW; ++jj) {
                        S[rr * LD + j0 + jj] = a[s][jj];
                        const T lm = (j0 + jj < nc) ? a[s][jj] : (T)0;
                        Lt[jj * N + rr] = lm;
                        Wt[jj * N + rr] = lm * dnv[jj];
                    }
                }
            }
        }
        __syncthreads();
        // rank-PW update of the lower triangle of the trailing square, 4 x 4 tiles
        const int m0 = j0 + PW;
        const int ntl = (N - m0) / 4;
        const int ntiles = ntl * (ntl + 1) / 2;
        for (int t = tid; t < ntiles; t += THREADS) {
            int ti = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
            while (ti * (ti + 1) / 2 > t) --ti;
            while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
            const int tk = t - ti * (ti + 1) / 2;
            const int i0 = m0 + 4 * ti;
            const int k0 = m0 + 4 * tk;
            T acc[4][4];
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y) acc[x][y] = S[(i0 + x) * LD + k0 + y];
#pragma unroll
            for (int jj = 0; jj < PW; ++jj) {
                T li[4], wk[4];
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                    li[x] = Lt[jj * N + i0 + x];
                    wk[x] = Wt[jj * N + k0 + x];
                }
#pragma unroll
                for (int x = 0; x < 4; ++x)
#pragma unroll
                    for (int y = 0; y < 4; ++y) acc[x][y] -= li[x] * wk[y];
            }
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y) S[(i0 + x) * LD + k0 + y] = acc[x][y];
        }
        __syncthreads();
    }
    // the contract wants both triangles of the trailing square
    const int w = N - nc;
    for (int e = tid; e < w * w; e += THREADS) {
        const int i = nc + e / w;
        const int k = nc + e % w;
        if (i < k) S[i * LD + k] = S[k * LD + i];
    }
    __syncthreads();
    stage_out<T, N>(S, out, N * N, tid, THREADS, vec);
}

// ---------------------------------------------------------------------------
// Work items.  With a table, item i is (offset of its first front in elements,
// offset of its first ncols entry, Fpad, number of fronts), four int64 each.
// Without one, the batch is uniform: item i is the i-th block's worth of fronts.
// ---------------------------------------------------------------------------
struct Item { long long off; int nc_off; int Fpad; int count; };

__device__ __forceinline__ Item get_item(const long long* __restrict__ items, int idx,
                                         int Fpad, int nb)
{
    Item it;
    if (items != nullptr) {
        const long long* p = items + 4 * (size_t)idx;
        it.off = p[0];
        it.nc_off = (int)p[1];
        it.Fpad = (int)p[2];
        it.count = (int)p[3];
    } else {
        const int per = Fpad <= 32 ? THREADS / Fpad : 1;
        const long long first = (long long)idx * per;
        it.off = first * Fpad * Fpad;
        it.nc_off = (int)first;
        it.Fpad = Fpad;
        it.count = (nb - first < per) ? (int)(nb - first) : per;
    }
    return it;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ldlt_small_kernel(const T* in, T* out, const int* __restrict__ ncols,
                  const long long* __restrict__ items, int Fpad, int nb, T tiny, int vec)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const Item it = get_item(items, blockIdx.x, Fpad, nb);
    const T* src = in + it.off;
    T* dst = out + it.off;
    const int* nc = ncols + it.nc_off;
    switch (it.Fpad) {
    case 8:  small_fronts<T, 8>(src, dst, nc, it.count, tiny, vec != 0, smem); break;
    case 16: small_fronts<T, 16>(src, dst, nc, it.count, tiny, vec != 0, smem); break;
    case 32: small_fronts<T, 32>(src, dst, nc, it.count, tiny, vec != 0, smem); break;
    default: break;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ldlt_medium_kernel(const T* in, T* out, const int* __restrict__ ncols,
                   const long long* __restrict__ items, int Fpad, int nb, T tiny, int vec)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const Item it = get_item(items, blockIdx.x, Fpad, nb);
    const T* src = in + it.off;
    T* dst = out + it.off;
    const int nc = ncols[it.nc_off];
    switch (it.Fpad) {
    case 64:  medium_front<T, 64>(src, dst, nc, tiny, vec != 0, smem); break;
    case 96:  medium_front<T, 96>(src, dst, nc, tiny, vec != 0, smem); break;
    case 128: medium_front<T, 128>(src, dst, nc, tiny, vec != 0, smem); break;
    default: break;
    }
}

static size_t small_smem(int Fpad, size_t size) { return (size_t)WARPS * 32 * (Fpad + 1) * size; }
static size_t medium_smem(int Fpad, size_t size)
{
    return ((size_t)Fpad * (Fpad + 1) + 2 * PW * Fpad) * size;
}

static bool on_ladder(int Fpad)
{
    return Fpad == 8 || Fpad == 16 || Fpad == 32 || Fpad == 64 || Fpad == 96 || Fpad == 128;
}

// launch `nblocks` blocks of one of the two kernels; `Fpad_max` sizes the shared memory
template <typename T>
static int launch_kernel(bool medium, const void* in, void* out, const int* ncols,
                         const long long* items, int nblocks, int Fpad, int nb,
                         int Fpad_max, double tiny, int vec, void* stream)
{
    if (nblocks <= 0) return 0;
    static bool opted[2] = {false, false};
    auto kernel = medium ? ldlt_medium_kernel<T> : ldlt_small_kernel<T>;
    if (!opted[medium]) {
        const size_t most = medium ? medium_smem(128, sizeof(T)) : small_smem(32, sizeof(T));
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
        if (err != cudaSuccess) return (int)err;
        opted[medium] = true;
    }
    const size_t smem = medium ? medium_smem(Fpad_max, sizeof(T))
                               : small_smem(Fpad_max, sizeof(T));
    kernel<<<nblocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)in, (T*)out, ncols, items, Fpad, nb, (T)tiny, vec);
    return (int)cudaGetLastError();
}

// a uniform batch: nb contiguous fronts of one size
template <typename T>
static int launch_uniform(const void* in, void* out, const int* ncols, int nb, int Fpad,
                          double tiny, void* stream)
{
    if (nb <= 0) return 0;
    if (!on_ladder(Fpad)) return (int)cudaErrorInvalidValue;
    const int vec = (((uintptr_t)in | (uintptr_t)out) % 16 == 0) ? 1 : 0;
    const bool medium = Fpad > 32;
    const int per = medium ? 1 : THREADS / Fpad;
    return launch_kernel<T>(medium, in, out, ncols, nullptr, (nb + per - 1) / per, Fpad,
                            nb, Fpad, tiny, vec, stream);
}

// a table of items: the first n_medium are single fronts of 64..128, the
// following n_small are blocks' worths of fronts of 8..32
template <typename T>
static int launch_items(const void* in, void* out, const int* ncols,
                        const long long* items, int n_medium, int medium_Fpad_max,
                        int n_small, int small_Fpad_max, double tiny, void* stream)
{
    const int vec = (((uintptr_t)in | (uintptr_t)out) % 16 == 0) ? 1 : 0;
    if (n_medium > 0 && !(on_ladder(medium_Fpad_max) && medium_Fpad_max > 32))
        return (int)cudaErrorInvalidValue;
    if (n_small > 0 && !(on_ladder(small_Fpad_max) && small_Fpad_max <= 32))
        return (int)cudaErrorInvalidValue;
    int err = launch_kernel<T>(true, in, out, ncols, items, n_medium, 0, 0,
                               medium_Fpad_max, tiny, vec, stream);
    if (err != 0) return err;
    return launch_kernel<T>(false, in, out, ncols, items + 4 * (size_t)n_medium, n_small,
                            0, 0, small_Fpad_max, tiny, vec, stream);
}

extern "C" int partial_ldlt_f32(const void* in, void* out, const int* ncols, int nb,
                                int Fpad, double tiny, void* stream)
{
    return launch_uniform<float>(in, out, ncols, nb, Fpad, tiny, stream);
}

extern "C" int partial_ldlt_f64(const void* in, void* out, const int* ncols, int nb,
                                int Fpad, double tiny, void* stream)
{
    return launch_uniform<double>(in, out, ncols, nb, Fpad, tiny, stream);
}

extern "C" int partial_ldlt_items_f32(const void* in, void* out, const int* ncols,
                                      const long long* items, int n_medium,
                                      int medium_Fpad_max, int n_small,
                                      int small_Fpad_max, double tiny, void* stream)
{
    return launch_items<float>(in, out, ncols, items, n_medium, medium_Fpad_max,
                               n_small, small_Fpad_max, tiny, stream);
}

extern "C" int partial_ldlt_items_f64(const void* in, void* out, const int* ncols,
                                      const long long* items, int n_medium,
                                      int medium_Fpad_max, int n_small,
                                      int small_Fpad_max, double tiny, void* stream)
{
    return launch_items<double>(in, out, ncols, items, n_medium, medium_Fpad_max,
                                n_small, small_Fpad_max, tiny, stream);
}

extern "C" const char* partial_ldlt_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
