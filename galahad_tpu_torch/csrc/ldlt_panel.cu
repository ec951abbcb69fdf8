// One panel of the blocked partial LDL^T of fronts wider than 128.
//
// Replaces, together with partial_ldlt.cu, the TPU kernel
// galahad_tpu/linalg/pallas_kernels.py::partial_ldlt_pallas (body _ldlt_kernel).
// That kernel stops at fronts of 128; wider fronts run the same elimination in
// its XLA twin galahad_tpu/linalg/supernodal_flat.py::_partial_ldlt_dyn, panel
// by panel.  This file is the panel step of that twin: for every front of a
// chunk F (ch, Fpad, Fpad) it eliminates, in place, the columns b .. b+31 of the
// panel F[:, b:, b:b+32].  Column gcol is active iff gcol < ncols[f]; an active
// column ends as unit-lower L with d on the diagonal (a pivot with
// |d| <= 16*tiny is divided by 1 instead); inactive columns keep what the
// active ones left there.  It also writes, for the trailing product that the
// caller leaves to a library matrix product,
//     Lm (ch, Fpad-b, 32) = the panel with inactive columns and the diagonal 0,
//     W  (ch, Fpad-b, 32) = Lm * dsafe (dsafe_j = d_j, or 1 for a tiny pivot),
// so that F[:, b:, b+32:] -= W @ Lm[:, 32:, :]^T is the whole trailing update.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; 67 / 34 TFLOP/s float32 /
// float64 outside the tensor cores): bytes.  A front moves
//     (Fpad-b) * 32 * sizeof(T)   read  (the panel, once)
//   + (Fpad-b) * 32 * sizeof(T)   written back
//   + 2 (Fpad-b) * 32 * sizeof(T) written into W and Lm
// (a front with no active column only has its W and Lm rows zeroed), against
// 32 + 2 * 496 operations per row below the diagonal block: 0.5 operations per
// byte in float64.  What it costs in practice is latency, not bandwidth: the
// 32 columns of a panel are a sequential recurrence.
//
// Design for this card.  The recurrence is confined to the 32 x 32 diagonal
// block; every row below it is an independent triangular solve against that
// block.  So a panel is two launches on the same stream, made by one call:
//   1. ldlt_panel_diag, one warp per front: lane r holds row r of the diagonal
//      block in 32 registers, the pivot row's entries travel by __shfl_sync,
//      no barrier and no shared-memory traffic inside the elimination.  It
//      writes the factored block back into F and its 32 rows of W and Lm.
//   2. ldlt_panel_strip, grid (strips of 64 rows, ch): a block stages its strip
//      and the FACTORED diagonal block (read-only by now) through shared memory
//      with coalesced loads, then each thread owns one row in 32 registers and
//      runs the 32 column steps on it with no barrier; the results go back
//      through shared memory so that F, W and Lm are written coalesced.
// The hazard of an in-place panel (strip blocks reading the diagonal block
// while another block overwrites it) is settled by that split: the diagonal
// block is factored and written by the first launch, and only read by the
// second.  No block waits on another.  The kernels are given the panel
// P = F[:, b:, b:b+32] (ch, rows, 32) by pointer, front stride and row stride,
// so the chunk may be any view of the flat store and is never copied.
//
// Every sum runs in a fixed order (columns ascending inside a row, no atomics):
// two runs give the same bits.  Arithmetic per entry is that of the plain
// version, a -= l_i * (dn * l_k), up to the fused multiply-add.
#include <cuda_runtime.h>

#define PB 32          // panel width
#define STRIP 64       // rows of one strip block (one thread per row)

template <typename T>
__global__ void __launch_bounds__(32)
ldlt_panel_diag(T* P, long long fs, long long rs, const int* __restrict__ ncols,
                int b, int rows, T* W, T* Lm, T tiny)
{
    __shared__ T S[PB][PB + 1];
    const int f = blockIdx.x;
    const int lane = threadIdx.x;
    int nact = ncols[f] - b;
    nact = nact < 0 ? 0 : (nact > PB ? PB : nact);
    const size_t wbase = (size_t)f * (size_t)rows * PB;
    T* Wf = W + wbase;
    T* Lf = Lm + wbase;
    if (nact == 0) {
        for (int i = 0; i < PB; ++i) {
            Wf[i * PB + lane] = (T)0;
            Lf[i * PB + lane] = (T)0;
        }
        return;
    }
    T* D = P + (size_t)f * fs;
    for (int i = 0; i < PB; ++i) S[i][lane] = D[(size_t)i * rs + lane];
    __syncwarp();
    T row[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) row[k] = S[lane][k];
#pragma unroll
    for (int j = 0; j < PB; ++j) {
        if (j >= nact) break;
        const T d = __shfl_sync(0xffffffffu, row[j], j);
        const T dn = (fabs(d) > tiny) ? d : (T)1;
        const T l = row[j] / dn;
        const bool below = lane > j;
#pragma unroll
        for (int k = j + 1; k < PB; ++k) {
            const T lk = __shfl_sync(0xffffffffu, l, k);
            if (below) row[k] -= l * (dn * lk);
        }
        if (below) row[j] = l;
    }
#pragma unroll
    for (int k = 0; k < PB; ++k) S[lane][k] = row[k];
    __syncwarp();
    const T dk = S[lane][lane];
    const T dsafe = (fabs(dk) > tiny) ? dk : (T)1;
    for (int i = 0; i < PB; ++i) {
        const T v = S[i][lane];
        D[(size_t)i * rs + lane] = v;
        const bool on = lane < nact && lane != i;
        Lf[i * PB + lane] = on ? v : (T)0;
        Wf[i * PB + lane] = on ? v * dsafe : (T)0;
    }
}

template <typename T>
__global__ void __launch_bounds__(STRIP)
ldlt_panel_strip(T* P, long long fs, long long rs, const int* __restrict__ ncols,
                 int b, int rows, T* W, T* Lm, T tiny)
{
    __shared__ T Mt[PB][PB + 1];     // Mt[j][k] = dn_j * L11[k][j] for k > j
    __shared__ T dnv[PB];
    __shared__ T Ts[STRIP][PB + 1];
    const int f = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    constexpr int NW = STRIP / 32;
    const int r0 = PB + blockIdx.x * STRIP;      // first row of the strip in the panel
    int nrows = rows - r0;
    if (nrows > STRIP) nrows = STRIP;
    int nact = ncols[f] - b;
    nact = nact < 0 ? 0 : (nact > PB ? PB : nact);
    const size_t wbase = ((size_t)f * (size_t)rows + (size_t)r0) * PB;
    T* Wf = W + wbase;
    T* Lf = Lm + wbase;
    if (nact == 0) {
        for (int e = tid; e < nrows * PB; e += STRIP) {
            Wf[e] = (T)0;
            Lf[e] = (T)0;
        }
        return;
    }
    const T* D = P + (size_t)f * fs;
    T* R = P + (size_t)f * fs + (size_t)r0 * rs;
    if (tid < PB) {
        const T d = D[(size_t)tid * rs + tid];
        dnv[tid] = (fabs(d) > tiny) ? d : (T)1;
    }
    for (int i = warp; i < nrows; i += NW) Ts[i][lane] = R[(size_t)i * rs + lane];
    __syncthreads();
    for (int i = warp; i < PB; i += NW) {
        const T v = D[(size_t)i * rs + lane];          // L11[i][lane]
        Mt[lane][i] = (i > lane) ? dnv[lane] * v : (T)0;
    }
    __syncthreads();
    if (tid < nrows) {
        T a[PB];
#pragma unroll
        for (int k = 0; k < PB; ++k) a[k] = Ts[tid][k];
#pragma unroll
        for (int j = 0; j < PB; ++j) {
            if (j >= nact) break;
            const T x = a[j] / dnv[j];
            a[j] = x;
#pragma unroll
            for (int k = j + 1; k < PB; ++k) a[k] -= x * Mt[j][k];
        }
#pragma unroll
        for (int k = 0; k < PB; ++k) Ts[tid][k] = a[k];
    }
    __syncthreads();
    const T dl = dnv[lane];
    for (int i = warp; i < nrows; i += NW) {
        const T v = Ts[i][lane];
        R[(size_t)i * rs + lane] = v;
        const bool on = lane < nact;
        Lf[i * PB + lane] = on ? v : (T)0;
        Wf[i * PB + lane] = on ? v * dl : (T)0;
    }
}

template <typename T>
static int launch(void* P, long long fs, long long rs, const int* ncols, int ch,
                  int rows, int b, void* W, void* Lm, double tiny, void* stream)
{
    if (ch <= 0) return 0;
    if (b < 0 || rows < PB) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    ldlt_panel_diag<T><<<ch, 32, 0, st>>>((T*)P, fs, rs, ncols, b, rows,
                                          (T*)W, (T*)Lm, (T)tiny);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int below = rows - PB;
    if (below > 0) {
        dim3 grid((below + STRIP - 1) / STRIP, ch);
        ldlt_panel_strip<T><<<grid, STRIP, 0, st>>>((T*)P, fs, rs, ncols, b, rows,
                                                    (T*)W, (T*)Lm, (T)tiny);
        err = cudaGetLastError();
    }
    return (int)err;
}

extern "C" int ldlt_panel_f32(void* P, long long fs, long long rs, const int* ncols,
                              int ch, int rows, int b, void* W, void* Lm,
                              double tiny, void* stream)
{
    return launch<float>(P, fs, rs, ncols, ch, rows, b, W, Lm, tiny, stream);
}

extern "C" int ldlt_panel_f64(void* P, long long fs, long long rs, const int* ncols,
                              int ch, int rows, int b, void* W, void* Lm,
                              double tiny, void* stream)
{
    return launch<double>(P, fs, rs, ncols, ch, rows, b, W, Lm, tiny, stream);
}

extern "C" const char* ldlt_panel_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
