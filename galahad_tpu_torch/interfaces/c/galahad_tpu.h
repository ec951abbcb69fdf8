/* C interface to the galahad_tpu_torch port (PyTorch / CUDA).
 *
 * The same C API as galahad_tpu/interfaces/c/galahad_tpu.h, function for
 * function and struct for struct, so that a C program written against the
 * JAX package's header compiles unchanged against this one and links with
 * libgalahad_tpu_torch_c (interfaces/c/build.py).  The counterpart of
 * GALAHAD's C interface layer (reference src/<pkg>/C/<pkg>_ciface.f90 +
 * include/galahad.h:1-31, include/cqp.h): the C ABI fronts the port's
 * Python / PyTorch runtime through an embedded interpreter.  The solvers run
 * on the CUDA device; GALAHAD_TPU_TORCH_DEVICE=cpu in the environment asks
 * for the CPU (capi_impl.py).
 *
 * Status codes match galahad_tpu_torch.core.status (reference
 * src/symbols/symbols.f90:52-102).
 */
#ifndef GALAHAD_TPU_H
#define GALAHAD_TPU_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* status values (subset; negative = error, 0 = success) */
#define GALAHAD_TPU_OK               0
#define GALAHAD_TPU_ALLOCATE        -1
#define GALAHAD_TPU_RESTRICTIONS    -3
#define GALAHAD_TPU_BAD_BOUNDS      -4
#define GALAHAD_TPU_PRIMAL_INFEAS   -5
#define GALAHAD_TPU_UNBOUNDED       -7
#define GALAHAD_TPU_FACTORIZATION  -10
#define GALAHAD_TPU_MAX_ITERATIONS -18
#define GALAHAD_TPU_UNKNOWN_SOLVER -26

/* inform block (the reference's *_inform_type essentials:
 * cqp.f90:484-575). */
typedef struct {
    int32_t status;
    int32_t iter;
    double  obj;
    double  primal_infeasibility;
    double  dual_infeasibility;
    double  complementary_slackness;
} galahad_tpu_inform;

/* Initialize / finalize the embedded runtime.  Calling solve functions
 * initializes lazily; explicit init lets callers front-load the cost. */
int galahad_tpu_init(void);
void galahad_tpu_terminate(void);

/* Solve the dense QP
 *     min 1/2 x'Hx + g'x + f
 *     s.t. c_l <= A x <= c_u,  x_l <= x <= x_u
 * with the named solver ("cqp", "dqp", "ccqp", "qpa", "qpb", "qpc",
 * "lpa", "lpb").  H is n*n row-major (pass NULL for an LP), A is m*n
 * row-major (may be NULL when m == 0).  x/y/z are output arrays of
 * size n/m/n.  Returns inform.status (also written to *inform if
 * non-NULL). */
int galahad_tpu_qp_solve(const char *solver,
                         int32_t n, int32_t m,
                         const double *H, const double *g, double f,
                         const double *A,
                         const double *c_l, const double *c_u,
                         const double *x_l, const double *x_u,
                         double *x, double *y, double *z,
                         galahad_tpu_inform *inform);

/* ---- per-package entries (the reference mirrors each package's
 * control/inform derived type into a C struct; src/cqp/C/cqp_ciface.f90,
 * src/trs/C/trs_ciface.f90, src/sls/C/sls_ciface.f90) ---- */

/* CQP: interior-point control (CQP_control_type essentials,
 * cqp.f90:134-343). arc: 0 = Mehrotra PC, 1 = Zhang-Taylor series,
 * 2 = Zhang-Puiseux, 3 = Zhao-Sun. */
typedef struct {
    int32_t maxit;
    int32_t print_level;
    int32_t series_order;
    int32_t arc;
    double  stop_abs_p;
    double  stop_abs_d;
    double  stop_abs_c;
} galahad_tpu_cqp_control;

void galahad_tpu_cqp_control_init(galahad_tpu_cqp_control *c);
int galahad_tpu_cqp_solve(const galahad_tpu_cqp_control *control,
                          int32_t n, int32_t m,
                          const double *H, const double *g, double f,
                          const double *A,
                          const double *c_l, const double *c_u,
                          const double *x_l, const double *x_u,
                          double *x, double *y, double *z,
                          galahad_tpu_inform *inform);

/* QPA: active-set control (QPA_control_type essentials). */
typedef struct {
    int32_t maxit;
    double  feas_tol;
    double  multiplier_tol;
} galahad_tpu_qpa_control;

void galahad_tpu_qpa_control_init(galahad_tpu_qpa_control *c);
int galahad_tpu_qpa_solve(const galahad_tpu_qpa_control *control,
                          int32_t n, int32_t m,
                          const double *H, const double *g, double f,
                          const double *A,
                          const double *c_l, const double *c_u,
                          const double *x_l, const double *x_u,
                          double *x, double *y, double *z,
                          galahad_tpu_inform *inform);

/* TRS / RQS: exact trust-region / regularized subproblems
 * (TRS_inform_type essentials, trs.f90). */
typedef struct {
    int32_t status;
    int32_t hard_case;
    double  multiplier;    /* lambda with (H + lambda I) x = -g */
    double  obj;
    double  norm_x;
} galahad_tpu_trs_inform;

int galahad_tpu_trs_solve(int32_t n, const double *H, const double *g,
                          double radius, double *x,
                          galahad_tpu_trs_inform *inform);
int galahad_tpu_rqs_solve(int32_t n, const double *H, const double *g,
                          double sigma, double power, double *x,
                          galahad_tpu_trs_inform *inform);

/* SLS: sparse symmetric factorize/solve with an opaque handle
 * (sls_ciface import/analyse/factorize/solve/terminate pattern).
 * Pattern: symmetric COO (either triangle), 0-based int32 indices.
 * order: 0 = AMD, 1 = RCM, 2 = nested dissection, 3 = best-of, 4 =
 * natural.  Returns a handle > 0, or < 0 on error. */
int64_t galahad_tpu_sls_analyse(int32_t n, int64_t nnz,
                                const int32_t *rows, const int32_t *cols,
                                int32_t order);
int galahad_tpu_sls_factorize(int64_t handle, const double *vals,
                              double shift);
int galahad_tpu_sls_solve(int64_t handle, const double *b, double *x);
/* inertia[3] = (n_pos, n_neg, n_zero) of the factorized matrix */
int galahad_tpu_sls_inertia(int64_t handle, int32_t *inertia);
void galahad_tpu_sls_free(int64_t handle);

#ifdef __cplusplus
}
#endif
#endif /* GALAHAD_TPU_H */
