/* Embedded-interpreter implementation of the galahad_tpu_torch C interface.
 *
 * The reference's C layer is generated Fortran (iso_c_binding shims,
 * src/cqp/C/cqp_ciface.f90); this one bridges into the port's Python /
 * PyTorch runtime: each entry marshals raw pointers (as integers) into the
 * function of the same role in galahad_tpu_torch.capi_impl, which views
 * them zero-copy with numpy, moves the data to the device and runs the
 * solver.  An entry whose Python side raises (no CUDA device and no
 * GALAHAD_TPU_TORCH_DEVICE=cpu, an unknown solver) prints the error and
 * returns a nonzero status.  Thread-safety: calls are serialized through the
 * GIL.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

#include "galahad_tpu.h"

static PyObject *g_impl = NULL;

int galahad_tpu_init(void) {
    if (g_impl != NULL) return 0;
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *mod = PyImport_ImportModule("galahad_tpu_torch.capi_impl");
    if (mod == NULL) {
        PyErr_Print();
        PyGILState_Release(st);
        return GALAHAD_TPU_ALLOCATE;
    }
    g_impl = mod;
    PyGILState_Release(st);
    return 0;
}

void galahad_tpu_terminate(void) {
    if (g_impl != NULL) {
        PyGILState_STATE st = PyGILState_Ensure();
        Py_CLEAR(g_impl);
        PyGILState_Release(st);
    }
}

int galahad_tpu_qp_solve(const char *solver,
                         int32_t n, int32_t m,
                         const double *H, const double *g, double f,
                         const double *A,
                         const double *c_l, const double *c_u,
                         const double *x_l, const double *x_u,
                         double *x, double *y, double *z,
                         galahad_tpu_inform *inform) {
    int rc = galahad_tpu_init();
    if (rc != 0) return rc;

    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = PyObject_CallMethod(
        g_impl, "qp_solve_raw", "sii" "LLd" "LLL" "LL" "LLL",
        solver, (int)n, (int)m,
        (long long)(intptr_t)H, (long long)(intptr_t)g, f,
        (long long)(intptr_t)A,
        (long long)(intptr_t)c_l, (long long)(intptr_t)c_u,
        (long long)(intptr_t)x_l, (long long)(intptr_t)x_u,
        (long long)(intptr_t)x, (long long)(intptr_t)y,
        (long long)(intptr_t)z);
    int status;
    if (res == NULL) {
        PyErr_Print();
        status = GALAHAD_TPU_RESTRICTIONS;
        if (inform != NULL) {
            memset(inform, 0, sizeof(*inform));
            inform->status = status;
        }
    } else {
        /* res = (status, iter, obj, rp, rd, rc) */
        int iter = 0;
        double obj = 0, rp = 0, rd = 0, rcs = 0;
        if (!PyArg_ParseTuple(res, "iidddd", &status, &iter, &obj,
                              &rp, &rd, &rcs)) {
            PyErr_Print();
            status = GALAHAD_TPU_RESTRICTIONS;
        }
        if (inform != NULL) {
            inform->status = status;
            inform->iter = iter;
            inform->obj = obj;
            inform->primal_infeasibility = rp;
            inform->dual_infeasibility = rd;
            inform->complementary_slackness = rcs;
        }
        Py_DECREF(res);
    }
    PyGILState_Release(st);
    return status;
}

/* ---- per-package entries ---- */

static int parse_inform6(PyObject *res, galahad_tpu_inform *inform) {
    int status = GALAHAD_TPU_RESTRICTIONS;
    if (res == NULL) {
        PyErr_Print();
        if (inform != NULL) {
            memset(inform, 0, sizeof(*inform));
            inform->status = status;
        }
        return status;
    }
    int iter = 0;
    double obj = 0, rp = 0, rd = 0, rcs = 0;
    if (!PyArg_ParseTuple(res, "iidddd", &status, &iter, &obj,
                          &rp, &rd, &rcs)) {
        PyErr_Print();
        status = GALAHAD_TPU_RESTRICTIONS;
    }
    if (inform != NULL) {
        inform->status = status;
        inform->iter = iter;
        inform->obj = obj;
        inform->primal_infeasibility = rp;
        inform->dual_infeasibility = rd;
        inform->complementary_slackness = rcs;
    }
    Py_DECREF(res);
    return status;
}

void galahad_tpu_cqp_control_init(galahad_tpu_cqp_control *c) {
    c->maxit = 200;
    c->print_level = 0;
    c->series_order = 2;
    c->arc = 0;
    c->stop_abs_p = 1.0e-6;
    c->stop_abs_d = 1.0e-6;
    c->stop_abs_c = 1.0e-6;
}

int galahad_tpu_cqp_solve(const galahad_tpu_cqp_control *control,
                          int32_t n, int32_t m,
                          const double *H, const double *g, double f,
                          const double *A,
                          const double *c_l, const double *c_u,
                          const double *x_l, const double *x_u,
                          double *x, double *y, double *z,
                          galahad_tpu_inform *inform) {
    galahad_tpu_cqp_control def;
    if (control == NULL) {
        galahad_tpu_cqp_control_init(&def);
        control = &def;
    }
    int rc = galahad_tpu_init();
    if (rc != 0) return rc;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = PyObject_CallMethod(
        g_impl, "cqp_solve_raw", "ii" "iiii" "ddd" "LLd" "LLL" "LL" "LLL",
        (int)n, (int)m,
        (int)control->maxit, (int)control->print_level,
        (int)control->series_order, (int)control->arc,
        control->stop_abs_p, control->stop_abs_d, control->stop_abs_c,
        (long long)(intptr_t)H, (long long)(intptr_t)g, f,
        (long long)(intptr_t)A,
        (long long)(intptr_t)c_l, (long long)(intptr_t)c_u,
        (long long)(intptr_t)x_l, (long long)(intptr_t)x_u,
        (long long)(intptr_t)x, (long long)(intptr_t)y,
        (long long)(intptr_t)z);
    int status = parse_inform6(res, inform);
    PyGILState_Release(st);
    return status;
}

void galahad_tpu_qpa_control_init(galahad_tpu_qpa_control *c) {
    c->maxit = 500;
    c->feas_tol = 1.0e-8;
    c->multiplier_tol = 1.0e-8;
}

int galahad_tpu_qpa_solve(const galahad_tpu_qpa_control *control,
                          int32_t n, int32_t m,
                          const double *H, const double *g, double f,
                          const double *A,
                          const double *c_l, const double *c_u,
                          const double *x_l, const double *x_u,
                          double *x, double *y, double *z,
                          galahad_tpu_inform *inform) {
    galahad_tpu_qpa_control def;
    if (control == NULL) {
        galahad_tpu_qpa_control_init(&def);
        control = &def;
    }
    int rc = galahad_tpu_init();
    if (rc != 0) return rc;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = PyObject_CallMethod(
        g_impl, "qpa_solve_raw", "ii" "idd" "LLd" "LLL" "LL" "LLL",
        (int)n, (int)m,
        (int)control->maxit, control->feas_tol, control->multiplier_tol,
        (long long)(intptr_t)H, (long long)(intptr_t)g, f,
        (long long)(intptr_t)A,
        (long long)(intptr_t)c_l, (long long)(intptr_t)c_u,
        (long long)(intptr_t)x_l, (long long)(intptr_t)x_u,
        (long long)(intptr_t)x, (long long)(intptr_t)y,
        (long long)(intptr_t)z);
    int status = parse_inform6(res, inform);
    PyGILState_Release(st);
    return status;
}

static int parse_trs_inform(PyObject *res,
                            galahad_tpu_trs_inform *inform) {
    int status = GALAHAD_TPU_RESTRICTIONS;
    if (res == NULL) {
        PyErr_Print();
        if (inform != NULL) {
            memset(inform, 0, sizeof(*inform));
            inform->status = status;
        }
        return status;
    }
    double mult = 0, obj = 0, nx = 0;
    int hard = 0;
    if (!PyArg_ParseTuple(res, "idddi", &status, &mult, &obj, &nx,
                          &hard)) {
        PyErr_Print();
        status = GALAHAD_TPU_RESTRICTIONS;
    }
    if (inform != NULL) {
        inform->status = status;
        inform->multiplier = mult;
        inform->obj = obj;
        inform->norm_x = nx;
        inform->hard_case = hard;
    }
    Py_DECREF(res);
    return status;
}

int galahad_tpu_trs_solve(int32_t n, const double *H, const double *g,
                          double radius, double *x,
                          galahad_tpu_trs_inform *inform) {
    int rc = galahad_tpu_init();
    if (rc != 0) return rc;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = PyObject_CallMethod(
        g_impl, "trs_solve_raw", "iLLdL",
        (int)n, (long long)(intptr_t)H, (long long)(intptr_t)g,
        radius, (long long)(intptr_t)x);
    int status = parse_trs_inform(res, inform);
    PyGILState_Release(st);
    return status;
}

int galahad_tpu_rqs_solve(int32_t n, const double *H, const double *g,
                          double sigma, double power, double *x,
                          galahad_tpu_trs_inform *inform) {
    int rc = galahad_tpu_init();
    if (rc != 0) return rc;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = PyObject_CallMethod(
        g_impl, "rqs_solve_raw", "iLLddL",
        (int)n, (long long)(intptr_t)H, (long long)(intptr_t)g,
        sigma, power, (long long)(intptr_t)x);
    int status = parse_trs_inform(res, inform);
    PyGILState_Release(st);
    return status;
}

int64_t galahad_tpu_sls_analyse(int32_t n, int64_t nnz,
                                const int32_t *rows, const int32_t *cols,
                                int32_t order) {
    int rc = galahad_tpu_init();
    if (rc != 0) return rc;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = PyObject_CallMethod(
        g_impl, "sls_analyse_raw", "iLLLi",
        (int)n, (long long)nnz,
        (long long)(intptr_t)rows, (long long)(intptr_t)cols,
        (int)order);
    int64_t handle = GALAHAD_TPU_RESTRICTIONS;
    if (res == NULL) {
        PyErr_Print();
    } else {
        handle = PyLong_AsLongLong(res);
        Py_DECREF(res);
    }
    PyGILState_Release(st);
    return handle;
}

static int sls_call_i(const char *name, PyObject *args_res) {
    int status = GALAHAD_TPU_RESTRICTIONS;
    if (args_res == NULL) {
        PyErr_Print();
        return status;
    }
    status = (int)PyLong_AsLong(args_res);
    Py_DECREF(args_res);
    return status;
}

int galahad_tpu_sls_factorize(int64_t handle, const double *vals,
                              double shift) {
    int rc = galahad_tpu_init();
    if (rc != 0) return rc;
    PyGILState_STATE st = PyGILState_Ensure();
    int status = sls_call_i("sls_factorize_raw", PyObject_CallMethod(
        g_impl, "sls_factorize_raw", "LLd",
        (long long)handle, (long long)(intptr_t)vals, shift));
    PyGILState_Release(st);
    return status;
}

int galahad_tpu_sls_solve(int64_t handle, const double *b, double *x) {
    int rc = galahad_tpu_init();
    if (rc != 0) return rc;
    PyGILState_STATE st = PyGILState_Ensure();
    int status = sls_call_i("sls_solve_raw", PyObject_CallMethod(
        g_impl, "sls_solve_raw", "LLL",
        (long long)handle, (long long)(intptr_t)b,
        (long long)(intptr_t)x));
    PyGILState_Release(st);
    return status;
}

int galahad_tpu_sls_inertia(int64_t handle, int32_t *inertia) {
    int rc = galahad_tpu_init();
    if (rc != 0) return rc;
    PyGILState_STATE st = PyGILState_Ensure();
    int status = sls_call_i("sls_inertia_raw", PyObject_CallMethod(
        g_impl, "sls_inertia_raw", "LL",
        (long long)handle, (long long)(intptr_t)inertia));
    PyGILState_Release(st);
    return status;
}

void galahad_tpu_sls_free(int64_t handle) {
    if (galahad_tpu_init() != 0) return;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = PyObject_CallMethod(g_impl, "sls_free_raw", "L",
                                        (long long)handle);
    Py_XDECREF(res);
    PyGILState_Release(st);
}
