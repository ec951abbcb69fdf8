"""State carried across from the JAX package, as numpy arrays.

The tests feed both packages the same inputs: the caller turns the JAX
package's objects into dictionaries of numpy arrays (``np.asarray`` on
each field; that side imports JAX) and these functions build the port's
objects from them.  This module imports no JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device, resolve_dtype
from .core.problem import QP, make_qp
from .core.sparse import COOPattern, SparseQP
from .linalg.band_ops import BandMatrix
from .linalg.bsc import BSCPlan
from .linalg.scu import SCUState
from .linalg.supernodal import LevelPlan, SupernodalSymbolic
from .linalg.supernodal_flat import FlatGroup, FlatPlan
from .nlp._loop import TRUState
from .nlp.check import FDHPattern
from .nlp.filtrane import Filter
from .nlp.lancelot import LancelotInfo
from .pre.presolve import PresolveTransform
from .pre.scale import Scaling
from .qp.dqp import DQPInfo
from .qp.ipm import IPMState, device_state
from .qp.ipm_banded import BandedQP, make_banded_qp
from .qp.qcqp import QCQP
from .qn.lms import LMSData
from .qn.sha import SHAPattern
from .tr.trs import TRSInfo
from .tr.trs_sparse import TRSSparseInfo


def _get(fields):
    """The field reader of a dict or of an object."""
    return fields.get if isinstance(fields, dict) else lambda k: getattr(fields, k)


def coo_pattern_from_numpy(p) -> COOPattern:
    """Build a COOPattern from the JAX ``COOPattern``'s fields: ``p`` is a
    dict (or an object) with ``rows``, ``cols``, ``m`` and ``n``."""
    get = _get(p)
    return COOPattern(np.asarray(get("rows")), np.asarray(get("cols")),
                      int(get("m")), int(get("n")))


def sparse_qp_from_numpy(fields: dict, dtype=None, device=None) -> SparseQP:
    """Build a SparseQP from the JAX ``SparseQP``'s fields as numpy arrays:
    ``g``, ``c_l``, ``c_u``, ``x_l``, ``x_u``, ``h_vals``, ``a_vals``,
    ``f`` and optionally ``x``/``y``/``z``, plus ``h_pat`` and ``a_pat``
    (each with ``rows``, ``cols``, ``m``, ``n``)."""
    device = resolve_device(device)
    dt = resolve_dtype(dtype)
    npdt = np.float64 if dt == torch.float64 else np.float32

    def dev(a):
        if a is None:
            return None
        return torch.as_tensor(np.array(a, dtype=npdt, order="C"),
                               device=device)

    return SparseQP(
        g=dev(fields["g"]), f=float(fields.get("f", 0.0)),
        c_l=dev(fields["c_l"]), c_u=dev(fields["c_u"]),
        x_l=dev(fields["x_l"]), x_u=dev(fields["x_u"]),
        h_vals=dev(fields["h_vals"]), a_vals=dev(fields["a_vals"]),
        x=dev(fields.get("x")), y=dev(fields.get("y")), z=dev(fields.get("z")),
        h_pat=coo_pattern_from_numpy(fields["h_pat"]),
        a_pat=coo_pattern_from_numpy(fields["a_pat"]),
        name=str(fields.get("name", "")))


def qp_from_numpy(fields: dict, dtype=None, device=None) -> QP:
    """Build a dense QP from the JAX ``QP``'s fields as numpy arrays:
    ``g``, ``A``, ``c_l``, ``c_u``, ``x_l``, ``x_u``, ``H`` (None for the
    "zero" and "identity" kinds), ``h_kind``, ``f`` and optionally
    ``x``/``y``/``z`` and ``name``."""
    return make_qp(
        g=fields["g"], A=fields.get("A"), c_l=fields["c_l"], c_u=fields["c_u"],
        x_l=fields["x_l"], x_u=fields["x_u"], H=fields.get("H"),
        h_kind=str(fields.get("h_kind", "dense")), f=float(fields.get("f", 0.0)),
        x=fields.get("x"), y=fields.get("y"), z=fields.get("z"),
        name=str(fields.get("name", "")), dtype=dtype, device=device)


def band_matrix_from_numpy(fields, dtype=None, device=None) -> BandMatrix:
    """Build a BandMatrix from the JAX ``BandMatrix``'s fields (a dict, or an
    object with them): ``val`` (ndiag, m) as a numpy array, ``offsets``,
    ``m`` and ``n``."""
    get = fields.get if isinstance(fields, dict) else lambda k: getattr(fields, k)
    device = resolve_device(device)
    val = torch.as_tensor(np.array(get("val"), dtype=np.float64, order="C"),
                          device=device).to(resolve_dtype(dtype))
    return BandMatrix(val=val, offsets=tuple(int(o) for o in get("offsets")),
                      m=int(get("m")), n=int(get("n")))


def banded_qp_from_numpy(fields: dict, dtype=None, device=None) -> BandedQP:
    """Build a BandedQP from the JAX ``BandedQP``'s fields as numpy arrays:
    ``g``, ``c_l``, ``c_u``, ``x_l``, ``x_u``, ``h_diags`` (None for
    h_kind "zero"), ``A_band`` (None, or the fields of a ``BandMatrix``, see
    :func:`band_matrix_from_numpy`), ``h_kind``, ``block``, ``cg_maxit``,
    ``f`` and optionally ``x``/``y``/``z`` and ``name``."""
    a = fields.get("A_band")
    get = (a.get if isinstance(a, dict) else lambda k: getattr(a, k)) if a is not None else None
    return make_banded_qp(
        g=fields["g"], a_val=None if a is None else get("val"),
        a_offsets=() if a is None else tuple(int(o) for o in get("offsets")),
        c_l=fields["c_l"], c_u=fields["c_u"], x_l=fields["x_l"], x_u=fields["x_u"],
        h_diags=fields.get("h_diags"), h_kind=str(fields.get("h_kind", "banded")),
        block=int(fields.get("block", 8)), cg_maxit=int(fields.get("cg_maxit", 64)),
        f=float(fields.get("f", 0.0)), x=fields.get("x"), y=fields.get("y"),
        z=fields.get("z"), name=str(fields.get("name", "")), dtype=dtype, device=device)


def flat_plan_from_numpy(fields: dict) -> FlatPlan:
    """Build a FlatPlan from the JAX ``FlatPlan``'s fields: ``n``, ``S``,
    ``perm``, ``iperm``, ``a_idx``, ``a_src``, ``d_idx``, ``d_col``,
    ``nnz_L``, ``flops``, ``ns`` and ``groups``, a list of dicts with
    ``goff``, ``nb``, ``Fpad``, ``level``, ``ncols``, ``frows`` and ``ea``
    (the raw extend-add records)."""
    i64 = lambda a: np.asarray(a, np.int64)
    groups = [
        FlatGroup(goff=int(g["goff"]), nb=int(g["nb"]), Fpad=int(g["Fpad"]),
                  level=int(g["level"]), ncols=i64(g["ncols"]),
                  frows=i64(g["frows"]),
                  ea=[dict(sbase=int(o["sbase"]), sncols=int(o["sncols"]),
                           fp_src=int(o["fp_src"]), u=int(o["u"]),
                           ppos=i64(o["ppos"]), ppar=int(o["ppar"]))
                      for o in g["ea"]])
        for g in fields["groups"]]
    return FlatPlan(
        n=int(fields["n"]), S=int(fields["S"]),
        perm=i64(fields["perm"]), iperm=i64(fields["iperm"]), groups=groups,
        a_idx=i64(fields["a_idx"]), a_src=i64(fields["a_src"]),
        d_idx=i64(fields["d_idx"]), d_col=i64(fields["d_col"]),
        nnz_L=int(fields.get("nnz_L", 0)), flops=float(fields.get("flops", 0.0)),
        ns=int(fields.get("ns", len(groups))))


def ipm_state_from_numpy(fields: dict, dtype=None, device=None) -> IPMState:
    """Build an IPMState from the JAX ``IPMState``'s fields, folding each
    double-word ``(hi, lo)`` pair into one value of the working type:
    ``x``+``x_lo``, ``c``+``c_lo``, ``y``+``y_lo``, ``z_l``+``zl_lo``,
    ``z_u``+``zu_lo``, ``y_l``+``yl_lo``, ``y_u``+``yu_lo``.  The scalar
    fields become 0-d tensors on ``device``, as the step takes them."""
    device = resolve_device(device)
    dt = resolve_dtype(dtype)
    npdt = np.float64 if dt == torch.float64 else np.float32

    def fold(hi, lo=None):
        v = np.asarray(fields[hi], np.float64)
        if lo is not None and fields.get(lo) is not None:
            v = v + np.asarray(fields[lo], np.float64)
        return torch.as_tensor(np.ascontiguousarray(v.astype(npdt)),
                               device=device)

    def scalar(name, default, cast):
        v = fields.get(name)
        return default if v is None else cast(np.asarray(v))

    return device_state(IPMState(
        x=fold("x", "x_lo"), c=fold("c", "c_lo"), y=fold("y", "y_lo"),
        z_l=fold("z_l", "zl_lo"), z_u=fold("z_u", "zu_lo"),
        y_l=fold("y_l", "yl_lo"), y_u=fold("y_u", "yu_lo"),
        s_l=fold("s_l"), s_u=fold("s_u"), t_l=fold("t_l"), t_u=fold("t_u"),
        mu=fold("mu"),
        iter=scalar("iter", 0, int),
        converged=scalar("converged", False, bool),
        halt=scalar("halt", False, bool),
        status=scalar("status", IPMState.__dataclass_fields__["status"].default,
                      int),
        res_p=scalar("res_p", float("inf"), float),
        res_d=scalar("res_d", float("inf"), float),
        res_c=scalar("res_c", float("inf"), float),
        best_infeas=scalar("best_infeas", float("inf"), float),
        stall=scalar("stall", 0, int)))


def _tensor(a, dtype=None, device=None):
    return torch.as_tensor(np.array(a, dtype=np.float64, order="C"),
                           device=resolve_device(device)).to(resolve_dtype(dtype))


def scaling_from_numpy(fields: dict, dtype=None, device=None) -> Scaling:
    """Build a Scaling from the JAX ``Scaling``'s fields as numpy arrays:
    ``row`` (m,) and ``col`` (n,)."""
    return Scaling(row=_tensor(fields["row"], dtype, device),
                   col=_tensor(fields["col"], dtype, device))


def presolve_transform_from_numpy(fields: dict) -> PresolveTransform:
    """Build a PresolveTransform from the JAX ``PresolveTransform``'s fields
    (host numpy arrays and Python values in both packages; ``empty``, which
    the JAX package sets as an attribute, is read too)."""
    names = {f.name for f in dataclasses.fields(PresolveTransform)}
    kw = {k: v for k, v in fields.items() if k in names}
    for k in ("keep_x", "keep_c", "x_fixed_val", "x_fixed", "transfer_row",
              "transfer_coef", "x_l0", "x_u0", "c_l0", "c_u0", "H", "g", "A"):
        if kw.get(k) is not None:
            kw[k] = np.array(kw[k])
    kw["merged_rows"] = [(int(i), int(k), float(s)) for i, k, s in kw.get("merged_rows") or []]
    return PresolveTransform(**kw)


def dqp_info_from_numpy(fields: dict, dtype=None, device=None) -> DQPInfo:
    """Build a DQPInfo from the JAX ``DQPInfo``'s fields as numpy arrays:
    ``x``, ``y``, ``z`` and the scalars ``obj``, ``iter``, ``converged``,
    ``status``, ``norm_pg``."""
    return DQPInfo(x=_tensor(fields["x"], dtype, device), y=_tensor(fields["y"], dtype, device),
                   z=_tensor(fields["z"], dtype, device), obj=float(fields["obj"]),
                   iter=int(fields["iter"]), converged=bool(fields["converged"]),
                   status=int(fields["status"]), norm_pg=float(fields["norm_pg"]))


def trs_info_from_numpy(fields: dict, dtype=None, device=None) -> TRSInfo:
    """Build a TRSInfo from the JAX ``TRSInfo``'s fields as numpy arrays:
    ``x``, ``obj``, ``multiplier``, ``norm_x`` (tensors of ``dtype``) and the
    flags ``hard_case``, ``interior`` (bool tensors), on ``device``."""
    device = resolve_device(device)
    flag = lambda k: torch.as_tensor(np.asarray(fields[k], bool), device=device)   # noqa: E731
    return TRSInfo(x=_tensor(fields["x"], dtype, device), obj=_tensor(fields["obj"], dtype, device),
                   multiplier=_tensor(fields["multiplier"], dtype, device),
                   norm_x=_tensor(fields["norm_x"], dtype, device),
                   hard_case=flag("hard_case"), interior=flag("interior"))


def trs_sparse_info_from_numpy(fields: dict, dtype=None, device=None) -> TRSSparseInfo:
    """Build a TRSSparseInfo from the JAX ``TRSSparseInfo``'s fields (``x`` as
    a numpy array, the rest host values as in both packages), so that a JAX
    result warm-starts the port's ``trs_contract``."""
    return TRSSparseInfo(
        x=_tensor(fields["x"], dtype, device), obj=float(fields["obj"]),
        multiplier=float(fields["multiplier"]), norm_x=float(fields["norm_x"]),
        hard_case=bool(fields["hard_case"]), interior=bool(fields["interior"]),
        n_factorizations=int(fields["n_factorizations"]),
        history_lambda=np.asarray(fields["history_lambda"], np.float64),
        history_norm=np.asarray(fields["history_norm"], np.float64))


def tru_state_from_numpy(fields, dtype=None, device=None) -> TRUState:
    """Build a TRUState from the JAX ``TRUState``'s fields as numpy arrays (a
    dict or an object): ``x``, ``f``, ``g``, ``radius``, ``norm_g`` as
    tensors of ``dtype``, ``iter`` / ``status`` int32, ``converged`` bool."""
    get = _get(fields)
    device = resolve_device(device)
    t = lambda k, dt: torch.as_tensor(np.array(get(k)), device=device).to(dt)  # noqa: E731
    ft = resolve_dtype(dtype)
    return TRUState(x=t("x", ft), f=t("f", ft), g=t("g", ft), radius=t("radius", ft),
                    iter=t("iter", torch.int32), converged=t("converged", torch.bool),
                    status=t("status", torch.int32), norm_g=t("norm_g", ft))


def lms_data_from_numpy(fields, dtype=None, device=None) -> LMSData:
    """Build an LMSData from the JAX ``LMSData``'s fields: ``S``, ``Y``,
    ``valid``, ``head``, ``delta`` (numpy) and ``method``; a wrapped ring
    buffer keeps its slots and its ``head``."""
    get = _get(fields)
    device = resolve_device(device)
    ft = resolve_dtype(dtype)
    t = lambda k, dt: torch.as_tensor(np.array(get(k)), device=device).to(dt)  # noqa: E731
    return LMSData(S=t("S", ft), Y=t("Y", ft), valid=t("valid", torch.bool),
                   head=t("head", torch.int64), delta=t("delta", ft), method=str(get("method")))


def sha_pattern_from_numpy(fields) -> SHAPattern:
    """Build an SHAPattern from the JAX ``SHAPattern``'s fields (``row_cols``
    as nested tuples or an array, ``row_deg``, ``n``, ``max_deg``)."""
    get = _get(fields)
    n, max_deg = int(get("n")), int(get("max_deg"))
    return SHAPattern(row_cols=np.asarray(get("row_cols"), np.int64).reshape(n, max_deg),
                      row_deg=np.asarray(get("row_deg"), np.int64), n=n, max_deg=max_deg)


def fdh_pattern_from_numpy(fields) -> FDHPattern:
    """Build an FDHPattern from the JAX ``FDHPattern``'s fields."""
    get = _get(fields)
    return FDHPattern(n=int(get("n")), rows=np.asarray(get("rows"), np.int32),
                      cols=np.asarray(get("cols"), np.int32),
                      groups=np.asarray(get("groups"), np.int32), ngroups=int(get("ngroups")))


def bsc_plan_from_numpy(fields) -> BSCPlan:
    """Build a BSCPlan from the JAX ``BSCPlan``'s fields: ``m``, ``n``,
    ``s_pat`` (a COOPattern or its fields), ``p1``, ``p2``, ``dcol``,
    ``sout``."""
    get = _get(fields)
    arr = lambda k: np.asarray(get(k), np.int64)  # noqa: E731
    return BSCPlan(int(get("m")), int(get("n")), coo_pattern_from_numpy(get("s_pat")),
                   arr("p1"), arr("p2"), arr("dcol"), arr("sout"))


def qcqp_from_numpy(fields, dtype=None, device=None) -> QCQP:
    """Build a QCQP from the JAX ``QCQP``'s fields as numpy arrays (a dict or
    an object): ``g``, ``A``, ``Qc``, ``c_l``, ``c_u``, ``x_l``, ``x_u``,
    ``H`` (None for the "zero" kind), ``f``, optionally ``x`` / ``y`` /
    ``z``, and ``name``, ``h_kind``."""
    get = _get(fields)
    t = lambda k: None if get(k) is None else _tensor(get(k), dtype, device)  # noqa: E731
    return QCQP(g=t("g"), A=t("A"), Qc=t("Qc"), c_l=t("c_l"), c_u=t("c_u"), x_l=t("x_l"),
                x_u=t("x_u"), H=t("H"), f=float(get("f")), x=t("x"), y=t("y"), z=t("z"),
                name=str(get("name") or ""), h_kind=str(get("h_kind") or "dense"))


def filter_from_numpy(fields, dtype=None, device=None) -> Filter:
    """Build a FILTER state from the JAX ``Filter``'s fields: ``theta_inf``,
    ``theta_2`` (numpy), ``count`` and ``cap``."""
    get = _get(fields)
    device = resolve_device(device)
    return Filter(theta_inf=_tensor(get("theta_inf"), dtype, device),
                  theta_2=_tensor(get("theta_2"), dtype, device),
                  count=torch.full((), int(get("count")), dtype=torch.int32, device=device),
                  cap=int(get("cap")))


def lancelot_info_from_numpy(fields, dtype=None, device=None) -> LancelotInfo:
    """Build a LancelotInfo from the JAX ``LancelotInfo``'s fields: ``x``,
    ``y``, ``f``, ``infeas``, ``norm_pg``, ``mu`` as tensors of ``dtype``,
    ``iter`` / ``status`` int32, ``converged`` bool."""
    get = _get(fields)
    device = resolve_device(device)
    t = lambda k, dt: torch.as_tensor(np.array(get(k)), device=device).to(dt)  # noqa: E731
    ft = resolve_dtype(dtype)
    return LancelotInfo(x=t("x", ft), y=t("y", ft), f=t("f", ft), infeas=t("infeas", ft),
                        norm_pg=t("norm_pg", ft), mu=t("mu", ft), iter=t("iter", torch.int32),
                        converged=t("converged", torch.bool), status=t("status", torch.int32))


def supernodal_symbolic_from_numpy(fields) -> SupernodalSymbolic:
    """Build the inline supernodal plan from the JAX ``SupernodalSymbolic``'s
    fields (numpy; a dict or an object): ``n``, ``perm``, ``iperm``,
    ``nnz_L``, ``flops``, ``ns`` and ``levels``, each with ``frows``,
    ``ncols``, ``nrows``, ``Cmax``, ``Fpad``, ``B``, ``a_node``, ``a_fi``,
    ``a_fj``, ``a_src`` and ``ea`` (dicts of ``src_level``, ``src_nodes``,
    ``dst_nodes``, ``cpos``, ``ppos``, ``uvalid``)."""
    get = _get(fields)
    levels = []
    for lv in get("levels"):
        g = _get(lv)
        levels.append(LevelPlan(
            frows=np.asarray(g("frows"), np.int32), ncols=np.asarray(g("ncols"), np.int32),
            nrows=np.asarray(g("nrows"), np.int32), Cmax=int(g("Cmax")), Fpad=int(g("Fpad")),
            B=int(g("B")), a_node=np.asarray(g("a_node"), np.int32),
            a_fi=np.asarray(g("a_fi"), np.int32), a_fj=np.asarray(g("a_fj"), np.int32),
            a_src=np.asarray(g("a_src"), np.int32),
            ea=[dict(src_level=int(e["src_level"]),
                     src_nodes=np.asarray(e["src_nodes"], np.int32),
                     dst_nodes=np.asarray(e["dst_nodes"], np.int32),
                     cpos=np.asarray(e["cpos"], np.int32), ppos=np.asarray(e["ppos"], np.int32),
                     uvalid=np.asarray(e["uvalid"], bool)) for e in g("ea")]))
    return SupernodalSymbolic(n=int(get("n")), perm=np.asarray(get("perm"), np.int64),
                              iperm=np.asarray(get("iperm"), np.int64), levels=levels,
                              nnz_L=int(get("nnz_L")), flops=float(get("flops")),
                              ns=int(get("ns")))


def scu_state_from_numpy(fields, dtype=None, device=None) -> SCUState:
    """Build an SCUState from the JAX ``SCUState``'s fields: ``B``, ``C``,
    ``D``, ``S``, ``W`` (numpy), ``count``, ``cap`` and ``n``."""
    get = _get(fields)
    device = resolve_device(device)
    return SCUState(**{k: _tensor(get(k), dtype, device) for k in ("B", "C", "D", "S", "W")},
                    count=torch.full((), int(get("count")), dtype=torch.int64, device=device),
                    cap=int(get("cap")), n=int(get("n")))
