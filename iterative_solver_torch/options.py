"""Typed options + key=value string parsing (copy of iterative_solver_tpu/options.py).

Mirrors the reference's Options hierarchy (Options.h:20-61, per-solver
*Options.h — see SURVEY.md Appendix A) and StringFacet::parse_keyval_string
(util.h:104-115). Keys are case-insensitive.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


def parse_keyval_string(options: str) -> Dict[str, str]:
    """Parse "key=value,key=value" into an upper-cased dict."""
    result: Dict[str, str] = {}
    if not options:
        return result
    for part in options.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"malformed option: {part!r}")
        key, value = part.split("=", 1)
        result[key.strip().upper()] = value.strip()
    return result


def _get(mapping, key, conv):
    v = mapping.get(key.upper())
    return conv(v) if v is not None else None


def _bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Options:
    n_roots: Optional[int] = None
    convergence_threshold: Optional[float] = None
    convergence_threshold_value: Optional[float] = None
    verbosity: Optional[int] = None
    max_iter: Optional[int] = None
    max_p: Optional[int] = None
    p_threshold: Optional[float] = None

    @classmethod
    def from_string(cls, options: str) -> "Options":
        m = parse_keyval_string(options)
        return cls(**cls._parse_fields(m))

    @classmethod
    def _parse_fields(cls, m) -> dict:
        return dict(
            n_roots=_get(m, "N_ROOTS", int),
            convergence_threshold=_get(m, "CONVERGENCE_THRESHOLD", float),
            convergence_threshold_value=_get(m, "CONVERGENCE_THRESHOLD_VALUE", float),
            verbosity=_get(m, "VERBOSITY", int),
            max_iter=_get(m, "MAX_ITER", int),
            max_p=_get(m, "MAX_P", int),
            p_threshold=_get(m, "P_THRESHOLD", float),
        )


@dataclasses.dataclass
class LinearEigensystemDavidsonOptions(Options):
    reset_D: Optional[int] = None
    reset_D_max_Q_size: Optional[int] = None
    max_size_qspace: Optional[int] = None
    norm_thresh: Optional[float] = None
    svd_thresh: Optional[float] = None
    hermiticity: Optional[bool] = None

    @classmethod
    def from_string(cls, options: str) -> "LinearEigensystemDavidsonOptions":
        m = parse_keyval_string(options)
        fields = Options._parse_fields(m)
        fields.update(
            reset_D=_get(m, "RESET_D", int),
            reset_D_max_Q_size=_get(m, "RESET_D_MAX_Q_SIZE", int),
            max_size_qspace=_get(m, "MAX_SIZE_QSPACE", int),
            norm_thresh=_get(m, "NORM_THRESH", float),
            svd_thresh=_get(m, "SVD_THRESH", float),
            hermiticity=_get(m, "HERMITICITY", _bool),
        )
        return cls(**fields)


@dataclasses.dataclass
class LinearEquationsDavidsonOptions(LinearEigensystemDavidsonOptions):
    augmented_hessian: Optional[float] = None

    @classmethod
    def from_string(cls, options: str) -> "LinearEquationsDavidsonOptions":
        base = LinearEigensystemDavidsonOptions.from_string(options)
        m = parse_keyval_string(options)
        fields = dataclasses.asdict(base)
        fields.update(augmented_hessian=_get(m, "AUGMENTED_HESSIAN", float))
        return cls(**fields)


@dataclasses.dataclass
class LinearEigensystemRSPTOptions(Options):
    norm_thresh: Optional[float] = None
    svd_thresh: Optional[float] = None

    @classmethod
    def from_string(cls, options: str) -> "LinearEigensystemRSPTOptions":
        m = parse_keyval_string(options)
        fields = Options._parse_fields(m)
        fields.update(
            norm_thresh=_get(m, "NORM_THRESH", float),
            svd_thresh=_get(m, "SVD_THRESH", float),
        )
        return cls(**fields)


@dataclasses.dataclass
class NonLinearEquationsDIISOptions(Options):
    max_size_qspace: Optional[int] = None
    norm_thresh: Optional[float] = None
    svd_thresh: Optional[float] = None

    @classmethod
    def from_string(cls, options: str) -> "NonLinearEquationsDIISOptions":
        m = parse_keyval_string(options)
        fields = Options._parse_fields(m)
        fields.update(
            max_size_qspace=_get(m, "MAX_SIZE_QSPACE", int),
            norm_thresh=_get(m, "NORM_THRESH", float),
            svd_thresh=_get(m, "SVD_THRESH", float),
        )
        return cls(**fields)


@dataclasses.dataclass
class OptimizeBFGSOptions(Options):
    max_size_qspace: Optional[int] = None
    norm_thresh: Optional[float] = None
    svd_thresh: Optional[float] = None
    strong_Wolfe: Optional[bool] = None
    Wolfe_1: Optional[float] = None
    Wolfe_2: Optional[float] = None
    linesearch_tolerance: Optional[float] = None
    linesearch_grow_factor: Optional[float] = None

    @classmethod
    def from_string(cls, options: str) -> "OptimizeBFGSOptions":
        m = parse_keyval_string(options)
        fields = Options._parse_fields(m)
        fields.update(
            max_size_qspace=_get(m, "MAX_SIZE_QSPACE", int),
            norm_thresh=_get(m, "NORM_THRESH", float),
            svd_thresh=_get(m, "SVD_THRESH", float),
            strong_Wolfe=_get(m, "STRONG_WOLFE", _bool),
            Wolfe_1=_get(m, "WOLFE_1", float),
            Wolfe_2=_get(m, "WOLFE_2", float),
            linesearch_tolerance=_get(m, "LINESEARCH_TOLERANCE", float),
            linesearch_grow_factor=_get(m, "LINESEARCH_GROW_FACTOR", float),
        )
        return cls(**fields)


@dataclasses.dataclass
class OptimizeSDOptions(Options):
    @classmethod
    def from_string(cls, options: str) -> "OptimizeSDOptions":
        m = parse_keyval_string(options)
        return cls(**Options._parse_fields(m))
