"""Develop-parameter sidecars: persist fitted state for reproducible develops.

A copy of ``pysp_tpu/utils/sidecar.py`` whose registry holds the port's CA
models. The JSON is the same byte for byte, so a sidecar written by either
package loads in the other.

SURVEY.md §5 (checkpoint/resume row): the reference's only mutable state is the
in-place raw buffer; this rebuild's develops are stateless, so the quantities
worth persisting are the FITTED ones — blind-CA model coefficients (a few
floats, expensive to re-fit) and the solved white balance. A sidecar is a small
JSON next to the raw file: fit once (say, on the first frame of a burst), apply
everywhere, diff and version like any text file.

CLI: ``pysp_tpu_torch develop shot.dng --ca --save-params shot.json`` writes
the fitted state; ``pysp_tpu_torch develop shot.dng --params shot.json``
applies it without re-fitting.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

SIDECAR_VERSION = 1

_CA_MODEL_TYPES: Dict[str, Any] = {}


def _model_registry():
    global _CA_MODEL_TYPES
    if not _CA_MODEL_TYPES:
        from ..correct.ca.models import (
            Poly3CorrectionModel,
            Poly5CorrectionModel,
            PtLensCorrectionModel,
        )

        _CA_MODEL_TYPES = {
            "Poly3": Poly3CorrectionModel,
            "Poly5": Poly5CorrectionModel,
            "PTLens": PtLensCorrectionModel,
        }
    return _CA_MODEL_TYPES


def ca_model_to_dict(model) -> Optional[Dict[str, Any]]:
    """Serializable form of a fitted CA model: {"type", "coefficients"}."""
    if model is None:
        return None
    reg = _model_registry()
    for name, cls in reg.items():
        if isinstance(model, cls):
            return {
                "type": name,
                "coefficients": [float(v) for v in model.get_coefficients()],
            }
    raise ValueError(f"unsupported CA model type: {type(model).__name__}")


def ca_model_from_dict(d: Optional[Dict[str, Any]]):
    if d is None:
        return None
    reg = _model_registry()
    cls = reg.get(d.get("type"))
    if cls is None:
        raise ValueError(f"unknown CA model type in sidecar: {d.get('type')!r}")
    return cls(*[float(v) for v in d["coefficients"]])


def save_sidecar(
    path: str,
    ca_model_r=None,
    ca_model_b=None,
    wb_neutral: Optional[np.ndarray] = None,
    temperature: Optional[float] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Write a develop-parameter sidecar; returns the dict written."""
    doc: Dict[str, Any] = {"pysp_tpu_sidecar": SIDECAR_VERSION}
    if ca_model_r is not None or ca_model_b is not None:
        doc["ca"] = {
            "model_r": ca_model_to_dict(ca_model_r),
            "model_b": ca_model_to_dict(ca_model_b),
        }
    if wb_neutral is not None:
        doc["wb_neutral"] = [float(v) for v in np.asarray(wb_neutral).tolist()]
    if temperature is not None:
        doc["temperature_k"] = float(temperature)
    if extra:
        doc["extra"] = extra
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc


def load_sidecar(path: str) -> Dict[str, Any]:
    """Read a sidecar back into usable objects.

    Returns {"ca_model_r", "ca_model_b", "wb_neutral" (np.ndarray | None),
    "temperature_k" (float | None), "extra"}. Raises ValueError on an
    unrecognized document.
    """
    with open(path) as f:
        doc = json.load(f)
    if doc.get("pysp_tpu_sidecar") != SIDECAR_VERSION:
        raise ValueError(
            f"{path}: not a pysp_tpu sidecar (or unsupported version "
            f"{doc.get('pysp_tpu_sidecar')!r})"
        )
    ca = doc.get("ca") or {}
    return {
        "ca_model_r": ca_model_from_dict(ca.get("model_r")),
        "ca_model_b": ca_model_from_dict(ca.get("model_b")),
        "wb_neutral": (
            np.asarray(doc["wb_neutral"], np.float64)
            if "wb_neutral" in doc
            else None
        ),
        "temperature_k": doc.get("temperature_k"),
        "extra": doc.get("extra"),
    }


def fitted_models_tuple(params: Dict[str, Any]) -> Tuple[Any, Any]:
    return params["ca_model_r"], params["ca_model_b"]
