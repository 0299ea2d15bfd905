"""The reference's example patient (``predict_hf.py:5-27``).

Copy of the JAX package's ``data/examples.py`` (numpy only). The insertion
order of ``EXAMPLE_PATIENT`` is the model input contract: the 17
Lasso-selected features in training order, locked to ``schema.SELECTED_17``.
"""

from __future__ import annotations

import math

import numpy as np

from machine_learning_replications_tpu_torch.data.schema import SELECTED_17

EXAMPLE_PATIENT: dict[str, float] = {
    "Obstructive HCM": 1,
    "Gender": 1,
    "Syncope": 0,
    "Dyspnea": 0,
    "Fatigue": 1,
    "Presyncope": 0,
    "NYHA_Class": 1,
    "Atrial_Fibrillation": 1,
    "Hypertension": 0,
    "Beta_blocker": 0,
    "Ca_Channel_Blockers": 0,
    "ACEI_ARB": 0,
    "Coumadin": 0,
    "Max_Wall_Thick": 13,
    "Septal_Anterior_Motion": 0,
    "Mitral_Regurgitation": 0,
    "Ejection_Fraction": 55,
}

if tuple(EXAMPLE_PATIENT) != SELECTED_17:
    raise RuntimeError("example patient order drifted from schema.SELECTED_17")


def patient_row(params: dict[str, float] | None = None) -> np.ndarray:
    """Flatten a patient dict to the ``(1, 17)`` float64 model input row, as
    ``predict_hf.py:29-31`` does."""
    d = EXAMPLE_PATIENT if params is None else params
    return np.array([d[k] for k in EXAMPLE_PATIENT], dtype=np.float64).reshape(1, -1)


def validate_patient(patient: dict) -> np.ndarray:
    """Validate a patient dict against the 17-variable inference contract and
    return its ``(1, 17)`` row: all 17 variables present, no unknown keys,
    finite numeric values (silently defaulting or imputing a clinical input
    would be unsafe). Raises ``ValueError`` naming what is wrong."""
    if not isinstance(patient, dict):
        raise ValueError(
            f"patient must be a JSON object of the 17 variables, got "
            f"{type(patient).__name__}"
        )
    unknown = set(patient) - set(EXAMPLE_PATIENT)
    if unknown:
        raise ValueError(f"unknown patient variables: {sorted(unknown)}")
    missing = [k for k in EXAMPLE_PATIENT if k not in patient]
    if missing:
        raise ValueError(
            "patient JSON must provide all 17 variables; missing: " + ", ".join(missing)
        )
    bad = [
        k for k, v in patient.items()
        if isinstance(v, bool) or not isinstance(v, (int, float)) or not math.isfinite(v)
    ]
    if bad:
        raise ValueError(f"non-numeric or non-finite patient variables: {sorted(bad)}")
    return patient_row(patient)
