"""Cohort schema — the 64 clinical variables of Supplementary Table S1.

The reference ships the schema only as a Word table (``HF/Table 1.DOCX``,
"Supplementary Table S1", n=1427 HCM patients); the feature matrix contract is
``data_tb[:, :64]`` + outcome in the last column (``HF/load_data_public.py:9-10``).
This module encodes every variable with its published marginal so the synthetic
cohort generator (``synthetic.py``) can emit statistically matched data — the
real ``.mat`` cohorts are not shipped (``train_ensemble_public.py:36,39`` load
files absent from the repo).

Marginals transcribed from Table S1:
  binary      → ``count (percent)`` of 1427
  continuous  → ``mean ± sd (median)``
  ordinal     → ``lo-hi (median)``
"""

from __future__ import annotations

import dataclasses

N_COHORT = 1427  # Table S1 caption cohort size


@dataclasses.dataclass(frozen=True)
class VariableSpec:
    name: str
    kind: str  # 'binary' | 'continuous' | 'ordinal'
    # binary: p = prevalence; continuous: mean/sd; ordinal: lo/hi/median
    p: float = 0.0
    mean: float = 0.0
    sd: float = 1.0
    lo: int = 0
    hi: int = 0
    median: float = 0.0


def _b(name: str, count: int) -> VariableSpec:
    return VariableSpec(name, "binary", p=count / N_COHORT)


def _c(name: str, mean: float, sd: float, median: float) -> VariableSpec:
    return VariableSpec(name, "continuous", mean=mean, sd=sd, median=median)


def _o(name: str, lo: int, hi: int, median: float) -> VariableSpec:
    return VariableSpec(name, "ordinal", lo=lo, hi=hi, median=median)


# Order follows Table S1 top-to-bottom (the reference's .mat column order is
# unknowable — only the post-selection 17-feature order is contractual, see
# SELECTED_17 below / predict_hf.py:5-27).
COHORT_SCHEMA: tuple[VariableSpec, ...] = (
    _b("Gender", 985),  # 1 = female (predict_hf.py:7)
    _c("Age at HCM diagnosis", 45, 18, 48),
    _b("Obstructive HCM", 747),
    _b("Massive hypertrophy", 84),
    _b("Non-sustained ventricular tachycardia on holter", 137),
    _b("Syncope", 137),
    _b("Dyspnea", 645),
    _b("Chest pain", 252),
    _b("Fatigue", 198),
    _b("Presyncope", 71),
    _b("Palpitations", 192),
    _o("NYHA_Class", 1, 2, 1),
    _b("ICD", 159),
    _b("Appropriate ICD shocks prior to initial visit", 17),
    _o("Number of ICD shocks", 0, 8, 0),
    _b("Permanent pace maker", 21),
    _b("Mitral valve surgery", 2),
    _b("VT ablation", 4),
    _b("Coronary artery bypass graft", 6),
    _b("Stents", 36),
    _b("Cardioversion", 64),
    _o("Number of DC cardioversions", 0, 4, 0),
    _b("Atrial fibrillation ablation", 16),
    _o("Number of AF ablations", 0, 3, 0),
    _b("Recurrent AF after ablation", 13),
    _b("Atrial_Fibrillation", 199),
    _b("Resuscitated cardiac arrest prior to initial visit", 24),
    _b("Hypertension", 461),
    _b("Coronary artery disease", 79),
    _b("Prior myocardial infarction", 22),
    _b("Stroke", 31),
    _o("Type of stroke", 0, 2, 0),
    _b("Family history of SCD", 154),
    _o("FH SCD: relation to patient", 0, 4, 0),
    _b("FH SCD: multiple relatives", 54),
    _b("Family history of HCM", 369),
    _b("Family history of end stage HCM", 41),
    _b("Family history of heart transplant due to HCM", 26),
    _b("Beta_blocker", 807),
    _b("Ca_Channel_Blockers", 290),
    _b("Disopyramide", 20),
    _b("ACEI_ARB", 309),
    _b("Spironolactone", 16),
    _b("Diuretic", 151),
    _b("Amiodarone", 27),
    _b("Coumadin", 80),
    _b("Aspirin", 405),
    _b("Statin", 459),
    _b("Novel anti-coagulation", 51),
    _b("Other anti-arrhythmic", 44),
    _b("Other cardiac medications", 38),
    _c("Max_Wall_Thick", 19, 5, 17),
    _b("Septal_Anterior_Motion", 927),
    _c("LVOT gradient", 19, 35, 0),
    _c("Mid-cavity obstruction gradient", 3, 12, 0),
    _o("Mitral_Regurgitation", 0, 4, 0),
    _c("Ejection_Fraction", 64, 5, 65),
    _c("LA diameter", 40, 7, 40),
    _c("LV end diastolic diameter", 42, 7, 42),
    _c("LV end systolic diameter", 27, 6, 26),
    _b("Severe aortic stenosis", 9),
    _b("Apical HCM", 161),
    _b("Apical aneurysm", 42),
    _b("End-stage HCM", 25),
)

assert len(COHORT_SCHEMA) == 64, len(COHORT_SCHEMA)

# The 17 model-input variables in their contractual order (predict_hf.py:5-27).
SELECTED_17: tuple[str, ...] = (
    "Obstructive HCM",
    "Gender",
    "Syncope",
    "Dyspnea",
    "Fatigue",
    "Presyncope",
    "NYHA_Class",
    "Atrial_Fibrillation",
    "Hypertension",
    "Beta_blocker",
    "Ca_Channel_Blockers",
    "ACEI_ARB",
    "Coumadin",
    "Max_Wall_Thick",
    "Septal_Anterior_Motion",
    "Mitral_Regurgitation",
    "Ejection_Fraction",
)


def variable_names() -> list[str]:
    return [v.name for v in COHORT_SCHEMA]


def selected_indices() -> list[int]:
    """Column indices of the 17 contractual features within the 64-col schema."""
    names = variable_names()
    return [names.index(n) for n in SELECTED_17]
