"""Host-side data: the Table S1 schema and the synthetic cohort generator."""

from machine_learning_replications_tpu_torch.data.schema import (
    COHORT_SCHEMA,
    N_COHORT,
    SELECTED_17,
    selected_indices,
    variable_names,
)
from machine_learning_replications_tpu_torch.data.synthetic import make_cohort

__all__ = [
    "COHORT_SCHEMA",
    "N_COHORT",
    "SELECTED_17",
    "make_cohort",
    "selected_indices",
    "variable_names",
]
