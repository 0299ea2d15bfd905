"""Host-side data: the Table S1 schema, the synthetic cohort generator and
the reference's ``.mat`` layout."""

from machine_learning_replications_tpu_torch.data.schema import (
    COHORT_SCHEMA,
    N_COHORT,
    SELECTED_17,
    selected_indices,
    variable_names,
)
from machine_learning_replications_tpu_torch.data.matloader import load_data, save_data
from machine_learning_replications_tpu_torch.data.synthetic import make_cohort

__all__ = [
    "COHORT_SCHEMA",
    "N_COHORT",
    "SELECTED_17",
    "load_data",
    "make_cohort",
    "save_data",
    "selected_indices",
    "variable_names",
]
