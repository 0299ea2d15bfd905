"""Host-side helpers: CV fold assignment and model-selection metrics."""
