"""Model-quality observability: the training reference profile (``quality``)."""
