"""Model members (scaler, SVC, GBDT, logistic regressions) and stacking."""
