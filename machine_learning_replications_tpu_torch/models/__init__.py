"""Model members (scaler, SVC, GBDT, logistic regressions) and their solvers,
feature selection, stacking, the full pipeline and the CV sweep."""
