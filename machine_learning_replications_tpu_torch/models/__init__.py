"""Model members (scaler, SVC, GBDT, logistic regressions), stacking and the CV sweep."""
