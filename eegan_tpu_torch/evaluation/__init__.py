"""Evaluation of the port: FID, Inception Score and its classifier, the
checkpoint sweep with R-precision, evaluation overlapped with training."""
