"""Probabilistic models on the heat-kernel covariance."""
