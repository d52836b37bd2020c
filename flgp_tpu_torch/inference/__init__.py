"""Hyperparameter optimization and posterior sampling."""
