"""Experiment logging."""
