"""Learner loops (host, device and hybrid placements, and fully on the
device), collection, evaluation and metrics."""
