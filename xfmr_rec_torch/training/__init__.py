"""Training: train state and steps, retrieval metrics, the trainer, its
CLI."""
