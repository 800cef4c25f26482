"""Training: the optimizer transforms and the single-device train step."""
