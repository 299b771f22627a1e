"""Training-side utilities of the port (the checkpoint format so far)."""
