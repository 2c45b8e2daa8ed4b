"""Core host and tensor utilities of the PyTorch port (no eager imports)."""
