"""core package of the PyTorch port."""
