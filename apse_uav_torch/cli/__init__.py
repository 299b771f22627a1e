"""cli package of the PyTorch port."""
