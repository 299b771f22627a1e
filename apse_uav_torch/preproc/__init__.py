"""preproc package of the PyTorch port."""
