"""aruco package of the PyTorch port."""
