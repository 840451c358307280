"""solve layer of the PyTorch port."""
