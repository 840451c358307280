"""mesh layer of the PyTorch port."""
