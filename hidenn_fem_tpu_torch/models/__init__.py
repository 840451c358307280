"""models layer of the PyTorch port."""
