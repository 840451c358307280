"""ops layer of the PyTorch port."""
