"""Model families of the PyTorch port (settings and model builders)."""
