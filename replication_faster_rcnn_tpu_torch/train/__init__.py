"""Training of the PyTorch port (the JAX package's ``train/``)."""
