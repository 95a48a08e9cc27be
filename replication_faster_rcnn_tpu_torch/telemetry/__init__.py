"""Telemetry of the PyTorch port (the JAX package's ``telemetry/``)."""
