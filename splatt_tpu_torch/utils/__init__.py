"""Host-side helpers of the PyTorch port: the environment registry and the
fault-injection harness."""
