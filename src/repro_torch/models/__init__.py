"""Model code of the port: the dense decoder family so far."""
