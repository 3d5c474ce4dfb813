"""Step functions and the serving driver of the port."""
