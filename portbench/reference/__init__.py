"""The plain float32 reference the benchmark compares the port with. It
imports nothing of the port and nothing of JAX."""
