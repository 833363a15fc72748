"""Device op layer: uint32 modular arithmetic, negacyclic NTT, RNS/CRT,
sampling, and polynomial ring ops in jax.numpy."""
