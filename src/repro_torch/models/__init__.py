"""Model stack of the port: layers, attention, the dense decoder LM, the
model API and the converter from the JAX pytree."""
