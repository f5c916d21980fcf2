"""Model stack of the port: layers, attention, the RWKV-6 and RG-LRU
blocks, the decoder LM (dense, hybrid and ssm families), the model API and
the converter from the JAX pytree."""
