"""Plain fp32 PyTorch references of what the benchmark's cells time.

They import nothing of the program (``omg_tpu_torch``), of JAX or of the
JAX package, and take nothing the program made: the weights, LoRAs,
token ids, masks and noise are drawn again from the run's seed by the
benchmark's own code.
"""
