"""The benchmark's plain float32 reference of the VINCE pretraining step. It
imports nothing of the program under test, nor JAX."""
