"""Synthetic inputs of the port: numpy-only copies of the reference's
generators, bit-identical from the same seed."""
