"""Embedding-bag kernel: CUDA (``kernel``), its plain version (``ref``)
and the wrapper that chooses between them (``ops``)."""
