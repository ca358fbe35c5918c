"""PQTopK scoring kernels: CUDA (``kernel``), plain versions (``ref``) and
the wrappers that choose between them (``ops``)."""
