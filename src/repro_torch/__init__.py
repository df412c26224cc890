"""PyTorch + CUDA port of the ``repro`` package (mini-batch SSCA federated
learning), for one NVIDIA H100. Mirrors ``repro``'s module layout; imports
neither ``jax`` nor ``repro``. See README.md, "PyTorch port"."""
