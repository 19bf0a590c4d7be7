"""Device layer of the port: limb constants (``bigint``), the plain
PyTorch field library (``field``), the CUDA kernels with their plain
versions (``kernels``, ``csrc/``, ``build``), the recovery and classic
verify pipelines (``ec``) and batched Keccak-256 (``keccak``)."""
