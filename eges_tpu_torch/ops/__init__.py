"""Device layer of the port: the limb constants and the plain PyTorch
field library (``field``), the front door mod P and mod N (``bigint``),
the CUDA kernels with their plain versions (``kernels``, ``csrc/``,
``build``), the recovery and classic verify pipelines (``ec``) and
batched Keccak-256 (``keccak``)."""
