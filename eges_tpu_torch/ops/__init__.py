"""Device layer of the port: limb constants (``bigint``), the plain
PyTorch field library (``field``), the CUDA kernels with their plain
versions (``kernels``, ``csrc/``, ``build``) and the recovery pipeline
(``ec``)."""
