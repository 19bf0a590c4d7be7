"""The profiling harness of the port: the counterparts of the JAX repo's
top-level ``harness/profile*.py``, ``measure_recover.py`` and
``hlo_census.py``, one module each under the same name, run on the card
as ``python -m eges_tpu_torch.harness.<name>``."""
