"""Standalone bootnode package (ref: cmd/bootnode/main.go); the port's
copy of ``eges_tpu/bootnode``."""
