"""Caption scoring of the port (twins of `patchioner_tpu/eval/`)."""
