"""Decoder and prefix-mapper training of the port (twins of
`patchioner_tpu/train/`)."""
