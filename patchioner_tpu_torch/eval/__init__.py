"""The port's evaluation layer (twins of `patchioner_tpu/eval/`): the four
task evaluators, the caption metrics and SPICE, dense-captioning mAP,
PAC-S, the grid runner, the results collector and the one-task CLI."""
