"""Reading and writing: the JAX package's parameters and state into the
port, checkpoints in the published layouts, HDF5 banks and COCO
annotations."""
