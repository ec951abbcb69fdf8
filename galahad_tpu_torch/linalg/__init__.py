"""Linear algebra of the port: the flat supernodal LDL^T, its hand-written
kernels (factor, extend-add, sweeps), and the sparse KKT layer."""
