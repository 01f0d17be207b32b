"""Problem generators of the port.  So far the consensus scaling benchmark
(``scaling_bench``); the JAX package's 27 generators are still to port."""
