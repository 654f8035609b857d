"""The plain reference: the join's Gram matrix by materializing the join in
blocks (`join`), and the numbers a run's answers are compared on (`checks`).

It imports neither JAX, the JAX package nor anything of the port, and takes
nothing the port made: only the tables and feature sets the benchmark drew.
"""
