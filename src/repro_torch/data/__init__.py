"""Relational dataset generators (`relational`), copies of the JAX package's."""
