"""FiGaRo core in PyTorch: Givens QR decomposition over relational joins.

Modules: `relation`, `join_tree`, `materialize` (host-side numpy), `counts`,
`heads_tails`, `figaro`, `postprocess` (tensor code on the device),
`plan_cache`, `engine`, `qr`, `svd`. Import them directly; this package
re-exports nothing, so importing one module does not pull in the rest.
"""
