"""Launch helpers of the port: meshes and the serving batch buckets
(`mesh`), the LM trainer (`train`, ``python -m repro_torch.launch.train``)."""
