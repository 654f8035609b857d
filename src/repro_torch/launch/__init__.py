"""Launch helpers of the port: meshes and the serving batch buckets
(`mesh`), the LM trainer (`train`, ``python -m repro_torch.launch.train``),
the roofline of a step (`roofline`) and the dry run of the production
cells (`dryrun`, ``python -m repro_torch.launch.dryrun``)."""
