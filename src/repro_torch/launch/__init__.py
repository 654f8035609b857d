"""Launch helpers of the port: the serving batch buckets (`mesh`)."""
