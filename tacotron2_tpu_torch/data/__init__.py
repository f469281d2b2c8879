"""Input pipeline of the port: manifests, dataset, collate, loader (host numpy)."""
