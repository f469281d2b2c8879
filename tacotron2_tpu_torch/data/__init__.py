"""Input pipeline of the port's training: dataset, collate, loader (host numpy)."""
