"""Training of the port: losses, optimizer, train/eval steps, checkpoints, logs."""
