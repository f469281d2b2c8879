"""Drivers of the port: say, train, server, test, train_mel_export."""
