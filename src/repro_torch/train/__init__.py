"""Training programs of the port: the loss and the compressed DDP steps."""
