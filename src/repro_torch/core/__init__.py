"""The compression layer of the port (adaptive top-k, paper §IV)."""
