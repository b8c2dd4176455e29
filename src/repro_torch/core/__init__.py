"""Core of the port: index, engine, pruners, sparse containers."""
